"""Measured serial-arm kinematic chains and their capsule mask envs
(counterpart of `robot_aware_control_tpu/robot/kinematic_chain.py`;
reference: src/env/robotics/masks/*_mask_env.py, which render MuJoCo
segmentation images, and src/env/robotics/controllers/*.py, per-robot
PyBullet IK).

Each robot is a product-of-exponentials chain measured from the reference
MJCF (zero-pose world joint anchors and axes, one fitted capsule a geom:
`_chain_data.py`, radii tuned against MuJoCo renders: `_chain_tuned.py`).
Its silhouette is the union of those capsules, rigidly attached to their
driven-joint frames and projected through the measured camera extrinsics
(data/calibration.py) with the MJCF main camera's fovy.

Everything runs on tensors of the caller's device, in float32, with the
per-element arithmetic of the JAX package and fewer launches:

  * every joint's rotation is built in one set of tensor ops (axes as a
    (J, 3) table, the axis products taken in float64 and rounded once, as
    JAX multiplies the axis components as Python floats), then the J - 1
    products; the anchors and the tip are one cumulative sum;
  * IK stacks its starts (q0 and three seeds) on one batch axis and
    solves each damped 3x3 system by its adjugate: elementwise work, so a
    row's result depends on that row alone (batched plans equal single
    plans bit for bit) and nothing waits on the host;
  * 3x3 products are broadcast multiplies summed over a small axis, not
    library matmuls, for the same reason.

The render is plain tensor work, as the JAX package computes it in jnp (it
reaches no Pallas kernel).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from robot_aware_control_tpu_torch.data import calibration as calib
from robot_aware_control_tpu_torch.robot._chain_data import CHAIN_DATA
from robot_aware_control_tpu_torch.robot._chain_tuned import (
    TUNED_EXT,
    TUNED_OCC_SCALE,
    TUNED_RADII,
)
from robot_aware_control_tpu_torch.utils.device import resolve_device


def _rot_tables(axes: np.ndarray):
    """(J, 3) float32 axes -> the float32 (J, 3, 3) tables of Rodrigues'
    formula: outer[i, j] = a_i a_j (the product in float64, rounded once)
    and skew (the cross-product matrix)."""
    a = np.asarray(axes, np.float32).astype(np.float64)
    outer = (a[:, :, None] * a[:, None, :]).astype(np.float32)
    x, y, z = (a[:, i].astype(np.float32) for i in range(3))
    o = np.zeros_like(x)
    skew = np.stack([np.stack([o, -z, y], -1), np.stack([z, o, -x], -1),
                     np.stack([-y, x, o], -1)], -2)
    return outer, skew


def _rot(outer, skew, eye, th):
    """Axis-angle rotations: outer, skew (..., 3, 3) tables of the axes
    (`_rot_tables`), eye the identity, th (...,) -> (..., 3, 3):
    c I + (1 - c) a a^T + s [a]x, each element in the order the JAX `_rot`
    sums it."""
    c, s = torch.cos(th)[..., None, None], torch.sin(th)[..., None, None]
    return outer * (1 - c) + skew * s + eye * c


def _mm(a, b):
    """(..., 3, 3) @ (..., 3, 3) as a broadcast multiply and a sum."""
    return (a[..., :, :, None] * b[..., None, :, :]).sum(-2)


def _solve3(A, b):
    """A (..., 3, 3) symmetric, b (..., 3) -> A^-1 b by the adjugate: the
    columns of A^-1 det(A) are the cross products of A's rows."""
    adj = torch.linalg.cross(A.roll(-1, -2), A.roll(-2, -2))  # rows of adj
    det = (A[..., 0, :] * adj[..., 0, :]).sum(-1)
    return (adj * b[..., :, None]).sum(-2) / det[..., None]


class KinematicChain:
    """Product-of-exponentials chain from zero-pose measurements.

    anchors (J, 3) world joint anchors at qpos = 0; axes (J, 3) world joint
    axes at qpos = 0; jnt_range (J, 2); tip (3,) the eef at qpos = 0 (rides
    the last joint's frame). With R_k = prod_{i<=k} Rot(axis_i, q_i),
    anchor_k(q) = anchor_{k-1}(q) + R_{k-1} (anchor_k^0 - anchor_{k-1}^0)
    (MuJoCo hinge trees, src/env/robotics/assets/*/robot.xml)."""

    def __init__(self, name: str, anchors, axes, jnt_range, tip):
        self.name = name
        self.anchors = np.asarray(anchors, np.float32)
        self.axes = np.asarray(axes, np.float32)
        self.jnt_range = np.asarray(jnt_range, np.float32)
        self.tip = np.asarray(tip, np.float32)
        self._tables = {}  # device -> the chain's constants there

    @property
    def dof(self) -> int:
        return len(self.axes)

    def consts(self, device) -> Dict[str, torch.Tensor]:
        """The chain's constant tensors on `device`, made once a device (a
        copy inside a rollout would wait for the device)."""
        device = torch.device(device)
        t = self._tables.get(device)
        if t is None:
            lo, hi = self.jnt_range[:, 0], self.jnt_range[:, 1]
            mid, span = np.float32(0.5) * (lo + hi), np.float32(0.5) * (hi - lo)
            outer, skew = _rot_tables(self.axes)
            # per frame k: the offset its rotation carries to the next
            # anchor (the tip for the last), and the next joint's axis
            off = np.concatenate([self.anchors[1:] - self.anchors[:-1],
                                  (self.tip - self.anchors[-1])[None]])
            nxt = np.concatenate([self.axes[1:], np.zeros((1, 3), np.float32)])
            host = dict(outer=outer, skew=skew, eye=np.eye(3, dtype=np.float32),
                        anchors=self.anchors,
                        axes=self.axes, lo=lo, hi=hi,
                        seeds=np.stack([mid, mid + np.float32(0.25) * span,
                                        mid - np.float32(0.25) * span]),
                        vecs=np.stack([off, nxt], 1))  # (J, 2, 3)
            t = {k: torch.tensor(np.ascontiguousarray(v), device=device)
                 for k, v in host.items()}
            self._tables[device] = t
        return t

    def _frames(self, q):
        """q (..., dof) -> (R (..., J, 3, 3) cumulative rotations incl. joint
        k's own, points (..., J + 1, 3): every joint anchor then the tip,
        axes_w (..., J, 3) world axes (joint i's rotates with the frames
        before it))."""
        k = self.consts(q.device)
        rots = _rot(k["outer"], k["skew"], k["eye"], q)  # (..., J, 3, 3)
        Rs = [rots[..., 0, :, :]]
        for i in range(1, self.dof):
            Rs.append(_mm(Rs[-1], rots[..., i, :, :]))
        R = torch.stack(Rs, -3)
        vecs = (R[..., None, :, :] * k["vecs"][:, :, None, :]).sum(-1)
        # (..., J, 2, 3): R_k (offset to the next anchor), R_k axis_{k+1};
        # anchors accumulate in JAX's order: ((a_0 + d_0) + d_1) + ...
        base = k["anchors"][0].expand(q.shape[:-1] + (1, 3))
        points = torch.cumsum(torch.cat([base, vecs[..., 0, :]], -2), -2)
        axes_w = torch.cat([k["axes"][0].expand(q.shape[:-1] + (1, 3)),
                            vecs[..., :-1, 1, :]], -2)
        return R, points, axes_w

    def fk_frames(self, qpos):
        """qpos (..., >=dof) -> (pos (..., J, 3), R (..., J, 3, 3)): world
        anchor position and cumulative rotation of every driven joint."""
        R, points, _ = self._frames(qpos[..., : self.dof].float())
        return points[..., :-1, :], R

    def fk_points(self, qpos):
        """qpos (..., >=dof) -> (..., dof + 2, 3): base anchor, every joint
        anchor, eef tip."""
        _, points, _ = self._frames(qpos[..., : self.dof].float())
        return torch.cat([points[..., :1, :], points], -2)

    def fk_full(self, qpos):
        """(pts (..., dof + 2, 3) as fk_points, axes_w (..., dof, 3))."""
        _, points, axes_w = self._frames(qpos[..., : self.dof].float())
        return torch.cat([points[..., :1, :], points], -2), axes_w

    def ik(self, target, q0=None, iters: int = 60, damping: float = 5e-2,
           tol: float = 5e-3):
        """Batched damped-least-squares position IK (JAX `ik`): target
        (..., 3) world positions; q0 (..., >=dof) an optional start. From
        each start (q0, then the range's midpoint and +-a quarter span)
        `iters` Gauss-Newton/DLS steps, the position Jacobian's column for
        joint i being axis_w_i x (tip - anchor_i), clipped to the joint
        ranges; the start that ends nearest the target wins (ties to the
        earlier). Where several starts reach a target they end within about
        1e-7 m of it, and the choice follows float32 rounding, as in the
        JAX package. Returns (qpos (..., dof), valid (...,) = error < tol)."""
        errs, q = self.ik_starts(target, q0, iters, damping)
        best = errs.argmin(0)
        q = torch.take_along_dim(q, best[None, ..., None], 0)[0]
        err = torch.take_along_dim(errs, best[None], 0)[0]
        return q, err < tol

    def ik_starts(self, target, q0=None, iters: int = 60,
                  damping: float = 5e-2):
        """`ik` before its choice: (errors (S, ...), qpos (S, ..., dof)) of
        every start, q0 first where given."""
        target = target.float()
        batch = target.shape[:-1]
        k = self.consts(target.device)
        starts = [k["seeds"].reshape((3,) + (1,) * len(batch) + (self.dof,))
                  .expand((3,) + batch + (self.dof,))]
        if q0 is not None:
            starts.insert(0, q0[..., : self.dof].float()
                          .expand(batch + (self.dof,))[None])
        q = torch.cat(starts)  # (S, ..., dof)
        damp = damping ** 2 * k["eye"]
        for _ in range(iters):
            _, points, axes_w = self._frames(q)
            tip = points[..., -1, :]
            err = target - tip
            cols = torch.linalg.cross(axes_w, tip[..., None, :] - points[..., :-1, :])
            A = (cols[..., :, :, None] * cols[..., :, None, :]).sum(-3) + damp
            dq = (cols * _solve3(A, err)[..., None, :]).sum(-1)
            q = torch.clamp(q + dq, k["lo"], k["hi"])
        tip = self._frames(q)[1][..., -1, :]
        return torch.sqrt(((target - tip) ** 2).sum(-1)), q


def _make_chain(key: str) -> KinematicChain:
    d = CHAIN_DATA[key]
    return KinematicChain(key, d["anchors"], d["axes"], d["jnt_range"], d["eef"])


CHAINS: Dict[str, KinematicChain] = {k: _make_chain(k) for k in CHAIN_DATA}

# each robot's measured default viewpoint: the extrinsics each reference
# mask env loads (sawyer_mask_env.py:226-230, widowx_mask_env.py:119-127,
# baxter_mask_env.py:179-196, franka_mask_env.py:126-140,
# kuka_mask_env.py:113-121, fetch_mask_env.py:171-185, wx250s_model.py:25-28)
DEFAULT_CAMERA: Dict[str, str] = {
    "sawyer": "sawyer_sudri0_c0",
    "widowx": "widowx_widowx1_c0",
    "baxter": "baxter_left_c0",
    "baxter_right": "baxter_right_c0",
    "franka": "franka_c0",
    "kuka": "kuka_c0",
    "fetch": "fetch_c0",
    "wx250s": "wx250s_c0",
}


class ChainMaskEnv:
    """A robot's mask renderer with the reference MaskEnv API
    (base_mask_env.py:73-82): `render(qpos)` gives one {0, 1} mask a
    configuration, batched over the leading axes, on the env's device;
    `generate_masks` the same as numpy. "Thick" masks scale every radius
    by 1.45. Occluder capsules (geoms the reference's mask filter leaves
    out, whose z-buffer presence still hides mask geoms behind them) are
    rendered with a depth test where the robot's tuned occluder scale is
    above 0 (fetch)."""

    SUBDIV = 3  # each capsule axis in 3 pieces before projection
    OCC_EPS = 0.0
    OCC_CHUNK = 8  # occluders a pass (JAX `occluder_depth`)
    _INF_DEPTH = 1e9

    def __init__(self, robot: str, image_size: Tuple[int, int] = (48, 64),
                 camera_key: Optional[str] = None, thick: bool = False,
                 arm: str = "left", occlude: bool = True, device="cuda"):
        key = "baxter_right" if robot == "baxter" and arm == "right" else robot
        data = CHAIN_DATA[key]
        dev = self.device = resolve_device(device)
        self.chain = CHAINS[key]
        self.robot = robot
        self.h, self.w = image_size
        self.native_size = tuple(data["native_size"])  # (W, H)
        w2c = calib.get_world_to_camera(camera_key or DEFAULT_CAMERA[key])
        # intrinsics from the MJCF main_cam fovy at the native render size,
        # rescaled to the output size
        nw, nh = self.native_size
        f = (nh / 2.0) / np.tan(np.radians(data["fovy"]) / 2.0)
        self._fx, self._fy = f * self.w / nw, f * self.h / nh
        self._cx, self._cy = self.w / 2.0, self.h / 2.0
        self._w2c = torch.tensor(np.asarray(w2c, np.float32)[:3], device=dev)
        radii = np.asarray(TUNED_RADII.get(key, data["caps_r"]), np.float32)
        self.radii = torch.tensor(radii * (1.45 if thick else 1.0), device=dev)
        # per-capsule axial endpoint extensions (m) from the same tuning
        self.ext = torch.tensor(np.asarray(
            TUNED_EXT.get(key, np.zeros(len(radii))), np.float32), device=dev)
        self._caps = self._capsule_set(data["caps_attach"], data["caps_a"],
                                       data["caps_b"])
        occ_r = np.asarray(data.get("occ_r", np.zeros(0)), np.float32)
        live = occ_r > 0  # the mesh fitter gives r = 0 for flat geoms
        self.has_occluders = bool(live.any())
        self._occ_scale = float(TUNED_OCC_SCALE.get(key, 0.0)) if occlude else 0.0
        self.occlude = self.has_occluders and self._occ_scale > 0.0
        if self.has_occluders:
            self._occ = self._capsule_set(
                np.asarray(data["occ_attach"])[live],
                np.asarray(data["occ_a"], np.float32)[live],
                np.asarray(data["occ_b"], np.float32)[live])
            self._occ_r = torch.tensor(occ_r[live], device=dev)  # unscaled
        self._px = torch.arange(self.w, dtype=torch.float32, device=dev) + 0.5
        self._py = torch.arange(self.h, dtype=torch.float32, device=dev) + 0.5
        self._ts = torch.tensor(np.linspace(0.0, 1.0, self.SUBDIV + 1)
                                .astype(np.float32), device=dev)

    def _capsule_set(self, attach, a, b):
        """Capsules attached to driven joints (attach >= 0) or static
        (attach = -1), as tensors on the env's device."""
        attach = np.asarray(attach, np.int64)
        dev = self.device
        return dict(attach=torch.tensor(np.maximum(attach, 0), device=dev),
                    static=torch.tensor(attach < 0, device=dev)[:, None],
                    a=torch.tensor(np.asarray(a, np.float32), device=dev),
                    b=torch.tensor(np.asarray(b, np.float32), device=dev))

    def _project(self, pts):
        """world (..., 3) -> (u, v, z (...,)): camera z clamped at 1e-4."""
        cam = (pts[..., None, :] * self._w2c[:, :3]).sum(-1) + self._w2c[:, 3]
        z = torch.clamp(cam[..., 2], min=1e-4)
        u = self._fx * cam[..., 0] / z + self._cx
        v = self._fy * cam[..., 1] / z + self._cy
        return u, v, z

    def _capsule_endpoints(self, qpos, caps):
        """World endpoints (a, b (..., C, 3)) of a capsule set: capsules on
        joint k move rigidly with frame k, static ones keep their
        zero-pose world pose."""
        pos, R = self.chain.fk_frames(qpos)
        anchors = self.chain.consts(qpos.device)["anchors"]
        att = caps["attach"]
        p_att, R_att, anch = pos[..., att, :], R[..., att, :, :], anchors[att]
        ends = []
        for c in (caps["a"], caps["b"]):
            moved = p_att + (R_att * (c - anch)[:, None, :]).sum(-1)
            ends.append(torch.where(caps["static"], c, moved))
        return ends

    def _seg_cover_depth(self, qpos, radii, ext, caps, depth: bool):
        """Screen coverage (and, with `depth`, the front-surface camera z)
        of every capsule sub-segment at every pixel centre: cover
        (..., C*S, H, W) bool, depth (..., C*S, H, W) float32 or None. A
        pixel is covered when its distance to the projected sub-segment is
        at most the radius interpolated along it (r / z at each end); a
        sub-segment whose both ends sit at the clamped depth is skipped."""
        a, b = self._capsule_endpoints(qpos, caps)
        axis = b - a
        u = axis / (torch.sqrt((axis * axis).sum(-1, keepdim=True)) + 1e-9)
        a = a - ext[:, None] * u
        b = b + ext[:, None] * u
        pts = a[..., None, :] + (b - a)[..., None, :] * self._ts[:, None]
        pu, pv, pz = self._project(pts)  # (..., C, S + 1)
        lead = pu.shape[:-2]
        n = pu.shape[-2] * self.SUBDIV
        seg = lambda x, s: x[..., s].reshape(lead + (n, 1, 1))
        au, bu = seg(pu, slice(None, -1)), seg(pu, slice(1, None))
        av, bv = seg(pv, slice(None, -1)), seg(pv, slice(1, None))
        az, bz = seg(pz, slice(None, -1)), seg(pz, slice(1, None))
        r = radii.repeat_interleave(self.SUBDIV)[:, None, None]
        r_a, r_b = self._fx * r / az, self._fx * r / bz
        # a skipped sub-segment gets a negative radius: no pixel is covered
        skip = (az + bz) <= 2e-4
        r_a = torch.where(skip, -1.0, r_a)
        r_b = torch.where(skip, -1.0, r_b)
        dx, dy = bu - au, bv - av
        ex = self._px - au  # (..., n, 1, W)
        ey = self._py[:, None] - av  # (..., n, H, 1)
        t = (ex * dx + ey * dy).div_(dx * dx + dy * dy + 1e-8).clamp_(0.0, 1.0)
        gx = torch.addcmul(ex, t, dx, value=-1.0)
        gy = torch.addcmul(ey, t, dy, value=-1.0)
        dist = gx.mul_(gx).add_(gy.mul_(gy)).sqrt_()
        del gy
        cover = dist <= torch.addcmul(r_a, t, r_b - r_a)
        del dist
        if not depth:
            return cover, None
        return cover, torch.addcmul(az, t, bz - az).sub_(r)

    def occluder_depth(self, qpos, scale: Optional[float] = None):
        """(..., H, W) nearest occluder surface depth (1e9 where none), in
        chunks of OCC_CHUNK occluders. `scale` multiplies the measured
        occluder radii (None: the tuned scale; <= 0 or no occluders: all
        far)."""
        s_abs = self._occ_scale if scale is None else float(scale)
        if not self.has_occluders or s_abs <= 0.0:
            return torch.full(qpos.shape[:-1] + (self.h, self.w),
                              self._INF_DEPTH, device=qpos.device)
        occ = self._occ
        out = None
        for s in range(0, len(self._occ_r), self.OCC_CHUNK):
            part = {k: v[s:s + self.OCC_CHUNK] for k, v in occ.items()}
            r = self._occ_r[s:s + self.OCC_CHUNK] * s_abs
            cover, depth = self._seg_cover_depth(
                qpos, r, torch.zeros_like(r), part, depth=True)
            d = torch.where(cover, depth, self._INF_DEPTH).amin(-3)
            out = d if out is None else torch.minimum(out, d)
        return out

    def render_with(self, qpos, radii, ext, occ_depth=None):
        """The silhouette for capsule radii `radii` (C,) and axial
        extensions `ext` (C,): qpos (..., >=dof) -> (..., H, W, 1) float32.
        Where the robot's tuned occluder scale is above 0 (or `occ_depth`
        is given), a mask pixel survives only if its nearest mask-capsule
        surface lies in front of every occluder surface there."""
        qpos = qpos.float()
        if occ_depth is None and self.occlude:
            occ_depth = self.occluder_depth(qpos)
        cover, depth = self._seg_cover_depth(qpos, radii, ext, self._caps,
                                             depth=occ_depth is not None)
        if occ_depth is not None:
            cover &= depth <= occ_depth[..., None, :, :] + self.OCC_EPS
        return cover.any(-3)[..., None].float()

    def render(self, qpos):
        """qpos (..., >=dof) on the env's device -> masks (..., H, W, 1)."""
        return self.render_with(qpos, self.radii, self.ext)

    def generate_masks(self, qpos) -> np.ndarray:
        """(reference: base_mask_env.py:73-82) qpos (..., >=dof), any
        array -> numpy masks (..., H, W, 1)."""
        q = torch.as_tensor(np.asarray(qpos, np.float32), device=self.device)
        return self.render(q).cpu().numpy()


class _LocobotMaskEnv:
    """The locobot's capsule renderer behind the MaskEnv API."""

    def __init__(self, **kw):
        from robot_aware_control_tpu_torch.robot.mask_renderer import (
            CapsuleMaskRenderer,
        )

        self.r = CapsuleMaskRenderer(**kw)
        self.device = self.r._w2c.device

    def generate_masks(self, qpos) -> np.ndarray:
        q = torch.as_tensor(np.asarray(qpos, np.float32), device=self.device)
        return self.r.render(q).cpu().numpy()


def get_mask_env(robot: str, **kw):
    """Per-robot dispatch matching the reference env classes
    (SawyerMaskEnv, BaxterMaskEnv, WidowXMaskEnv, FrankaMaskEnv,
    KukaMaskEnv, FetchMaskEnv, WX250sMaskEnv; LocobotMaskEnv through the
    capsule renderer and its kernel)."""
    if robot == "locobot":
        return _LocobotMaskEnv(**kw)
    return ChainMaskEnv(robot, **kw)
