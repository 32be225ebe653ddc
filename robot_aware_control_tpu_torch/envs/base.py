"""Environment base: explicit sim state, a physics step on tensors, the
calibrated scene render.

Counterpart of `robot_aware_control_tpu/envs/base.py` (reference:
src/env/robotics/robot_env.py:20-217, state API :202-217). The simulator
state is a tuple of tensors (`SimState`) and the transition a function
`physics_step(state, action)` over any leading batch dims, so

  * the env is a thin stateful shell for gym-style interaction,
  * ground-truth CEM rolls N candidates through one batched step a
    horizon step (planning/gt_rollout.py; the JAX package vmaps its step
    over candidates and scans it over steps),
  * get/set of the flattened state is a copy, so branching is free.

The step is branchless on tensor values (`torch.where`, no `.item()`, no
Python `if` on a tensor), so a plan makes no host sync inside its loop.

Contact model (the JAX package's, fitted there against the reference's
MuJoCo LocobotTableEnv; locobot_table_env.py:186-256): quasi-static
projection pushing with momentum. A block overlapping the tip's end
position is projected out along the tip->block normal to the touch
distance; block-block overlaps then resolve in chain order; pushing a train
shares the weld load; a block leaving contact coasts with decaying
velocity. Pick uses attach/release flags driven by the gripper channel.
"""

from __future__ import annotations

import functools
import warnings
from typing import NamedTuple, Optional

import numpy as np
import torch

from robot_aware_control_tpu_torch.envs.renderer import SceneRenderer
from robot_aware_control_tpu_torch.robot import locobot_kinematics as lk
from robot_aware_control_tpu_torch.utils.device import resolve_device

# locobot workspace (reference: src/cem/trajectory_sampler.py:22-23)
WS_LOW = np.array([0.015, -0.3, 0.1], np.float32)
WS_HIGH = np.array([0.55, 0.3, 0.4], np.float32)
TABLE_Z = 0.1
ACTION_SCALE = 0.05  # eef position control scale (locobot_table_env.py:190)
CONTACT_RADIUS = 0.045  # tip + block half-extent (touch distance)
# the mocap weld lags under contact load: tip and block advance by this
# fraction of the commanded displacement during contact
PUSH_EFFICIENCY = 0.44
# pushing an n-block train: eff_n = eff / (1 + PUSH_LOAD * (n - 1))
PUSH_LOAD = 0.4
# a block out of contact coasts: COAST_INIT x the last contact
# displacement, then geometric decay
COAST_INIT = 0.8
COAST_DECAY = 0.3
# centre distance at which two blocks push each other
BLOCK_TOUCH = 0.044
# the contact fit holds for contact pushes with |action_xy| >= this
# fraction of the full step (the JAX package's envs/base.py says why)
QUASISTATIC_MIN_PUSH = 0.5


class SimState(NamedTuple):
    eef: torch.Tensor       # (..., 3) gripper tip world position
    qpos: torch.Tensor      # (..., 5) arm joints [yaw, shoulder, elbow, wrist, roll]
    obj_pos: torch.Tensor   # (..., K, 3) block centres
    gripper: torch.Tensor   # (...,) gripper openness in [0, 1] (1 = open)
    attached: torch.Tensor  # (..., K) 1.0 if the block is held
    obj_vel: torch.Tensor   # (..., K, 2) xy coast velocity (m/step)


@functools.lru_cache(maxsize=None)
def _bounds(device: torch.device, obj_half: float):
    """The workspace's bounds for the tip and for block centres, as
    tensors on `device` (made once, not per step)."""
    t = lambda x: torch.tensor(x, dtype=torch.float32, device=device)
    return (t(WS_LOW), t(WS_HIGH), t(WS_LOW[:2] + obj_half),
            t(WS_HIGH[:2] - obj_half))


def solve_qpos(eef, cur_qpos, pitch=lk.DEFAULT_PITCH, roll=lk.DEFAULT_ROLL):
    theta, _ = lk.ik(eef, -pitch, cur_qpos[..., :4])
    return torch.cat([theta, torch.full_like(theta[..., :1], roll)], -1)


def _resolve_contacts(xy, free, low_enough, tip_xy, contact_radius,
                      n_chain_passes):
    """Projection contact in the plane (JAX `base.py:_resolve_contacts`):
    blocks overlapping the tip's end position are pushed out along the
    tip->block normal to the touch distance; then, n_chain_passes times, a
    block moved this step shoves any free block it overlaps out along their
    centre axis. xy (..., K, 2), free (..., K), low_enough (...,), tip_xy
    (..., 2). Returns (new_xy, moved (..., K))."""
    d = xy - tip_xy[..., None, :]
    dist = torch.clamp(torch.linalg.vector_norm(d, dim=-1), min=1e-6)
    nhat = d / dist[..., None]
    overlap = torch.clamp(contact_radius - dist, min=0.0)
    overlap = torch.where(low_enough[..., None] & free, overlap, 0.0)
    xy = xy + overlap[..., None] * nhat
    moved = overlap > 1e-6
    K = xy.shape[-2]
    others = ~torch.eye(K, dtype=torch.bool, device=xy.device)
    for _ in range(n_chain_passes):
        vec = xy[..., None, :, :] - xy[..., :, None, :]  # vec[i, j] = j - i
        dij = torch.clamp(torch.linalg.vector_norm(vec, dim=-1), min=1e-6)
        nij = vec / dij[..., None]
        ov = torch.clamp(BLOCK_TOUCH - dij, min=0.0)
        ov = torch.where(moved[..., :, None] & free[..., None, :] & others,
                         ov, 0.0)
        shove = torch.sum(ov[..., None] * nij, dim=-3)  # (..., K, 2)
        xy = xy + shove
        moved = moved | (torch.linalg.vector_norm(shove, dim=-1) > 1e-6)
    return xy, moved


def push_objects(obj_pos, attached, obj_vel, tip_prev, tip_next,
                 contact_radius=CONTACT_RADIUS, obj_half=0.02):
    """Contact and momentum update of the blocks (xy only); held blocks
    follow the tip. Returns (new_obj_pos, new_obj_vel)."""
    K = obj_pos.shape[-2]
    free = attached < 0.5
    low_enough = tip_next[..., 2] < (TABLE_Z + 2.5 * obj_half + 0.03)
    xy0 = obj_pos[..., :2]
    xy, moved = _resolve_contacts(xy0, free, low_enough, tip_next[..., :2],
                                  contact_radius, max(K - 1, 1))
    contact_delta = xy - xy0
    # coasting: blocks not in contact keep sliding with decaying velocity
    coasting = ~moved & free
    xy = xy + torch.where(coasting[..., None], obj_vel, 0.0)
    new_vel = torch.where(moved[..., None], COAST_INIT * contact_delta,
                          obj_vel * COAST_DECAY)
    new_vel = torch.where(free[..., None], new_vel, 0.0)
    _, _, lo, hi = _bounds(xy.device, obj_half)
    new_xy = torch.minimum(torch.maximum(xy, lo), hi)
    held = attached > 0.5
    held_xy = tip_next[..., None, :2].expand(new_xy.shape)
    held_z = torch.clamp(tip_next[..., 2] - 0.04, min=TABLE_Z + obj_half)
    z = torch.where(held, held_z[..., None], obj_pos[..., 2])
    xy = torch.where(held[..., None], held_xy, new_xy)
    return torch.cat([xy, z[..., None]], -1), new_vel


def physics_step(state: SimState, action, action_scale=ACTION_SCALE,
                 pick: bool = False, obj_half: float = 0.02) -> SimState:
    """One transition of states with any leading batch dims. action
    (..., A): [:3] eef delta (x action_scale, clipped to the workspace as
    in locobot_table_env.py:186-199), fewer than 3 channels zero-padded;
    pick envs read a 4th gripper channel (locobot_pick_env.py:163-238)."""
    A = action.shape[-1]
    a = (action[..., :3] if A >= 3 else torch.cat(
        [action, action.new_zeros(action.shape[:-1] + (3 - A,))], -1))
    a = torch.clamp(a, -1.0, 1.0)
    eef = state.eef
    lo, hi, _, _ = _bounds(eef.device, obj_half)
    tip_free = torch.minimum(torch.maximum(eef + a * action_scale, lo), hi)
    # contact resistance: pushing slows tip and blocks to a fraction of the
    # commanded displacement; an n-block train divides it further. The
    # chain is probed at the full commanded step.
    n_pass = max(state.obj_pos.shape[-2] - 1, 1)
    low_free = tip_free[..., 2] < (TABLE_Z + 2.5 * obj_half + 0.03)
    _, probe_moved = _resolve_contacts(
        state.obj_pos[..., :2], state.attached < 0.5, low_free,
        tip_free[..., :2], CONTACT_RADIUS, n_pass)
    n_load = torch.sum(probe_moved.float(), -1)
    eff = torch.where(
        n_load > 0.0,
        PUSH_EFFICIENCY / (1.0 + PUSH_LOAD * torch.clamp(n_load - 1.0,
                                                         min=0.0)),
        1.0)
    tip_next = eef + eff[..., None] * (tip_free - eef)
    grip = state.gripper
    attached = state.attached
    if pick:
        close_cmd = action[..., 3] < -0.0025  # gripper channel in [-0.01, 0]
        grip = torch.where(close_cmd, 0.0, 1.0)
        d = tip_next[..., None, :2] - state.obj_pos[..., :2]
        near = torch.sqrt(torch.sum(d * d, -1)) < CONTACT_RADIUS
        near_z = torch.abs(tip_next[..., None, 2] - state.obj_pos[..., 2]) < 0.06
        grab = close_cmd[..., None] & near & near_z
        # release all when opening; keep holding otherwise
        attached = torch.where(close_cmd[..., None],
                               torch.maximum(attached, grab.float()),
                               torch.zeros_like(attached))
    obj_pos, obj_vel = push_objects(state.obj_pos, attached, state.obj_vel,
                                    eef, tip_next, obj_half=obj_half)
    if pick:  # dropped blocks fall to the table
        dropped = (state.attached > 0.5) & (attached < 0.5)
        z = torch.where(dropped, TABLE_Z + obj_half, obj_pos[..., 2])
        obj_pos = torch.cat([obj_pos[..., :2], z[..., None]], -1)
    qpos = solve_qpos(tip_next, state.qpos)
    return SimState(tip_next, qpos, obj_pos, grip, attached, obj_vel)


def to_host(*tensors):
    """Copies tensors to numpy in one device-to-host transfer (one host
    sync on the GPU): they are flattened into one float32 buffer."""
    flat = torch.cat([t.detach().reshape(-1).float() for t in tensors])
    host = flat.cpu().numpy()
    out, i = [], 0
    for t in tensors:
        out.append(host[i:i + t.numel()].reshape(tuple(t.shape)))
        i += t.numel()
    return out


class RobotEnv:
    """gym-style shell over the physics step and the renderer, on `device`
    (the GPU unless the caller asks for the CPU). Draws from
    np.random.RandomState(seed) in the JAX env's order, so a seed gives the
    same start states in both packages."""

    action_dim = 5
    pick = False
    num_objects = 1
    obj_half = 0.02
    OBJ_COLORS = np.array(
        [[0.85, 0.20, 0.15], [0.15, 0.55, 0.85], [0.20, 0.75, 0.30],
         [0.90, 0.75, 0.15]], np.float32,
    )

    # "modified" robot variant: longer forearm and another appearance, the
    # zero-shot transfer target (reference: modified locobot xmls,
    # locobot_analytical_ik.py:271-274, --modified)
    modified = False
    arm_color = None
    arm_radii = None

    def __init__(self, config=None, seed: Optional[int] = None,
                 device="cuda"):
        self._config = config
        self.device = resolve_device(device)
        cfg = config
        g = lambda name, d: getattr(cfg, name, d) if cfg else d
        h, w = g("image_height", 48), g("image_width", 64)
        self._img_shape = (h, w)
        modified = self.modified or bool(g("modified", False))
        # --red_robot: a distinctly coloured arm (reference: fetch_push.py)
        arm_color = self.arm_color
        if g("red_robot", False):
            arm_color = (0.75, 0.12, 0.10)
        # --camera_name: a measured viewpoint of data/calibration.py, or a
        # look-at camera registered there under that name
        self.renderer = SceneRenderer(
            (h, w), camera_key=g("camera_name", None), table_z=TABLE_Z, modified=modified,
            arm_color=arm_color, radii=self.arm_radii, device=self.device,
        )
        self.rng = np.random.RandomState(
            seed if seed is not None else g("seed", 0))
        self.max_episode_length = g("max_episode_length", 20)
        # --action_repeat: physics substeps per env step (reference:
        # clutter_push.py:66,105)
        self._action_repeat = max(1, int(g("action_repeat", 1) or 1))
        self._action_noise = float(g("action_noise", 0.0) or 0.0)
        # observation modes (reference: fetch_push.py / clutter_push.py)
        self._pixels_ob = bool(g("pixels_ob", True))
        self._norobot_ob = bool(g("norobot_pixels_ob", False))
        self._most_recent_bg = bool(g("most_recent_background", False))
        self._mask_with_obj = bool(g("robot_mask_with_obj", False))
        self._inpaint_eef = bool(g("inpaint_eef", True))
        if g("depth_ob", False):
            raise NotImplementedError(
                "--depth_ob: the analytic scene rasterizer does not produce "
                "depth maps")
        self._force_norobot = False  # set during --invisible_demo collection
        self._background_img = None
        # --large_block: bigger pushable blocks (reference: fetch_push.py)
        if g("large_block", False):
            self.obj_half = self.obj_half * 1.5
        K = self.num_objects
        self._colors = self.OBJ_COLORS[:K]
        self._halfs = np.full(K, self.obj_half, np.float32)
        # the same on the device, so that a render copies nothing to it
        self._colors_t = torch.tensor(self._colors, device=self.device)
        self._halfs_t = torch.tensor(self._halfs, device=self.device)
        self._t = 0
        self.state: SimState = None  # set by reset()

    # ------------------------------------------------------------------
    def _step_fn(self, state: SimState, action) -> SimState:
        return physics_step(state, action, pick=self.pick,
                            obj_half=self.obj_half)

    def _render_fn(self, state: SimState, include_arm: bool = True):
        return self.renderer.render_scene(
            state.qpos, state.obj_pos, self._halfs_t, self._colors_t,
            include_arm=include_arm)

    def _render_norobot_fn(self, state: SimState):
        return self._render_fn(state, include_arm=False)

    def _obj_hit_fn(self, state: SimState):
        return self.renderer.render_objects(state.obj_pos,
                                            self._halfs_t)[0].any(dim=-3)

    def _host(self, name: str) -> np.ndarray:
        """A field of the state as numpy (a host sync on the GPU)."""
        return to_host(getattr(self.state, name))[0]

    def _noised(self, action):
        """--action_noise: gaussian perturbation of scripted demo actions
        (reference: clutter_push.py:1083, collect_clutter_data.py:221)."""
        if self._action_noise <= 0:
            return action
        a = np.asarray(action, np.float32)
        return np.clip(
            a + self.rng.normal(0.0, self._action_noise, a.shape), -1.0, 1.0
        ).astype(np.float32)

    def _state(self, eef, qpos, obj, grip, att, vel) -> SimState:
        t = lambda x: torch.as_tensor(np.asarray(x, np.float32),
                                      device=self.device)
        return SimState(t(eef), t(qpos), t(obj), t(grip), t(att), t(vel))

    def _sample_state(self) -> SimState:
        eef = np.array([
            self.rng.uniform(0.18, 0.32),
            self.rng.uniform(-0.15, 0.15),
            lk.PUSH_HEIGHT,
        ], np.float32)
        objs = np.stack([
            np.array([
                self.rng.uniform(0.25, 0.45),
                self.rng.uniform(-0.18, 0.18),
                TABLE_Z + self.obj_half,
            ], np.float32)
            for _ in range(self.num_objects)
        ])
        K = self.num_objects
        eef_t = torch.tensor(eef, device=self.device)
        qpos = solve_qpos(eef_t, torch.zeros(5, device=self.device))
        return SimState(eef_t, qpos, torch.tensor(objs, device=self.device),
                        torch.tensor(1.0, device=self.device),
                        torch.zeros(K, device=self.device),
                        torch.zeros(K, 2, device=self.device))

    def reset(self):
        self.state = self._sample_state()
        self._t = 0
        self._background_img = None
        if self._norobot_ob or self._most_recent_bg:
            # the arm-free render is the exact background the reference
            # approximates by moving the robot out of frame
            # (clutter_push.py:225-233 _get_background_img)
            self._background_img = to_host(
                self._render_norobot_fn(self.state)[0])[0].copy()
        return self._get_obs()

    def _tip_pixel_mask(self, radius_m: float = 0.03):
        """Screen-space disc around the gripper tip (--inpaint_eef False:
        keep the eef visible while inpainting the arm)."""
        u, v, z = self.renderer._project(self.state.eef[None])
        u, v, z = (float(a) for a in to_host(u[0], v[0], z[0]))
        r = float(self.renderer._K[0, 0]) * radius_m / max(z, 1e-4)
        h, w = self._img_shape
        ys, xs = np.mgrid[0:h, 0:w]
        return ((ys + 0.5 - v) ** 2 + (xs + 0.5 - u) ** 2) <= r * r

    def _get_obs(self):
        """The observation as numpy: the scene render (one mask launch) and
        the state, copied to the host in one transfer."""
        s = self.state
        img_t, mask_t = self._render_fn(s)
        extra = [self._obj_hit_fn(s)] if self._mask_with_obj else []
        img, mask, eef, qpos, obj_pos, *hit = to_host(
            img_t, mask_t, s.eef, s.qpos, s.obj_pos, *extra)
        if self._mask_with_obj:
            # --robot_mask_with_obj: the mask covers the blocks too
            mask = np.maximum(mask, hit[0][..., None])
        if self._norobot_ob or self._force_norobot:
            # --norobot_pixels_ob: robot pixels replaced by background,
            # incrementally with most_recent_background
            # (clutter_push.py:580-593), else the exact robot-free scene
            seg = mask[..., 0] > 0.5
            if not self._inpaint_eef:
                seg &= ~self._tip_pixel_mask()
            if self._most_recent_bg and self._background_img is not None:
                self._background_img[~seg] = img[~seg]
                img = img.copy()
                img[seg] = self._background_img[seg]
            else:
                img_nr = to_host(self._render_norobot_fn(s)[0])[0]
                img = np.where(seg[..., None], img_nr, img)
        if not self._pixels_ob:
            # --pixels_ob False: a low-dim observation
            img = np.concatenate([eef, obj_pos.ravel()]).astype(np.float32)
        return {
            "observation": img,
            "masks": mask,
            "states": np.array([*eef, 0.0, 0.0], np.float32),
            "qpos": qpos,
            # privileged block poses for demo collection and runner stats
            "obj_poses": obj_pos,
        }

    def step(self, action):
        action = np.clip(np.asarray(action, np.float32), -1.0, 1.0)
        self._check_quasistatic(action)
        a = torch.tensor(action, device=self.device)
        for _ in range(self._action_repeat):
            self.state = self._step_fn(self.state, a)
        self._t += 1
        obs = self._get_obs()
        done = self._t >= self.max_episode_length
        return obs, 0.0, done, {"reward": 0.0}

    def _would_contact(self, action):
        """True when this command's end position overlaps a free block: the
        predicate under which `physics_step`'s projection contact moves a
        block (its probe at the full commanded step)."""
        a = np.clip(np.asarray(action, np.float32)[:3], -1.0, 1.0)
        if a.shape[0] < 3:
            a = np.pad(a, (0, 3 - a.shape[0]))
        eef, obj, att = to_host(self.state.eef, self.state.obj_pos,
                                self.state.attached)
        tip = np.clip(eef + a * ACTION_SCALE, WS_LOW, WS_HIGH)
        if tip[2] >= TABLE_Z + 2.5 * self.obj_half + 0.03:
            return False
        d = np.linalg.norm(obj[:, :2] - tip[None, :2], axis=-1)
        return bool(np.any((att < 0.5) & (d < CONTACT_RADIUS)))

    def envelope_action(self, action):
        """Demo-script guard: a commanded action slower than the
        quasi-static envelope that would engage a free block has its xy
        part scaled up to QUASISTATIC_MIN_PUSH (direction kept; moves
        without contact pass through)."""
        a = np.clip(np.asarray(action, np.float32), -1.0, 1.0).copy()
        a_xy = float(np.linalg.norm(a[:2]))
        if 1e-6 < a_xy < QUASISTATIC_MIN_PUSH and self._would_contact(a):
            # 2% over the threshold so that float32 rounding of the norm
            # cannot land the action back below the envelope
            a[:2] *= 1.02 * QUASISTATIC_MIN_PUSH / a_xy
            a = np.clip(a, -1.0, 1.0)
        return a

    def _check_quasistatic(self, action):
        """Warns once per env when a commanded push slower than
        QUASISTATIC_MIN_PUSH contacts a block: outside the fitted regime."""
        if getattr(self, "_warned_slow_push", False):
            return
        a_xy = float(np.linalg.norm(action[:2]))
        if not (1e-6 < a_xy < QUASISTATIC_MIN_PUSH):
            return
        if self._would_contact(action):
            warnings.warn(
                f"commanded contact push |a_xy|={a_xy:.2f} is below the "
                f"quasi-static validity envelope (>= "
                f"{QUASISTATIC_MIN_PUSH}): the analytic contact model is "
                "fitted for faster pushes (envs/base.py:QUASISTATIC_MIN_"
                "PUSH)", RuntimeWarning, stacklevel=3)
            self._warned_slow_push = True

    # --- rollout branching (reference: robot_env.py:202-217) -----------
    def get_flattened_state(self):
        s = self.state
        return np.concatenate(
            [a.ravel() for a in to_host(*s)]).astype(np.float32)

    def set_flattened_state(self, flat):
        flat = np.asarray(flat, np.float32)
        K = self.num_objects
        i = 0
        eef = flat[i:i + 3]; i += 3
        qpos = flat[i:i + 5]; i += 5
        obj = flat[i:i + 3 * K].reshape(K, 3); i += 3 * K
        grip = flat[i]; i += 1
        att = flat[i:i + K]; i += K
        # states serialized before obj_vel existed: at rest
        vel = (flat[i:i + 2 * K].reshape(K, 2) if len(flat) >= i + 2 * K
               else np.zeros((K, 2), np.float32))
        self.state = self._state(eef, qpos, obj, grip, att, vel)

    def render(self, mode="rgb_array"):
        return to_host(self._render_fn(self.state)[0])[0]

    def render_object_only(self):
        """Robot-less goal image (reference 'object_only_demo' images,
        src/mbrl/episode_runner.py:92-99)."""
        return to_host(self._render_norobot_fn(self.state)[0])[0]

    def get_robot_mask(self):
        return to_host(self._render_fn(self.state)[1])[0]

    def robot_kinematics(self, qpos):
        """FK and the mask of joints qpos (reference:
        clutter_push.py:96-117), stateless by construction."""
        q = torch.as_tensor(np.asarray(qpos, np.float32), device=self.device)
        eef = lk.eef_position(q)
        return tuple(to_host(eef, self.renderer.render(q)))
