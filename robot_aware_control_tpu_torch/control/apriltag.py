"""AprilTag-based camera-extrinsics calibration (pure numpy; a copy of
`robot_aware_control_tpu/control/apriltag.py`, with its tag36h11 codebook).

Reference parity: the real-robot setup detects one tag36h11 AprilTag
mounted on the arm, estimates its pose in the camera frame, reads the
tag's base-frame pose from FK at a known joint configuration, and
composes the camera-to-base extrinsics that the planner's mask renderer
uses (reference: locobot_rospkg/nodes/visual_MPC_controller.py:115-219
`get_camera_pose_from_apriltag` / `get_cam_calibration` /
`set_camera_calibration`, which wrap the pupil_apriltags Detector).

Here the pipeline is dependency-free and the detector is PLUGGABLE:

* `detect_tag(gray, ...)` — built-in numpy detector: dark-quad corner
  extraction (convex hull -> max-area quadrilateral), homography bit
  sampling, codebook match under 4 rotations. Good for the synthetic /
  lab-bench images the calibration step sees (one unoccluded tag);
  pass `detector=` (any pupil_apriltags-compatible object with
  `.detect(gray)` returning objects with `.corners`/`.tag_id`) to use
  a production detector on the real robot.
* `estimate_tag_pose(corners, K, tag_size)` — planar pose from the tag
  homography (IPPE-style decomposition + Gauss-Newton reprojection
  refinement), the 4-point case `data/camera_calib.py:solve_pnp`'s DLT
  cannot handle.
* `cam_to_base_from_tag(tag_T_base, R, t)` — the reference's exact
  transform composition incl. its fixed tag-frame flip
  (visual_MPC_controller.py:186-195).
* `calibrate_camera_from_tag(...)` — the full flow, registering the
  result in `data/calibration.py` so every mask render picks it up.

Tag family: tag36h11 layout (8x8-cell footprint = 1-cell black border
around a 6x6 data grid, MSB-first raster, bit 1 = white). The embedded
codebook carries the first entries of the public tag36h11 table — pass
`codebook=` with the full 587-entry table (or use an external detector)
for arbitrary tag ids.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from robot_aware_control_tpu_torch.data.camera_calib import (
    _project,
    _rodrigues,
    _rodrigues_inv,
)

# First entries of the public AprilTag tag36h11 code table (apriltag
# tag36h11.c). Enough for the single-tag calibration rig; extend via the
# `codebook` argument for other ids.
TAG36H11_CODES: Dict[int, int] = {
    0: 0xD5D628584,
    1: 0xD97F18B49,
    2: 0xDD280910E,
    3: 0xE479E9C98,
}

# Tag-frame corner coordinates (unit half-size), pupil_apriltags order:
# bottom-left, bottom-right, top-right, top-left, tag y UP, z out of the
# tag toward the viewer. The detected tag footprint (black border outer
# edge) spans [-1, 1]^2; `tag_size` is that footprint's metric edge.
_CORNERS_TAG = np.array(
    [[-1.0, -1.0, 0.0], [1.0, -1.0, 0.0], [1.0, 1.0, 0.0], [-1.0, 1.0, 0.0]]
)
GRID = 8  # cells across the footprint (border + 6x6 data)


def tag_bits(tag_id: int, codebook: Optional[Dict[int, int]] = None):
    """(6, 6) 0/1 data grid, row 0 = top of the canonical tag."""
    code = (codebook or TAG36H11_CODES)[tag_id]
    bits = [(code >> (35 - i)) & 1 for i in range(36)]
    return np.asarray(bits, np.uint8).reshape(6, 6)


def render_tag(tag_id: int, cam_T_tag: np.ndarray, K: np.ndarray,
               tag_size: float, shape: Tuple[int, int],
               codebook: Optional[Dict[int, int]] = None) -> np.ndarray:
    """Synthesize a grayscale view of the tag under a pinhole camera —
    the oracle for the detector tests (tests/test_apriltag.py and
    tests/test_torch_port_realrobot.py) and a stand-in for the RealSense
    frame of the reference's setup step.

    cam_T_tag: 4x4 tag-frame -> camera-frame. Returns float (H, W) in
    [0, 1] with a mid-gray background."""
    h, w = shape
    R, t = cam_T_tag[:3, :3], cam_T_tag[:3, 3]
    bits = tag_bits(tag_id, codebook)
    # inverse map: pixel -> ray -> tag plane (z=0 in tag frame),
    # 4x4-supersampled so edges antialias like a real sensor (the
    # subpixel corner refinement reads the geometric edge from the
    # intensity ramp)
    ss = 4
    sub = (np.arange(ss) + 0.5) / ss
    us, vs = np.meshgrid(
        (np.arange(w)[:, None] + sub[None]).ravel(),
        (np.arange(h)[:, None] + sub[None]).ravel(),
    )
    rays = np.stack([us.ravel(), vs.ravel(), np.ones(us.size)], 1)
    rays = rays @ np.linalg.inv(K).T
    # tag plane: points p = R x + t with x_z = 0 -> solve for plane hit
    Rin = R.T
    o_tag = -Rin @ t                       # camera center in tag frame
    d_tag = rays @ Rin.T                   # ray directions in tag frame
    s = -o_tag[2] / np.where(np.abs(d_tag[:, 2]) < 1e-12, 1e-12,
                             d_tag[:, 2])
    hit = o_tag[None] + s[:, None] * d_tag
    x, y = hit[:, 0], hit[:, 1]
    half = tag_size / 2.0
    # cell indices over the footprint; tag y up -> row index flips
    cx = np.floor((x / half + 1.0) * (GRID / 2.0)).astype(np.int64)
    cy = np.floor((1.0 - y / half) * (GRID / 2.0)).astype(np.int64)
    inside = (s > 0) & (cx >= 0) & (cx < GRID) & (cy >= 0) & (cy < GRID)
    border = inside & ((cx == 0) | (cx == GRID - 1) | (cy == 0)
                       | (cy == GRID - 1))
    data = inside & ~border
    img = np.full(us.size, 0.55, np.float64)  # quiet-zone background
    img[border] = 0.0
    dcx = np.clip(cx[data] - 1, 0, 5)
    dcy = np.clip(cy[data] - 1, 0, 5)
    img[data] = bits[dcy, dcx].astype(np.float64)
    # box-filter the supersamples back to the pixel grid
    img = img.reshape(h, ss, w, ss).mean(axis=(1, 3))
    return img


def _convex_hull(pts: np.ndarray) -> np.ndarray:
    """Andrew's monotone chain; pts (N, 2) float -> hull (H, 2) CCW."""
    pts = np.unique(pts, axis=0)
    if len(pts) <= 3:
        return pts
    pts = pts[np.lexsort((pts[:, 1], pts[:, 0]))]

    def half(seq):
        out = []
        for p in seq:
            while len(out) >= 2 and np.cross(out[-1] - out[-2],
                                             p - out[-2]) <= 0:
                out.pop()
            out.append(p)
        return out

    lower = half(pts)
    upper = half(pts[::-1])
    return np.asarray(lower[:-1] + upper[:-1])


def _quad_from_hull(hull: np.ndarray) -> np.ndarray:
    """The 4 hull vertices spanning the max-area quadrilateral (the
    projective image of the tag's square border is exactly a quad, so
    its corners are hull vertices)."""
    h = len(hull)
    if h <= 4:
        return hull
    if h > 24:  # keep the exhaustive search tiny: strongest 24 corners
        c = hull.mean(0)
        keep = np.argsort(-np.linalg.norm(hull - c, axis=1))[:24]
        hull = hull[np.sort(keep)]
        h = len(hull)
    best, quad = -1.0, hull[:4]
    from itertools import combinations

    for idx in combinations(range(h), 4):
        p = hull[list(idx)]
        a = 0.5 * abs(
            np.cross(p[1] - p[0], p[2] - p[0])
        ) + 0.5 * abs(np.cross(p[2] - p[0], p[3] - p[0]))
        if a > best:
            best, quad = a, p
    return quad


def _order_ccw_image(quad: np.ndarray) -> np.ndarray:
    """Order corners counter-clockwise in TAG orientation (image y is
    down, so clockwise in raster coords), starting anywhere."""
    c = quad.mean(0)
    ang = np.arctan2(quad[:, 1] - c[1], quad[:, 0] - c[0])
    return quad[np.argsort(ang)]  # y-down: ascending angle == CW visual


def _homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """DLT homography mapping src (N, 2) -> dst (N, 2), N >= 4."""
    A = []
    for (x, y), (u, v) in zip(src, dst):
        A.append([x, y, 1, 0, 0, 0, -u * x, -u * y, -u])
        A.append([0, 0, 0, x, y, 1, -v * x, -v * y, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    H = Vt[-1].reshape(3, 3)
    return H / H[2, 2]


def _bilinear(gray: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Sample gray at pixel coordinates (u, v); pixel (i, j)'s center is
    at (j + 0.5, i + 0.5)."""
    u = np.clip(np.asarray(u, np.float64) - 0.5, 0, gray.shape[1] - 1.001)
    v = np.clip(np.asarray(v, np.float64) - 0.5, 0, gray.shape[0] - 1.001)
    u0, v0 = np.floor(u).astype(int), np.floor(v).astype(int)
    fu, fv = u - u0, v - v0
    u1 = np.minimum(u0 + 1, gray.shape[1] - 1)
    v1 = np.minimum(v0 + 1, gray.shape[0] - 1)
    return (gray[v0, u0] * (1 - fu) * (1 - fv)
            + gray[v0, u1] * fu * (1 - fv)
            + gray[v1, u0] * (1 - fu) * fv
            + gray[v1, u1] * fu * fv)


def _sample_bits(gray: np.ndarray, H_tag2img: np.ndarray,
                 thresh: float) -> np.ndarray:
    """Read the 6x6 data grid through the tag->image homography."""
    ij = np.arange(6) + 1.5  # data cell centers in footprint cells
    gx = ij / (GRID / 2.0) - 1.0           # tag x of column centers
    gy = 1.0 - ij / (GRID / 2.0)           # tag y of row centers (row 0 top)
    X, Y = np.meshgrid(gx, gy)
    p = np.stack([X.ravel(), Y.ravel(), np.ones(36)], 1) @ H_tag2img.T
    uv = p[:, :2] / p[:, 2:3]
    g = _bilinear(gray, uv[:, 0], uv[:, 1])
    return (g > thresh).astype(np.uint8).reshape(6, 6)


def _refine_quad(gray: np.ndarray, quad: np.ndarray,
                 thresh: float) -> np.ndarray:
    """Subpixel corner refinement: the hull of dark PIXEL CENTERS sits
    ~half a pixel inside the true black-border edge, which biases the
    pose scale. For each quad edge, locate the subpixel threshold
    crossing along the outward normal at 16 stations, least-squares fit
    the border line, and intersect adjacent lines."""
    c = quad.mean(0)
    lines = []
    for i in range(4):
        a, b = quad[i], quad[(i + 1) % 4]
        d = b - a
        n = np.array([d[1], -d[0]])
        n = n / (np.linalg.norm(n) + 1e-12)
        if np.dot(n, a - c) < 0:
            n = -n
        ts = np.linspace(0.15, 0.85, 16)
        pts = []
        offs = np.linspace(-2.0, 2.0, 41)
        for t in ts:
            p0 = a + t * d
            vals = _bilinear(gray, p0[0] + offs * n[0], p0[1] + offs * n[1])
            # geometric edge = midpoint of the LOCAL intensity ramp
            # (border black -> whatever surrounds the tag), not the
            # global bit threshold
            mid = 0.5 * (vals.min() + vals.max())
            above = vals > mid
            idx = np.nonzero(above[1:] & ~above[:-1])[0]
            if len(idx) == 0:
                continue
            k = idx[0]
            f = (mid - vals[k]) / (vals[k + 1] - vals[k] + 1e-12)
            o = offs[k] + f * (offs[k + 1] - offs[k])
            pts.append(p0 + o * n)
        if len(pts) < 4:
            return quad  # degenerate view: keep the hull corners
        P = np.asarray(pts)
        # line through P: point m + direction e (principal axis)
        m = P.mean(0)
        _, _, Vt = np.linalg.svd(P - m)
        lines.append((m, Vt[0]))
    out = []
    for i in range(4):
        m1, e1 = lines[(i - 1) % 4]
        m2, e2 = lines[i]
        A = np.stack([e1, -e2], 1)
        try:
            s = np.linalg.solve(A, m2 - m1)
        except np.linalg.LinAlgError:  # pragma: no cover
            return quad
        out.append(m1 + s[0] * e1)
    return np.asarray(out)


class TagDetection:
    """Matches the pupil_apriltags result surface the reference consumes
    (visual_MPC_controller.py:144-149): tag_id, corners (4, 2) px in
    canonical order (BL, BR, TR, TL of the upright tag), and — when
    intrinsics were given — pose_R/pose_t (tag frame -> camera frame)."""

    def __init__(self, tag_id, corners, pose_R=None, pose_t=None):
        self.tag_id = int(tag_id)
        self.corners = np.asarray(corners, np.float64)
        self.pose_R = pose_R
        self.pose_t = pose_t


def detect_tag(gray: np.ndarray,
               K: Optional[np.ndarray] = None,
               tag_size: Optional[float] = None,
               codebook: Optional[Dict[int, int]] = None,
               detector=None) -> Optional[TagDetection]:
    """Detect one AprilTag. `detector` plugs in a production detector
    (pupil_apriltags-compatible); the built-in path handles the
    unoccluded single-tag frames of the calibration procedure."""
    gray = np.asarray(gray, np.float64)
    if gray.ndim == 3:
        gray = gray.mean(-1)
    if detector is not None:  # production detector (reference default)
        res = detector.detect(gray)
        if not res:
            return None
        r = res[0]
        det = TagDetection(r.tag_id, np.asarray(r.corners))
    else:
        thresh = 0.5 * (gray.min() + gray.max())
        ys, xs = np.nonzero(gray < thresh)
        if len(xs) < 16:
            return None
        # border of the dark blob only (cheap hull input)
        pts = np.stack([xs, ys], 1).astype(np.float64) + 0.5
        hull = _convex_hull(pts)
        quad = _order_ccw_image(_quad_from_hull(hull))
        quad = _refine_quad(gray, quad, thresh)
        # identify orientation + id by decoding under 4 corner rolls
        code_b = codebook or TAG36H11_CODES
        det = None
        for roll in range(4):
            c = np.roll(quad, roll, axis=0)
            Ht = _homography(_CORNERS_TAG[:, :2], c)
            bits = _sample_bits(gray, Ht, thresh)
            code = 0
            for b in bits.ravel():
                code = (code << 1) | int(b)
            for tid, ref in code_b.items():
                if code == ref:
                    det = TagDetection(tid, c)
                    break
            if det is not None:
                break
        if det is None:
            return None
    if K is not None and tag_size is not None:
        R, t = estimate_tag_pose(det.corners, K, tag_size)
        det.pose_R, det.pose_t = R, t
    return det


def estimate_tag_pose(corners_px: np.ndarray, K: np.ndarray,
                      tag_size: float) -> Tuple[np.ndarray, np.ndarray]:
    """Planar pose (R, t): tag frame -> camera frame, from the 4 corner
    pixels. Homography decomposition H ~ K [r1 r2 t] + Gauss-Newton on
    reprojection (4 coplanar points — below solve_pnp's DLT minimum)."""
    obj = _CORNERS_TAG * (tag_size / 2.0)
    H = _homography(obj[:, :2], np.asarray(corners_px, np.float64))
    M = np.linalg.inv(K) @ H
    s = 0.5 * (np.linalg.norm(M[:, 0]) + np.linalg.norm(M[:, 1]))
    M = M / s
    if M[2, 2] < 0:  # tag must sit in front of the camera
        M = -M
    r1, r2, t = M[:, 0], M[:, 1], M[:, 2]
    R = np.stack([r1, r2, np.cross(r1, r2)], 1)
    U, _, Vt = np.linalg.svd(R)
    R = U @ Vt
    if np.linalg.det(R) < 0:
        R = U @ np.diag([1.0, 1.0, -1.0]) @ Vt
    # Gauss-Newton reprojection refinement (camera_calib.py machinery)
    x = np.concatenate([_rodrigues_inv(R), t])
    p2 = np.asarray(corners_px, np.float64)
    for _ in range(50):
        R = _rodrigues(x[:3])
        r = (_project(K, R, x[3:], obj) - p2).ravel()
        J = []
        eps = 1e-7
        for k in range(6):
            xp = x.copy()
            xp[k] += eps
            rp = (_project(K, _rodrigues(xp[:3]), xp[3:], obj) - p2).ravel()
            J.append((rp - r) / eps)
        J = np.stack(J, 1)
        try:
            dx = np.linalg.lstsq(J, -r, rcond=None)[0]
        except np.linalg.LinAlgError:  # pragma: no cover
            break
        x = x + dx
        if np.linalg.norm(dx) < 1e-12:
            break
    return _rodrigues(x[:3]), x[3:]


# The reference's fixed tag-frame flip between the tag pose the detector
# reports and the tag frame its MJCF models (visual_MPC_controller.py:
# 188-193 "For explanation, refer to Kun's hand drawing").
TAGC_T_TAGW = np.array(
    [[0.0, 0.0, -1.0, 0.0],
     [0.0, -1.0, 0.0, 0.0],
     [-1.0, 0.0, 0.0, 0.0],
     [0.0, 0.0, 0.0, 1.0]]
)


def cam_to_base_from_tag(tag_T_base: np.ndarray, pose_R: np.ndarray,
                         pose_t: np.ndarray,
                         tag_flip: Optional[np.ndarray] = None
                         ) -> np.ndarray:
    """camTbase = tagTbase @ flip @ inv(tagTcam)
    (visual_MPC_controller.py:176-196). `tag_T_base` comes from FK at
    the calibration joint pose (the reference reads the `ar_tag_geom`
    body pose from its MuJoCo model); pose_R/pose_t from detect_tag.
    `tag_flip` defaults to identity — the reference's TAGC_T_TAGW flip
    encodes ITS physical tag mounting; pass it explicitly when
    reproducing that rig."""
    tagTcam = np.eye(4)
    tagTcam[:3, :3] = np.asarray(pose_R)
    tagTcam[:3, 3] = np.asarray(pose_t).ravel()
    flip = np.eye(4) if tag_flip is None else tag_flip
    return np.asarray(tag_T_base) @ flip @ np.linalg.inv(tagTcam)


def calibrate_camera_from_tag(camera_key: str, gray: np.ndarray,
                              tag_T_base: np.ndarray, K: np.ndarray,
                              tag_size: float,
                              offset=(0.0, 0.0, 0.0),
                              codebook: Optional[Dict[int, int]] = None,
                              detector=None) -> Optional[np.ndarray]:
    """Full reference setup flow (get_cam_calibration +
    set_camera_calibration, visual_MPC_controller.py:152-219): detect
    the tag, compose camera-to-base, apply the measured position offset
    (the reference applies [0, -0.015, 0.0125]), and register under
    `camera_key` so mask renders and planners pick it up
    (data/calibration.py:register_camera). Returns the 4x4 extrinsics
    or None when no tag is found."""
    det = detect_tag(gray, K=K, tag_size=tag_size, codebook=codebook,
                     detector=detector)
    if det is None or det.pose_R is None:
        return None
    cam_T_base = cam_to_base_from_tag(tag_T_base, det.pose_R, det.pose_t)
    cam_T_base = cam_T_base.copy()
    cam_T_base[:3, 3] += np.asarray(offset, np.float64)

    from robot_aware_control_tpu_torch.data import calibration

    calibration.register_camera(camera_key, cam_T_base)
    return cam_T_base
