"""Camera calibration from 2D-3D correspondences (a numpy copy of
`robot_aware_control_tpu/data/camera_calib.py`).

Reference parity: the camera-calibration tools (reference:
robonet/camera_calib/robonet_calibration.py, robot_viewpoint_calib.py,
annotation_gui.py): annotate the end-effector pixel position in frames with
known world eef positions, then solve the camera pose. The click-GUI is
host-tooling out of scope here; the solver is a dependency-free DLT +
Gauss-Newton PnP (the reference uses OpenCV solvePnP).

AprilTag-based online calibration on the real robot (reference:
locobot_rospkg/nodes/visual_MPC_controller.py:109-219) reduces to the same
`solve_pnp` on the tag corners; register the result via
`calibration.register_camera`.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from robot_aware_control_tpu_torch.data import calibration


def _rodrigues(rvec):
    th = np.linalg.norm(rvec)
    if th < 1e-12:
        return np.eye(3)
    k = rvec / th
    K = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _rodrigues_inv(R):
    th = np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1))
    if th < 1e-12:
        return np.zeros(3)
    return th / (2 * np.sin(th)) * np.array(
        [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]]
    )


def _project(K, R, t, pts3d):
    cam = pts3d @ R.T + t
    z = np.maximum(cam[:, 2:3], 1e-9)
    uv = cam[:, :2] / z
    return uv @ K[:2, :2].T + K[:2, 2]


def solve_pnp(points3d, points2d, K, iters: int = 100) -> Tuple[np.ndarray, float]:
    """DLT initialization + Gauss-Newton refinement of reprojection error.

    Returns (world_to_camera 4x4, rms reprojection error in pixels)."""
    p3 = np.asarray(points3d, np.float64)
    p2 = np.asarray(points2d, np.float64)
    assert len(p3) >= 6, "need >= 6 correspondences for DLT"
    # normalized image coords
    xn = (p2 - K[:2, 2]) @ np.linalg.inv(K[:2, :2]).T
    # DLT for P = [R|t]: x ~ P X
    A = []
    for (X, Y, Z), (u, v) in zip(p3, xn):
        A.append([X, Y, Z, 1, 0, 0, 0, 0, -u * X, -u * Y, -u * Z, -u])
        A.append([0, 0, 0, 0, X, Y, Z, 1, -v * X, -v * Y, -v * Z, -v])
    _, _, Vt = np.linalg.svd(np.asarray(A))
    P = Vt[-1].reshape(3, 4)
    # enforce rotation via SVD; fix scale/sign
    U, S, Vt2 = np.linalg.svd(P[:, :3])
    scale = S.mean()
    R = U @ Vt2
    if np.linalg.det(R) < 0:
        R, scale = -R, -scale
    t = P[:, 3] / scale
    if np.mean((p3 @ R.T + t)[:, 2]) < 0:  # points must be in front
        R = _rodrigues(_rodrigues_inv(R))  # keep rotation, flip translation
        t = -t

    rvec = _rodrigues_inv(R)
    x = np.concatenate([rvec, t])
    for _ in range(iters):
        R = _rodrigues(x[:3])
        resid = (_project(K, R, x[3:], p3) - p2).ravel()
        # numeric Jacobian (6 params, cheap at calibration scale)
        J = np.zeros((len(resid), 6))
        eps = 1e-6
        for j in range(6):
            xp = x.copy()
            xp[j] += eps
            Rp = _rodrigues(xp[:3])
            rp = (_project(K, Rp, xp[3:], p3) - p2).ravel()
            J[:, j] = (rp - resid) / eps
        try:
            dx = np.linalg.lstsq(J, -resid, rcond=None)[0]
        except np.linalg.LinAlgError:
            break
        x = x + dx
        if np.linalg.norm(dx) < 1e-10:
            break
    R = _rodrigues(x[:3])
    t = x[3:]
    w2c = np.eye(4)
    w2c[:3, :3] = R
    w2c[:3, 3] = t
    rms = float(np.sqrt(np.mean((_project(K, R, t, p3) - p2) ** 2)))
    return w2c, rms


def calibrate_viewpoint(key: str, eef_world, eef_pixels, cam_name: str
                        ) -> Tuple[np.ndarray, float]:
    """Solve + register a viewpoint from annotated eef positions
    (reference: robonet_calibration.py workflow)."""
    K = calibration.CAM_INTRINSICS[cam_name]
    w2c, rms = solve_pnp(eef_world, eef_pixels, K)
    calibration.register_camera(key, np.linalg.inv(w2c))
    return w2c, rms
