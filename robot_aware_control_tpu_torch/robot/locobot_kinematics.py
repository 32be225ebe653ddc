"""Locobot closed-form kinematics on tensors (batched, branchless).

Counterpart of `robot_aware_control_tpu/robot/locobot_kinematics.py`
(reference: src/env/robotics/masks/locobot_analytical_ik.py:28-196): the
same geometry and solution-selection rules, with a Python loop over the
horizon in place of `lax.scan`.
"""

from __future__ import annotations

import math

import torch

BASE_OFFSET = (0.0973, 0.0, 0.097363)
L1 = 0.0655 + 0.04125
L2 = math.sqrt(0.05 ** 2 + 0.2 ** 2)
ANGLE2_BIAS = math.atan2(0.05, 0.2)
L3 = 0.2002
L3_MODIFIED = 0.3002  # longer forearm variant (reference: :271-274)
L4 = 0.063

JOINT_LIMIT = math.pi

# eef conventions for planar pushing (reference:
# src/dataset/locobot/locobot_model.py:15-17)
PUSH_HEIGHT = 0.15
DEFAULT_PITCH = 1.3
DEFAULT_ROLL = 0.0


def _base_offset(like):
    return torch.tensor(BASE_OFFSET, dtype=like.dtype, device=like.device)


def ik(eef_pos, alpha, cur_config, l3: float = L3):
    """Batched IK. eef_pos (..., 3) world target, alpha scalar or (...,),
    cur_config (..., 4) current joint angles for nearest-solution selection.

    Returns (theta (..., 4), valid (...,) bool)."""
    p = eef_pos - _base_offset(eef_pos)
    x, y, z = p[..., 0], p[..., 1], p[..., 2]
    theta0 = torch.atan2(y, x)

    X = torch.sqrt(x * x + y * y)
    Y = z
    alpha = torch.as_tensor(alpha, dtype=X.dtype, device=X.device).expand(X.shape)
    p3x = X - L4 * torch.cos(alpha)
    p3y = Y - L4 * torch.sin(alpha)

    # circles: (0, L1, L2) and (p3, l3) — intersection in the arm plane
    dx, dy = p3x, p3y - L1
    d2 = dx * dx + dy * dy
    d = torch.sqrt(torch.clamp(d2, min=1e-12))
    geom_ok = (d <= (L2 + l3)) & (d >= abs(L2 - l3)) & (d > 1e-9)

    a = (L2 * L2 - l3 * l3 + d2) / (2.0 * d)
    h = torch.sqrt(torch.clamp(L2 * L2 - a * a, min=0.0))
    xm = a * dx / d
    ym = L1 + a * dy / d
    # two elbow candidates
    ex = torch.stack([xm + h * dy / d, xm - h * dy / d], -1)
    ey = torch.stack([ym - h * dx / d, ym + h * dx / d], -1)

    ang1 = torch.atan2(ex, ey - L1) - ANGLE2_BIAS
    ang2 = -torch.atan2(p3y[..., None] - ey, p3x[..., None] - ex) - ang1
    ang3 = -alpha[..., None] - ang1 - ang2

    in_lim = lambda t: torch.abs(t) < JOINT_LIMIT
    valid = in_lim(ang1) & in_lim(ang2) & in_lim(ang3) & geom_ok[..., None]

    cur = cur_config
    diff = (torch.abs(ang1 - cur[..., 1:2]) + torch.abs(ang2 - cur[..., 2:3])
            + torch.abs(ang3 - cur[..., 3:4]))
    # invalid candidates get +inf distance so argmin picks a valid one
    score = torch.where(valid, diff, torch.full_like(diff, math.inf))
    pick = torch.argmin(score, dim=-1, keepdim=True)
    take = lambda c: torch.gather(c, -1, pick)[..., 0]
    theta = torch.stack([theta0, take(ang1), take(ang2), take(ang3)], -1)
    any_valid = valid.any(-1)
    theta = torch.where(any_valid[..., None], theta, cur[..., :4])
    return theta, any_valid


def fk_points(qpos, l3: float = L3):
    """Forward kinematics to the arm's joint positions.

    qpos (..., >=4): [yaw, shoulder, elbow, wrist]. Returns (..., 5, 3)
    world points: arm base, shoulder top, elbow, wrist, gripper tip."""
    t0, t1, t2, t3 = qpos[..., 0], qpos[..., 1], qpos[..., 2], qpos[..., 3]
    zero = torch.zeros_like(t1)
    ex = zero + L2 * torch.sin(t1 + ANGLE2_BIAS)
    ey = L1 + L2 * torch.cos(t1 + ANGLE2_BIAS)
    phi3 = -(t1 + t2)
    wx = ex + l3 * torch.cos(phi3)
    wy = ey + l3 * torch.sin(phi3)
    phi4 = -(t1 + t2 + t3)
    gx = wx + L4 * torch.cos(phi4)
    gy = wy + L4 * torch.sin(phi4)

    X = torch.stack([zero, zero, ex, wx, gx], -1)  # radial
    Ypts = torch.stack([zero, torch.full_like(t1, L1), ey, wy, gy], -1)  # height
    c0, s0 = torch.cos(t0)[..., None], torch.sin(t0)[..., None]
    pts = torch.stack([X * c0, X * s0, Ypts], -1)  # (..., 5, 3)
    return pts + _base_offset(pts)


def integrate_planar_actions(start_eef, start_qpos, actions,
                             push_height: float = PUSH_HEIGHT,
                             pitch: float = DEFAULT_PITCH,
                             roll: float = DEFAULT_ROLL,
                             l3: float = L3):
    """Roll a planar action sequence through eef integration + IK
    (reference: src/dataset/locobot/locobot_model.py:50-102).

    start_eef (..., >=2) raw world xy(z); start_qpos (..., 5);
    actions (T, ..., >=2) planar displacements.

    Returns (states (T+1, ..., 5), qpos (T+1, ..., 5)) where states rows are
    [x, y, z, 0, 0] raw world eef poses."""
    z0 = (start_eef[..., 2] if start_eef.shape[-1] > 2
          else torch.full_like(start_eef[..., 0], push_height))
    eef = torch.stack([start_eef[..., 0], start_eef[..., 1], z0], -1)
    q = start_qpos
    eefs, qs = [eef], [q]
    for act in actions:
        eef = torch.stack([eef[..., 0] + act[..., 0], eef[..., 1] + act[..., 1],
                           torch.full_like(eef[..., 0], push_height)], -1)
        theta, _ = ik(eef, -pitch, q[..., :4], l3)
        q = torch.cat([theta, torch.full_like(theta[..., :1], roll)], -1)
        eefs.append(eef)
        qs.append(q)
    eefs = torch.stack(eefs)
    pad = torch.zeros(eefs.shape[:-1] + (2,), dtype=eefs.dtype,
                      device=eefs.device)
    return torch.cat([eefs, pad], -1), torch.stack(qs)
