"""Rotation conversions (euler <-> quat <-> mat) on batched tensors.

Counterpart of `robot_aware_control_tpu/utils/rotations.py` (reference:
src/env/robotics/rotations.py and the quaternion utilities of
src/env/robotics/controllers/transform_utils). Conventions match MuJoCo:
wxyz quaternions, extrinsic XYZ euler angles.
"""

from __future__ import annotations

import torch


def euler2mat(euler):
    """(..., 3) extrinsic XYZ euler -> (..., 3, 3)."""
    ai, aj, ak = euler[..., 0], euler[..., 1], euler[..., 2]
    si, ci = torch.sin(ai), torch.cos(ai)
    sj, cj = torch.sin(aj), torch.cos(aj)
    sk, ck = torch.sin(ak), torch.cos(ak)
    # R = Rz(ak) @ Ry(aj) @ Rx(ai)
    r00 = cj * ck
    r01 = si * sj * ck - ci * sk
    r02 = ci * sj * ck + si * sk
    r10 = cj * sk
    r11 = si * sj * sk + ci * ck
    r12 = ci * sj * sk - si * ck
    r20 = -sj
    r21 = si * cj
    r22 = ci * cj
    return torch.stack([
        torch.stack([r00, r01, r02], -1),
        torch.stack([r10, r11, r12], -1),
        torch.stack([r20, r21, r22], -1),
    ], -2)


def mat2euler(mat):
    """(..., 3, 3) -> (..., 3) extrinsic XYZ euler."""
    sy = torch.sqrt(mat[..., 0, 0] ** 2 + mat[..., 1, 0] ** 2)
    singular = sy < 1e-6
    ai = torch.where(singular,
                   torch.atan2(-mat[..., 1, 2], mat[..., 1, 1]),
                   torch.atan2(mat[..., 2, 1], mat[..., 2, 2]))
    aj = torch.atan2(-mat[..., 2, 0], sy)
    ak = torch.where(singular, 0.0, torch.atan2(mat[..., 1, 0], mat[..., 0, 0]))
    return torch.stack([ai, aj, ak], -1)


def euler2quat(euler):
    return mat2quat(euler2mat(euler))


def quat2euler(quat):
    return mat2euler(quat2mat(quat))


def quat2mat(quat):
    """(..., 4) wxyz -> (..., 3, 3)."""
    q = quat / torch.linalg.vector_norm(quat, dim=-1, keepdim=True)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                   2 * (x * z + w * y)], -1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                   2 * (y * z - w * x)], -1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                   1 - 2 * (x * x + y * y)], -1),
    ], -2)


def mat2quat(mat):
    """(..., 3, 3) -> (..., 4) wxyz (stable branchless Shepperd)."""
    m = mat
    t = m[..., 0, 0] + m[..., 1, 1] + m[..., 2, 2]
    w = torch.sqrt(torch.clamp(1 + t, 1e-12)) / 2
    x = torch.sqrt(torch.clamp(1 + m[..., 0, 0] - m[..., 1, 1] - m[..., 2, 2],
                             min=1e-12)) / 2
    y = torch.sqrt(torch.clamp(1 - m[..., 0, 0] + m[..., 1, 1] - m[..., 2, 2],
                             min=1e-12)) / 2
    z = torch.sqrt(torch.clamp(1 - m[..., 0, 0] - m[..., 1, 1] + m[..., 2, 2],
                             min=1e-12)) / 2
    x = x * torch.sign(m[..., 2, 1] - m[..., 1, 2])
    y = y * torch.sign(m[..., 0, 2] - m[..., 2, 0])
    z = z * torch.sign(m[..., 1, 0] - m[..., 0, 1])
    q = torch.stack([w, x, y, z], -1)
    return q / torch.linalg.vector_norm(q, dim=-1, keepdim=True)


def quat_mul(q1, q2):
    """(..., 4) wxyz Hamilton product."""
    w1, x1, y1, z1 = q1[..., 0], q1[..., 1], q1[..., 2], q1[..., 3]
    w2, x2, y2, z2 = q2[..., 0], q2[..., 1], q2[..., 2], q2[..., 3]
    return torch.stack([
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
    ], -1)


def quat_conjugate(q):
    return q * torch.tensor([1.0, -1.0, -1.0, -1.0], dtype=q.dtype,
                            device=q.device)


def quat_rotate(q, v):
    """Rotate vectors v (..., 3) by quaternions q (..., 4)."""
    qv = torch.cat([torch.zeros_like(v[..., :1]), v], -1)
    return quat_mul(quat_mul(q, qv), quat_conjugate(q))[..., 1:]
