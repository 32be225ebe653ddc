"""Segments (M, S, 6) [au, av, bu, bv, ra, rb] for the port's capsule-mask
kernel, each case made from a seed with numpy.

tests/test_torch_port_gpu.py holds the CUDA kernel to its plain version on
these cases, tests/test_torch_port_kernels.py holds the kernel's skip rule to
the JAX package on them, and chip_smoke.py runs them in its masks phase.
Imports neither JAX nor the JAX package.
"""

import numpy as np
import torch

from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer


def scattered(rng, M, S, h, w):
    """Capsules over and around an h x w image."""
    size = np.array([w, h], np.float64)
    a = rng.uniform(-0.15, 1.15, (M, S, 2)) * size
    b = a + rng.randn(M, S, 2) * 0.25 * size
    r = rng.uniform(0.05, 0.15, (M, S, 2)) * size.max()
    return np.concatenate([a, b, r], -1)


def _off_image(rng):
    """Capsules parallel to an image edge, 0.05-2 px beyond the reach of
    the outermost pixel centres, and one far away: every pixel misses."""
    M, S, h, w = 16, 8, 48, 64
    r = rng.uniform(0.0, 6.0, (M, S))
    off = r + rng.uniform(0.05, 2.0, (M, S))
    side = rng.randint(4, size=(M, S))  # beyond the left, right, top, bottom
    fixed = np.choose(side, [0.5 - off, w - 0.5 + off, 0.5 - off,
                             h - 0.5 + off])
    along = rng.uniform(-20.0, 84.0, (M, S, 2))
    vertical = side < 2  # u fixed
    segs = np.empty((M, S, 6))
    segs[..., 0] = np.where(vertical, fixed, along[..., 0])
    segs[..., 2] = np.where(vertical, fixed, along[..., 1])
    segs[..., 1] = np.where(vertical, along[..., 0], fixed)
    segs[..., 3] = np.where(vertical, along[..., 1], fixed)
    segs[..., 4] = segs[..., 5] = r
    segs[:, -1] = [-500.0, 800.0, -480.0, 790.0, 9.0, 3.0]
    return segs, h, w


def _degenerate(rng):
    """a = b, some on pixel centres, some on pixel corners, radii from 0."""
    c = rng.uniform(-5.0, 69.0, (16, 8, 2))
    c[::2] = np.floor(c[::2]) + 0.5
    c[1::4] = np.round(c[1::4])
    r = rng.uniform(0.0, 6.0, (16, 8, 1))
    r[:, ::3] = 0.0
    return np.concatenate([c, c, r, r], -1), 48, 64


def _radii(rng):
    """Zero, negative and mixed-sign radii, and radii whose square
    underflows."""
    segs = scattered(rng, 16, 8, 48, 64)
    segs[:, 0, 4:] = 0.0
    segs[:, 1, 4] *= -1.0
    segs[:, 2, 4:] *= -1.0
    segs[:, 3, 5] = -segs[:, 3, 4]
    segs[:, 4, 4] = 0.0
    segs[:, 5, 4:] = [1e-30, -1e-30]
    return segs, 48, 64


def _whole_image(rng):
    """One capsule of each mask covers every pixel."""
    segs = scattered(rng, 8, 8, 48, 64)
    segs[:, 3] = [20.0, 24.0, 44.0, 24.0, 45.0, 45.0]
    return segs, 48, 64


def _far(rng):
    """Coordinates near +-1e6: long capsules across the image, huge radii
    whose edge runs through it, and a far capsule."""
    one = np.ones(8)
    y, x = rng.uniform(-5.0, 53.0, (2, 8)), rng.uniform(-5.0, 69.0, (2, 8))
    r = rng.uniform(1.0, 5.0, (6, 8))
    corner = np.hypot(1e6 - 30.0, 1e6 - 20.0) + rng.uniform(-5.0, 5.0, 8)
    reach = 1e6 - rng.uniform(10.0, 50.0, 8)
    caps = [
        [-1e6 * one, y[0], 1e6 * one, y[1], r[0], r[1]],
        [x[0], -1e6 * one, x[1], 1e6 * one, r[2], r[3]],
        [1e6 * one, 1e6 * one, (1e6 + 0.5) * one, 1e6 * one, corner, corner],
        [1e6 * one, 24.0 * one, (1e6 + 5.0) * one, 24.0 * one, reach,
         reach + 3.0],
        [-1e6 + x[0], -1e6 + y[0], -1e6 + x[1], 1e6 + y[1], r[4], r[5]],
    ]
    return np.stack([np.stack(c, -1) for c in caps], 1), 48, 64


def _box_edge():
    """Two masks of four capsules (a = b, radius near 2) whose boxes, as
    the kernel computes them, end exactly on the outer pixel centre of a
    tile (mask 0) or one float32 step short of it (mask 1). Capsule s
    touches tile BOX_EDGE_TILES[s] (tile row, tile column)."""
    # (box edge: 0 lo_u, 1 hi_u, 2 lo_v, 3 hi_v; the centre it ends on;
    # the axis of the edge; the other coordinate)
    edges = [(0, 7.5, 0, 24.0), (1, 8.5, 0, 24.0),
             (2, 15.5, 1, 20.0), (3, 16.5, 1, 20.0)]
    # the radius runs over the float32 values around 2
    steps = np.arange(-2 ** 16, 2 ** 16 + 1, dtype=np.int32)
    radius = (np.array([2.0], np.float32).view(np.int32) + steps).view(
        np.float32)
    segs = np.zeros((2, 4, 6), np.float32)
    for s, (e, target, axis, other) in enumerate(edges):
        side = 1.0 if e % 2 == 0 else -1.0  # a low edge: the capsule above
        cand = np.full((radius.size, 6), other, np.float32)
        cand[:, axis] = cand[:, axis + 2] = target + side * 3.0
        cand[:, 4] = cand[:, 5] = radius
        box = kernels.capsule_mask_boxes(torch.from_numpy(cand)[:, None])
        box = box[:, 0, e].numpy()
        short = np.nextafter(np.float32(target), np.float32(side * np.inf))
        for m, want in enumerate((np.float32(target), short)):
            segs[m, s] = cand[np.flatnonzero(box == want)[0]]
    return segs, 48, 64


BOX_EDGE_TILES = [(1, 0), (1, 1), (0, 2), (1, 2)]


def _nonfinite(rng):
    """NaN and infinite parameters, and magnitudes past the skip rule's
    limit (1e19 with a radius that covers the image)."""
    segs = scattered(rng, 8, 8, 48, 64)
    segs[0, 0, 0] = np.nan
    segs[1, 1, 4] = np.inf
    segs[2, 2, 2] = np.inf
    segs[3, 3, 5] = -np.inf
    segs[4, 4, 1] = np.nan
    segs[5, 5] = [1e19, 1e19, 1e19, 1e19, 2e19, 2e19]
    return segs, 48, 64


PLANNER_POSES = np.random.RandomState(500).uniform(-0.5, 0.5, (500, 5))
# a launch of four requests planned together: 4 x 500 masks
SERVED_POSES = np.random.RandomState(2000).uniform(-0.5, 0.5, (2000, 5))


def _planner(poses):
    """Thick-mask segments of random arm poses, as the planner renders
    them (the 500 poses are those of chip_smoke.py's mask timing)."""
    r = CapsuleMaskRenderer((48, 64), thick=True, device="cpu")
    return r.segment_params(torch.tensor(poses, dtype=torch.float32)
                            ).numpy(), 48, 64


MASK_CASES = {
    "planner_500": lambda rng: _planner(PLANNER_POSES),
    "m1": lambda rng: (scattered(rng, 1, 8, 48, 64), 48, 64),
    "m37": lambda rng: (scattered(rng, 37, 8, 48, 64), 48, 64),
    "s1": lambda rng: (scattered(rng, 37, 1, 48, 64), 48, 64),
    "s13": lambda rng: (scattered(rng, 37, 13, 48, 64), 48, 64),
    "48x62": lambda rng: (scattered(rng, 37, 8, 48, 62), 48, 62),
    "5x7": lambda rng: (scattered(rng, 37, 8, 5, 7), 5, 7),
    "off_image": _off_image,
    "degenerate": _degenerate,
    "radii": _radii,
    "whole_image": _whole_image,
    "far": _far,
    "box_edge": lambda rng: _box_edge(),
    "nonfinite": _nonfinite,
    "empty": lambda rng: (np.zeros((0, 8, 6)), 48, 64),
    "served_2000": lambda rng: _planner(SERVED_POSES),
}


def mask_case(name: str, device):
    """(segs float32 on `device`, h, w) of a case of MASK_CASES."""
    seed = list(MASK_CASES).index(name)
    segs, h, w = MASK_CASES[name](np.random.RandomState(seed))
    return torch.tensor(np.asarray(segs, np.float32), device=device), h, w
