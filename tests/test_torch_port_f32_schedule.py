"""The schedule of the float32 ConvLSTM cell, walked on the CPU.

`robot_aware_control_tpu_torch/csrc/conv_lstm_cell_f32_geom.h` holds the
kernel's geometry (`Geom`, `make_geom`, `choose_shape`): its tile shapes,
the launch's tiles in the order blocks take them, the k-steps each tile
walks (its row's in-map row taps) and the choice of tile shape per launch.
It includes no CUDA header, so g++ compiles it with -D__host__=
-D__device__= into `tests/f32_schedule_walk.cpp`, which checks every tile
shape of one launch (see that file) and, with `emulate`, sums a small
convolution in the kernel's float32 chain order against the replaced
kernel's order (bit for bit) and a naive float64 one. g++ is looked up in
a fixture; the tests skip without it.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robot_aware_control_tpu_torch",
                    "csrc")


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    exe = str(tmp_path_factory.mktemp("f32") / "f32_schedule_walk")
    subprocess.run([gxx, "-O2", "-std=c++17", "-ffp-contract=off",
                    "-D__host__=", "-D__device__=", "-I", CSRC, "-o", exe,
                    os.path.join(HERE, "f32_schedule_walk.cpp")],
                   check=True, capture_output=True, text=True, timeout=120)

    def run(*args):
        out = subprocess.run([exe, *map(str, args)], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        return dict(kv.split("=") for kv in out.stdout.split()[1:])

    return run


@pytest.mark.parametrize("channels", [256, 260, 258])
@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("B", [16, 100, 200, 400])
def test_f32_schedule_covers_every_output_once(walk, B, k, channels):
    """The planner's cells (256 channels), det's (260, and 258 without
    robot state) at the eval batch, one request and 2 and 4 planned
    together: for every tile shape each (pixel, hidden channel) in one
    tile, heaviest rows first, each tile's k-steps its row's in-map row
    taps with every column tap and channel chunk, in order."""
    got = walk(B, 6, 8, channels, channels, k)
    assert got["chosen"] in ("0", "1")


@pytest.mark.parametrize("B,H,W,Cx,C,k", [
    (3, 5, 7, 24, 40, 5),     # a partial hidden tile, a map narrower than its box
    (2, 6, 8, 13, 20, 3),     # odd channels: a chunk straddling x and h
    (17, 3, 3, 8, 36, 5),     # batch runs past B, k above the map's height
    (1, 3, 130, 8, 8, 3),     # a row wider than a tile
])
def test_f32_schedule_sums_the_convolution(walk, B, H, W, Cx, C, k):
    """The kernel's chain (bias, the tile's k-steps in order, zeros for
    out-of-map columns and channel tails) emulated with float32 fmaf equals
    the replaced kernel's chain (every tap) bit for bit, and a naive
    float64 SAME convolution to 1e-5, for every tile shape."""
    got = walk(B, H, W, Cx, C, k, "emulate")
    assert got["emulated"] == "1"
    assert float(got["max_err"]) <= 1e-4
