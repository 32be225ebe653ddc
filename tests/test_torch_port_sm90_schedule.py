"""The schedule of the wgmma/TMA ConvLSTM cell, walked on the CPU.

`robot_aware_control_tpu_torch/csrc/conv_lstm_cell_sm90_geom.h` holds the
kernel's geometry (`Geom`, `make_geom`): its tiles, the cut of each tile's K
range into pieces (its in-map row taps), the deal of the pieces to the
persistent clusters, the k-steps a piece loads (with det's short steps and
narrow hidden tail) and the workspace slots. It includes no CUDA header, so
g++ compiles it with -D__host__= -D__device__= into
`tests/sm90_schedule_walk.cpp`, which checks the schedule of one launch (see
that file) and, with `emulate`, sums a small convolution the way the kernel
does against a naive one. g++ is looked up in a fixture; the tests skip
without it.
"""

from __future__ import annotations

import os
import shutil
import subprocess

import pytest

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(os.path.dirname(HERE), "robot_aware_control_tpu_torch",
                    "csrc")
# persistent clusters of two blocks on an H100 (132 SMs), and a deal over
# fewer clusters than a launch has pieces
CLUSTERS = (66, 7)


@pytest.fixture(scope="module")
def walk(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    exe = str(tmp_path_factory.mktemp("sm90") / "sm90_schedule_walk")
    subprocess.run([gxx, "-O2", "-std=c++17", "-D__host__=", "-D__device__=",
                    "-I", CSRC, "-o", exe,
                    os.path.join(HERE, "sm90_schedule_walk.cpp")],
                   check=True, capture_output=True, text=True, timeout=120)

    def run(*args):
        out = subprocess.run([exe, *map(str, args)], capture_output=True,
                             text=True, timeout=120)
        assert out.returncode == 0, out.stdout + out.stderr
        return dict(kv.split("=") for kv in out.stdout.split()[1:])

    return run


@pytest.mark.parametrize("channels,tail", [(256, "0"), (260, "1"), (258, "1")])
@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("B", [16, 100, 200, 400])
def test_sm90_schedule_takes_every_step_once(walk, B, k, channels, tail):
    """The planner's cells (256 + 256 channels: the general layout) and
    det's (260 and 258: the tail layout), at the eval batch, one request and
    2 and 4 planned together: every k-step of every unit once, the pieces
    of a unit its in-map row taps, every input and hidden channel once,
    slots distinct."""
    for clusters in CLUSTERS:
        got = walk(B, 6, 8, channels, channels, k, clusters)
        assert got["tail"] == tail


@pytest.mark.parametrize("B,H,W,Cx,C,k", [
    (3, 5, 7, 260, 260, 5),   # det's tails, a map narrower than its box
    (2, 6, 8, 258, 258, 3),   # det without robot state
    (2, 4, 4, 16, 132, 3),    # the tail layout with one tile pair
    (3, 5, 7, 24, 40, 5),     # general: partial channel chunk and tile
    (13, 5, 7, 128, 64, 5),   # general: Cx != C, a batch run past the end
    (1, 3, 130, 16, 16, 3),   # general: a row wider than 128 columns
])
def test_sm90_schedule_sums_the_convolution(walk, B, H, W, Cx, C, k):
    """The pixels, channels and weight rows the kernel's loads take, with
    TMA's zero fill, summed piece by piece in piece order, equal a naive
    SAME convolution (float64, to 1e-9) on hidden channels of every tile."""
    for clusters in CLUSTERS:
        assert walk(B, H, W, Cx, C, k, clusters, "emulate")["emulated"] == "1"
