#!/usr/bin/env python3
"""Ablations of the wgmma/TMA ConvLSTM-cell kernel on one NVIDIA GPU.

    python3 cell_ablation.py

Builds variants of robot_aware_control_tpu_torch/csrc/conv_lstm_cell_sm90.cu,
each made by a textual substitution in the source, and times them at the
planner's two cell shapes (B=100, 6x8, Cx=C=256, k=5 and k=3), in turns
(every variant once, then every variant again in reverse order), with the
same CUDA-event timing as chip_smoke.py. Each variant takes one thing out:

  kernel        the source as it is;
  no_loads      the producer signals each stage without loading it: products
                and update only (results are wrong);
  no_products   no wgmma: loads, fixups and update only (results are wrong);
  no_update     no LSTM update and no stores of h', c' (results are wrong);
  precise_math  expf, an IEEE division and tanhf in the update in place of
                the approximate exponential and reciprocal;
  bk32          32 channels a k-step over 8 stages in place of 64 over 4.

Prints per variant and shape the device time and its spread; for the
variants that still compute the cell, that they agree with the plain version
(1e-2 abs + rel, else it raises); for no_products the rates at which the
operands fill shared memory (48 KB a block's k-step) and are read from L2
(40 KB: the two blocks of a cluster share A). Builds go to
robot_aware_control_tpu_torch/_build/ablation/ (git-ignored).
"""

from __future__ import annotations

import ctypes
import os
import re
import subprocess
import sys

import numpy as np
import torch

import chip_smoke as smoke
from robot_aware_control_tpu_torch.ops import kernels

SRC = os.path.join(kernels._CSRC, "conv_lstm_cell_sm90.cu")
OUT = os.path.join(kernels.BUILD_DIR, "ablation")

VARIANTS = {
    "kernel": [],
    "no_loads": [(r"mbar_expect_tx\(fb, kStageBytes\);", "mbar_arrive(fb);"),
                 (r"tma_load_4d_both\(a \+", "if (0) tma_load_4d_both(a +"),
                 (r"tma_load_2d\(a \+ kABytes", "if (0) tma_load_2d(a + kABytes")],
    "no_products": [(r"wgmma_m64n256k16\(acc,[^;]*;", ";")],
    "no_update": [(r"if \(pix\[hr\] < 0 \|\| n >= g\.C\) continue;", "continue;")],
    "precise_math": [
        (r"(float sigmoid\(float v\) \{).*?(\n\})",
         r"\1\n  return 1.0f / (1.0f + expf(-v));\2"),
        (r"tanh_fast\(float v\) \{[^}]*\}", "tanh_fast(float v) { return tanhf(v); }")],
    "bk32": [(r"BK = 64;", "BK = 32;"), (r"kStages = 4;", "kStages = 8;")],
}
EXACT = {"kernel", "precise_math", "bk32"}  # variants that still compute the cell


def build_variants() -> dict:
    """Writes and compiles every variant (nvcc in parallel); returns the
    loaded libraries with their argument types set."""
    os.makedirs(OUT, exist_ok=True)
    src = open(SRC).read()
    procs = {}
    for name, subs in VARIANTS.items():
        text = src
        for pattern, repl in subs:
            text, n = re.subn(pattern, repl, text, flags=re.DOTALL)
            if n == 0:
                raise RuntimeError(f"{name}: {pattern!r} matches nothing")
        path = os.path.join(OUT, f"{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-o", os.path.join(OUT, f"{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(os.path.join(OUT, f"{name}.so"))
        ptr, i = ctypes.c_void_p, ctypes.c_int
        lib.conv_lstm_cell_sm90.argtypes = [ptr] * 9 + [i] * 6 + [ptr]
        lib.conv_lstm_cell_sm90.restype = i
        lib.conv_lstm_cell_sm90_schedule.argtypes = [i] * 6 + [ptr]
        lib.conv_lstm_cell_sm90_schedule.restype = i
        libs[name] = lib
    return libs


def main() -> int:
    if not torch.cuda.is_available():
        print("cell_ablation: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(card)
    libs = build_variants()
    for shape in smoke.PLANNER_CELLS:
        args = smoke.cell_inputs(*shape, torch.bfloat16, dev, 7)
        want = kernels.conv_lstm_cell_plain(*args)
        times = {name: [] for name in libs}
        order = list(libs)
        for names in (order, order[::-1]):
            for name in names:
                # the wrapper loads its library once; point it at the variant
                kernels._libs["conv_lstm_cell_sm90"] = libs[name]
                got = kernels.conv_lstm_cell(*args)
                if name in EXACT and not all(
                        torch.allclose(g.float(), w.float(), rtol=1e-2, atol=1e-2)
                        for g, w in zip(got, want)):
                    raise AssertionError(f"{name} disagrees with the plain version")
                times[name].append(
                    smoke.cuda_ms(lambda: kernels.conv_lstm_cell(*args)))
        steps = kernels.sm90_schedule(*shape, dev)["steps"]
        for name, ms in times.items():
            extra = ", agrees with plain" if name in EXACT else ""
            if name == "no_products":
                per_s = steps / (np.mean(ms) * 1e-3) * 1024 / 1e12
                extra = (f", operands into shared memory at {48 * per_s:.2f} "
                         f"TB/s, from L2 at {40 * per_s:.2f} TB/s")
            print(f"k={shape[-1]} {name:13s} {np.mean(ms):.4f} ms "
                  f"({', '.join(f'{v:.4f}' for v in ms)}){extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
