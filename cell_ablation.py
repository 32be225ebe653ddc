#!/usr/bin/env python3
"""Ablations of the wgmma/TMA ConvLSTM-cell kernel on one NVIDIA GPU.

    python3 cell_ablation.py [--det | --f32]

Builds variants of robot_aware_control_tpu_torch/csrc/conv_lstm_cell_sm90.cu
(with its header conv_lstm_cell_sm90_geom.h written into it), each made by a
textual substitution in the source, and times them at the
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

With --det, the variants are timed at det's two cell shapes (B=100, 6x8,
Cx=C=260 in det's layout: padded views; the kernel reads the weights'
gate-packed copy, ops/kernels.py:sm90_weights), each taking
out one part of the tail layout (csrc/conv_lstm_cell_sm90_geom.h):

  kernel        the source as it is;
  no_tail_n     no narrow tail: the 4 last hidden channels are not
                multiplied or loaded (results are wrong);
  no_short      the short k-step loads and multiplies nothing (results are
                wrong);
  no_fold       a tile's pieces are not added: each block finishes its own
                piece (results are wrong);
  whole_tiles   the general layout at 260 channels: whole 64-channel tiles
                and k-steps for the tails, as a padding to 264 channels
                would multiply;
  producer_56   56 registers for the producer warpgroup (224 for the
                consumers) in place of 40 (232): no spills;
and, on the source as it is, two other layouts of the same inputs:
  gates_on_8    each gate's weight columns on a multiple of 8 (264) in
                place of 64 (320), so that boxes' rows straddle 128-byte
                lines;
  pixels_on_64  x, h and c at a pixel stride of 320 in place of 264.

With --f32, variants of robot_aware_control_tpu_torch/csrc/conv_lstm_cell_f32.cu
(with conv_lstm_cell_f32_geom.h written into it), timed in float32 at the
planner's two cell shapes (B = 100) and at B = 16 and 400, k = 5, each at
the tile shape the kernel's schedule picks:

  kernel        the source as it is;
  no_loads      no cp.async: products, barriers and update only (results
                are wrong);
  no_sync       no cp.async and no barrier: the products alone (results are
                wrong);
  regs_free     no register cap from __launch_bounds__;
  ring_4x16     a ring of 4 stages of 16 channels in place of 2 of 32;
  prefetch      each operand fragment read from shared memory one step
                ahead of its products (A a quad of channels, B a gate);
  narrow        64 x 16 tiles in place of 64 x 32 (the B = 16 and 100
                launches take that shape).

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

OUT = os.path.join(kernels.BUILD_DIR, "ablation")

VARIANTS = {
    "kernel": [],
    "no_loads": [(r"mbar_expect_tx\(fb,[^;]*;", "mbar_arrive(fb);"),
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
DET_VARIANTS = {
    "kernel": [],
    "no_tail_n": [(r"(__host__ __device__ bool carries\(int np, int rank, int wg\) const \{)",
                   r"\1 return false;")],
    "no_short": [(r"mbar_expect_tx\(fb, 2 \* kShortABytes[^;]*;", "mbar_arrive(fb);"),
                 (r"tma_load_4d_both\(a \+ (rank \* \(kShortABytes|kShortABytes)",
                  r"if (0) tma_load_4d_both(a + \1"),
                 (r"tma_load_2d\(a \+ kABytes \+ (gate \* 2|kBBytes \+ part)",
                  r"if (0) tma_load_2d(a + kABytes + \1"),
                 (r"(wgmma_m64n256k16\(acc, da,\n\s*smem_desc\(b \+ kk \* kShortBBytes)",
                  r"if (0) \1"),
                 (r"(wgmma_m64n32k16\(acct, da, smem_desc\(b \+ kBBytes \+ kk \* kShortBtBytes)",
                  r"if (0) \1")],
    "no_fold": [(r"if \(pc\.n > 1\) \{\n        if \(ct == 0\) s_arrival",
                 "if (0) {\n        if (ct == 0) s_arrival")],
    "whole_tiles": [(r"(inline __host__ __device__ bool takes_tail\(int Cx, int C\) \{)",
                     r"\1\n  return false;")],
    "producer_56": [(r"setmaxnreg\.dec\.sync\.aligned\.u32 40;",
                     "setmaxnreg.dec.sync.aligned.u32 56;"),
                    (r"setmaxnreg\.inc\.sync\.aligned\.u32 232;",
                     "setmaxnreg.inc.sync.aligned.u32 224;")],
}
F32_NO_LOADS = [(r"copy_async<VEC>\((a_s|b_s) \+", r"if (0) copy_async<VEC>(\1 +")]
F32_PREFETCH = """    float4 an[kTP];
#pragma unroll
    for (int i = 0; i < kTP; ++i) an[i] = *reinterpret_cast<const float4*>(a_s + i * TM * A_LD);
    float4 bn = *reinterpret_cast<const float4*>(b_s);
#pragma unroll
    for (int kq = 0; kq < BK; kq += 4) {
      float4 a[kTP];
#pragma unroll
      for (int i = 0; i < kTP; ++i) a[i] = an[i];
      if (kq + 4 < BK) {
#pragma unroll
        for (int i = 0; i < kTP; ++i)
          an[i] = *reinterpret_cast<const float4*>(a_s + i * TM * A_LD + kq + 4);
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
#pragma unroll
        for (int gt = 0; gt < 4; ++gt) {
          const float4 b = bn;
          if (!(kq + q == BK - 1 && gt == 3))
            bn = *reinterpret_cast<const float4*>(b_s + (kq + q + (gt == 3)) * B_LD + ((gt + 1) % 4) * NH);
#pragma unroll
          for (int i = 0; i < kTP; ++i)
#pragma unroll
            for (int j = 0; j < kTH; ++j)
              acc[i][j][gt] = fmaf(lane(a[i], q), lane(b, j), acc[i][j][gt]);
        }
    }
  }
  wait_copies<0>();"""
F32_VARIANTS = {
    "kernel": [],
    "no_loads": F32_NO_LOADS,
    "no_sync": F32_NO_LOADS + [(r"    __syncthreads\(\);  ", "    //")],
    "regs_free": [(r"__launch_bounds__\(shape_threads\(S\), 65536 / \(shape_threads\(S\) \* 128\)\)",
                   "__launch_bounds__(shape_threads(S), 1)")],
    "ring_4x16": [(r"BK = 32;", "BK = 16;"), (r"kStages = 2;", "kStages = 4;")],
    "prefetch": [(r"#pragma unroll\n    for \(int kk = 0; kk < BK; kk \+= 4\) \{.*?\n    \}\n  \}\n"
                  r"  wait_copies<0>\(\);", F32_PREFETCH)],
    "narrow": [(r"shape_nh\(int\) \{ return 32; \}", "shape_nh(int s) { return s == 0 ? 32 : 16; }")],
}
F32_SHAPES = [(100, 6, 8, 256, 256, 5), (100, 6, 8, 256, 256, 3),
              (16, 6, 8, 256, 256, 5), (400, 6, 8, 256, 256, 5)]
EXACT = {"kernel", "precise_math", "bk32", "whole_tiles", "producer_56",
         "gates_on_8", "pixels_on_64", "regs_free", "ring_4x16", "prefetch",
         "narrow"}  # variants that still compute the cell


def other_det_layouts(x, h, c, w, b) -> dict:
    """Launches of the source as it is on det's cell in the two other
    layouts --det compares."""
    B, H, W, Cx = x.shape
    C, k = h.shape[-1], w.shape[0]
    det = smoke.det_layout(x, h, c, w, b)
    packed, cp = kernels.sm90_weights(w, C)
    # each gate's columns on a multiple of 8 (264) in place of 64 (320),
    # then the tail's block
    w8 = torch.cat([packed[..., q * cp:q * cp + kernels.round_up(C)]
                    for q in range(4)] + [packed[..., 4 * cp:]], -1)
    wide = [torch.full((B, H, W, kernels.round_up(t.shape[-1], 64)),
                       float("nan"), dtype=t.dtype, device=t.device)
            [..., :t.shape[-1]].copy_(t) for t in (x, h, c)]
    return {"gates_on_8": lambda: kernels.launch_sm90(
                (B, H, W, Cx, C, k), *det[:3], w8, kernels.round_up(C), b),
            "pixels_on_64": lambda: kernels.conv_lstm_cell(*wide, w, b)}


def build_variants(variants, lib="conv_lstm_cell_sm90") -> dict:
    """Writes and compiles every variant of library `lib`'s source, its
    header written into it (nvcc in parallel); returns the loaded
    libraries with their argument types set."""
    os.makedirs(OUT, exist_ok=True)
    source = os.path.join(kernels._CSRC, kernels.SOURCES[lib][0])
    header_name = f"{lib}_geom.h"
    with open(os.path.join(kernels._CSRC, header_name)) as f:
        header = f.read().replace("#pragma once", "")
    src = open(source).read().replace(f'#include "{header_name}"', header)
    procs = {}
    for name, subs in variants.items():
        text = src
        for pattern, repl in subs:
            text, n = re.subn(pattern, repl, text, flags=re.DOTALL)
            if n == 0:
                raise RuntimeError(f"{name}: {pattern!r} matches nothing")
        path = os.path.join(OUT, f"{lib}_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        procs[name] = subprocess.Popen(
            [kernels._nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
             "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
             "-Xptxas", "-v", "-o", os.path.join(OUT, f"{lib}_{name}.so"), path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    libs = {}
    for name, p in procs.items():
        out, _ = p.communicate()
        if p.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        spills = sorted({l.strip() for l in out.splitlines() if "spill stores" in l})
        print(f"{lib} {name}: {'; '.join(spills)}")
        libs[name] = kernels.bind(lib, ctypes.CDLL(os.path.join(OUT, f"{lib}_{name}.so")))
    return libs


def f32_ablation(dev) -> None:
    """--f32: the float32 kernel's variants (module docstring), in turns."""
    torch.backends.cudnn.allow_tf32 = False
    libs = build_variants(F32_VARIANTS, "conv_lstm_cell_f32")
    for shape in F32_SHAPES:
        args = smoke.cell_inputs(*shape, torch.float32, dev, 7)
        want = kernels.conv_lstm_cell_plain(*args)
        times = {name: [] for name in libs}
        order = list(libs)
        for names in (order, order[::-1]):
            for name in names:
                kernels._libs["conv_lstm_cell_f32"] = libs[name]
                kernels._f32_schedule.cache_clear()
                kernels.reset_launches()
                got = kernels.conv_lstm_cell(*args)
                if name in EXACT and not all(
                        torch.allclose(g, w, rtol=1e-4, atol=1e-4)
                        for g, w in zip(got, want)):
                    raise AssertionError(f"{name} disagrees with the plain version")
                if kernels.launches["conv_lstm_cell_f32"] != 1:
                    raise AssertionError(f"{name} did not take the float32 kernel")
                times[name].append(smoke.cuda_ms(lambda: kernels.conv_lstm_cell(*args), n=5))
        s = kernels.f32_schedule(*shape, dev)
        print(f"float32 B={shape[0]} k={shape[-1]} (tile {s['bm']}x{s['nh']}, "
              f"{s['tiles']} tiles, {2 * s['macs'] / 1e9:.1f} GFLOP multiplied):")
        for name, ms in times.items():
            extra = ", agrees with plain" if name in EXACT else ""
            print(f"  {name:10s} {np.mean(ms):.4f} ms ({', '.join(f'{v:.4f}' for v in ms)})"
                  f" = {2 * s['macs'] / np.mean(ms) / 1e9:.1f} TFLOP/s{extra}")


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
    if "--f32" in sys.argv[1:]:
        f32_ablation(dev)
        return 0
    det = "--det" in sys.argv[1:]
    libs = build_variants(DET_VARIANTS if det else VARIANTS)
    for shape in smoke.DET_CELLS if det else smoke.PLANNER_CELLS:
        raw = smoke.cell_inputs(*shape, torch.bfloat16, dev, 7)
        want = kernels.conv_lstm_cell_plain(*raw)
        args = smoke.det_layout(*raw) if det else raw
        runs = {name: lambda: kernels.conv_lstm_cell(*args) for name in libs}
        if det:
            runs.update(other_det_layouts(*raw))
        times = {name: [] for name in runs}
        order = list(runs)
        for names in (order, order[::-1]):
            for name in names:
                # the wrapper loads its library once; point it at the variant
                kernels._libs["conv_lstm_cell_sm90"] = libs.get(name, libs["kernel"])
                kernels._sm90_schedule.cache_clear()
                kernels.reset_launches()
                got = runs[name]()
                if name in EXACT and not all(
                        torch.allclose(g.float(), w.float(), rtol=1e-2, atol=1e-2)
                        for g, w in zip(got, want)):
                    raise AssertionError(f"{name} disagrees with the plain version")
                if kernels.launches["conv_lstm_cell_sm90"] != 1:
                    raise AssertionError(f"{name} did not take the sm90 kernel")
                times[name].append(smoke.cuda_ms(runs[name]))
        steps = kernels.sm90_schedule(*shape, dev)["steps"]
        if det:
            print(f"det B={shape[0]} Cx=C={shape[3]}:")
        for name, ms in times.items():
            extra = ", agrees with plain" if name in EXACT else ""
            if name == "no_products" and not det:
                per_s = steps / (np.mean(ms) * 1e-3) * 1024 / 1e12
                extra = (f", operands into shared memory at {48 * per_s:.2f} "
                         f"TB/s, from L2 at {40 * per_s:.2f} TB/s")
            print(f"k={shape[-1]} {name:13s} {np.mean(ms):.4f} ms "
                  f"({', '.join(f'{v:.4f}' for v in ms)}){extra}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
