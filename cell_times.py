#!/usr/bin/env python3
"""Times the bf16 ConvLSTM-cell kernel of the checkout it runs in, or with
--f32 its float32 cell kernel, on one NVIDIA GPU, at the shapes of the
trainer's eval epoch, the planner and the plan server: B = 16, 100, 200
and 400 (6x8 maps, Cx = C = 256), k = 5 and 3. In bf16 also at det's
shapes (B = 100, Cx = C = 260 in views of 264-channel buffers, NaN pad
lanes, the layout models/det.py gives them) and at widths that are not
multiples of 8, B = 100: g_dim 252 and 100 as a model steps its first
cell (x contiguous, h and c padded views) and 13/20 on contiguous tensors.

    python3 cell_times.py [--f32] [--plan] [--g_dim N] [--save FILE] [--bits FILE]

The inputs (seed 7) and the CUDA-event timing are chip_smoke.py's, imported
from the same checkout. A copy of this script run from the root of another
checkout (say the parent commit, unpacked by `git archive`) times that
checkout's kernel on the same inputs, so two versions of the kernel are
compared in one call in turns: parent, change, change, parent. Each launch
is first held to the plain version (bf16: 1e-2 absolute and relative;
float32: 1e-4 with TF32 off) with one cell launch counted in
launches["conv_lstm_cell"], which every checkout has; each shape's route
is "sm90" where launches["conv_lstm_cell_sm90"] moved, else "other" (a
checkout before the wgmma/TMA kernel took every bf16 cell). The 256- and
260-channel shapes must take sm90 in bf16. `--plan` also runs the
canonical planner at g_dim N (default 256) in the kernel's type (bf16, or
float32 with --f32; seed-0 weights): one warm-up and three timed plans of
160 cells and 10 masks each, one plan's host syncs, then one plan under
torch.profiler (device busy time, kernel time summed over streams, the
cell kernels' share of that sum). `--save FILE` writes each shape's h'
and c' and route to FILE (torch.save); `--bits FILE` fails unless the
shapes that took sm90 in both runs give the bits in FILE. Prints the
card's name and power limit, then one JSON line {"card": ..., "dtype":
..., "cell_ms": {"B=16 k=5": [ms, ms, ms], ...}, "routes": ..., "bits":
..., "plan": ...}.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

import chip_smoke as smoke
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from torch_variant_cases import CANONICAL, start_goal  # tests/, on chip_smoke's path

SHAPES = [(B, 6, 8, 256, 256, k) for B in (16, 100, 200, 400) for k in (5, 3)]
# bf16 only: (shape, layout) beside SHAPES' contiguous cells
WIDTHS = ([((100, 6, 8, 260, 260, k), "det") for k in (5, 3)]
          + [((100, 6, 8, C, C, k), "model") for C in (252, 100) for k in (5, 3)]
          + [((100, 6, 8, 13, 20, k), "contiguous") for k in (5, 3)])


def laid_out(args, layout):
    """The cell's inputs in `layout`: "contiguous" as made, "det" x, h and c
    as views of padded buffers with NaN pad lanes (chip_smoke.det_layout),
    "model" x contiguous and h, c such views (lstm.zero_state's). Kept here,
    not imported: copies of this script run against older chip_smoke.py."""
    if layout == "contiguous":
        return args
    padded = smoke.det_layout(*args)
    return padded if layout == "det" else [args[0]] + padded[1:]


def canonical_plan(compute_dtype: str, g_dim: int = 256,
                   n_timed: int = 3) -> dict:
    """The canonical planner at `g_dim` in `compute_dtype`: latency of n_timed plans
    after a warm-up (host clock, each ending in a sync), each launching 160
    cells and 10 masks, the host syncs of one plan, then one plan under
    torch.profiler: device busy time, kernel time summed over streams, and
    the cell kernel's part of that sum (kernels named cell_kernel)."""
    from torch.profiler import ProfilerActivity, profile

    cfg = Config(**dict(CANONICAL, compute_dtype=compute_dtype, g_dim=g_dim))
    policy = CEMPolicy(cfg, svg.init(cfg, seed=0, device="cuda"))
    start, goal = start_goal(np.random.RandomState(0))
    want = {"conv_lstm_cell": 4 * (cfg.horizon - 1) * cfg.opt_iter,
            "capsule_mask_render": cfg.opt_iter}
    seconds = []
    for i in range(n_timed + 1):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = policy.get_action(start, goal, ep_num=1, step=i)
        torch.cuda.synchronize()
        if i:
            seconds.append(time.perf_counter() - t0)
        got = {n: kernels.launches[n] - before[n] for n in want}
        if got != want or plan.shape != (4, 2) or not np.all(np.isfinite(plan)):
            raise AssertionError(f"{compute_dtype} plan {i}: launches {got}, "
                                 f"plan {plan}")
    syncs = smoke.count_syncs(lambda: policy.get_action(start, goal, ep_num=3))
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        policy.get_action(start, goal, ep_num=2, step=0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = [(e.key, e.device_time_total / 1e3, e.count)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    # busy: the union of the device activities' intervals (cuDNN's FFT
    # convolutions run kernels on other streams, which overlap)
    spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                   if e.device_type == torch.autograd.DeviceType.CUDA)
    busy, end = 0.0, float("-inf")
    for start, stop in spans:
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy /= 1e3
    summed = sum(ms for _, ms, _ in rows)
    cell = sum(ms for key, ms, _ in rows if "cell_kernel" in key)
    cell_n = sum(n for key, _, n in rows if "cell_kernel" in key)
    return dict(g_dim=g_dim, latency_s=statistics.median(seconds),
                latency_runs=seconds,
                launches_per_plan=want, syncs=syncs, profiled_wall_ms=wall,
                busy_ms=busy,
                busy_share=busy / wall if busy else None, kernel_ms=summed,
                cell_ms=cell, cell_launches=cell_n,
                cell_share=cell / summed if summed else None)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--save", help="write the outputs to this file")
    ap.add_argument("--bits", help="compare the outputs with this file")
    ap.add_argument("--f32", action="store_true",
                    help="the float32 cell kernel in place of the bf16 one")
    ap.add_argument("--plan", action="store_true",
                    help="the canonical planner in the kernel's type too")
    ap.add_argument("--g_dim", type=int, default=256,
                    help="the planner's g_dim with --plan")
    args_ = ap.parse_args()
    if not torch.cuda.is_available():
        print("cell_times: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(card)
    if args_.f32:  # the plain side in full float32
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
    dtype, bits_as = ((torch.float32, torch.int32) if args_.f32
                      else (torch.bfloat16, torch.int16))
    tol = 1e-4 if args_.f32 else 1e-2
    cases = [(shape, "contiguous") for shape in SHAPES]
    if not args_.f32:
        cases += WIDTHS
    times, outputs, routes = {}, {}, {}
    for shape, layout in cases:
        key = f"B={shape[0]} k={shape[-1]}" + (
            "" if shape[3:5] == (256, 256) else
            f" Cx={shape[3]} C={shape[4]} {layout}")
        args = laid_out(smoke.cell_inputs(*shape, dtype, dev, 7), layout)
        before = dict(kernels.launches)
        got = kernels.conv_lstm_cell(*args)
        if kernels.launches["conv_lstm_cell"] != before["conv_lstm_cell"] + 1:
            raise AssertionError(f"{shape}: no cell launch counted")
        sm90 = (kernels.launches["conv_lstm_cell_sm90"]
                != before["conv_lstm_cell_sm90"])
        routes[key] = "sm90" if sm90 else "other"
        if not args_.f32 and not sm90 and shape[4] in (256, 260):
            raise AssertionError(f"{key}: did not take the wgmma/TMA kernel")
        for g, w in zip(got, kernels.conv_lstm_cell_plain(*args)):
            torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        outputs[key] = [t.cpu() for t in got]
        run = lambda: kernels.conv_lstm_cell(*args)
        times[key] = [smoke.cuda_ms(run, n=5 if args_.f32 else 20)
                      for _ in range(3)]
    result = {"card": card, "dtype": str(dtype), "cell_ms": times,
              "routes": routes, "bits": None,
              "plan": (canonical_plan("float32" if args_.f32 else "bfloat16",
                                      args_.g_dim)
                       if args_.plan else None)}
    if args_.bits:
        want = torch.load(args_.bits)
        same = [key for key in outputs if routes[key] == "sm90"
                and want["routes"].get(key) == "sm90"]
        differ = {key: [int((a.view(bits_as) != b.view(bits_as)).sum())
                        for a, b in zip(outputs[key], want["outputs"][key])]
                  for key in same}
        result["bits"] = {"compared_with": args_.bits, "elements_differ": differ}
        if any(v for d in differ.values() for v in d):
            print(json.dumps(result))
            raise AssertionError(f"outputs differ from {args_.bits}: {differ}")
    if args_.save:
        torch.save({"outputs": outputs, "routes": routes}, args_.save)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
