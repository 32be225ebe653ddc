#!/usr/bin/env python3
"""Checks the PyTorch port of the CEM planner on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. card       name and power limit from nvidia-smi;
  2. build      nvcc builds both kernels from csrc/ (timed);
  3. masks      capsule-mask kernel == its plain version, bit for bit, on
                segments from random poses through the port's renderer;
  4. cell       ConvLSTM-cell kernel vs its plain version at the planner's
                shapes (B=100, 6x8, Cx=C=256, k=5 and k=3) in bf16 and f32,
                and at a small odd shape;
  5. parity     a small float32 CEM plan on the GPU (kernels) equals the
                same plan on the CPU (plain versions) for injected noise;
  6. plan       the canonical planner of bench.py (svg, g_dim 256, z_dim 64,
                bf16, dontcare, N=100, horizon 5, opt_iter 10, topk 5) with
                weights initialised from a seed: one warm-up plan and three
                timed plans, each of which must launch the cell kernel 160
                times and the mask kernel 10 times;
  7. profile    one more canonical plan under torch.profiler: device time
                by kernel and the share of the plan the device was busy;
  8. kernels    per kernel: launches in phase 6, device time per launch
                (CUDA events), its plain version's time, the least time the card
                could take (bound), and a PyTorch library call's time.

Prints the card line and one JSON line of kernels, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch
import torch.nn.functional as F

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State

# NVIDIA H100 SXM data sheet, dense: bf16 tensor cores, float32 CUDA cores,
# HBM3 bandwidth (at the full 700 W power limit)
PEAK_BF16 = 989e12
PEAK_F32 = 67e12
PEAK_BYTES = 3.35e12

CANONICAL = dict(  # bench.py:266-287
    model="svg", g_dim=256, z_dim=64, image_height=48, image_width=64,
    action_dim=5, robot_dim=5, model_use_mask=True, model_use_future_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    reward_type="dontcare", compute_dtype="bfloat16", horizon=5, opt_iter=10,
    action_candidates=100, topk=5, cem_init_std=0.015,
)
SMALL = dict(CANONICAL, g_dim=16, z_dim=4, compute_dtype="float32",
             horizon=3, opt_iter=2, action_candidates=6, topk=2,
             sample_mean=True)
# tolerances of kernel vs plain: bf16 outputs may differ by one bf16
# rounding step (2^-8 relative) where the float32 gate sums, taken in
# another order, straddle a rounding boundary; float32 by sum order only
CELL_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}
PLAN_TOL = 1e-4
MASK_SRC = "robot_aware_control_tpu_torch/csrc/capsule_mask.cu"
CELL_SRC = "robot_aware_control_tpu_torch/csrc/conv_lstm_cell.cu"


def cuda_ms(fn, n: int = 20, sleep_cycles: int = 200_000_000) -> float:
    """Mean device milliseconds per call over n calls after a warm-up, by
    CUDA events. The calls are queued behind a sleeping kernel, so that the
    events time the device and not the host's launch overhead (which is
    longer than a small kernel); raises if the queue ran dry."""
    fn()
    torch.cuda.synchronize()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
    ev[0].record()
    torch.cuda._sleep(sleep_cycles)
    ev[1].record()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    host_ms = (time.perf_counter() - t0) * 1e3
    ev[2].record()
    torch.cuda.synchronize()
    if host_ms >= ev[0].elapsed_time(ev[1]):
        raise AssertionError(f"launches took {host_ms:.1f} ms on the host, "
                             "longer than the sleep ahead of them")
    return ev[1].elapsed_time(ev[2]) / n


def bound_ms(ops: float, peak: float, nbytes: float):
    t_ops, t_bytes = ops / peak, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


def phase(name):
    print(f"== {name}", flush=True)
    return time.perf_counter()


# --------------------------------------------------------------- kernels
def mask_inputs(M: int, seed: int, dev):
    """Thick-mask segments of M random arm poses, as the planner renders."""
    r = CapsuleMaskRenderer((48, 64), thick=True, device=dev)
    q = np.random.RandomState(seed).uniform(-0.5, 0.5, (M, 5))
    segs = r.segment_params(torch.tensor(q, dtype=torch.float32, device=dev))
    return segs.contiguous()


def check_masks(dev):
    for M in (500, 37):
        segs = mask_inputs(M, M, dev)
        got = kernels.capsule_mask_render(segs, 48, 64)
        want = kernels.capsule_mask_render_plain(segs, 48, 64)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        print(f"masks M={M}: {differ} pixels differ, "
              f"{float(want.mean()):.4f} of pixels inside")
        if differ:
            raise AssertionError(f"mask kernel differs from plain at M={M}")
    return 0.0


def cell_inputs(B, H, W, Cx, C, k, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x, h, c = (torch.randn(B, H, W, n, generator=g) for n in (Cx, C, C))
    w = torch.randn(k, k, Cx + C, 4 * C, generator=g) * 0.02
    b = torch.randn(4 * C, generator=g) * 0.1
    return ([t.to(dev, dtype) for t in (x, h, c, w)] + [b.to(dev)])


def check_cells(dev):
    errs = {}
    # the planner's two cells, then odd shapes: 24/40 channels take the bf16
    # kernel's 16-byte loads, 13/20 its element-wise loads
    shapes = [(100, 6, 8, 256, 256, 5), (100, 6, 8, 256, 256, 3),
              (3, 5, 7, 24, 40, 5), (2, 6, 8, 13, 20, 3)]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            args = cell_inputs(*shape, dtype, dev, seed=sum(shape))
            got = kernels.conv_lstm_cell(*args)
            want = kernels.conv_lstm_cell_plain(*args)
            tol = CELL_TOL[dtype]
            err = 0.0
            for g, w in zip(got, want):
                torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
                err = max(err, float((g.float() - w.float()).abs().max()))
            print(f"cell B,H,W,Cx,C,k={shape} {dtype}: max |kernel - plain| "
                  f"= {err:.3g} (tolerance {tol} abs + rel)")
            errs[(shape, dtype)] = err
    return errs


# ----------------------------------------------------------------- plans
def start_goal(rng, h=48, w=64):
    start = State(img=rng.rand(h, w, 3).astype(np.float32),
                  state=np.array([0.3, 0.0, 0.15, 0.0, 0.0], np.float32),
                  qpos=np.zeros(5, np.float32))
    goal = DemoGoalState(
        imgs=[rng.rand(h, w, 3).astype(np.float32) for _ in range(4)],
        masks=[np.zeros((h, w), np.float32) for _ in range(4)])
    return start, goal


def check_small_plan_parity():
    cfg = Config(**SMALL)
    start, goal = start_goal(np.random.RandomState(1))
    noise = np.random.RandomState(2).randn(
        cfg.opt_iter, cfg.action_candidates, cfg.horizon - 1, 2)
    plans = {}
    for dev in ("cpu", "cuda"):
        model = svg.init(cfg, seed=3, device=dev)
        plans[dev] = CEMPolicy(cfg, model, device=dev).get_action(
            start, goal, noise=noise)
    err = float(np.abs(plans["cuda"] - plans["cpu"]).max())
    print(f"small f32 plan, GPU vs CPU: max |diff| = {err:.3g} "
          f"(tolerance {PLAN_TOL})")
    if not err <= PLAN_TOL:
        raise AssertionError("GPU plan differs from CPU plan")


def canonical_plans(n_timed: int = 3):
    cfg = Config(**CANONICAL)
    model = svg.init(cfg, seed=0, device="cuda")
    policy = CEMPolicy(cfg, model)
    start, goal = start_goal(np.random.RandomState(0))
    # per model step, 2 cells in each of the prior and frame stacks
    want = {"conv_lstm_cell": 4 * (cfg.horizon - 1) * cfg.opt_iter,
            "capsule_mask_render": cfg.opt_iter}
    kernels.reset_launches()
    seconds = []
    for i in range(n_timed + 1):
        before = dict(kernels.launches)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plan = policy.get_action(start, goal, ep_num=1, step=i)
        torch.cuda.synchronize()
        if i:  # the first plan warms up
            seconds.append(time.perf_counter() - t0)
        got = {k: kernels.launches[k] - before[k] for k in want}
        if got != want:
            raise AssertionError(f"plan {i} launched {got}, expected {want}")
        if plan.shape != (cfg.horizon - 1, 2) or not np.all(np.isfinite(plan)):
            raise AssertionError(f"bad plan {plan!r}")
    launches = dict(kernels.launches)
    rollouts = cfg.opt_iter * cfg.action_candidates
    print("plan seconds: " + ", ".join(f"{s:.4f}" for s in seconds))
    print(f"plan latency {np.median(seconds):.4f} s (median of {n_timed}), "
          f"{rollouts / np.median(seconds):.1f} rollouts/s "
          f"({cfg.opt_iter} iterations x {cfg.action_candidates} candidates, "
          f"horizon {cfg.horizon}); kernel launches per plan {want}")
    return launches, policy, start, goal


def profile_plan(policy, start, goal):
    """One plan under torch.profiler: device time by kernel, and the share
    of the plan's wall time in which the device was busy (one stream, so
    kernel times add up without overlap)."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        policy.get_action(start, goal, ep_num=2, step=0)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profiler recorded no device time: device busy share not measured")
        return
    print(f"profiled plan: {wall:.1f} ms wall (profiler on), device busy "
          f"{busy:.1f} ms = {busy / wall:.1%}, idle {1 - busy / wall:.1%}")
    for ms, n, key in rows[:12]:
        print(f"  {ms:9.2f} ms {ms / busy:6.1%} {n:5d}x  {key[:100]}")


# ---------------------------------------------------------------- timing
def valid_taps(H, W, k):
    """Taps of a SAME k x k window that land inside an H x W map, summed
    over its pixels: the work of the convolution without its zero border."""
    p = k // 2
    rows = sum(min(y + p, H - 1) - max(y - p, 0) + 1 for y in range(H))
    cols = sum(min(x + p, W - 1) - max(x - p, 0) + 1 for x in range(W))
    return rows * cols


def time_mask(dev, launches, err):
    segs = mask_inputs(500, 500, dev)
    M, S = segs.shape[:2]
    ms = cuda_ms(lambda: kernels.capsule_mask_render(segs, 48, 64))
    plain = cuda_ms(lambda: kernels.capsule_mask_render_plain(segs, 48, 64))
    # 24 float32 operations per pixel and segment (one of them a division)
    # plus 5 per segment; read the segments once, write the masks once
    ops = M * S * (48 * 64 * 24 + 5)
    bound, by = bound_ms(ops, PEAK_F32, segs.numel() * 4 + M * 48 * 64 * 4)
    return dict(name="capsule_mask_render", route="cuda", source=MASK_SRC,
                replaces="robot_aware_control_tpu/ops/pallas_kernels.py:57",
                launches=launches, max_abs_err=err, ms=ms, plain_ms=plain,
                bound_ms=bound, bound_by=by, library_ms=None)


def time_cell(dev, launches, errs):
    """The planner launches cell0 (k=5) and cell1 (k=3) equally often, so
    the per-launch numbers are the mean of the two shapes."""
    rows = []
    for k in (5, 3):
        B, H, W, Cx, C = 100, 6, 8, 256, 256
        x, h, c, w, b = cell_inputs(B, H, W, Cx, C, k, torch.bfloat16, dev, 7)
        ms = cuda_ms(lambda: kernels.conv_lstm_cell(x, h, c, w, b))
        plain = cuda_ms(lambda: kernels.conv_lstm_cell_plain(x, h, c, w, b))
        xh = torch.cat([x, h], -1).permute(0, 3, 1, 2)  # channels-last NCHW
        w_oihw = w.permute(3, 2, 0, 1).contiguous(
            memory_format=torch.channels_last)
        lib = cuda_ms(lambda: F.conv2d(xh, w_oihw, b.to(torch.bfloat16),
                                       padding=k // 2))
        ops = 2.0 * B * valid_taps(H, W, k) * (Cx + C) * 4 * C
        nbytes = 2 * (x.numel() + h.numel() + c.numel() + w.numel()
                      + 2 * h.numel()) + 4 * b.numel()
        bound, by = bound_ms(ops, PEAK_BF16, nbytes)
        err = errs[((B, H, W, Cx, C, k), torch.bfloat16)]
        rows.append(dict(k=k, ms=ms, plain_ms=plain, library_ms=lib,
                         bound_ms=bound, bound_by=by, gflop=ops / 1e9,
                         max_abs_err=err))
        print(f"cell k={k} bf16: kernel {ms:.4f} ms, plain {plain:.4f} ms, "
              f"cuDNN gate conv {lib:.4f} ms, bound {bound:.4f} ms ({by}, "
              f"{ops / 1e9:.1f} GFLOP without the zero border)")
    mean = lambda key: sum(r[key] for r in rows) / len(rows)
    return dict(name="conv_lstm_cell", route="cuda", source=CELL_SRC,
                replaces="robot_aware_control_tpu/ops/pallas_kernels.py:146",
                launches=launches, max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by=rows[0]["bound_by"], library_ms=mean("library_ms"),
                per_shape=rows)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    phase("card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(f"{card}; python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")

    t = phase("build")
    kernels.build()
    print(f"built {sorted(kernels.SOURCES)} in {time.perf_counter() - t:.1f} s")

    # plain versions in full float32: cuDNN would otherwise use TF32
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    phase("masks")
    mask_err = check_masks(dev)
    phase("cell")
    cell_errs = check_cells(dev)
    phase("parity")
    check_small_plan_parity()

    phase("plan")
    launches, policy, start, goal = canonical_plans()
    phase("profile")
    profile_plan(policy, start, goal)
    phase("kernels")
    line = {"kernels": [
        time_mask(dev, launches["capsule_mask_render"], mask_err),
        time_cell(dev, launches["conv_lstm_cell"], cell_errs),
    ]}
    print(card)
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
