#!/usr/bin/env python3
"""Checks the PyTorch port of the CEM planner on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each of which raises on failure:
  1. card       name and power limit from nvidia-smi;
  2. build      nvcc builds the kernel sources of csrc/ in parallel (timed,
                with each cell kernel's registers and spills from ptxas);
  3. masks      capsule-mask kernel == its plain version, bit for bit, on
                the cases of tests/torch_mask_cases.py that the GPU tests
                run: 500 planner poses through the port's renderer, other
                counts and sizes (M = 1, 37 and 0; S = 1, 8 and 13; 48x64,
                48x62 whose rows take 4-byte stores, and 5x7), capsules off
                the image, degenerate, with zero and negative radii, covering
                the image, near +-1e6, ending on a tile's edge, non-finite;
  4. cell       the ConvLSTM-cell kernels vs their plain version at the
                planner's shapes (B=100, 6x8, Cx=C=256, k=5 and k=3) and the
                trainer's eval shapes (B=16, the same otherwise): in bf16
                the wgmma/TMA kernel both take and the WMMA kernel it
                replaced, and the float32 kernel; then small odd shapes;
  5. parity     a small float32 CEM plan on the GPU (kernels) equals the
                same plan on the CPU (plain versions) for injected noise;
  6. plan       the canonical planner of bench.py (svg, g_dim 256, z_dim 64,
                bf16, dontcare, N=100, horizon 5, opt_iter 10, topk 5) with
                weights initialised from a seed: one warm-up plan and three
                timed plans, each of which must launch the cell 160 times,
                every time through the wgmma/TMA kernel, and the mask
                kernel 10 times;
  7. profile    one more canonical plan under torch.profiler: device time
                by kernel and the share of the plan the device was busy;
  8. train      SVG training (training/step.py, training/trainer.py):
                GPU-vs-CPU parity of one small float32 train step (loss,
                metrics, gradients, BatchNorm statistics; TF32 off) and of
                one eval step through the float32 cell kernel; the
                trainer's full-width bf16 eval step (B=16) with the cell
                kernel against the same step with its plain version; at the
                training config of bench.py:136-156 (g_dim 256, z_dim 64,
                batch 128, window 6, bf16) 2 warm-up and 5 timed steps for
                each of remat none, full and conv (median step time,
                frames/s = 128 x 6 / step, peak memory, no kernel
                launched, one profiled step), the step's FLOP count and
                bound; then PredictionTrainer at full width on the
                synthetic experiment: it trains, runs its eval epoch
                through the wgmma/TMA cell kernel (launches counted),
                writes a checkpoint, and a second trainer resumes from it;
  9. kernels    per kernel: launches in phase 6, device time per launch
                (CUDA events) at the planner's shapes, its plain version's
                time, the least time the card could take (bound), and a
                PyTorch library call's time (for the cell also at the eval
                shapes, reported apart); for the
                mask kernel also the operations dense and those its inputs
                need, its time with every tile culled and with none culled,
                the share of tests its skip rule keeps (the rule replayed in
                PyTorch) and its registers and spills; for the cell per
                planner shape also the WMMA kernel's time on the same
                inputs (the kernel it
                replaced), the GFLOP it multiplies, and its stream-K schedule
                (tiles, k-steps, blocks in clusters of two, waves, fill).

Prints the card line, one JSON line of the train phase and one of
kernels, then, as the last line,
{"ok": true, "device": {...}}. Exits non-zero without a CUDA device.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.nn.functional as F

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.step import make_train_step
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State

# the mask kernel's cases, shared with its GPU and CPU tests
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_mask_cases import MASK_CASES, mask_case  # noqa: E402
from torch_train_small import (  # noqa: E402
    EVAL_TOL,
    GRAD_TOL_DEVICES,
    TRAIN,
    TRAIN_TOL,
    bench_batch,
    eval_kernel_vs_plain,
    train_step_parity,
)

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
CELL_SRC = "robot_aware_control_tpu_torch/csrc/conv_lstm_cell_sm90.cu"
CELL_REPLACES = "robot_aware_control_tpu/ops/pallas_kernels.py:146"
PLANNER_CELLS = [(100, 6, 8, 256, 256, 5), (100, 6, 8, 256, 256, 3)]
# the trainer's eval epoch: B = test_batch_size = 16, 24 output tiles
# for 132 persistent blocks, another stream-K split than the planner's
EVAL_CELLS = [(16, 6, 8, 256, 256, 5), (16, 6, 8, 256, 256, 3)]


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
def check_masks(dev):
    for name in MASK_CASES:
        segs, h, w = mask_case(name, dev)
        got = kernels.capsule_mask_render(segs, h, w)
        want = kernels.capsule_mask_render_plain(segs, h, w)
        torch.cuda.synchronize()
        differ = int((got != want).sum())
        M, S = segs.shape[:2]
        print(f"masks {name} M={M} S={S} {h}x{w}: {differ} pixels differ, "
              f"{float(want.mean()) if M else 0.0:.4f} of pixels inside")
        if differ or got.shape != (M, h, w):
            raise AssertionError(f"mask kernel differs from plain on {name}")
    return 0.0


def cell_inputs(B, H, W, Cx, C, k, dtype, dev, seed):
    g = torch.Generator().manual_seed(seed)
    x, h, c = (torch.randn(B, H, W, n, generator=g) for n in (Cx, C, C))
    w = torch.randn(k, k, Cx + C, 4 * C, generator=g) * 0.02
    b = torch.randn(4 * C, generator=g) * 0.1
    return ([t.to(dev, dtype) for t in (x, h, c, w)] + [b.to(dev)])


def cell_err(got, want, tol):
    err = 0.0
    for g, w in zip(got, want):
        torch.testing.assert_close(g.float(), w.float(), rtol=tol, atol=tol)
        err = max(err, float((g.float() - w.float()).abs().max()))
    return err


def check_cells(dev):
    """Max |kernel - plain| by (shape, path). Paths: "sm90" (wgmma/TMA, the
    planner's), "wmma" (the kernel it replaced, called by name), "f32"."""
    errs = {}
    # the planner's two cells, the trainer's eval cells, then odd shapes:
    # 24/40 channels take the wgmma/TMA kernel in bf16 (a partial channel
    # tile, a 5x7 map), 13/20 the WMMA kernel's element-wise loads
    shapes = PLANNER_CELLS + EVAL_CELLS + [(3, 5, 7, 24, 40, 5),
                                           (2, 6, 8, 13, 20, 3)]
    for shape in shapes:
        for dtype in (torch.bfloat16, torch.float32):
            args = cell_inputs(*shape, dtype, dev, seed=sum(shape))
            want = kernels.conv_lstm_cell_plain(*args)
            tol = CELL_TOL[dtype]
            sm90 = kernels.takes_sm90(*args[:4])
            if (dtype == torch.bfloat16 and shape in PLANNER_CELLS + EVAL_CELLS
                    and not sm90):
                raise AssertionError(f"{shape} bf16 does not take sm90")
            runs = {"sm90" if sm90 else "wmma" if dtype == torch.bfloat16
                    else "f32": kernels.conv_lstm_cell}
            if sm90:
                runs["wmma"] = kernels.conv_lstm_cell_wmma
            for path, fn in runs.items():
                before = kernels.launches["conv_lstm_cell_sm90"]
                got = fn(*args)
                if (kernels.launches["conv_lstm_cell_sm90"] - before
                        != (path == "sm90")):
                    raise AssertionError(f"{shape} {dtype}: {path} expected")
                err = errs[(shape, path)] = cell_err(got, want, tol)
                print(f"cell B,H,W,Cx,C,k={shape} {dtype} {path}: max "
                      f"|kernel - plain| = {err:.3g} (tolerance {tol} abs + rel)")
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
    cells = 4 * (cfg.horizon - 1) * cfg.opt_iter
    want = {"conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
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
    segs, h, w = mask_case("planner_500", dev)
    M, S = segs.shape[:2]
    # the same launch with every (tile, capsule) test culled (the capsules
    # moved 1000 px right of the image) and with none culled (radii of
    # 1000 px): the kernel's cost without its tests and with all of them
    culled, dense_segs = segs.clone(), segs.clone()
    culled[..., 0] += 1000.0
    culled[..., 2] += 1000.0
    dense_segs[..., 4:] = 1000.0
    for s, value in ((culled, 0.0), (dense_segs, 1.0)):
        got = kernels.capsule_mask_render(s, h, w)
        if not (torch.equal(got, kernels.capsule_mask_render_plain(s, h, w))
                and bool((got == value).all())):
            raise AssertionError("mask kernel wrong on the timing variants")
    render = lambda s: (lambda: kernels.capsule_mask_render(s, h, w))
    # turns: planner, every tile culled, none culled, planner
    ms = [cuda_ms(render(segs), n=200)]
    all_culled = cuda_ms(render(culled), n=200)
    none_culled = cuda_ms(render(dense_segs), n=200)
    ms.append(cuda_ms(render(segs), n=200))
    plain = cuda_ms(lambda: kernels.capsule_mask_render_plain(segs, h, w))
    # a yardstick for the write alone: PyTorch filling an output of this size
    out = torch.empty(M, h, w, device=dev)
    fill = cuda_ms(lambda: out.fill_(0.0), n=200)
    # 24 float32 operations per pixel and capsule (one of them a division)
    # plus 5 per capsule. The work these inputs need: the tests of the pixel
    # centres inside a capsule's box grown by its larger radius (no margin,
    # no tiles); outside it every test misses. Dense: every test.
    au, av, bu, bv, ra, rb = segs.unbind(-1)
    grow = torch.maximum(ra.abs(), rb.abs())
    px = torch.arange(w, device=dev) + 0.5
    py = torch.arange(h, device=dev) + 0.5

    def inside(p, a, b):
        lo = (torch.minimum(a, b) - grow)[..., None]
        hi = (torch.maximum(a, b) + grow)[..., None]
        return ((p >= lo) & (p <= hi)).sum(-1)

    needed = int((inside(px, au, bu) * inside(py, av, bv)).sum())
    ops = 24 * needed + 5 * M * S
    dense = 24 * M * S * h * w + 5 * M * S
    bound, by = bound_ms(ops, PEAK_F32, segs.numel() * 4 + M * h * w * 4)
    rows, cols = kernels.MASK_TILE
    # the kernel's skip rule replayed in PyTorch, not counted on the card
    kept = kernels.capsule_mask_tests_kept(segs, h, w).float().mean().item()
    ptxas = ptxas_info("capsule_mask")
    print(f"mask M={M} S={S} {h}x{w}: kernel {np.mean(ms):.5f} ms "
          f"({', '.join(f'{v:.5f}' for v in ms)}), every tile culled "
          f"{all_culled:.5f} ms, none culled {none_culled:.5f} ms, plain "
          f"{plain:.4f} ms, fill_ of the output {fill:.5f} ms, bound "
          f"{bound:.5f} ms ({by}; {ops / 1e9:.4f} G operations the inputs "
          f"need, {dense / 1e9:.4f} G dense); share of the tests the skip "
          f"rule keeps on {rows}x{cols} tiles, replayed in PyTorch: "
          f"{kept:.4f} (pixel centres inside a capsule's box: "
          f"{needed / (M * S * h * w):.4f})")
    print("ptxas, capsule_mask.cu: " + ptxas)
    return dict(name="capsule_mask_render", route="cuda", source=MASK_SRC,
                replaces="robot_aware_control_tpu/ops/pallas_kernels.py:57",
                launches=launches, max_abs_err=err, ms=float(np.mean(ms)),
                ms_runs=ms, plain_ms=plain, bound_ms=bound, bound_by=by,
                library_ms=None, fill_ms=fill, ms_all_culled=all_culled,
                ms_none_culled=none_culled, gops=ops / 1e9,
                gops_dense=dense / 1e9, ptxas=ptxas)


def ptxas_info(lib: str) -> str:
    """Registers and spills of each kernel in `lib`, from ptxas -v output
    captured by this process's build ("" if it did not build here)."""
    out = kernels.build_log.get(lib, {}).get("output", "")
    regs = [l.split("info    : ")[-1] for l in out.splitlines()
            if "Used" in l and "registers" in l]
    spills = [l.strip() for l in out.splitlines() if "spill stores" in l]
    losses = [l.split("info    : ")[-1][:90] for l in out.splitlines()
              if "Performance Loss" in l]
    return "; ".join([f"{r} ({sp})" for r, sp in zip(regs, spills)] + losses)


def time_cell(dev, launches, errs):
    """The planner launches cell0 (k=5) and cell1 (k=3) equally often, so
    the per-launch numbers are the mean of the two shapes. The WMMA kernel
    the planner took before runs on the same inputs in the same call. The
    trainer's eval shapes (B = 16) are timed too, and reported apart."""
    rows = []
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for shape in PLANNER_CELLS + EVAL_CELLS:
        B, H, W, Cx, C, k = shape
        x, h, c, w, b = cell_inputs(B, H, W, Cx, C, k, torch.bfloat16, dev, 7)
        # turns: WMMA, wgmma, wgmma, WMMA
        wmma = [cuda_ms(lambda: kernels.conv_lstm_cell_wmma(x, h, c, w, b))]
        ms = [cuda_ms(lambda: kernels.conv_lstm_cell(x, h, c, w, b))
              for _ in range(2)]
        wmma.append(cuda_ms(lambda: kernels.conv_lstm_cell_wmma(x, h, c, w, b)))
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
        s = kernels.sm90_schedule(B, H, W, Cx, C, k, dev)
        multiplied = s["steps"] * 2.0 * 128 * 256 * 64
        per_block = -(-s["steps"] // s["grid"])
        row = dict(B=B, k=k, ms=float(np.mean(ms)), ms_runs=ms,
                   wmma_ms=float(np.mean(wmma)), wmma_ms_runs=wmma,
                   plain_ms=plain, library_ms=lib, bound_ms=bound,
                   bound_by=by, gflop=ops / 1e9,
                   gflop_multiplied=multiplied / 1e9,
                   gflop_dense=2.0 * B * H * W * k * k * (Cx + C) * 4 * C / 1e9,
                   tiles=s["tiles"], blocks=s["grid"], steps=s["steps"],
                   waves=s["grid"] / sms,
                   fill=s["steps"] / (s["grid"] * per_block),
                   max_abs_err=errs[(shape, "sm90")])
        rows.append(row)
        print(f"cell B={B} k={k} bf16: wgmma/TMA kernel {row['ms']:.4f} ms "
              f"({', '.join(f'{v:.4f}' for v in ms)}), WMMA kernel "
              f"{row['wmma_ms']:.4f} ms ({', '.join(f'{v:.4f}' for v in wmma)}), "
              f"plain {plain:.4f} ms, cuDNN gate conv {lib:.4f} ms, bound "
              f"{bound:.4f} ms ({by}, {row['gflop']:.1f} GFLOP without the "
              f"zero border, {row['gflop_dense']:.1f} dense, "
              f"{row['gflop_multiplied']:.1f} multiplied = "
              f"{multiplied / row['ms'] / 1e9:.0f} TFLOP/s); {s['tiles']} "
              f"tiles, {s['steps']} k-steps on {s['grid']} blocks over {sms} "
              f"SMs ({row['waves']:.2f} waves, fill {row['fill']:.4f})")
    ptxas = ptxas_info("conv_lstm_cell_sm90")
    print("ptxas, wgmma/TMA kernel: " + ptxas)
    print("ptxas, conv_lstm_cell.cu: " + ptxas_info("conv_lstm_cell"))
    plan, ev = rows[:len(PLANNER_CELLS)], rows[len(PLANNER_CELLS):]
    mean = lambda key, rs=plan: sum(r[key] for r in rs) / len(rs)
    return dict(name="conv_lstm_cell_sm90", route="cuda", source=CELL_SRC,
                replaces=CELL_REPLACES, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=mean("ms"), plain_ms=mean("plain_ms"),
                bound_ms=mean("bound_ms"),
                bound_by=rows[0]["bound_by"], library_ms=mean("library_ms"),
                wmma_ms=mean("wmma_ms"), ptxas=ptxas, per_shape=rows,
                eval_shapes=dict(ms=mean("ms", ev), bound_ms=mean("bound_ms", ev),
                                 plain_ms=mean("plain_ms", ev),
                                 library_ms=mean("library_ms", ev),
                                 max_abs_err=max(r["max_abs_err"] for r in ev)))


# ----------------------------------------------------------------- train
def check_train_parity():
    """One small float32 train step and one eval step on the GPU against
    the same on the CPU (tests/torch_train_small.py:train_step_parity)."""
    errs, launched = train_step_parity()
    print("small f32 train step, GPU vs CPU: " + ", ".join(
        f"{k} {v:.3g}" for k, v in errs.items())
        + f" (tolerance {TRAIN_TOL}; gradients {GRAD_TOL_DEVICES} of each "
        f"leaf's norm); GPU eval step: {launched['cuda'][1]['conv_lstm_cell']}"
        " float32 cell launches, train step none")
    return errs


def check_eval_kernel():
    """The trainer's full-width bf16 eval step (B = 16) with the cell
    kernel against the same step with the kernel's plain version
    (tests/torch_train_small.py:eval_kernel_vs_plain)."""
    result = eval_kernel_vs_plain()
    for mode, r in result.items():
        print(f"full-width bf16 eval step ({mode}), kernel vs plain cell: "
              f"predictions {r['preds']:.3g}, metrics {r['metrics']:.3g} of "
              f"their max (tolerance {EVAL_TOL}); "
              f"{r['launched']['conv_lstm_cell_sm90']} sm90 launches")
    return result


def train_step_timing(dev):
    """The bench.py training config at batch 128 for each remat mode: 2
    warm-up and 5 timed steps (host clock, each ending in a sync), peak
    memory, 0 kernel launches, one profiled step; the FLOP count of a step (torch's FlopCounterMode: convolutions forward
    and backward, counted from their shapes)."""
    from torch.utils.flop_counter import FlopCounterMode

    rows, profiles = {}, {}
    flops = None
    for mode in ("none", "full", "conv"):
        cfg = Config(**dict(TRAIN, remat=mode != "none",
                            remat_policy="full" if mode == "none" else mode))
        model = svg.init(cfg, seed=0, device=dev, train=True)
        step, _ = make_train_step(cfg, model)
        batch = bench_batch(cfg, cfg.batch_size, 0, dev)
        gen = torch.Generator(dev).manual_seed(0)
        kernels.reset_launches()
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        seconds, losses = [], []
        for i in range(7):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            losses.append(float(step(batch, 1.0, gen)["loss"]))
            torch.cuda.synchronize()
            if i >= 2:
                seconds.append(time.perf_counter() - t0)
        if any(kernels.launches.values()):
            raise AssertionError(f"train steps launched {kernels.launches}")
        if not all(np.isfinite(losses)):
            raise AssertionError(f"remat {mode}: loss {losses}")
        med = statistics.median(seconds)
        window = cfg.n_past + cfg.n_future
        rows[mode] = dict(step_s=med, step_s_runs=seconds,
                          frames_per_s=cfg.batch_size * window / med,
                          peak_gb=torch.cuda.max_memory_allocated() / 1e9,
                          loss=losses[-1])
        print(f"train remat {mode}: step {med:.4f} s (median of 5: "
              + ", ".join(f"{v:.4f}" for v in seconds)
              + f"), {rows[mode]['frames_per_s']:.1f} frames/s, peak "
              f"{rows[mode]['peak_gb']:.2f} GB, loss {losses[0]:.4f} -> "
              f"{losses[-1]:.4f}, 0 kernel launches")
        if mode == "none":
            with FlopCounterMode(display=False) as fc:
                step(batch, 1.0, gen)
            flops = fc.get_total_flops()
        profiles[mode] = profile_train_step(step, batch, gen, mode)
        del model, step, batch
        torch.cuda.empty_cache()
    bound = flops / PEAK_BF16 * 1e3
    print(f"train step: {flops / 1e12:.3f} TFLOP (convolutions and cells, "
          f"forward and backward) = bound {bound:.2f} ms at "
          f"{PEAK_BF16 / 1e12:.0f} TFLOP/s bf16; the steps take "
          + ", ".join(f"{m} {r['step_s'] * 1e3 / bound:.1f}x"
                      for m, r in rows.items()) + " of it")
    for mode, r in rows.items():
        r["profile"] = profiles[mode]
    return rows, dict(tflop=flops / 1e12, bound_ms=bound)


def profile_train_step(step, batch, gen, mode):
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(batch, 1.0, gen)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    rows = sorted(((e.device_time_total / 1e3, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  reverse=True)
    busy = sum(r[0] for r in rows)
    if not busy:
        print("profiler recorded no device time: busy share not measured")
        return None
    print(f"profiled train step (remat {mode}): {wall:.1f} ms wall (profiler "
          f"on), device busy {busy:.1f} ms = {busy / wall:.1%}")
    for ms, n, key in rows[:10]:
        print(f"  {ms:9.2f} ms {ms / busy:6.1%} {n:5d}x  {key[:100]}")
    return dict(wall_ms=wall, busy_ms=busy, busy_share=busy / wall,
                top=[dict(ms=ms, count=n, kernel=key[:100])
                     for ms, n, key in rows[:10]])


def check_trainer():
    """PredictionTrainer at full width (g_dim 256, z_dim 64, bf16) on the
    synthetic experiment: one epoch of 2 videos, its eval epoch through
    the wgmma/TMA cell kernel, a checkpoint, and a resume from it."""
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory(dir=here) as d:
        cfg = Config(**dict(TRAIN, experiment="synthetic", batch_size=32,
                            test_batch_size=16, niter=1, epoch_size=2,
                            video_length=31, n_eval=10, eval_interval=1,
                            checkpoint_interval=1, log_dir=d, jobname="smoke"))
        tr = PredictionTrainer(cfg)
        kernels.reset_launches()
        t0 = time.perf_counter()
        tr.train()
        seconds = time.perf_counter() - t0
        launched = dict(kernels.launches)
        eval_batches = 2  # the synthetic test set, cfg.eval_batches = 0
        cells = (6 * (cfg.n_eval - 1) * (cfg.video_length // cfg.n_eval) * 2
                 * eval_batches)
        if launched != {"conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
                        "capsule_mask_render": 0}:
            raise AssertionError(f"trainer launched {launched}, expected "
                                 f"{cells} cells, all through sm90")
        path = ckpt.latest_checkpoint(tr.log_dir)
        windows = cfg.epoch_size * (cfg.video_length // 6)
        if tr._step != windows or not path.endswith(f"ckpt_{windows}.npz"):
            raise AssertionError(f"trainer at step {tr._step}, saved {path}")
        tr2 = PredictionTrainer(cfg)
        tr2._resume()
        if tr2._step != tr._step:
            raise AssertionError(f"resumed at {tr2._step}, saved {tr._step}")
        with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
            recs = [json.loads(line) for line in f]
        tr.logger.close()
        tr2.logger.close()
    train = next(r for r in recs if "train/loss" in r)
    ev = next(r for r in recs if "eval/autoreg_psnr" in r)
    if not all(np.isfinite(v) for r in (train, ev) for v in r.values()):
        raise AssertionError(f"non-finite trainer metrics {train} {ev}")
    out = dict(seconds=seconds, steps=tr._step, checkpoint=os.path.basename(path),
               resumed_step=tr2._step, cell_launches=launched["conv_lstm_cell"],
               sm90_launches=launched["conv_lstm_cell_sm90"],
               frames_per_s=train["train/frames_per_sec"],
               loss=train["train/loss"],
               autoreg_psnr=ev["eval/autoreg_psnr"],
               autoreg_ssim=ev["eval/autoreg_ssim"])
    print(f"trainer: {out['steps']} steps and an eval epoch in {seconds:.1f} s "
          f"({out['frames_per_s']:.1f} frames/s over the epoch, data "
          f"generation included), {cells} cell launches in the eval epoch, "
          f"all through sm90; wrote {out['checkpoint']}, resumed at step "
          f"{tr2._step}; loss {out['loss']:.4f}, autoregressive PSNR "
          f"{out['autoreg_psnr']:.2f}, SSIM {out['autoreg_ssim']:.4f}")
    return out


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
    print(f"built {sorted(kernels.SOURCES)} in {time.perf_counter() - t:.1f} s "
          "(one nvcc each, in parallel; seconds until each was done: "
          + ", ".join(f"{n} {v['seconds']:.1f}"
                      for n, v in kernels.build_log.items()) + ")")

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
        time_cell(dev, launches["conv_lstm_cell_sm90"], cell_errs),
    ]}

    # training: the train step runs no hand kernel; the trainer's eval
    # epoch runs the cell kernel
    phase("train")
    parity = check_train_parity()
    eval_kernel = check_eval_kernel()
    modes, flops = train_step_timing(dev)
    trainer = check_trainer()
    line["kernels"][1]["launches_trainer_eval"] = trainer["cell_launches"]
    print(card)
    print(json.dumps({"train": {"card": card, "parity": parity,
                                "eval_kernel_vs_plain": eval_kernel,
                                "remat": modes, "flops": flops,
                                "trainer": trainer}}))
    print(json.dumps(line))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
