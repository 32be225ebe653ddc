"""The training checks that run on the card as well as on the CPU (not a
test module; imports no JAX): the training config of bench.py, the small
float32 config cut from it, a bench.py-style batch, the prior offset, the
tolerances, and two device checks that chip_smoke.py and
tests/test_torch_port_gpu.py both run:

  * `train_step_parity`: one small float32 train step and one eval step on
    the GPU against the same on the CPU (same weights, window and draws);
  * `eval_kernel_vs_plain`: the full-width bf16 eval step (the trainer's,
    g_dim 256, B = test_batch_size = 16, n_eval 10) with the cell kernel
    against the same step with the kernel's plain version in its place.

tests/torch_train_cases.py cuts the small config to 24x32 frames for the
CPU tests against the JAX package."""

import contextlib

import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.training.step import (
    draw_noise,
    make_eval_step,
    make_train_step,
)

TRAIN = dict(  # bench.py:136-156
    model="svg", g_dim=256, z_dim=64, image_height=48, image_width=64,
    action_dim=5, robot_dim=5, robot_joint_dim=5, n_past=1, n_future=5,
    batch_size=128, model_use_mask=True, model_use_future_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    scheduled_sampling=True, compute_dtype="bfloat16", remat=True,
    remat_policy="conv",
)
# cut to g_dim 16, z_dim 4, batch 2, window 4, float32; sgd at lr 1 so that
# a step's parameter change is minus its gradient
TRAIN_SMALL = dict(TRAIN, g_dim=16, z_dim=4, batch_size=2, n_future=3,
                   n_eval=4, compute_dtype="float32", remat=False,
                   optimizer="sgd", lr=1.0)
# the prior's heads are offset so that the prior is unlike the posterior:
# at the reference's init both give nearly the same Gaussian, and their KL
# (a few 1e-5) and its gradient are float32 cancellations that differ
# between any two implementations by a percent
PRIOR_MU_BIAS, PRIOR_LOGVAR_BIAS = 0.3, -0.5

# Loss, metrics, BatchNorm statistics and eval outputs of the small float32
# step hold to 1e-4 relative (to each leaf's max for tensors). Its
# gradients are held to a share of each leaf's norm, set at about 3x the
# largest reading, because they are ill-conditioned in float32: a max pool
# routes its gradient to one entry of a window, and entries within rounding
# of each other route differently under another summation order, and
# BatchNorm's backward over 96-384 values a channel cancels.
TRAIN_TOL = 1e-4
# GPU vs CPU at 48x64 frames: readings 6.9e-3 and 7.8e-3 on the H100 (the
# same code on the CPU with oneDNN's convolutions on and off: 6.1e-3)
GRAD_TOL_DEVICES = 2e-2
# the port vs the JAX package at 24x32 frames: reading 1.5e-3
GRAD_TOL_JAX = 5e-3

# the full-width eval step, kernel vs plain cell, bf16: predictions (images
# in [0, 1]) and per-step metrics, max |difference| over the largest value;
# reading 5.2e-3 on the H100 (one bf16 step of the predictions), metrics
# 6.2e-5
EVAL_TOL = 1.5e-2


def bench_batch(cfg, B, seed, dev):
    """A window as bench.py:165-175 makes it: uniform images, masks with
    20% robot pixels, uniform states and actions."""
    g = torch.Generator().manual_seed(seed)
    W, h, w = cfg.n_past + cfg.n_future, cfg.image_height, cfg.image_width
    batch = {"images": torch.rand(W, B, h, w, 3, generator=g),
             "masks": (torch.rand(W, B, h, w, 1, generator=g) > 0.8).float(),
             "states": torch.rand(W, B, 5, generator=g),
             "actions": torch.rand(W - 1, B, 5, generator=g)}
    return {k: v.to(dev) for k, v in batch.items()}


@torch.no_grad()
def distinct_prior(model):
    """Offsets the prior's heads (see PRIOR_MU_BIAS)."""
    model.prior.mu.bias.fill_(PRIOR_MU_BIAS)
    model.prior.logvar.bias.fill_(PRIOR_LOGVAR_BIAS)


def max_rel(got, want):
    """max |got - want| / max |want| over a tensor."""
    got, want = got.double().cpu(), want.double().cpu()
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _to(tensors, dev):
    return {k: v.to(dev) for k, v in tensors.items()}


def train_step_parity(dev="cuda"):
    """One small float32 train step and one eval step on `dev` against the
    same on the CPU. Call with TF32 off. Returns the errors by kind (for
    gradients the worst leaf's norm and max errors) and the kernel launches
    of each side's train step and eval step; raises AssertionError with
    them past the tolerances or where the launches are not the expected
    ones."""
    cfg = Config(**TRAIN_SMALL)
    window = cfg.n_past + cfg.n_future
    batch = bench_batch(cfg, cfg.batch_size, 5, "cpu")
    noise = draw_noise(cfg, cfg.batch_size, window - 1,
                       torch.Generator().manual_seed(6), "cpu", 0.5)
    ebatch = bench_batch(cfg.replace(n_future=cfg.n_eval - 1),
                         cfg.batch_size, 7, "cpu")
    out, launched = {}, {}
    for d in ("cpu", dev):
        model = svg.init(cfg, seed=3, device=d, train=True)
        distinct_prior(model)
        step, _ = make_train_step(cfg, model)
        before = dict(kernels.launches)
        metrics = step(_to(batch, d), 0.5, noise=_to(noise, d))
        mid = dict(kernels.launches)
        grads = {n: p.grad.detach().cpu() for n, p in model.named_parameters()}
        bn = {n: b.cpu() for n, b in model.named_buffers()}
        per_step, preds = make_eval_step(cfg, model)(_to(ebatch, d),
                                                     noise=_to(noise, d))
        launched[str(d)] = (
            {k: mid[k] - before[k] for k in before},
            {k: kernels.launches[k] - mid[k] for k in before})
        out[str(d)] = (metrics, grads, bn, per_step, preds)
    (m0, g0, b0, e0, p0), (m1, g1, b1, e1, p1) = out["cpu"], out[str(dev)]
    errs = {
        "metrics": max(abs(float(m1[k]) - float(m0[k])) / abs(float(m0[k]))
                       for k in m0),
        "grads_norm": max(float((g1[k] - g0[k]).norm()
                                / g0[k].norm().clamp_min(1e-30)) for k in g0),
        "grads_max": max(max_rel(g1[k], g0[k]) for k in g0),
        "bn": max(max_rel(b1[k], b0[k]) for k in b0),
        "eval_metrics": max(max_rel(e1[k], e0[k]) for k in e0),
        "eval_preds": max_rel(p1, p0),
    }
    # the eval step on the card: its 6 cells a model step through the
    # float32 cell kernel; nothing else launches a kernel
    cells = 6 * (cfg.n_eval - 1)
    want = {"cpu": ({}, {}), str(dev): ({}, {"conv_lstm_cell": cells})}
    ok = (errs["grads_norm"] <= GRAD_TOL_DEVICES
          and all(v <= TRAIN_TOL for k, v in errs.items()
                  if not k.startswith("grads"))
          and all({k: v for k, v in t.items() if v} == w
                  for d, ts in launched.items() for t, w in zip(ts, want[d])))
    if not ok:
        raise AssertionError(f"{dev} train/eval step differs from the CPU's "
                             f"or launched other kernels than {want}: {errs} "
                             f"{launched}")
    return errs, launched


@contextlib.contextmanager
def plain_cells():
    """The cell kernel's wrapper replaced by its plain version."""
    kernel = kernels.conv_lstm_cell
    kernels.conv_lstm_cell = kernels.conv_lstm_cell_plain
    try:
        yield
    finally:
        kernels.conv_lstm_cell = kernel


def eval_kernel_vs_plain(dev="cuda"):
    """The trainer's eval step at full width (TRAIN with n_eval 10, batch
    test_batch_size = 16, bf16, weights from a seed, injected noise), each
    mode (autoregressive and one-step) once with the cell kernel and once
    with its plain version in its place. Returns, by mode, the kernel
    launches of the kernel run and the errors of predictions and metrics;
    raises AssertionError past EVAL_TOL or if a launch missed sm90."""
    cfg = Config(**dict(TRAIN, n_eval=10))
    B = cfg.test_batch_size
    model = svg.init(cfg, seed=4, device=dev, train=True)
    batch = bench_batch(cfg.replace(n_future=cfg.n_eval - 1), B, 8, dev)
    noise = draw_noise(cfg, B, cfg.n_eval - 1,
                       torch.Generator().manual_seed(9), "cpu")
    noise = _to(noise, dev)
    cells = 6 * (cfg.n_eval - 1)
    result = {}
    for mode in ("autoreg", "one_step"):
        step = make_eval_step(cfg, model, autoregressive=mode == "autoreg")
        before = dict(kernels.launches)
        m1, p1 = step(batch, noise=noise)
        launched = {k: kernels.launches[k] - before[k] for k in before}
        with plain_cells():
            m0, p0 = step(batch, noise=noise)
        errs = {"preds": max_rel(p1, p0),
                "metrics": max(max_rel(m1[k], m0[k]) for k in m0)}
        result[mode] = dict(launched=launched, **errs)
        if launched != {"conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
                        "capsule_mask_render": 0}:
            raise AssertionError(f"eval step {mode} launched {launched}, "
                                 f"expected {cells} cells, all through sm90")
        if not (max(errs.values()) <= EVAL_TOL
                and all(bool(torch.isfinite(v).all()) for v in m1.values())):
            raise AssertionError(f"eval step {mode}, kernel vs plain cell: "
                                 f"{errs} (tolerance {EVAL_TOL})")
    return result
