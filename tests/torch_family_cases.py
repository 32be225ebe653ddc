"""The other model families (svg_vec, det_vec, cdna_det, cdna_robonet) and
the inverse model, as checks that run on the card as well as on the CPU
(not a test module; imports no JAX), shared by chip_smoke.py and
tests/test_torch_port_gpu.py:

  * `FAMILIES`: the families' names; `family_fields` the config fields a
    family sets on top of a planning or training config (`small=True`:
    the 1-layer, 32-unit fc-LSTM stacks of tests/test_model_families.py;
    else the JAX defaults, rnn_size 256 and 2 layers);
  * `small_plan_parity`: a small float32 plan on the GPU against the CPU's
    (torch_variant_cases.small_plan_parity with the family's fields);
  * `train_step_parity`: the small float32 train and eval step, GPU
    against CPU (torch_train_small.small_steps), the vector models with
    channel dropout on, so that their drawn keep masks ride along;
  * `debug_cem_frames`: the frames a debug_cem plan hands `save_gif`;
  * the inverse model (models/inverse_model.py): `inverse_step_parity`,
    one Adam step on the GPU against the CPU's, and `inverse_learns`,
    a few steps at a batch whose loss must fall.
"""

from __future__ import annotations

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import inverse_model
from robot_aware_control_tpu_torch.training import plot
from torch_train_small import (
    GRAD_TOL_DEVICES,
    TRAIN_SMALL,
    TRAIN_TOL,
    cells_per_step,
    grad_errors,
    max_rel,
    small_steps,
)
from torch_variant_cases import small_plan_parity as _small_plan_parity

FAMILIES = ("svg_vec", "det_vec", "cdna_det", "cdna_robonet")
SMALL_STACKS = dict(rnn_size=32, prior_rnn_layers=1, posterior_rnn_layers=1,
                    predictor_rnn_layers=1)
# the vector encoder's channel dropout in the small train steps
DROPOUT = 0.1
# the vector models' small train steps take batch 8: their encoder's c5
# BatchNorm normalises B values a channel (a 1x1 map), and at
# torch_train_small's B = 2 it puts out about +-1 whatever its input, so
# the gradient of c5's convolution lives in BatchNorm's eps alone (det_vec,
# an H100 80GB HBM3 against the CPU: 1.83e-2 of its norm; oneDNN against
# the CPU's plain convolutions 2.9e-2; at B = 8 the worst leaf reads
# 6.7e-3 there, and 7.3e-3 on that card, svg_vec's 9.4e-3)
VECTOR_TRAIN_BATCH = 8


def family_fields(name: str, small: bool = True, train: bool = False) -> dict:
    """The config fields of a family: the model and, small, the small
    fc-LSTM stacks; with `train` a vector model's channel dropout and
    batch (VECTOR_TRAIN_BATCH)."""
    fields = dict(model=name, **(SMALL_STACKS if small else {}))
    if train and name.endswith("_vec"):
        fields.update(dropout=DROPOUT, batch_size=VECTOR_TRAIN_BATCH)
    return fields


def small_plan_parity(name: str, dev="cuda"):
    """The family's small float32 plan (torch_variant_cases.SMALL, seed-3
    weights, injected action noise, the prior's mean) on `dev` against
    the CPU's to PLAN_TOL, with `plan_launches`' counts. Call with TF32
    off. Returns (max |difference|, the launches)."""
    return _small_plan_parity(name, dev, fields=family_fields(name))


# the vector models' convolutions whose output a train-mode BatchNorm
# normalises: the batch mean takes their bias out, whose gradient is zero
# but for rounding on either device (a relative check of it read noise on
# an H100 80GB HBM3 at 700 W: 1.9 of its norm, card against CPU)
BN_FED_BIASES = ("encoder.c5.conv.bias", "decoder.upc1.conv.bias")

def train_step_parity(name: str, dev="cuda"):
    """One small float32 train step and one eval step of the family on
    `dev` against the CPU's (torch_train_small.small_steps: the same
    weights, window and draws, dropout masks included; svg_vec's prior and
    CDNA's kernel MLP offset): metrics, eval outputs and BatchNorm
    statistics to TRAIN_TOL (a running mean's error over the largest
    running standard deviation of its BatchNorm: det_vec's decoder upc1
    takes a batch mean of a few 1e-7, a cancellation, and relative to its
    own largest value an H100 80GB HBM3's read 2.15e-4 against the CPU's,
    oneDNN's against the CPU's plain convolutions 4.9e-4), gradients to GRAD_TOL_DEVICES of each leaf's norm but for
    BN_FED_BIASES, whose gradients must be under 1e-5 of the largest
    leaf's norm on both devices; the eval step's cells (CDNA) through the
    float32 kernel. Call with TF32 off. Returns the errors and the
    launches; raises AssertionError past a limit."""
    fields = family_fields(name, train=True)
    cfg = Config(**dict(TRAIN_SMALL, **fields))
    out, launched = {}, {}
    for d in ("cpu", dev):
        out[str(d)], launched[str(d)] = small_steps(d, **fields)
    (m0, g0, b0, e0, p0), (m1, g1, b1, e1, p1) = out["cpu"], out[str(dev)]
    largest = max(float(g.norm()) for g in g0.values())
    vanishing = {k: max(float(g0[k].norm()), float(g1[k].norm())) / largest
                 for k in BN_FED_BIASES if k in g0}
    grads = {k: v for k, v in grad_errors(g1, g0).items() if k not in vanishing}

    def bn_err(k):
        if not k.endswith("running_mean"):
            return max_rel(b1[k], b0[k])
        std = b0[k.replace("running_mean", "running_var")].sqrt().max()
        return float((b1[k] - b0[k]).abs().max() / std)

    errs = {
        "metrics": max(abs(float(m1[k]) - float(m0[k])) / abs(float(m0[k]))
                       for k in m0),
        "grads_norm": max(grads.values()),
        "grads_max": max(max_rel(g1[k], g0[k]) for k in grads),
        "bn": max(bn_err(k) for k in b0),
        "eval_metrics": max(max_rel(e1[k], e0[k]) for k in e0),
        "eval_preds": max_rel(p1, p0),
    }
    if vanishing:
        errs["bn_fed_bias_grads"] = max(vanishing.values())
    cells = cells_per_step(cfg) * (cfg.n_eval - 1)
    want = ({"conv_lstm_cell": cells, "conv_lstm_cell_f32": cells}
            if cells and torch.device(dev).type == "cuda" else {})
    got = {k: v for k, v in launched[str(dev)][1].items() if v}
    ok = (errs["grads_norm"] <= GRAD_TOL_DEVICES
          and errs.get("bn_fed_bias_grads", 0.0) <= 1e-5
          and all(v <= TRAIN_TOL for k, v in errs.items()
                  if k in ("metrics", "bn", "eval_metrics", "eval_preds"))
          and got == want
          and not any(v for t in launched["cpu"] for v in t.values())
          and not any(launched[str(dev)][0].values()))
    if not ok:
        raise AssertionError(f"{name}: {dev} train/eval step differs from the "
                             f"CPU's or launched other kernels than {want}: "
                             f"{errs} {launched}")
    return errs, launched


def debug_cem_frames(policy, start, goal, ep_num=0, step=0):
    """Plans with the policy (whose config has debug_cem on) and returns
    (the plan, the frames handed to `save_gif`, its return value: the
    path, or None without imageio). The real save_gif runs."""
    seen = []
    save_gif = plot.save_gif

    def record(path, frames, fps=2):
        seen.append((frames, save_gif(path, frames, fps)))
        return seen[-1][1]

    plot.save_gif = record
    try:
        plan = policy.get_action(start, goal, ep_num=ep_num, step=step)
    finally:
        plot.save_gif = save_gif
    (frames, path), = seen
    return plan, frames, path


# ------------------------------------------------------------ inverse model
# the JAX tests' config (tests/test_collect_inverse.py): 2-d actions
INVERSE = dict(action_dim=2, channels=3)
INVERSE_HORIZON = 3


def inverse_batch(B, h, w, horizon=INVERSE_HORIZON, seed=0, dev="cpu",
                  discretized=False):
    """Start and goal frames U(0, 1) (B, h, w, 3) and actions (B, horizon,
    2): U(0, 1), or U(-1, 1) for the discretized head, float32."""
    r = np.random.RandomState(seed)
    start, goal = (torch.tensor(r.rand(B, h, w, 3).astype(np.float32))
                   for _ in range(2))
    lo = -1.0 if discretized else 0.0
    acts = torch.tensor(r.uniform(lo, 1.0, (B, horizon, 2)).astype(np.float32))
    return start.to(dev), goal.to(dev), acts.to(dev)


def inverse_step_parity(dev="cuda", discretized=False, bins=5):
    """One Adam step of the inverse model (seed-0 weights, a batch of 8 at
    48x64) on `dev` against the same on the CPU: the losses and every
    parameter after the step to TRAIN_TOL of its max. Call with TF32 off.
    Returns the errors; raises AssertionError past the limit."""
    cfg = Config(**INVERSE)
    out = {}
    for d in ("cpu", dev):
        model = inverse_model.init(cfg, INVERSE_HORIZON, discretized=discretized,
                                   bins=bins if discretized else 0, device=d)
        step, _ = inverse_model.make_inverse_train_step(
            cfg, INVERSE_HORIZON, model, discretized=discretized, bins=bins)
        loss = step(*inverse_batch(8, 48, 64, dev=d, discretized=discretized))
        out[str(d)] = (float(loss), {n: p.detach().cpu()
                                     for n, p in model.named_parameters()})
    (l0, p0), (l1, p1) = out["cpu"], out[str(dev)]
    errs = {"loss": abs(l1 - l0) / abs(l0),
            "params": max(max_rel(p1[k], p0[k]) for k in p0)}
    if not max(errs.values()) <= TRAIN_TOL:
        raise AssertionError(f"inverse model step on {dev} differs from the "
                             f"CPU's: {errs} (tolerance {TRAIN_TOL})")
    return errs


def inverse_learns(dev="cuda", B=128, steps=20, h=48, w=64):
    """`steps` Adam steps (lr 1e-3) of the inverse model on one fixed batch
    of B at h x w: the loss must fall. Returns the losses."""
    cfg = Config(**INVERSE)
    model = inverse_model.init(cfg, INVERSE_HORIZON, device=dev)
    step, _ = inverse_model.make_inverse_train_step(cfg, INVERSE_HORIZON, model)
    batch = inverse_batch(B, h, w, dev=dev)
    losses = [step(*batch) for _ in range(steps)]
    losses = [float(v) for v in losses]
    if not (np.all(np.isfinite(losses)) and losses[-1] < losses[0]):
        raise AssertionError(f"inverse model losses {losses}")
    return losses
