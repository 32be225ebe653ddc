"""Whole-window training and evaluation steps (counterpart of
`robot_aware_control_tpu/training/step.py`; reference:
src/prediction/trainer.py:326-465, 566-734).

One call of a train step is one window and one optimizer step, as in the
JAX package: scheduled sampling (one Bernoulli per step for the whole
batch, ground truth at the first step), robot-pixel blackout of the model
inputs when a dontcare loss or black_robot_input is active, future-mask
conditioning (duplicated at the target step), the skip frozen after n_past
frames, the composite with the un-blacked input, loss = Σ recon + β Σ KL,
metrics divided by n_future. The JAX step is one `lax.scan`; here a Python
loop over the window's steps queues the same work, and the device
arrays never come back to the host inside a step.

Training runs the autograd ConvLSTM cell, as the JAX train step runs the
XLA cell; the eval step runs the hand kernel (`cfg.fused_lstm`).

Remat (`cfg.remat`) checkpoints each step of the window: "full" recomputes
the step in the backward pass, "conv" saves the convolutions' outputs and
recomputes the rest (selective checkpointing), as `step.py:264-281` does
with `jax.checkpoint`. Recomputation replays the forward, so nothing in a
step draws random numbers or updates state: the draws of a window come
from `draw_noise` before it, and BatchNorm's updates are returned by each
step and applied once after the backward pass.
"""

from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models.common import composite, skip_zeros
from robot_aware_control_tpu_torch.models.registry import get_model
from robot_aware_control_tpu_torch.models.svg import compute_dtype
from robot_aware_control_tpu_torch.ops import losses as L
from robot_aware_control_tpu_torch.ops import metrics as M
from robot_aware_control_tpu_torch.ops.nn import apply_batch_stats


class OptaxRMSprop(torch.optim.Optimizer):
    """`optax.rmsprop(lr)` at its defaults, which `torch.optim.RMSprop`'s
    differ from (alpha 0.99, eps outside the square root):
    nu = decay * nu + (1 - decay) * g^2 from nu = 0, then
    p -= lr * g * rsqrt(nu + eps) (`optax.scale_by_rms`)."""

    def __init__(self, params, lr, decay=0.9, eps=1e-8):
        super().__init__(params, dict(lr=lr, decay=decay, eps=eps))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            for p in group["params"]:
                if p.grad is None:
                    continue
                state = self.state[p]
                if "nu" not in state:
                    state["nu"] = torch.zeros_like(p)
                nu = state["nu"]
                nu.mul_(group["decay"]).addcmul_(p.grad, p.grad,
                                                 value=1 - group["decay"])
                p.add_(p.grad * torch.rsqrt(nu + group["eps"]),
                       alpha=-group["lr"])


def make_optimizer(cfg: Config, params):
    """The optimizer of `step.py:make_optimizer`, matching optax: Adam with
    torch-matching hyperparameters (reference: trainer.py:109-116), optax's
    rmsprop, plain SGD."""
    params = list(params)
    if cfg.optimizer == "adam":
        return torch.optim.Adam(params, lr=cfg.lr, betas=(cfg.beta1, 0.999),
                                eps=1e-8)
    if cfg.optimizer == "rmsprop":
        return OptaxRMSprop(params, lr=cfg.lr)
    if cfg.optimizer == "sgd":
        return torch.optim.SGD(params, lr=cfg.lr)
    raise ValueError(f"Unknown optimizer: {cfg.optimizer}")


def _model_step(cfg: Config, model, carry, x_j, m_in, r_in, hm_in, a_j,
                generator=None, sample_mean=False, **kw):
    """Dispatch one prediction step to the configured model family; the
    port has svg. `kw` passes the posterior inputs, skips, `train`,
    `force_use_prior` and `noise` on. Returns (out, new_carry)."""
    if cfg.model != "svg":
        raise NotImplementedError(f"model {cfg.model!r} is not ported yet")
    return model(carry, image=x_j, mask=m_in, robot=r_in, heatmap=hm_in,
                 action=a_j, generator=generator, sample_mean=sample_mean,
                 **kw)


def _conditioning(cfg: Config, m_j, m_i, r_j, r_i, hm_j, hm_i):
    """Build mask/state/heatmap conditioning inputs for one step
    (reference: trainer.py:373-381)."""
    m_in = m_j
    if cfg.model_use_future_mask:
        m_in = torch.cat([m_j, m_i], -1)
    r_in = r_j
    if cfg.model_use_future_robot_state:
        r_in = (r_j, r_i)
    hm_in = hm_j
    if cfg.model_use_future_heatmap and hm_j is not None:
        hm_in = torch.cat([hm_j, hm_i], -1)
    return m_in, r_in, hm_in


def _next_conditioning(cfg: Config, x_i_black, m_i, r_i, hm_i):
    """Posterior-side inputs; the future mask duplicates the current one at
    the target step (reference: trainer.py:386-391)."""
    m_next = torch.cat([m_i, m_i], -1) if cfg.model_use_future_mask else m_i
    hm_next = hm_i
    if cfg.model_use_future_heatmap and hm_i is not None:
        hm_next = torch.cat([hm_i, hm_i], -1)
    return {"next_image": x_i_black, "next_mask": m_next, "next_robot": r_i,
            "next_heatmap": hm_next}


def _recon_loss(cfg: Config, prediction, target, mask, batch_weight=None):
    """(reference: trainer.py:149-161)"""
    kind = cfg.reconstruction_loss
    if kind == "mse":
        return L.mse_criterion(prediction, target)
    if kind == "l1":
        return L.l1_criterion(prediction, target, batch_weight)
    if kind == "dontcare_mse":
        return L.dontcare_mse_criterion(prediction, target, mask,
                                        cfg.robot_pixel_weight)
    if kind == "dontcare_l1":
        return L.dontcare_l1_criterion(prediction, target, mask,
                                       cfg.robot_pixel_weight, batch_weight)
    raise NotImplementedError(kind)


def draw_noise(cfg: Config, batch: int, steps: int, generator=None,
               device=None, sched_prob: float = 1.0) -> dict:
    """A window's random draws, made before it runs: per step the
    scheduled-sampling Bernoulli (ground truth with probability
    `sched_prob`, one draw for the whole batch) and the prior's and the
    posterior's N(0, 1) draws, float32 (steps, B, fh, fw, z_dim)."""
    shape = (steps, batch, cfg.feat_height, cfg.feat_width, cfg.z_dim)
    use_truth = torch.rand(steps, generator=generator, device=device) < sched_prob
    eps = torch.randn((2,) + shape, generator=generator, device=device)
    return {"use_truth": use_truth, "eps_prior": eps[0], "eps_post": eps[1]}


def _window_inputs(batch: dict, i: int, masks=None):
    """Step i's inputs (1 <= i < window): frame, mask and state j = i - 1
    and i, and action j."""
    if "heatmaps" in batch:
        raise NotImplementedError("heatmap conditioning is not ported yet")
    x, states = batch["images"], batch["states"]
    masks = batch["masks"] if masks is None else masks
    return dict(x_j=x[i - 1], x_i=x[i], m_j=masks[i - 1], m_i=masks[i],
                r_j=states[i - 1], r_i=states[i], a_j=batch["actions"][i - 1])


def _predict(cfg, model, i, carry, skip, x_j, inp, noise, train,
             force_use_prior=False, sample_mean=False):
    """The model step shared by train and eval: blackout, conditioning,
    the step, the composite with the un-blacked x_j, and the skip frozen
    after n_past. Returns (out, x_pred float32, new_carry, new_skip)."""
    x_j_black, x_i_black = x_j, inp["x_i"]
    if cfg.dontcare:
        x_j_black = L.zero_robot_region(inp["m_j"], x_j)
        x_i_black = L.zero_robot_region(inp["m_i"], inp["x_i"])
    m_in, r_in, hm_in = _conditioning(cfg, inp["m_j"], inp["m_i"], inp["r_j"],
                                      inp["r_i"], None, None)
    out, new_carry = _model_step(
        cfg, model, carry, x_j_black, m_in, r_in, hm_in, inp["a_j"],
        sample_mean=sample_mean, skip=skip,
        use_curr_skip=(i <= 1) if not cfg.last_frame_skip else None,
        train=train, force_use_prior=force_use_prior, noise=noise,
        **_next_conditioning(cfg, x_i_black, inp["m_i"], inp["r_i"], None))
    x_pred = composite(cfg, out["x_pred"], x_j).float()
    # freeze the skip after the conditioning frames (trainer.py:409-410)
    new_skip = out["curr_skip"] if i <= cfg.n_past else skip
    return out, x_pred, new_carry, new_skip


def _save_convolutions(ctx, op, *args, **kwargs):
    """Selective-checkpoint policy of remat "conv": keep every convolution's
    output, recompute the rest (the JAX policy saves conv and dot outputs;
    the SVG conv model has no dots)."""
    if op is torch.ops.aten.convolution.default:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def make_train_step(cfg: Config, model):
    """Builds the whole-window train step of `model` (a training SVG:
    float32 parameters) and its optimizer.

    train_step(batch, sched_prob, generator=None, noise=None) -> metrics,
    a dict of 0-d float32 tensors on the batch's device (not synced).

    batch: time-first tensors on the model's device
      images   (W, B, H, W', 3) float32 in [0,1]
      masks    (W, B, H, W', 1)
      states   (W, B, robot_dim)
      actions  (W-1, B, action_dim)
      batch_weight (B,) optional movement weighting (trainer.py:426-429)
    noise: `draw_noise`'s dict for the window, else drawn from `generator`.
    """
    optimizer = make_optimizer(cfg, model.parameters())
    dtype = compute_dtype(cfg)
    window = cfg.n_past + cfg.n_future

    def step_fn(i, carry, skip, x_prev, inp, use_truth, eps, batch_weight):
        x_j = inp["x_j"]
        if i > 1 and cfg.scheduled_sampling:  # else ground truth throughout
            x_j = torch.where(use_truth, x_j, x_prev)
        out, x_pred, carry, skip = _predict(cfg, model, i, carry, skip, x_j,
                                            inp, eps, train=True)
        x_i, m_i = inp["x_i"], inp["m_i"]
        losses = {
            "recon_loss": _recon_loss(cfg, x_pred, x_i, m_i, batch_weight),
            "robot_loss": L.robot_mse_criterion(x_pred, x_i, m_i),
            "world_loss": L.world_mse_criterion(x_pred, x_i, m_i),
            "kld": L.kl_criterion(out["mu"], out["logvar"], out["mu_p"],
                                  out["logvar_p"], x_i.shape[0]),
        }
        return carry, skip, x_pred, losses, out["bn_stats"]

    if cfg.remat and cfg.remat_policy == "conv":
        context = functools.partial(create_selective_checkpoint_contexts,
                                    _save_convolutions)
        run = functools.partial(checkpoint, step_fn, use_reentrant=False,
                                preserve_rng_state=False, context_fn=context)
    elif cfg.remat:
        run = functools.partial(checkpoint, step_fn, use_reentrant=False,
                                preserve_rng_state=False)
    else:
        run = step_fn

    def train_step(batch, sched_prob, generator=None, noise=None):
        x = batch["images"]
        B = x.shape[1]
        if noise is None:
            noise = draw_noise(cfg, B, window - 1, generator, x.device,
                               sched_prob)
        carry = get_model(cfg).init_carry(cfg, B, dtype, x.device)
        skip = skip_zeros(cfg, B, dtype, x.device)
        x_prev = x[0]
        steps, stats = [], []
        for i in range(1, window):
            carry, skip, x_prev, losses, bn_stats = run(
                i, carry, skip, x_prev, _window_inputs(batch, i),
                noise["use_truth"][i - 1],
                (noise["eps_prior"][i - 1], noise["eps_post"][i - 1]),
                batch.get("batch_weight"))
            steps.append(losses)
            stats += bn_stats
        totals = {k: torch.stack([s[k] for s in steps]).sum() for k in steps[0]}
        loss = totals["recon_loss"] + cfg.beta * totals["kld"]
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        apply_batch_stats(stats)
        metrics = {k: v.detach() / cfg.n_future for k, v in totals.items()}
        metrics["loss"] = loss.detach()
        return metrics

    return train_step, optimizer


def make_eval_step(cfg: Config, model, autoregressive: bool = True):
    """Builds the eval step over an n_eval window (reference:
    trainer.py:566-734): the prior drives the prediction
    (force_use_prior), BatchNorm uses its running statistics and the cells
    the hand kernel. The batch may carry "pred_masks", the model-input
    masks; the metrics always use the true masks.

    eval_step(batch, generator=None, noise=None) -> (per-step metrics, each
    (n_eval-1,), predictions (n_eval-1, B, H, W, 3)), on the batch's
    device."""
    dtype = compute_dtype(cfg)

    @torch.no_grad()
    def eval_step(batch, generator=None, noise=None):
        x, true_masks = batch["images"], batch["masks"]
        masks = batch.get("pred_masks", true_masks)
        B, n = x.shape[1], cfg.n_eval
        if noise is None:
            noise = draw_noise(cfg, B, n - 1, generator, x.device)
        carry = get_model(cfg).init_carry(cfg, B, dtype, x.device)
        skip = skip_zeros(cfg, B, dtype, x.device)
        x_prev = x[0]
        per_step, preds = [], []
        for i in range(1, n):
            inp = _window_inputs(batch, i, masks)
            x_j = x_prev if autoregressive and i > 1 else inp["x_j"]
            out, x_pred, carry, skip = _predict(
                cfg, model, i, carry, skip, x_j, inp,
                (noise["eps_prior"][i - 1], noise["eps_post"][i - 1]),
                train=False, force_use_prior=True,
                sample_mean=cfg.sample_mean)
            # metrics against the true masks (trainer.py:677-697)
            x_i, tm_i = inp["x_i"], true_masks[i]
            x_pred_black = L.zero_robot_region(tm_i, x_pred)
            x_i_black = L.zero_robot_region(tm_i, x_i)
            per_step.append({
                "recon_loss": _recon_loss(cfg, x_pred, x_i, tm_i),
                "robot_loss": L.robot_mse_criterion(x_pred, x_i, tm_i),
                "world_loss": L.world_mse_criterion(x_pred, x_i, tm_i),
                "psnr": M.psnr(x_i_black.clamp(0, 1),
                               x_pred_black.clamp(0, 1)).mean(),
                "ssim": M.ssim(x_i_black, x_pred_black).mean(),
                "kld": L.kl_criterion(out["mu"], out["logvar"], out["mu_p"],
                                      out["logvar_p"], B),
            })
            preds.append(x_pred)
            x_prev = x_pred
        stacked = {k: torch.stack([s[k] for s in per_step])
                   for k in per_step[0]}
        return stacked, torch.stack(preds)

    return eval_step
