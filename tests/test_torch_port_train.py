"""The port's training step held against the JAX package on the CPU:
losses and metrics, train-mode BatchNorm, the train-time ConvLSTM cell,
one whole-window train step (same parameters, same batch, the same
injected posterior noise), the optimizers and remat. The eval steps,
checkpoints, data and trainer are in test_torch_port_trainer.py.

Float32 unless a test says otherwise. Tolerances: 1e-5 for single ops;
1e-4 for whole steps (stacks of convolutions whose float32 sums XLA and
PyTorch take in other orders); gradients to GRAD_TOL_JAX of each leaf's
norm, for the reason test_train_step_matches_jax gives, a limit that
test_gradient_limit_rejects_a_planted_fault shows a wrong gradient
exceeds."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from robot_aware_control_tpu.ops import losses as jL
from robot_aware_control_tpu.ops import lstm as jlstm
from robot_aware_control_tpu.ops import metrics as jM
from robot_aware_control_tpu.ops import nn as jnn
from robot_aware_control_tpu.training import step as jstep
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg as tsvg
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops import losses as tL
from robot_aware_control_tpu_torch.ops import metrics as tM
from robot_aware_control_tpu_torch.ops.lstm import conv_lstm_cell_autograd
from robot_aware_control_tpu_torch.ops.nn import BN_EPS, BatchNorm, apply_batch_stats
from robot_aware_control_tpu_torch.training import step as tstep
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import (
    JAX_TRAIN_KEYS,
    STEP_KW,
    STEP_TOL,
    fake_jax_normal,
    flat,
    jax_trees,
    np_tree,
    port_model,
    port_noise,
    torch_batch,
    window,
)
from torch_train_small import GRAD_TOL_DEVICES, GRAD_TOL_JAX


@pytest.fixture(scope="module")
def jax_side():
    """JAX trees and a window, and the JAX train step's results on them
    (jitted once per dtype, with jax.random.normal patched to the injected
    noise while it traces)."""
    jcfg = JConfig(**STEP_KW)
    params, bn = jax_trees(jcfg)
    batch = window(jsynthetic_batch(jcfg, 2, 8, seed=0), 4,
                   np.array([1.0, 2.0], np.float32))
    out = {"params": params, "bn": bn, "batch": batch, "train": {}}
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", fake_jax_normal)
        for dtype, probs in (("float32", (1.0, 0.0)), ("bfloat16", (1.0,))):
            step, tx = jstep.make_train_step(jcfg.replace(compute_dtype=dtype))
            for p in probs:
                new_p, new_bn, _, metrics = step(
                    copy(params), copy(bn), tx.init(params),
                    {k: jnp.asarray(v) for k, v in batch.items()},
                    jax.random.PRNGKey(3), jnp.float32(p))
                out["train"][(dtype, p)] = (np_tree(new_p), np_tree(new_bn),
                                            np_tree(metrics))
    return out


def _port_model(js, cfg):
    return port_model(js["params"], js["bn"], cfg)

# ------------------------------------------------------------- losses
def _loss_inputs(rng):
    p = rng.rand(3, 8, 10, 3).astype(np.float32)
    t = rng.rand(3, 8, 10, 3).astype(np.float32)
    m = (rng.rand(3, 8, 10, 1) > 0.6).astype(np.float32)
    bw = np.array([1.0, 3.0, 0.5], np.float32)
    return p, t, m, bw


LOSS_CASES = {
    "mse": lambda L, p, t, m, bw: L.mse_criterion(p, t),
    "l1": lambda L, p, t, m, bw: L.l1_criterion(p, t),
    "l1_batch_weight": lambda L, p, t, m, bw: L.l1_criterion(p, t, bw),
    "dontcare_mse": lambda L, p, t, m, bw: L.dontcare_mse_criterion(p, t, m, 0.3),
    "dontcare_l1": lambda L, p, t, m, bw: L.dontcare_l1_criterion(p, t, m, 0.0),
    "dontcare_l1_batch_weight":
        lambda L, p, t, m, bw: L.dontcare_l1_criterion(p, t, m, 0.3, bw),
    "robot_mse": lambda L, p, t, m, bw: L.robot_mse_criterion(p, t, m),
    "world_mse": lambda L, p, t, m, bw: L.world_mse_criterion(p, t, m),
    "world_psnr": lambda L, p, t, m, bw: L.world_psnr_criterion(p, t, m),
    "kl": lambda L, p, t, m, bw: L.kl_criterion(p, t - 0.5, t, p - 0.5, 3),
}


@pytest.mark.parametrize("case", sorted(LOSS_CASES))
def test_loss_matches_jax(case, rng):
    """Each criterion of ops/losses.py, float32 reductions, to 1e-5."""
    args = _loss_inputs(rng)
    want = LOSS_CASES[case](jL, *map(jnp.asarray, args))
    got = LOSS_CASES[case](tL, *map(torch.tensor, args))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)


METRIC_CASES = {"psnr": (1e-5, lambda M, a, b: M.psnr(a, b)),
                "true_psnr": (1e-5, lambda M, a, b: M.true_psnr(a, b)),
                "ssim": (1e-4, lambda M, a, b: M.ssim(a, b))}


@pytest.mark.parametrize("case", sorted(METRIC_CASES))
def test_metric_matches_jax(case, rng):
    """psnr (with the reference's (x+1)/2), true_psnr to 1e-5; the SSIM
    map to 1e-4 (eleven-tap float32 filters summed in other orders)."""
    tol, fn = METRIC_CASES[case]
    a = rng.rand(2, 16, 20, 3).astype(np.float32)
    b = np.clip(a + 0.1 * rng.randn(*a.shape), 0, 1).astype(np.float32)
    want = np.asarray(fn(jM, jnp.asarray(a), jnp.asarray(b)))
    got = fn(tM, torch.tensor(a), torch.tensor(b)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_ssim_ignores_the_tf32_flag(rng, monkeypatch):
    """ssim runs its filter in full float32 whatever torch's TF32 flag
    says (a no-op on the CPU; on the card the flag would otherwise send
    cuDNN's float32 convolutions through TF32)."""
    a = torch.tensor(rng.rand(1, 12, 12, 3).astype(np.float32))
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    seen = []
    conv2d = torch.nn.functional.conv2d

    def spy(*args, **kw):
        seen.append(torch.backends.cudnn.allow_tf32)
        return conv2d(*args, **kw)

    monkeypatch.setattr(torch.nn.functional, "conv2d", spy)
    out = tM.ssim(a, a)
    assert seen == [False] * 5 and torch.backends.cudnn.allow_tf32
    np.testing.assert_allclose(out.numpy(), 1.0, atol=1e-5)


# ----------------------------------------------------------- BatchNorm
def test_train_batchnorm_matches_jax(rng):
    """Output, and the running statistics after the update (momentum 0.1,
    unbiased variance), to 1e-5."""
    x = rng.randn(4, 6, 8, 16).astype(np.float32) * 2 + 1
    p = {"scale": rng.rand(16).astype(np.float32) + 0.5,
         "bias": rng.randn(16).astype(np.float32)}
    s = {"mean": rng.randn(16).astype(np.float32),
         "var": rng.rand(16).astype(np.float32) + 0.5}
    want_y, want_s = jnn.batchnorm(p, s, jnp.asarray(x), train=True)
    bn = BatchNorm(16)
    with torch.no_grad():
        bn.weight.copy_(torch.tensor(p["scale"]))
        bn.bias.copy_(torch.tensor(p["bias"]))
        bn.running_mean.copy_(torch.tensor(s["mean"]))
        bn.running_var.copy_(torch.tensor(s["var"]))
    stats = []
    y = bn(torch.tensor(x), stats)
    # train mode leaves the running statistics to apply_batch_stats
    np.testing.assert_array_equal(bn.running_mean.numpy(), s["mean"])
    apply_batch_stats(stats)
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(want_y), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(bn.running_mean.numpy(), np.asarray(want_s["mean"]), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(bn.running_var.numpy(), np.asarray(want_s["var"]), rtol=1e-5, atol=1e-6)


# ------------------------------------------------------- train-time cell
@pytest.mark.parametrize("k", [5, 3])
def test_autograd_cell_matches_jax_cell_and_grad(rng, k):
    """The autograd cell against the XLA cell `lstm.conv_lstm_cell`:
    outputs to 1e-5, gradients of a weighted sum of (h, c) with respect
    to x, h, c, w and b against jax.grad to 1e-4 of each one's max."""
    B, H, W, Cx, C = 2, 6, 8, 6, 4
    x, h, c = (rng.randn(B, H, W, n).astype(np.float32) for n in (Cx, C, C))
    w = (rng.randn(k, k, Cx + C, 4 * C) * 0.1).astype(np.float32)
    b = (rng.randn(4 * C) * 0.1).astype(np.float32)
    rh, rc = rng.randn(B, H, W, C).astype(np.float32), rng.randn(B, H, W, C).astype(np.float32)

    def jfun(x, h, c, w, b):
        hn, (_, cn) = jlstm.conv_lstm_cell({"gates": {"w": w, "b": b}}, (h, c), x)
        return jnp.sum(hn * rh) + jnp.sum(cn * rc), (hn, cn)

    (_, (want_h, want_c)), grads = jax.value_and_grad(
        jfun, argnums=(0, 1, 2, 3, 4), has_aux=True)(
            *map(jnp.asarray, (x, h, c, w, b)))
    ts = [torch.tensor(a, requires_grad=True) for a in (x, h, c, w, b)]
    hn, cn = conv_lstm_cell_autograd(*ts)
    ((hn * torch.tensor(rh)).sum() + (cn * torch.tensor(rc)).sum()).backward()
    np.testing.assert_allclose(hn.detach().numpy(), np.asarray(want_h), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(cn.detach().numpy(), np.asarray(want_c), rtol=1e-5, atol=1e-6)
    for t, g in zip(ts, grads):
        g = np.asarray(g)
        np.testing.assert_allclose(t.grad.numpy(), g, rtol=0,
                                   atol=1e-4 * np.abs(g).max())


# ----------------------------------------------------------- train step
def _port_train_step(js, cfg, prob, batch=None):
    """One port train step on the fixture's parameters and window with the
    injected noise; returns (metrics, {keystr: grad}, {keystr: new bn})."""
    model = _port_model(js, cfg)
    step, _ = tstep.make_train_step(cfg, model)
    before, _ = convert.jax_flat_trees(model)
    metrics = step(torch_batch(batch or js["batch"]), prob,
                   noise=port_noise(cfg.n_future, prob == 1.0))
    after, bn = convert.jax_flat_trees(model)
    return metrics, {k: before[k] - after[k] for k in before}, bn


@pytest.mark.parametrize("prob", [1.0, 0.0])
def test_train_step_matches_jax(jax_side, prob):
    """One whole-window step against make_train_step, ground truth fed at
    every step (sched_prob 1) or the model's own predictions after the
    first (sched_prob 0): loss and metrics to 1e-4, BatchNorm statistics
    to 1e-5, and every gradient (the sgd step at lr 1) to 2e-2 of its
    leaf's norm.

    The gradients cannot be held element by element: a 2x2 max pool sends
    its gradient to the larger entry, and where two entries differ by less
    than float32 rounding the two libraries can pick different ones; and
    the BatchNorm backward over a few dozen values a channel cancels. On
    this window port and JAX differ by at most 1.5e-3 of a leaf's norm
    (3.6e-3 of its max), and GRAD_TOL_JAX is about 3x that; at 48x64
    frames by 9.3e-3 (6.8e-2 of the max, encoder c2), where the port
    alone, with oneDNN's convolutions on and off, differs by up to 6.1e-3.
    test_gradient_limit_rejects_a_planted_fault shows the limit catches a
    wrong gradient."""
    js = jax_side
    cfg = Config(**STEP_KW)
    new_p, new_bn, jmetrics = js["train"][("float32", prob)]
    metrics, grads, bn = _port_train_step(js, cfg, prob)
    assert set(metrics) == set(jmetrics) == JAX_TRAIN_KEYS
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, **STEP_TOL, err_msg=k)
    errs = _grad_errors(js, new_p, grads)
    assert max(errs.values()) <= GRAD_TOL_JAX, max(errs.items(), key=lambda e: e[1])
    want_bn = flat(new_bn)
    assert set(bn) == set(want_bn)
    for k, v in want_bn.items():
        np.testing.assert_allclose(bn[k], v, rtol=1e-5, atol=1e-6, err_msg=k)


def _grad_errors(js, new_params, grads):
    """|port gradient - JAX gradient| / |JAX gradient| by leaf, the JAX
    gradient read off its sgd step at lr 1."""
    old = flat(js["params"])
    want = {k: old[k] - v for k, v in flat(new_params).items()}
    assert set(grads) == set(want)
    return {k: float(np.linalg.norm(grads[k] - g) / np.linalg.norm(g))
            for k, g in want.items()}


def _detach_fed_frames(monkeypatch):
    """The model's predictions fed back without their gradient."""
    predict = tstep._predict

    def fault(cfg, model, i, carry, skip, x_j, *a, **k):
        return predict(cfg, model, i, carry, skip,
                       x_j.detach() if i > 1 else x_j, *a, **k)

    monkeypatch.setattr(tstep, "_predict", fault)


def _detach_batch_statistics(monkeypatch):
    """Train-mode BatchNorm with no gradient through its batch mean and
    variance: the same forward, another backward."""
    forward = BatchNorm.forward

    def fault(self, x, stats=None):
        y = forward(self, x.detach(), stats)  # the running statistics
        xf = x.float()
        var, mean = (s.detach() for s in torch.var_mean(
            xf, dim=(0, 1, 2), unbiased=False))
        inv = torch.rsqrt(var + BN_EPS) * self.weight
        return ((xf - mean) * inv + self.bias).to(y.dtype)

    monkeypatch.setattr(BatchNorm, "forward", fault)


def _drop_kl(monkeypatch):
    """The KL term left out of the loss (its beta taken as 0)."""
    make = tstep.make_train_step
    monkeypatch.setattr(tstep, "make_train_step",
                        lambda cfg, model: make(cfg.replace(beta=0.0), model))


PLANTED_FAULTS = {"detached_fed_frames": _detach_fed_frames,
                  "detached_batch_statistics": _detach_batch_statistics,
                  "kl_dropped": _drop_kl}


@pytest.mark.parametrize("fault", sorted(PLANTED_FAULTS))
def test_gradient_limit_rejects_a_planted_fault(jax_side, monkeypatch, fault):
    """A port step with a planted gradient fault, at sched_prob 0 (the
    model's predictions fed back), exceeds GRAD_TOL_JAX on some leaf
    against the JAX step, and so would fail test_train_step_matches_jax,
    and exceeds the GPU-vs-CPU limit GRAD_TOL_DEVICES too (worst leaves
    0.42, 17.7 and 1.12 of their norm in the order below); a fault that
    leaves the forward alone keeps the loss within 1e-4."""
    js = jax_side
    new_p, _, jmetrics = js["train"][("float32", 0.0)]
    PLANTED_FAULTS[fault](monkeypatch)
    metrics, grads, _ = _port_train_step(js, Config(**STEP_KW), 0.0)
    errs = _grad_errors(js, new_p, grads)
    worst = max(errs.items(), key=lambda e: e[1])
    assert worst[1] > max(GRAD_TOL_JAX, GRAD_TOL_DEVICES), worst
    if fault != "kl_dropped":
        np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"],
                                   **STEP_TOL)


def test_train_step_feeds_predictions_without_ground_truth(jax_side):
    """sched_prob 0 changes the loss: the model's predictions replace the
    ground truth after the first step."""
    js = jax_side
    cfg = Config(**STEP_KW)
    l1 = float(_port_train_step(js, cfg, 1.0)[0]["loss"])
    l0 = float(_port_train_step(js, cfg, 0.0)[0]["loss"])
    assert l0 != l1


def test_bf16_train_step_loss_matches_jax(jax_side):
    """In bfloat16 the XLA cell and the port's differ in where they round
    (bias added and c updated in bf16 on both sides, sums in other
    orders); the loss holds to 2e-2 relative, the metrics to 5e-2."""
    js = jax_side
    cfg = Config(**STEP_KW).replace(compute_dtype="bfloat16")
    _, _, jmetrics = js["train"][("bfloat16", 1.0)]
    metrics, grads, _ = _port_train_step(js, cfg, 1.0)
    np.testing.assert_allclose(float(metrics["loss"]), jmetrics["loss"], rtol=2e-2)
    for k in ("recon_loss", "robot_loss", "world_loss"):
        np.testing.assert_allclose(float(metrics[k]), jmetrics[k], rtol=5e-2, err_msg=k)
    assert all(np.isfinite(g).all() for g in grads.values())


def test_train_step_holds_float32_master_weights(jax_side):
    """A bf16 training model keeps float32 parameters and computes in
    bf16; the optimizer updates the float32 parameters."""
    js = jax_side
    model = _port_model(js, Config(**STEP_KW).replace(compute_dtype="bfloat16"))
    assert {p.dtype for p in model.parameters()} == {torch.float32}
    assert all(p.requires_grad for p in model.parameters())
    inference = convert.svg_from_jax(
        Config(**STEP_KW).replace(compute_dtype="bfloat16"), np_tree(js["params"]),
        np_tree(js["bn"]), "cpu")
    assert inference.encoder.c1[0].conv.weight.dtype == torch.bfloat16
    trained = tsvg.init(Config(**STEP_KW), 0, "cpu", train=True)
    assert {p.dtype for p in trained.parameters()} == {torch.float32}


def test_train_step_never_reaches_the_kernels(jax_side, monkeypatch):
    """The kernels have no backward: the train step takes the autograd
    cell and never calls a kernel wrapper, while the eval step calls the
    cell wrapper for each of its 6 cells a model step."""
    js = jax_side
    cfg = Config(**STEP_KW)

    def refuse(*a, **k):
        raise AssertionError("a kernel wrapper was reached in training")

    before = dict(kernels.launches)
    cell = kernels.conv_lstm_cell
    monkeypatch.setattr(kernels, "conv_lstm_cell", refuse)
    monkeypatch.setattr(kernels, "conv_lstm_cell_wmma", refuse)
    monkeypatch.setattr(kernels, "capsule_mask_render", refuse)
    metrics, _, _ = _port_train_step(js, cfg, 0.0)
    assert np.isfinite(float(metrics["loss"])) and kernels.launches == before
    calls = []
    monkeypatch.setattr(kernels, "conv_lstm_cell",
                        lambda *a: calls.append(1) or cell(*a))
    tstep.make_eval_step(cfg, _port_model(js, cfg))(torch_batch(js["batch"]),
                                                    noise=port_noise(3, True))
    assert len(calls) == 6 * (cfg.n_eval - 1)


@pytest.mark.parametrize("remat,policy", [(True, "full"), (True, "conv")])
def test_remat_matches_no_remat(jax_side, remat, policy):
    """Remat recomputes, it changes no value: the same loss, gradients,
    BatchNorm statistics and random draws (the port's counterpart of
    tests/test_train_step.py:107), with the draws made from a generator."""
    js = jax_side
    cfg = Config(**STEP_KW)
    results = []
    for c in (cfg, cfg.replace(remat=remat, remat_policy=policy)):
        model = _port_model(js, c)
        step, _ = tstep.make_train_step(c, model)
        gen = torch.Generator().manual_seed(11)
        metrics = step(torch_batch(js["batch"]), 0.5, gen)
        grads = {n: p.grad.clone() for n, p in model.named_parameters()}
        results.append((metrics, grads, model.state_dict(), gen.get_state()))
    (m0, g0, s0, r0), (m1, g1, s1, r1) = results
    assert torch.equal(r0, r1)
    for k in m0:
        np.testing.assert_allclose(float(m1[k]), float(m0[k]), rtol=1e-6, err_msg=k)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-6, atol=1e-9)
    for k in s0:
        torch.testing.assert_close(s1[k], s0[k], rtol=1e-6, atol=1e-9)


# ----------------------------------------------------------- optimizers
@pytest.mark.parametrize("name", ["adam", "rmsprop"])
def test_optimizer_matches_optax(name, rng):
    """Three steps of the same gradients through the port's optimizer and
    optax's, to 1e-6; rmsprop follows optax (decay 0.9, eps inside the
    square root), not torch.optim.RMSprop's defaults."""
    cfg = Config(optimizer=name, lr=3e-3, beta1=0.5)
    p0 = {"a": rng.randn(4, 3).astype(np.float32),
          "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in p0.items()}
             for _ in range(3)]
    tx = jstep.make_optimizer(JConfig(optimizer=name, lr=3e-3, beta1=0.5))
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    state = tx.init(jp)
    tp = {k: torch.tensor(v, requires_grad=True) for k, v in p0.items()}
    opt = tstep.make_optimizer(cfg, tp.values())
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, t in tp.items():
            t.grad = torch.tensor(g[k])
        opt.step()
    for k in p0:
        np.testing.assert_allclose(tp[k].detach().numpy(), np.asarray(jp[k]),
                                   rtol=0, atol=1e-6, err_msg=k)
