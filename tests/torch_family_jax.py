"""JAX-side helpers and the per-family checks of the other model families
(svg_vec, det_vec, cdna_det, cdna_robonet), shared by the test modules
that hold each family against the JAX package on the CPU:
tests/test_torch_port_families_svg_vec.py, _det_vec.py and _cdna.py. Not
a test module: each of those parametrizes the `family_*` checks below over
its own families, so that tier-1's workers (pytest-xdist, one module a
worker) share the families' JAX compiles evenly.

Inputs come from seeded numpy arrays; the JAX functions' random draws
(jax.random.normal, the encoder's `_dropout2d`) are patched to the draws
the port is given. Small sizes: g_dim 16, z_dim 4, rnn_size 32, 1-layer
stacks, 16x32 frames, He-scaled weights (at the reference's N(0, 0.02) the
prediction hardly depends on its inputs) except where a gradient limit was
set at the reference's scale."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data.synthetic import synthetic_batch as jsynthetic_batch
from robot_aware_control_tpu.models.registry import get_model as jget_model
from robot_aware_control_tpu.ops import encoders as jencoders
from robot_aware_control_tpu.ops import lstm as jlstm
from robot_aware_control_tpu.planning import cem as jcem
from robot_aware_control_tpu.planning.rollout import RolloutEngine as JRolloutEngine
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu.training import step as jstep
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.plan_server import build_server
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW, normalize
from robot_aware_control_tpu_torch.models.registry import get_model, is_stochastic
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.ops.encoders import SKIP_CHANNELS
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.planning.rollout import RolloutEngine, prepare_goals
from robot_aware_control_tpu_torch.training import checkpoint as tckpt
from robot_aware_control_tpu_torch.training.step import make_eval_step, make_train_step
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from torch_family_cases import SMALL_STACKS
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import (
    STEP_KW,
    STEP_TOL,
    fake_jax_normal,
    fixed_normal,
    flat,
    np_tree,
    random_tree,
    torch_batch,
    window,
)
from torch_train_small import GRAD_TOL_JAX
from torch_variant_cases import start_goal

# the small training config with the small fc-LSTM stacks at 16x32 frames:
# the vector decoder's (H/16, W/16) map, upsampled, must meet the H/8 skip
# (the JAX vector models cannot run at 24x32)
H, W = 16, 32
FAM_KW = dict(STEP_KW, image_height=H, image_width=W, **SMALL_STACKS)
# planning: N 6, horizon 4 (3 model steps), the prior's mean
PLAN_KW = dict(FAM_KW, reward_type="dontcare", horizon=4, opt_iter=2,
               action_candidates=6, topk=2, cem_init_std=0.015,
               sample_mean=True)
TOL = dict(rtol=1e-5, atol=1e-5)
STACK_TOL = dict(rtol=1e-4, atol=1e-5)
_JAX_CONV_LSTM = jlstm.conv_lstm


def _jax_conv_lstm(params, state, x, group_norm_cells=False, fused=False):
    """JAX `conv_lstm` for GroupNorm cells after its int8 probe, which
    reads params["cell0"]["gates"] and so raises KeyError for them
    (lstm.py:119; as tests/test_torch_port_variants.py patches it)."""
    if not group_norm_cells:
        return _JAX_CONV_LSTM(params, state, x, group_norm_cells, fused)
    s0, s1 = state
    h, s0 = jlstm.norm_conv_lstm_cell(params["cell0"], s0, x)
    h, s1 = jlstm.norm_conv_lstm_cell(params["cell1"], s1, h)
    return h, (s0, s1)


def _jtree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def _t(a):
    return torch.tensor(np.asarray(a, np.float32))


def _jax_trees(jcfg, seed=0, he=True):
    """A JAX family's (params, BatchNorm state) as `random_tree` makes them,
    in the structure its init gives; svg_vec's prior heads offset so that
    the KL term is not a cancellation."""
    mod = jget_model(jcfg)
    shapes = jax.eval_shape(lambda k: mod.init(k, jcfg), jax.random.PRNGKey(0))
    params, bn = random_tree(shapes, np.random.RandomState(seed), he)
    if jcfg.model == "svg_vec":
        params["prior"]["mu"]["b"][:] = 0.3
        params["prior"]["logvar"]["b"][:] = -0.5
    return params, bn


def _port_model(cfg, params, bn, train=False):
    cls = convert.MODEL_CLASSES[cfg.model]
    model = cls(cfg, "cpu", param_dtype=torch.float32 if train else None)
    model.load_state_dict(convert.svg_state_dict(np_tree(params), np_tree(bn)),
                          strict=True)
    return model if train else model.eval().requires_grad_(False)


class _InjectedDropout:
    """Stands in for the JAX `encoders._dropout2d` (which draws its masks
    from folds of the step's key): call k of a step uses frame (k // 4)'s
    mask of stage `salt` (the current frame's four stages, then svg_vec's
    next frame's); traced once inside a scan, every step sees the same
    masks."""

    def __init__(self, masks):
        self.masks, self.calls = masks, 0

    def __call__(self, h, rate, rng, salt):
        frame = (self.calls // 4) % len(self.masks)
        self.calls += 1
        m = jnp.asarray(self.masks[frame][salt - 1], h.dtype)
        return h * m[:, None, None, :] / (1.0 - rate)


def _keep_masks(frames, B, rate=0.25, seed=11):
    """Keep masks [frame][stage] (B, C) float32 at the encoder's stage
    widths, each channel kept with probability 1 - rate."""
    r = np.random.RandomState(seed)
    return [[(r.rand(B, c) >= rate).astype(np.float32) for c in SKIP_CHANNELS]
            for _ in range(frames)]


def _port_drop(masks, steps):
    """The port's "drop" draws of `steps` steps that all take `masks`."""
    return [torch.tensor(np.stack([[masks[f][s] for f in range(len(masks))]
                                   for _ in range(steps)]) > 0.5)
            for s in range(len(SKIP_CHANNELS))]


# ---------------------------------------------------------------- steps
def _step_inputs(rng, B, frames=3):
    img = rng.rand(B, H, W, 3).astype(np.float32)
    mask = (rng.rand(B, H, W, 2) > 0.7).astype(np.float32)  # and the next
    robot = rng.randn(B, 5).astype(np.float32)
    action = rng.randn(B, 5).astype(np.float32)
    return img, mask, robot, action


def _jax_step(jcfg, params, bn, carry, img, mask, robot, action, t):
    """One JAX inference step of the family; svg_vec with the next frame
    (the posterior) and its draws patched."""
    mod = jget_model(jcfg)
    a = [jnp.asarray(v) for v in (img, mask, robot, action)]
    if jcfg.model == "svg_vec":
        return mod.step(jcfg, params, bn, carry, a[0], a[1], a[2], None, a[3],
                        jax.random.PRNGKey(t), next_image=a[0] * 0.5,
                        next_mask=a[1], next_robot=a[2] * 0.5)
    return mod.step(jcfg, params, bn, carry, *a)


def _port_step(cfg, model, carry, img, mask, robot, action, B):
    t = [_t(v) for v in (img, mask, robot, action)]
    with torch.no_grad():
        if cfg.model == "svg_vec":
            eps = torch.tensor(fixed_normal((B, cfg.z_dim)))
            return model(carry, t[0], t[1], t[2], None, t[3],
                         next_image=t[0] * 0.5, next_mask=t[1],
                         next_robot=t[2] * 0.5, noise=(eps, eps))
        return model(carry, t[0], t[1], t[2], t[3])


def _carry_leaves(carry):
    return [c for c in jax.tree_util.tree_leaves(carry) if c.ndim > 0]



def family_steps_match_jax(rng, monkeypatch, family):
    """Three inference steps of the family from its zero carry (svg_vec
    with the posterior on a next frame, its draws injected): x_pred,
    the posterior's and prior's statistics and every carry to 1e-4."""
    monkeypatch.setattr(jax.random, "normal", fake_jax_normal)
    kw = dict(FAM_KW, model=family)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    model = _port_model(cfg, params, bn)
    B = 3
    jcarry = jget_model(jcfg).init_carry(jcfg, B)
    carry = get_model(cfg).init_carry(cfg, B, torch.float32, "cpu")
    for t in range(3):
        inputs = _step_inputs(rng, B)
        jout, jcarry, _ = _jax_step(jcfg, _jtree(params), _jtree(bn), jcarry,
                                    *inputs, t)
        out, carry = _port_step(cfg, model, carry, *inputs, B)
        assert out["x_pred"].shape == (B, H, W, 3)
        for k in ("x_pred", "mu", "logvar", "mu_p", "logvar_p"):
            if jout.get(k) is not None:
                np.testing.assert_allclose(out[k].numpy(), np.asarray(jout[k]),
                                           **STACK_TOL, err_msg=k)
        for got, want in zip(_carry_leaves(carry), _carry_leaves(jcarry)):
            np.testing.assert_allclose(np.asarray(got), np.asarray(want),
                                       **STACK_TOL)



# ----------------------------------------------------- rollouts and plans
def family_rollout_matches_jax(rng, family, dtype):
    """The rollout engine's summed costs of the same candidates against the
    JAX engine's, the prior's mean for svg_vec: float32 to 1e-4 relative,
    bf16 to 1e-3 (8 significant bits; each cost sums 2304 pixels)."""
    kw = dict(PLAN_KW, model=family, compute_dtype=dtype)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    model = _port_model(cfg, params, bn)
    start, goal = start_goal(rng, H, W)
    goal.masks = [(rng.rand(H, W) > 0.8).astype(np.float32) for _ in goal.masks]
    acts = np.zeros((6, 3, 5), np.float32)
    acts[..., :2] = rng.uniform(-0.05, 0.05, (6, 3, 2))
    gi, gm, _ = prepare_goals(goal, 3)
    s_norm = normalize(start.state, LOCOBOT_LOW, LOCOBOT_HIGH)
    want = JRolloutEngine(jcfg)(
        params, bn, jnp.asarray(start.img), jnp.asarray(s_norm),
        jnp.asarray(start.qpos), jnp.asarray(acts), jnp.asarray(gi),
        jnp.asarray(gm), jax.random.PRNGKey(0))
    got = RolloutEngine(cfg, device="cpu")(
        model, _t(start.img), _t(s_norm), _t(start.qpos), _t(acts), _t(gi),
        _t(gm), torch.Generator().manual_seed(0))
    rtol = 1e-4 if dtype == "float32" else 1e-3
    np.testing.assert_allclose(got.double().numpy(), np.asarray(want, np.float64),
                               rtol=rtol)



def _jax_plan(monkeypatch, jcfg, params, bn, start, goal, noise):
    """The JAX plan with jax.random.normal returning `noise` for the action
    samples' shape (traced once, every iteration sees it)."""
    normal = jax.random.normal

    def fake(key, shape=(), dtype=jnp.float32):
        if tuple(shape) == noise.shape:
            return jnp.asarray(noise, dtype)
        return normal(key, shape, dtype)

    monkeypatch.setattr(jax.random, "normal", fake)
    policy = jcem.CEMPolicy(jcfg, params, bn)
    return np.asarray(policy.get_action(start, goal)), policy



def family_plan_matches_jax(rng, monkeypatch, family):
    """CEMPolicy.get_action with the same injected action noise gives the
    JAX plan to 1e-5 (svg_vec plans with the prior's mean, its prior draws
    shaped (N, z_dim))."""
    kw = dict(PLAN_KW, model=family)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    start, goal = start_goal(rng, H, W)
    noise = rng.randn(6, 3, 2).astype(np.float32)
    want, _ = _jax_plan(monkeypatch, jcfg, params, bn, start, goal, noise)
    got = CEMPolicy(cfg, _port_model(cfg, params, bn), device="cpu").get_action(
        start, goal, noise=np.broadcast_to(noise, (2, 6, 3, 2)))
    assert got.shape == (3, 2)
    np.testing.assert_allclose(got, want, atol=1e-5)



def family_batched_plans_equal_single(family):
    """get_action_batched of 3 requests (padded to 4) equals their single
    plans bit for bit on the CPU: the vector models' Linears and CDNA's
    einsums give each row a result of its own inputs, robonet's buffer and
    attention are per row, and each request draws its own prior noise."""
    cfg = Config(**dict(PLAN_KW, model=family, sample_mean=False))
    policy = CEMPolicy(cfg, get_model(cfg).init(cfg, 0, "cpu"), device="cpu")
    reqs = [start_goal(np.random.RandomState(i), H, W) for i in range(3)]
    singles = [policy.get_action(s, g, ep_num=i, step=1)
               for i, (s, g) in enumerate(reqs)]
    got = policy.get_action_batched([r[0] for r in reqs], [r[1] for r in reqs],
                                    ep_nums=[0, 1, 2], steps=[1, 1, 1])
    for i in range(3):
        np.testing.assert_array_equal(got[i], singles[i])
    assert len({p.tobytes() for p in singles}) == 3



# ------------------------------------------------- train and eval steps
_JAX_STEPS = {}
TRAIN_B = 2
# The vector encoder's c5 BatchNorm normalises TRAIN_B = 2 values a channel
# in train mode (a 1x1 map), which comes out near +-1 whatever they are: the
# gradients of its scale and bias are ill-conditioned in float32, and at
# det_vec's sched 0 step JAX's own float32 gradient of the scale lay 1.2e-2
# of its norm from the same step computed by the port in float64, the
# port's float32 one 0 (the port 1.2e-2 from JAX). These two leaves are
# held to 4x that reading; every other leaf to GRAD_TOL_JAX.
_C5_BN = ("['encoder']['c5']['bn']['scale']", "['encoder']['c5']['bn']['bias']")
_C5_BN_TOL = 5e-2


def _jax_steps(family):
    """JAX trees, windows, the train step's results at sched_prob 1 and 0
    (the reference's weight scale, where GRAD_TOL_JAX was set) and the
    autoregressive eval step's, with jax.random.normal and the vector
    encoder's dropout patched to the injected draws; cached per family."""
    if family in _JAX_STEPS:
        return _JAX_STEPS[family]
    kw = dict(FAM_KW, model=family)
    if family.endswith("_vec"):
        kw["dropout"] = 0.25
    jcfg = JConfig(**kw)
    params, bn = _jax_trees(jcfg)
    tparams, tbn = _jax_trees(jcfg, he=False)
    if family == "svg_vec":  # the prior unlike the posterior at this scale too
        tparams["prior"]["mu"]["b"][:] = 0.3
        tparams["prior"]["logvar"]["b"][:] = -0.5
    batch = window(jsynthetic_batch(jcfg, TRAIN_B, 8, seed=0), 4)
    # the synthetic frames' flat regions tie in the max pools, whose
    # gradient goes to one entry of a tie; float32 rounding picks it, and
    # svg_vec's action-encoder gradients then differed by 2.1e-2 of their
    # norm between the port and JAX (the port in float64 and JAX agreeing);
    # frames moved by U(0, 1e-2) have no ties, and differ by 7.4e-5
    images = batch["images"] * 0.99
    batch["images"] = (images + np.random.RandomState(9).uniform(
        0, 1e-2, images.shape)).astype(np.float32)
    ebatch = window(jsynthetic_batch(jcfg, TRAIN_B, 8, seed=5), 4)
    masks = _keep_masks(2 if family == "svg_vec" else 1, TRAIN_B)
    out = {"cfg": jcfg, "params": params, "bn": bn, "train_params": tparams,
           "train_bn": tbn, "batch": batch, "ebatch": ebatch, "masks": masks,
           "train": {}}
    copy = lambda t: jax.tree_util.tree_map(jnp.array, t)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "normal", fake_jax_normal)
        mp.setattr(jencoders, "_dropout2d", _InjectedDropout(masks))
        step, tx = jstep.make_train_step(jcfg)
        for sched in (1.0, 0.0):
            new_p, new_bn, _, metrics = step(
                copy(tparams), copy(tbn), tx.init(tparams),
                {k: jnp.asarray(v) for k, v in batch.items()},
                jax.random.PRNGKey(3), jnp.float32(sched))
            out["train"][sched] = np_tree(new_p), np_tree(new_bn), np_tree(metrics)
        per_step, preds = jstep.make_eval_step(jcfg, True)(
            params, bn, {k: jnp.asarray(v) for k, v in ebatch.items()},
            jax.random.PRNGKey(4))
        out["eval"] = np_tree(per_step), np.asarray(preds)
    _JAX_STEPS[family] = out
    return out


def _port_noise(cfg, steps, B, use_truth, masks):
    noise = {"use_truth": torch.full((steps,), use_truth),
             "eps_prior": None, "eps_post": None}
    if is_stochastic(cfg):
        eps = torch.tensor(fixed_normal((B, cfg.z_dim)))
        noise["eps_prior"] = noise["eps_post"] = eps.expand(steps, B, cfg.z_dim)
    if cfg.dropout is not None:
        noise["drop"] = _port_drop(masks, steps)
    return noise


# biases of convolutions whose output a train-mode BatchNorm normalises
_BN_FED_BIASES = {f: ("['encoder']['c5']['conv']['b']",
                      "['decoder']['upc1']['conv']['b']")
                  for f in ("svg_vec", "det_vec")}


def family_train_step_matches_jax(family, sched):
    """One whole-window train step (sgd at lr 1) at scheduled-sampling
    probability 1 (ground truth fed) and 0 (the model's own frames after
    the first step) against make_train_step: metrics (kld for svg_vec
    alone) to 1e-4, BatchNorm statistics to 1e-5, every gradient to
    GRAD_TOL_JAX of its leaf's norm; the vector models with the same
    channel-dropout masks in both, CDNA warping the context frame
    x[n_past - 1]. The port's convolutions run without oneDNN, whose CPU
    convolutions round more than XLA's: with it det_vec's worst leaf read
    1.6e-2 of its norm, without it 5.9e-5 (the frames as `_jax_steps` makes
    them)."""
    ref = _jax_steps(family)
    jcfg = ref["cfg"]
    cfg = Config(**{f: getattr(jcfg, f) for f in Config.__dataclass_fields__})
    model = _port_model(cfg, ref["train_params"], ref["train_bn"], train=True)
    step, _ = make_train_step(cfg, model)
    before, _ = convert.jax_flat_trees(model)
    with torch.backends.mkldnn.flags(enabled=False):
        metrics = step(torch_batch(ref["batch"]), sched,
                       noise=_port_noise(cfg, 3, TRAIN_B, sched == 1.0,
                                        ref["masks"]))
    after, got_bn = convert.jax_flat_trees(model)
    new_p, new_bn, jmetrics = ref["train"][sched]
    assert set(metrics) == set(jmetrics)
    assert ("kld" in metrics) == (family == "svg_vec")
    for k, v in jmetrics.items():
        np.testing.assert_allclose(float(metrics[k]), v, **STEP_TOL, err_msg=k)
    # sgd at lr 1: a step's change is minus its gradient
    old, errs, grads = flat(ref["train_params"]), {}, {}
    for k, v in flat(new_p).items():
        g = old[k] - v
        grads[k] = (np.linalg.norm(before[k] - after[k]), np.linalg.norm(g))
        errs[k] = float(np.linalg.norm((before[k] - after[k]) - g)
                        / max(np.linalg.norm(g), 1e-30))
    assert set(errs) == set(before)
    # the bias of a convolution ahead of a train-mode BatchNorm has a zero
    # gradient (the batch mean takes it out): both packages' are rounding
    largest = max(w for _, w in grads.values())
    for k in _BN_FED_BIASES.get(family, ()):
        assert max(grads.pop(k)) <= 1e-5 * largest, k
        del errs[k]
    for k in _C5_BN:  # see _C5_BN_TOL
        if k in errs:
            assert errs.pop(k) <= _C5_BN_TOL, k
    assert max(errs.values()) <= GRAD_TOL_JAX, sorted(errs.items(), key=lambda e: -e[1])[:6]
    for k, v in flat(new_bn).items():
        np.testing.assert_allclose(got_bn[k], v, rtol=1e-5, atol=1e-6, err_msg=k)



def family_eval_step_matches_jax(family):
    """The autoregressive eval step (the prior drives svg_vec, its draws
    injected; cells through the kernel's plain version for CDNA) against
    make_eval_step: per-step metrics and predictions to 1e-4."""
    ref = _jax_steps(family)
    jcfg = ref["cfg"]
    cfg = Config(**{f: getattr(jcfg, f) for f in Config.__dataclass_fields__})
    model = _port_model(cfg, ref["params"], ref["bn"])
    noise = _port_noise(cfg, 3, TRAIN_B, True, ref["masks"])
    per_step, preds = make_eval_step(cfg, model)(torch_batch(ref["ebatch"]),
                                                 noise=noise)
    jper_step, jpreds = ref["eval"]
    assert set(per_step) == set(jper_step)
    for k, v in jper_step.items():
        np.testing.assert_allclose(per_step[k].numpy(), v, rtol=1e-4, atol=1e-6,
                                   err_msg=k)
    np.testing.assert_allclose(preds.numpy(), jpreds, rtol=1e-4, atol=1e-5)



# ------------------------------------------------- checkpoints, trainer
def _trainer_kw(tmp_path, **kw):
    return dict(dict(FAM_KW, experiment="synthetic", log_dir=str(tmp_path),
                     jobname="f", optimizer="adam", lr=1e-3, test_batch_size=2,
                     niter=1, epoch_size=1, video_length=8, eval_interval=1,
                     checkpoint_interval=1), **kw)


def _assert_flat_equal(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)



def family_checkpoints_load_both_ways(tmp_path, family):
    """A JAX checkpoint of the family (params, BatchNorm, adam state) loads
    into the port's trainer and through build_server; a port checkpoint
    after a train step loads through the JAX load_checkpoint with JAX
    templates. Every leaf equal."""
    kw = _trainer_kw(tmp_path / "port", model=family)
    jcfg = JConfig(**kw)
    params, bn = _jax_trees(jcfg)
    tx = jstep.make_optimizer(jcfg)
    r = np.random.RandomState(3)
    state = jax.tree_util.tree_map(
        lambda s: (np.asarray(4, s.dtype) if s.shape == () else
                   r.uniform(0, 1e-3, s.shape).astype(np.float32)),
        jax.eval_shape(tx.init, params))
    path = jckpt.save_checkpoint(str(tmp_path / "jax"), 5, {
        "params": params, "bn": bn, "opt": state})
    tr = PredictionTrainer(Config(**kw), device="cpu")
    tr.load_checkpoint(path)
    assert tr._step == 5
    got_p, got_bn = convert.jax_flat_trees(tr.model)
    _assert_flat_equal(got_p, flat(params))
    _assert_flat_equal(got_bn, flat(bn))
    _assert_flat_equal(convert.optimizer_to_jax(tr.cfg, tr.model, tr.optimizer),
                       flat(state))
    server = build_server(Config(**dict(kw, dynamics_model_ckpt=path)), "cpu")
    try:
        _assert_flat_equal(convert.jax_flat_trees(server.policy.model)[0],
                           flat(params))
    finally:
        server.close()
    tr.train_step(torch_batch(window(jsynthetic_batch(jcfg, 2, 4, seed=0), 4)),
                  1.0, tr._generator)
    tr._step = 6
    tr._save(0)
    tckpt.wait_for_checkpoints()
    trees, step = jckpt.load_checkpoint(tckpt.latest_checkpoint(tr.log_dir), {
        "params": params, "bn": bn, "opt": tx.init(params)})
    assert step == 6
    for name, want in tr._trees().items():
        _assert_flat_equal(flat(trees[name]), want)
    tr.logger.close()
    # the strict loads of convert refuse another family's tree
    other = "det_vec" if family != "det_vec" else "svg_vec"
    with pytest.raises(RuntimeError):
        convert.model_from_jax(Config(**dict(kw, model=other)), np_tree(params),
                               np_tree(bn), "cpu")



def trainer_trains_each_family(tmp_path, monkeypatch, family):
    """PredictionTrainer on the synthetic experiment for each family: an
    epoch with finite train and eval metrics (kld for svg_vec alone), an
    eval pass whose cells (CDNA's alone) go through the kernel's wrapper
    (its plain version on the CPU), a checkpoint, and a second trainer that
    resumes at the first's step with its weights."""
    calls = []
    wrapper = kernels.conv_lstm_cell
    monkeypatch.setattr(kernels, "conv_lstm_cell",
                        lambda *a: calls.append(1) or wrapper(*a))
    kw = _trainer_kw(tmp_path, model=family)
    tr = PredictionTrainer(Config(**kw), device="cpu")
    tr.train()
    assert (len(calls) > 0) == family.startswith("cdna")
    tr.logger.close()
    import json

    with open(f"{tr.log_dir}/metrics.jsonl") as f:
        recs = [json.loads(line) for line in f]
    train = [r for r in recs if "train/loss" in r]
    ev = [r for r in recs if "eval/autoreg_psnr" in r]
    assert len(train) == 1 and len(ev) == 1
    assert ("train/kld" in train[0]) == (family == "svg_vec")
    assert all(np.isfinite(v) for r in train + ev for v in r.values())
    again = PredictionTrainer(Config(**kw), device="cpu")
    again._resume()
    assert again._step == tr._step > 0
    for k, v in tr.model.state_dict().items():
        assert torch.equal(again.model.state_dict()[k], v), k
    again.logger.close()



def get_model_builds_every_family(family):
    """The registry builds each family (no family raises), with its carry;
    svg_vec alone is stochastic among them."""
    cfg = Config(**dict(PLAN_KW, model=family))
    mod = get_model(cfg)
    model = mod.init(cfg, 0, "cpu")
    assert not model.training
    carry = mod.init_carry(cfg, 2, torch.float32, "cpu")
    assert type(carry).__name__ in ("Carry", "DetCarry", "RobonetCarry")
    assert is_stochastic(cfg) == (family == "svg_vec")
