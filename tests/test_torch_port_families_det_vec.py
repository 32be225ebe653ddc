"""det_vec, the deterministic vector family, the vector encoder and decoder
both vector families share (channel dropout injected; a planted
unflipped transpose-conv weight rejected), and the inverse model, held
against the JAX package on the CPU; det_vec's steps, rollouts, CEM plans,
batched == single plans, train and eval steps, checkpoints both ways and
its trainer are the checks of tests/torch_family_jax.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import inverse_model as jinverse
from robot_aware_control_tpu.ops import encoders as jencoders
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import inverse_model as tinverse
from robot_aware_control_tpu_torch.ops.encoders import SKIP_CHANNELS, Decoder, Encoder
from robot_aware_control_tpu_torch.ops.nn import apply_batch_stats
from torch_family_cases import INVERSE, INVERSE_HORIZON, inverse_batch
import torch_family_jax as fj
from torch_family_jax import (
    TOL,
    H,
    W,
    _InjectedDropout,
    _jtree,
    _keep_masks,
    _t,
)
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import flat, np_tree, random_tree

# this module's families, and their rollout cases
FAMILIES = ("det_vec",)
ROLLOUT_CASES = [("det_vec", "float32")]


# ---------------------------------------------------- vector encoder/decoder
def _vector_case(rng, init, *args):
    shapes = jax.eval_shape(lambda k: init(k, *args), jax.random.PRNGKey(0))
    return random_tree(shapes, rng)


@pytest.mark.parametrize("mode", ["eval", "train", "train_dropout"])
def test_vector_encoder_matches_jax(rng, monkeypatch, mode):
    """The vector Encoder (c1-c4 VGG stacks, c5 VALID (fh, fw) conv +
    BatchNorm + tanh) against the JAX encoder at 16x32 (fh, fw = 1, 2):
    the g_dim vector and the four skips to 1e-5 in eval mode; in train mode
    to 2e-4 (batch statistics: c5's BatchNorm normalises 3 values a
    channel, and JAX's own float32 result lies up to 3.8e-5 from the same
    function in float64, the port's 3.4e-5, seeds 0-2), with the BatchNorm
    statistics it returns; with dropout the same keep masks injected into
    both (JAX `_dropout2d` patched). The port's convolutions run without
    oneDNN here, whose CPU convolutions round more than XLA's: through 13
    float32 convolutions at He scale it differed from JAX by up to 1.95e-5
    in eval mode (seeds 0-5; from the port's module in float64 by 1.63e-5,
    JAX by 3.3e-6), without oneDNN by 3.0e-6."""
    B, nc, g = 3, 5, 16
    params, state = _vector_case(rng, jencoders.encoder_init, g, nc, (1, 2))
    x = rng.rand(B, H, W, nc).astype(np.float32)
    train = mode != "eval"
    masks = _keep_masks(1, B)[0] if mode == "train_dropout" else None
    if masks is not None:
        monkeypatch.setattr(jencoders, "_dropout2d", _InjectedDropout([masks]))
    want_h, want_skips, want_state = jencoders.encoder(
        _jtree(params), _jtree(state), jnp.asarray(x), train,
        dropout_rate=0.25 if masks else None,
        dropout_rng=jax.random.PRNGKey(0) if masks else None)
    enc = Encoder(g, nc, (1, 2))
    enc.load_state_dict(convert.svg_state_dict(params, state), strict=True)
    stats = [] if train else None
    with torch.no_grad(), torch.backends.mkldnn.flags(enabled=False):
        h, skips = enc(_t(x), stats,
                       None if masks is None else [_t(m) > 0.5 for m in masks],
                       0.25)
    assert h.shape == (B, g)
    tol = dict(rtol=1e-5, atol=2e-4) if train else TOL
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **tol)
    for got, want in zip(skips, want_skips):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **tol)
    if train:
        apply_batch_stats(stats)
        got_state = convert.jax_flat_trees(enc)[1]
        for k, v in flat(want_state).items():
            np.testing.assert_allclose(got_state[k], v, rtol=1e-5, atol=1e-6)
    if masks is not None:  # the masks moved the output
        undropped = jencoders.encoder(_jtree(params), _jtree(state),
                                      jnp.asarray(x), train)[0]
        assert np.abs(np.asarray(undropped) - np.asarray(want_h)).max() > 1e-2


def _decoder_case(rng, B=3, g=16):
    params, state = _vector_case(rng, jencoders.decoder_init, g, 3, (1, 2))
    vec = np.tanh(rng.randn(B, g)).astype(np.float32)
    skips = [rng.rand(B, H // 2 ** i, W // 2 ** i, c).astype(np.float32)
             for i, c in enumerate(SKIP_CHANNELS)]
    return params, state, vec, skips


def _port_decoder(params, state):
    dec = Decoder(16, 3, (1, 2))
    dec.load_state_dict(convert.svg_state_dict(params, state), strict=True)
    return dec


@pytest.mark.parametrize("train", [False, True])
def test_vector_decoder_matches_jax(rng, train):
    """The vector Decoder (upc1's VALID transpose conv from the vector to
    (fh, fw), BatchNorm, LeakyReLU, four upsample + skip + VGG stages,
    sigmoid) against the JAX decoder: frames to 1e-5."""
    params, state, vec, skips = _decoder_case(rng)
    want, _ = jencoders.decoder(_jtree(params), _jtree(state), jnp.asarray(vec),
                                [jnp.asarray(s) for s in skips], train)
    with torch.no_grad():
        got = _port_decoder(params, state)(_t(vec), [_t(s) for s in skips],
                                           [] if train else None)
    assert got.shape == (3, H, W, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_decoder_parity_rejects_an_unflipped_transpose_weight(rng):
    """`lax.conv_transpose` does not flip its kernel and
    `F.conv_transpose2d` does: the port flips it once, in ConvTranspose.
    The same check with upc1's weight flipped spatially in the state dict
    (the unflipped torch call) fails by far more than its tolerance; the
    transpose conv alone equals JAX's to 1e-5 at (3, 4, 2, 5) weights."""
    params, state, vec, skips = _decoder_case(rng)
    want, _ = jencoders.decoder(_jtree(params), _jtree(state), jnp.asarray(vec),
                                [jnp.asarray(s) for s in skips], False)
    bad = jax.tree_util.tree_map(np.copy, params)
    bad["upc1"]["conv"]["w"] = bad["upc1"]["conv"]["w"][::-1, ::-1].copy()
    with torch.no_grad():
        got = _port_decoder(bad, state)(_t(vec), [_t(s) for s in skips])
    assert np.abs(got.numpy() - np.asarray(want)).max() > 100 * TOL["atol"]
    # the transpose conv alone, at an asymmetric kernel
    from robot_aware_control_tpu_torch.ops.nn import ConvTranspose

    w = rng.randn(3, 4, 2, 5).astype(np.float32)
    b = rng.randn(5).astype(np.float32)
    x = rng.randn(6, 2).astype(np.float32)
    want = jencoders._conv_transpose_valid(
        {"w": jnp.asarray(w), "b": jnp.asarray(b)}, jnp.asarray(x)[:, None, None])
    tc = ConvTranspose(2, 5, (3, 4))
    tc.load_state_dict({"weight": _t(w.transpose(3, 2, 0, 1)), "bias": _t(b)})
    with torch.no_grad():
        np.testing.assert_allclose(tc(_t(x)).numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------ inverse model
def _inverse_trees(discretized, bins):
    cfg = JConfig(**INVERSE)
    shapes = jax.eval_shape(lambda k: jinverse.init(
        k, cfg, INVERSE_HORIZON, discretized=discretized, bins=bins),
        jax.random.PRNGKey(0))
    return cfg, random_tree(shapes, np.random.RandomState(0))


def _port_inverse(params, discretized, bins):
    model = tinverse.InverseModel(Config(**INVERSE), INVERSE_HORIZON,
                                  discretized=discretized, bins=bins)
    model.load_state_dict(convert.svg_state_dict(params, {}), strict=True)
    return model


@pytest.mark.parametrize("discretized", [False, True])
def test_inverse_apply_matches_jax(discretized):
    """apply: both frames through the shared stride-2 conv stack (XLA's
    SAME padding, the odd pixel at the far end), the MLP head; actions or
    logits to 1e-5."""
    bins = 5 if discretized else 0
    jcfg, params = _inverse_trees(discretized, bins)
    start, goal, _ = inverse_batch(4, 48, 64)
    want = jinverse.apply(_jtree(params), jcfg, jnp.asarray(start.numpy()),
                          jnp.asarray(goal.numpy()), INVERSE_HORIZON,
                          discretized, bins)
    with torch.no_grad():
        got = tinverse.apply(_port_inverse(params, discretized, bins), start, goal)
    assert got.shape == ((4, 3, 2, 5) if discretized else (4, 3, 2))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("discretized", [False, True])
def test_inverse_step_matches_jax(discretized):
    """One train step (Adam, lr 1e-3) against make_inverse_train_step: the
    loss to 1e-5 relative and every parameter after the step to 1e-5
    absolute, 1% of a step: a first Adam step moves a weight by lr g /
    (|g| + 1e-8), about lr wherever |g| is well above 1e-8 (where it is
    not, float32 noise in g moves the step: 2.1e-6 at one of fc1's 65536
    weights)."""
    bins = 5 if discretized else 11
    jcfg, params = _inverse_trees(discretized, bins if discretized else 0)
    start, goal, acts = inverse_batch(4, 48, 64, discretized=discretized)
    step, tx = jinverse.make_inverse_train_step(jcfg, INVERSE_HORIZON,
                                                discretized=discretized, bins=bins)
    jp = _jtree(params)
    new_p, _, loss = step(jp, tx.init(jp), *(jnp.asarray(t.numpy())
                                             for t in (start, goal, acts)))
    model = _port_inverse(params, discretized, bins if discretized else 0)
    tstep, _ = tinverse.make_inverse_train_step(Config(**INVERSE),
                                                INVERSE_HORIZON, model,
                                                discretized=discretized,
                                                bins=bins)
    got_loss = tstep(start, goal, acts)
    np.testing.assert_allclose(float(got_loss), float(loss), rtol=1e-5)
    got = convert.jax_flat_trees(model)[0]
    for k, v in flat(np_tree(new_p)).items():
        np.testing.assert_allclose(got[k], v, rtol=1e-5, atol=1e-5, err_msg=k)


def test_inverse_model_learns():
    """(tests/test_collect_inverse.py) 20 steps on one batch of 8 at
    16x16: the loss falls."""
    cfg = Config(**INVERSE)
    model = tinverse.init(cfg, INVERSE_HORIZON, device="cpu")
    step, _ = tinverse.make_inverse_train_step(cfg, INVERSE_HORIZON, model)
    batch = inverse_batch(8, 16, 16)
    losses = [float(step(*batch)) for _ in range(20)]
    assert losses[-1] < losses[0]


def test_inverse_model_discretized():
    """(tests/test_collect_inverse.py) The discretized head: a finite loss
    on actions in [-1, 1]; the labels truncate (a01 x bins) toward zero,
    then clip to [0, bins - 1], as the JAX step's astype(int32) and clip."""
    cfg = Config(**INVERSE)
    model = tinverse.init(cfg, 2, discretized=True, bins=5, device="cpu")
    step, _ = tinverse.make_inverse_train_step(cfg, 2, model, discretized=True,
                                               bins=5)
    start, goal, _ = inverse_batch(4, 16, 16)
    acts = torch.tensor(np.random.RandomState(1).uniform(-1, 1, (4, 2, 2)),
                        dtype=torch.float32)
    assert np.isfinite(float(step(start, goal, acts)))
    # -1.1 -> a01 -0.05 -> x5 -0.25 -> 0 (toward zero); 0.99 -> 4.975 -> 4;
    # 1.5 -> 6.25 -> 6 -> clipped 4
    edge = torch.tensor([-1.1, -1.0, -0.61, 0.99, 1.5]).reshape(1, 1, 5)
    a01 = (edge + 1.0) / 2.0
    labels = (a01 * 5).to(torch.int64).clamp(0, 4)
    want = jnp.clip((jnp.asarray(a01.numpy()) * 5).astype(jnp.int32), 0, 4)
    np.testing.assert_array_equal(labels.numpy(), np.asarray(want))
    assert labels.flatten().tolist() == [0, 0, 0, 4, 4]
    with pytest.raises(ValueError):
        tinverse.make_inverse_train_step(cfg, 2, model, discretized=False)


# ------------------------------------- torch_family_jax's checks, over FAMILIES
@pytest.mark.parametrize("family", FAMILIES)
def test_family_steps_match_jax(rng, monkeypatch, family):
    fj.family_steps_match_jax(rng, monkeypatch, family)


@pytest.mark.parametrize("family,dtype", ROLLOUT_CASES)
def test_family_rollout_matches_jax(rng, family, dtype):
    fj.family_rollout_matches_jax(rng, family, dtype)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_plan_matches_jax(rng, monkeypatch, family):
    fj.family_plan_matches_jax(rng, monkeypatch, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_batched_plans_equal_single(family):
    fj.family_batched_plans_equal_single(family)


@pytest.mark.parametrize("sched", [1.0, 0.0])
@pytest.mark.parametrize("family", FAMILIES)
def test_family_train_step_matches_jax(family, sched):
    fj.family_train_step_matches_jax(family, sched)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_eval_step_matches_jax(family):
    fj.family_eval_step_matches_jax(family)


@pytest.mark.parametrize("family", FAMILIES)
def test_family_checkpoints_load_both_ways(tmp_path, family):
    fj.family_checkpoints_load_both_ways(tmp_path, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_trainer_trains_each_family(tmp_path, monkeypatch, family):
    fj.trainer_trains_each_family(tmp_path, monkeypatch, family)


@pytest.mark.parametrize("family", FAMILIES)
def test_get_model_builds_every_family(family):
    fj.get_model_builds_every_family(family)
