"""svg_vec, the stochastic vector family, and its fc-LSTM stacks held
against the JAX package on the CPU: the LSTM cell (torch's gate order),
the LSTM and GaussianLSTM stacks, the MLP encoder, the family's steps,
rollouts (float32 and bf16), CEM plans, batched == single plans, train
and eval steps, checkpoints both ways and its trainer (the checks of
tests/torch_family_jax.py), and the debug_cem rollout plots. det_vec and
the vector encoder/decoder are in test_torch_port_families_det_vec.py,
CDNA in test_torch_port_families_cdna.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.ops import lstm as jlstm
from robot_aware_control_tpu.ops import nn as jnn
from robot_aware_control_tpu.training import plot as jplot
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.ops import lstm as tlstm
from robot_aware_control_tpu_torch.ops.nn import MLPEncoder
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.training import plot as tplot
import torch_family_jax as fj
from torch_family_jax import (
    PLAN_KW,
    TOL,
    H,
    W,
    _jax_plan,
    _jax_trees,
    _jtree,
    _port_model,
    _t,
)
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)
from torch_train_cases import fake_jax_normal, fixed_normal, random_tree
from torch_variant_cases import start_goal

# this module's families, and their rollout cases
FAMILIES = ("svg_vec",)
ROLLOUT_CASES = [("svg_vec", "float32"), ("svg_vec", "bfloat16")]


# ------------------------------------------------------------ fc-LSTMs
def test_lstm_cell_matches_jax(rng):
    """LSTMCell against lstm_cell (torch gate order i, f, g, o), float32:
    h' and c' to 1e-5; the conv cell's order i, f, o, g is far off."""
    shapes = jax.eval_shape(lambda k: jlstm.lstm_cell_init(k, 12, 8),
                            jax.random.PRNGKey(0))
    params = random_tree(shapes, rng)
    x, h, c = (rng.randn(3, n).astype(np.float32) for n in (12, 8, 8))
    want_h, (_, want_c) = jlstm.lstm_cell(_jtree(params), (jnp.asarray(h),
                                          jnp.asarray(c)), jnp.asarray(x))
    cell = tlstm.LSTMCell(12, 8)
    cell.load_state_dict(convert.svg_state_dict(params, {}), strict=True)
    with torch.no_grad():
        got_h, (_, got_c) = cell(_t(x), (_t(h), _t(c)))
        gi, gf, gg, go = cell.ih(_t(x)).add(cell.hh(_t(h))).chunk(4, -1)
        conv_order_c = torch.sigmoid(gf) * _t(c) + torch.sigmoid(gi) * torch.tanh(go)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), **TOL)
    np.testing.assert_allclose(got_c.numpy(), np.asarray(want_c), **TOL)
    assert np.abs(conv_order_c.numpy() - np.asarray(want_c)).max() > 1e-2


@pytest.mark.parametrize("kind", ["lstm", "gaussian"])
def test_lstm_stacks_match_jax(rng, monkeypatch, kind):
    """LSTM (embed, 2 cells, tanh head) and GaussianLSTM (mu, logvar and
    the reparameterized z with the draw injected) against the JAX stacks,
    float32, to 1e-5, the new (h, c) of both cells too."""
    din, dout, dhid, B = 10, 6, 8, 3
    init = jlstm.lstm_init if kind == "lstm" else jlstm.gaussian_lstm_init
    shapes = jax.eval_shape(lambda k: init(k, din, dout, dhid, 2),
                            jax.random.PRNGKey(0))
    params = random_tree(shapes, rng)
    x = rng.randn(B, din).astype(np.float32)
    state = tuple((rng.randn(B, dhid).astype(np.float32),
                   rng.randn(B, dhid).astype(np.float32)) for _ in range(2))
    jstate = jax.tree_util.tree_map(jnp.asarray, state)
    cls = tlstm.LSTM if kind == "lstm" else tlstm.GaussianLSTM
    stack = cls(din, dout, dhid, 2)
    stack.load_state_dict(convert.svg_state_dict(params, {}), strict=True)
    tstate = tuple((_t(h), _t(c)) for h, c in state)
    eps = fixed_normal((B, dout))
    with torch.no_grad():
        if kind == "lstm":
            want = jlstm.lstm_apply(_jtree(params), jstate, jnp.asarray(x))
            got = stack(_t(x), tstate)
        else:
            monkeypatch.setattr(jax.random, "normal", fake_jax_normal)
            want = jlstm.gaussian_lstm_apply(_jtree(params), jstate,
                                             jnp.asarray(x), jax.random.PRNGKey(0))
            got = stack(_t(x), tstate, eps=torch.tensor(eps))
    for g, w in zip(jax.tree_util.tree_leaves(got),
                    jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g), np.asarray(w), **TOL)
    zeros = tlstm.lstm_zero_state(B, dhid, 2)
    assert [tuple(t.shape) for s in zeros for t in s] == [(B, dhid)] * 4


def test_mlp_encoder_matches_jax(rng):
    shapes = jax.eval_shape(lambda k: jnn.mlp_encoder_init(k, 5, 4, 32),
                            jax.random.PRNGKey(0))
    params = random_tree(shapes, rng)
    x = rng.randn(7, 5).astype(np.float32)
    mlp = MLPEncoder(5, 4)
    mlp.load_state_dict(convert.svg_state_dict(params, {}), strict=True)
    with torch.no_grad():
        got = mlp(_t(x)).numpy()
    np.testing.assert_allclose(got, np.asarray(jnn.mlp_encoder(
        _jtree(params), jnp.asarray(x))), **TOL)


# ------------------------------------------------------------ debug_cem
def test_debug_cem_frames_match_jax(rng, monkeypatch, tmp_path):
    """debug_cem (JAX `cem.py:_plot_rollouts`): the plan's rollout beside
    the last goal frame, handed to save_gif (patched in both packages) as
    horizon-1 frames of (H, 2 W, 3), equal to the JAX policy's to 1e-4;
    the path names the episode and step."""
    kw = dict(PLAN_KW, model="svg_vec", debug_cem=True,
              log_dir=str(tmp_path))
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    start, goal = start_goal(rng, H, W)
    noise = rng.randn(6, 3, 2).astype(np.float32)
    saved = {"jax": [], "port": []}
    monkeypatch.setattr(jplot, "save_gif", lambda p, f, fps=2: saved["jax"].append((p, f)))
    monkeypatch.setattr(tplot, "save_gif", lambda p, f, fps=2: saved["port"].append((p, f)))
    want_plan, _ = _jax_plan(monkeypatch, jcfg, params, bn, start, goal, noise)
    got_plan = CEMPolicy(cfg, _port_model(cfg, params, bn), device="cpu").get_action(
        start, goal, noise=np.broadcast_to(noise, (2, 6, 3, 2)))
    np.testing.assert_allclose(got_plan, want_plan, atol=1e-5)
    (jpath, jframes), = saved["jax"]
    (path, frames), = saved["port"]
    assert path == jpath == str(tmp_path / "debug_cem_ep0_step0.gif")
    assert len(frames) == len(jframes) == 3
    for got, want in zip(frames, jframes):
        assert got.shape == (H, 2 * W, 3)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4, atol=1e-5)


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
