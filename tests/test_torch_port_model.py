"""The port's SVG model, its layers and the locobot kinematics held against
the JAX package on the CPU, in float32, with the same parameters carried
across by `convert.py`; plus the port's import and device rules."""

import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.ops import encoders as jenc
from robot_aware_control_tpu.robot import locobot_kinematics as jlk
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.convert import svg_from_jax
from robot_aware_control_tpu_torch.models import svg as tsvg
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.robot import locobot_kinematics as tlk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODEL_KW = dict(
    model="svg", g_dim=16, z_dim=4, image_height=48, image_width=64,
    action_dim=5, robot_dim=5, model_use_mask=True, model_use_future_mask=True,
    model_use_robot_state=True, reconstruction_loss="dontcare_l1",
    compute_dtype="float32",
)
# Tolerances: 1e-5 for single float32 ops; 1e-4 for stacks of convolutions
# (encoder, decoder, a model step), where float32 sums taken in another
# order by XLA and by PyTorch's CPU kernels drift by a few units of 1e-6.
STACK_TOL = dict(rtol=1e-4, atol=1e-5)


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.fixture(scope="module")
def models():
    jcfg = JConfig(**MODEL_KW)
    # jitted: one compile instead of one per op, half the time on the CPU
    params, bn = jax.jit(jsvg.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    r = np.random.RandomState(1)  # non-trivial BatchNorm statistics
    bn = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32)), bn)
    cfg = Config(**MODEL_KW)
    return jcfg, params, bn, cfg, svg_from_jax(cfg, _np(params), _np(bn), "cpu")


def _t(a):
    return None if a is None else torch.tensor(np.asarray(a))


def _inputs(rng, B=3):
    return dict(
        image=rng.rand(B, 48, 64, 3).astype(np.float32),
        mask=(rng.rand(B, 48, 64, 2) > 0.7).astype(np.float32),
        robot=rng.rand(B, 5).astype(np.float32),
        action=(rng.randn(B, 5) * 0.05).astype(np.float32),
    )


# ---------------------------------------------------------------- convert
def test_convert_strict_loads_every_parameter(models):
    """Every port parameter and statistic comes from the JAX tree (a strict
    load), conv weights as OIHW and the cells' gates in the kernel layout."""
    jcfg, params, bn, cfg, model = models
    fresh = svg_from_jax(cfg, _np(params), _np(bn), "cpu")
    w = fresh.prior.lstm.cell0.weight
    assert tuple(w.shape) == (5, 5, 32, 64)  # HWIO, in = x + h, out = 4 hid
    np.testing.assert_array_equal(
        w.numpy(), np.asarray(params["prior"]["lstm"]["cell0"]["gates"]["w"]))
    np.testing.assert_array_equal(
        fresh.frame_in.weight.numpy(),
        np.asarray(params["frame_in"]["w"]).transpose(3, 2, 0, 1))
    np.testing.assert_array_equal(
        fresh.encoder.c3[1].bn.running_var.numpy(),
        np.asarray(bn["encoder"]["c3"][1]["bn"]["var"]))


def test_bf16_model_keeps_bn_and_cell_bias_f32(models):
    _, params, bn, cfg, _ = models
    m = svg_from_jax(cfg.replace(compute_dtype="bfloat16"), _np(params),
                     _np(bn), "cpu")
    assert m.frame_lstm.cell0.weight.dtype == torch.bfloat16
    assert m.encoder.c1[0].conv.weight.dtype == torch.bfloat16
    assert m.frame_lstm.cell0.bias.dtype == torch.float32
    assert m.encoder.c1[0].bn.weight.dtype == torch.float32


# --------------------------------------------------------- encoder/decoder
def test_conv_encoder_decoder_match_jax(models, rng):
    _, params, bn, _, model = models
    x = rng.rand(2, 48, 64, 5).astype(np.float32)
    h, skips, _ = jenc.conv_encoder(params["encoder"], bn["encoder"],
                                    jnp.asarray(x), False)
    out, _ = jenc.conv_decoder(params["decoder"], bn["decoder"], h, skips,
                               False)
    with torch.no_grad():
        th, tskips = model.encoder(_t(x))
        tout = model.decoder(th, tskips)
    assert tout.shape == (2, 48, 64, 4)
    for got, want in zip([th, tout] + tskips, [h, out] + skips):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **STACK_TOL)


# --------------------------------------------------------------- SVG step
def _jax_step(jcfg, params, bn, carry, inp, key, **kw):
    out, carry, _ = jsvg.step(
        jcfg, params, bn, carry, jnp.asarray(inp["image"]),
        jnp.asarray(inp["mask"]), jnp.asarray(inp["robot"]), None,
        jnp.asarray(inp["action"]), key, **kw)
    return out, carry


def _check_carry(got, want):
    for g, w in zip(jax.tree_util.tree_leaves(tuple(got)),
                    jax.tree_util.tree_leaves(tuple(want))):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **STACK_TOL)


def test_svg_window_matches_jax(models, rng):
    """Three prior steps with sample_mean=True, carrying the recurrent state
    and the first step's skips, as the rollout does."""
    jcfg, params, bn, cfg, model = models
    jcarry = jsvg.init_carry(jcfg, 3)
    tcarry = tsvg.init_carry(cfg, 3)
    gen = torch.Generator().manual_seed(0)
    jskip = tskip = None
    for t in range(3):
        inp = _inputs(rng)
        jout, jcarry = _jax_step(jcfg, params, bn, jcarry, inp,
                                 jax.random.PRNGKey(t), skip=jskip,
                                 sample_mean=True)
        with torch.no_grad():
            tout, tcarry = model(tcarry, generator=gen, skip=tskip,
                                 sample_mean=True, heatmap=None,
                                 **{k: _t(v) for k, v in inp.items()})
        jskip, tskip = jout["skip"], tout["skip"]
        for k in ("x_pred", "mu_p", "logvar_p"):
            np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                       **STACK_TOL)
        _check_carry(tcarry, jcarry)


def test_svg_posterior_step_matches_jax(models, rng):
    """The posterior branch (next frame given): its statistics and carry,
    and the prior-driven prediction under force_use_prior."""
    jcfg, params, bn, cfg, model = models
    inp, nxt = _inputs(rng), _inputs(rng)
    kw = dict(next_mask=nxt["mask"], next_robot=nxt["robot"],
              force_use_prior=True, sample_mean=True)
    jout, jcarry = _jax_step(jcfg, params, bn, jsvg.init_carry(jcfg, 3), inp,
                             jax.random.PRNGKey(0),
                             next_image=jnp.asarray(nxt["image"]),
                             **{k: (jnp.asarray(v) if isinstance(v, np.ndarray)
                                    else v) for k, v in kw.items()})
    with torch.no_grad():
        tout, tcarry = model(tsvg.init_carry(cfg, 3),
                             generator=torch.Generator().manual_seed(0),
                             heatmap=None, next_image=_t(nxt["image"]),
                             **{k: _t(v) for k, v in inp.items()},
                             **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                                for k, v in kw.items()})
    for k in ("x_pred", "mu", "logvar"):
        np.testing.assert_allclose(tout[k].numpy(), np.asarray(jout[k]),
                                   **STACK_TOL)
    _check_carry(tcarry, jcarry)


def test_reparameterize_draws_from_generator():
    from robot_aware_control_tpu_torch.ops.lstm import reparameterize

    mu = torch.zeros(2, 3, 4, 5, dtype=torch.bfloat16)
    lv = torch.zeros_like(mu)
    a = reparameterize(mu, lv, torch.Generator().manual_seed(3))
    b = reparameterize(mu, lv, torch.Generator().manual_seed(3))
    assert a.dtype == torch.bfloat16 and torch.equal(a, b) and a.std() > 0.5


# ------------------------------------------------------------- kinematics
def test_ik_fk_match_jax(rng):
    """IK targets in the planar-push band and FK of random poses, to 1e-5:
    atan2/sqrt/sin/cos differ between the two libraries in the last ulps."""
    tgt = np.stack([rng.uniform(0.25, 0.45, 64), rng.uniform(-0.2, 0.2, 64),
                    np.full(64, 0.15)], -1).astype(np.float32)
    cur = rng.uniform(-0.5, 0.5, (64, 4)).astype(np.float32)
    th_j, ok_j = jlk.ik(jnp.asarray(tgt), -1.3, jnp.asarray(cur))
    th_t, ok_t = tlk.ik(torch.tensor(tgt), -1.3, torch.tensor(cur))
    np.testing.assert_array_equal(ok_t.numpy(), np.asarray(ok_j))
    assert ok_t.all()
    np.testing.assert_allclose(th_t.numpy(), np.asarray(th_j), atol=1e-5)
    q = rng.uniform(-0.5, 0.5, (2, 7, 5)).astype(np.float32)
    np.testing.assert_allclose(tlk.fk_points(torch.tensor(q)).numpy(),
                               np.asarray(jlk.fk_points(jnp.asarray(q))),
                               atol=1e-5)


def test_integrate_planar_actions_matches_jax(rng):
    start = np.array([[0.3, 0.0, 0.15, 0.0, 0.0]] * 6, np.float32)
    q0 = np.zeros((6, 5), np.float32)
    acts = rng.uniform(-0.05, 0.05, (4, 6, 2)).astype(np.float32)
    s_j, q_j = jlk.integrate_planar_actions(jnp.asarray(start),
                                            jnp.asarray(q0), jnp.asarray(acts))
    s_t, q_t = tlk.integrate_planar_actions(torch.tensor(start),
                                            torch.tensor(q0), torch.tensor(acts))
    assert s_t.shape == (5, 6, 5) and q_t.shape == (5, 6, 5)
    np.testing.assert_allclose(s_t.numpy(), np.asarray(s_j), atol=1e-6)
    np.testing.assert_allclose(q_t.numpy(), np.asarray(q_j), atol=1e-5)


# --------------------------------------------------- imports and devices
def test_port_imports_neither_jax_nor_the_jax_package():
    """Every module of the port, and chip_smoke, imports without pulling
    in jax or robot_aware_control_tpu (the port's own name starts with the
    JAX package's, so top-level names are compared exactly)."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import robot_aware_control_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "top = {n.split('.')[0] for n in sys.modules}\n"
        "bad = top & {'jax', 'jaxlib', 'robot_aware_control_tpu'}\n"
        "assert not bad, bad\n"
        "print(len([n for n in sys.modules if n.startswith(p.__name__)]))\n"
    )
    env = dict(os.environ, PYTHONPATH=REPO)
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert int(r.stdout.split()[-1]) >= 20


def test_entry_points_need_a_gpu_unless_told_cpu(models):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is available")
    _, _, _, cfg, model = models
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tsvg.init(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        CEMPolicy(cfg, model)
    assert CEMPolicy(cfg, model, device="cpu").device.type == "cpu"
