"""The CDNA families (cdna_det, cdna_robonet) held against the JAX package
on the CPU: the kernel warp, robonet's wrapping encoding buffer, GroupNorm
cells, and each family's steps, rollouts (cdna_det in bf16 too), CEM
plans, batched == single plans, train and eval steps, checkpoints both
ways and its trainer (the checks of tests/torch_family_jax.py; the cells
through the kernel's wrapper, its plain version on the CPU)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import cdna as jcdna
from robot_aware_control_tpu.ops import lstm as jlstm
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import cdna as tcdna
from robot_aware_control_tpu_torch.ops import kernels
import torch_family_jax as fj
from torch_family_jax import (
    FAM_KW,
    STACK_TOL,
    _jax_conv_lstm,
    _jax_step,
    _jax_trees,
    _jtree,
    _port_model,
    _port_step,
    _step_inputs,
    _t,
)
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

# this module's families, and their rollout cases
FAMILIES = ("cdna_det", "cdna_robonet")
ROLLOUT_CASES = [("cdna_det", "float32"), ("cdna_robonet", "float32"),
                 ("cdna_det", "bfloat16")]


# ---------------------------------------------------------- kernel warp
@pytest.mark.parametrize("k", [5, 3])
def test_apply_cdna_kernels_matches_jax(rng, k):
    """The kernel warp (one einsum over k x k neighbourhoods) against JAX's
    on random images and normalised kernels: (B, H, W, F, C) to 1e-6."""
    img = rng.rand(2, 6, 8, 3).astype(np.float32)
    kern = rng.rand(2, k, k, 4).astype(np.float32)
    kern /= kern.sum((1, 2), keepdims=True)
    want = np.asarray(jcdna.apply_cdna_kernels(jnp.asarray(img), jnp.asarray(kern)))
    got = tcdna.apply_cdna_kernels(_t(img), _t(kern)).numpy()
    assert got.shape == (2, 6, 8, 4, 3)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_cdna_delta_kernel_shifts_the_image():
    """A delta kernel warps the image by a pure shift (the JAX family test's
    case, tests/test_model_families.py)."""
    img = torch.zeros(1, 8, 8, 1)
    img[0, 4, 4, 0] = 1.0
    k = torch.zeros(1, 3, 3, 1)
    k[0, 1, 2, 0] = 1.0  # shift left by 1
    out = tcdna.apply_cdna_kernels(img, k)
    assert float(out[0, 4, 3, 0, 0]) == pytest.approx(1.0)
    assert float(out.sum()) == pytest.approx(1.0)


# ---------------------------------------------------------------- steps
def test_robonet_buffer_wraps_like_jax(rng):
    """cdna_robonet over 18 steps, so that the 16-slot encoding buffer
    wraps (the step counter a device tensor, the write an index_copy): each
    step's x_pred, the buffer and the counter against the JAX model's."""
    kw = dict(FAM_KW, model="cdna_robonet", g_dim=8)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    model = _port_model(cfg, params, bn)
    B = 2
    step = jax.jit(functools.partial(jcdna.robonet.step, jcfg))
    jcarry = jcdna.robonet.init_carry(jcfg, B)
    carry = tcdna.robonet.init_carry(cfg, B, torch.float32, "cpu")
    jp, jb = _jtree(params), _jtree(bn)
    for t in range(18):
        img, mask, robot, action = _step_inputs(rng, B)
        jout, jcarry, _ = step(jp, jb, jcarry, jnp.asarray(img),
                               jnp.asarray(mask), jnp.asarray(robot),
                               jnp.asarray(action))
        out, carry = _port_step(cfg, model, carry, img, mask, robot, action, B)
        np.testing.assert_allclose(out["x_pred"].numpy(),
                                   np.asarray(jout["x_pred"]), **STACK_TOL)
    assert int(carry.t) == int(jcarry.t) == 18
    np.testing.assert_allclose(carry.enc_buffer.numpy(),
                               np.asarray(jcarry.enc_buffer), **STACK_TOL)


def test_group_norm_cdna_step_matches_jax(rng, monkeypatch):
    """cdna_det with GroupNorm cells (cfg.lstm_group_norm): three steps
    against the JAX model, whose conv_lstm probe for int8 weights is
    skipped for GroupNorm cells (it raises KeyError for them, ROADMAP
    section 3); the cells never reach the kernel wrapper."""
    monkeypatch.setattr(jlstm, "conv_lstm", _jax_conv_lstm)
    monkeypatch.setattr(kernels, "conv_lstm_cell", lambda *a: pytest.fail(
        "a GroupNorm cell reached the kernel wrapper"))
    kw = dict(FAM_KW, model="cdna_det", lstm_group_norm=True)
    jcfg, cfg = JConfig(**kw), Config(**kw)
    params, bn = _jax_trees(jcfg)
    assert "ih_gn" in params["frame_lstm"]["cell0"]
    model = _port_model(cfg, params, bn)
    B = 2
    jcarry = jcdna.init_carry(jcfg, B)
    carry = tcdna.init_carry(cfg, B, torch.float32, "cpu")
    for t in range(3):
        inputs = _step_inputs(rng, B)
        jout, jcarry, _ = _jax_step(jcfg, _jtree(params), _jtree(bn), jcarry,
                                    *inputs, t)
        out, carry = _port_step(cfg, model, carry, *inputs, B)
        np.testing.assert_allclose(out["x_pred"].numpy(),
                                   np.asarray(jout["x_pred"]), **STACK_TOL)


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
