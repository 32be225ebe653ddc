"""Shared inputs of the training-slice tests against the JAX package
(test_torch_port_train.py, test_torch_port_trainer.py; not a test module):
the small config at 24x32 frames, the injected posterior noise, the JAX
trees with a prior unlike the posterior, and small conversions between the
packages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.models import svg as tsvg
from torch_train_small import (
    PRIOR_LOGVAR_BIAS,
    PRIOR_MU_BIAS,
    TRAIN_SMALL,
    TRAIN_TOL,
)

# the small training config (torch_train_small.py) at 24x32 frames
STEP_KW = dict(TRAIN_SMALL, image_height=24, image_width=32)
STEP_TOL = dict(rtol=TRAIN_TOL, atol=1e-6)
NOISE_SHAPE = (2, 3, 4, 4)  # (B, fh, fw, z_dim)
# the metrics of the JAX train step (and so of the JAX trainer's train/)
JAX_TRAIN_KEYS = {"recon_loss", "robot_loss", "world_loss", "kld", "loss"}


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Each module that imports this runs torch with one intra-op thread.
    Under pytest-xdist several worker processes share the cores, and
    torch's default of a thread per core made these small steps 15-25x
    slower there than alone; with one thread they take about 2 s."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def fixed_normal(shape):
    """The injected N(0, 1) stand-in: a fixed function of the shape."""
    n = int(np.prod(shape))
    return np.sin(np.arange(n) * 0.7 + 0.3).reshape(shape).astype(np.float32)


def fake_jax_normal(key, shape=(), dtype=jnp.float32):
    return jnp.asarray(fixed_normal(tuple(shape)), dtype)


def port_noise(steps, use_truth):
    eps = torch.tensor(fixed_normal(NOISE_SHAPE)).expand(steps, *NOISE_SHAPE)
    return {"use_truth": torch.full((steps,), use_truth),
            "eps_prior": eps, "eps_post": eps}


def np_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def flat(tree):
    return {jax.tree_util.keystr(p): np.asarray(v)
            for p, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def window(raw, n, batch_weight=None):
    out = {k: raw[k][:n] for k in ("images", "masks", "states")}
    out["actions"] = raw["actions"][:n - 1]
    if batch_weight is not None:
        out["batch_weight"] = batch_weight
    return out


def torch_batch(batch):
    return {k: torch.tensor(np.asarray(v)) for k, v in batch.items()}


def jax_trees(jcfg):
    """JAX SVG parameters and BatchNorm statistics (non-trivial ones), with
    the prior's heads offset so that the prior is unlike the posterior: the
    KL term and its gradient are then not a cancellation of nearly equal
    float32 terms."""
    params, bn = jax.jit(jsvg.init, static_argnums=1)(jax.random.PRNGKey(0), jcfg)
    r = np.random.RandomState(1)
    bn = jax.tree_util.tree_map(
        lambda a: jnp.asarray(r.uniform(0.5, 1.5, a.shape).astype(np.float32)), bn)
    for head, value in (("mu", PRIOR_MU_BIAS), ("logvar", PRIOR_LOGVAR_BIAS)):
        params["prior"][head]["b"] = jnp.full_like(params["prior"][head]["b"], value)
    return params, bn


def port_model(params, bn, cfg):
    """A training model (float32 parameters) holding the JAX trees."""
    model = tsvg.SVG(cfg, "cpu", param_dtype=torch.float32)
    model.load_state_dict(convert.svg_state_dict(np_tree(params), np_tree(bn)))
    return model
