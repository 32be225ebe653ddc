"""The bridge to the reference's torch checkpoints
(robot_aware_control_tpu_torch/models/torch_import.py, torch_export.py)
held against the JAX package's modules on the CPU.

The reference-layout state dicts are built here: random JAX trees of each
family (He-scaled, torch_train_cases.random_tree) written out by the JAX
package's `torch_export`, as the reference's `ckpt_*.pt` names and lays
them out (tests/test_torch_export.py loads such dicts strictly into the
reference's modules). The port loads them strictly; its rollout costs
equal the JAX model's, loaded by the JAX `torch_import` from the same dict,
to 1e-4 relative (float32 convolution stacks summed in another order, as
tests/test_torch_port_families_*.py hold them). The port's export equals
the JAX export key for key and bit for bit, and a `.pt` round trip through
torch.save is the identity."""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import torch_export as jexport
from robot_aware_control_tpu.models import torch_import as jimport
from robot_aware_control_tpu.models.registry import get_model as jget_model
from robot_aware_control_tpu.planning.rollout import RolloutEngine as JRolloutEngine
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data.norm import LOCOBOT_HIGH, LOCOBOT_LOW, normalize
from robot_aware_control_tpu_torch.models import torch_export as texport
from robot_aware_control_tpu_torch.models import torch_import as timport
from robot_aware_control_tpu_torch.planning.rollout import RolloutEngine, prepare_goals
from robot_aware_control_tpu_torch.training import checkpoint as tckpt
from torch_family_cases import SMALL_STACKS
from torch_train_cases import STEP_KW, random_tree
from torch_train_cases import one_torch_thread  # noqa: F401  (autouse)
from torch_variant_cases import start_goal

H, W = 16, 32  # the vector models' smallest frames (torch_family_cases)
KW = dict(STEP_KW, image_height=H, image_width=W, reward_type="dontcare",
          sample_mean=True, **SMALL_STACKS)
MODELS = ("svg", "det", "svg_vec", "det_vec")
EXPORT = {"svg": lambda p, s: jexport.export_svg_conv_model(p, s),
          "det": lambda p, s: jexport.export_det_conv_model(p, s, H // 8,
                                                            W // 8),
          "svg_vec": jexport.export_svg_vector_model,
          "det_vec": jexport.export_det_vector_model}
IMPORT = {"svg": jimport.import_svg_conv_model,
          "det": lambda sd: jimport.import_det_conv_model(sd, H // 8, W // 8),
          "svg_vec": jimport.import_svg_vector_model,
          "det_vec": jimport.import_det_vector_model}
COST_RTOL = 1e-4


def _cfgs(name):
    kw = dict(KW, model=name)
    return JConfig(**kw), Config(**kw)


def reference_state_dict(name, seed=0):
    """A reference-layout state dict of the family (numpy): random JAX
    trees through the JAX package's export."""
    jcfg, _ = _cfgs(name)
    mod = jget_model(jcfg)
    shapes = jax.eval_shape(lambda k: mod.init(k, jcfg), jax.random.PRNGKey(0))
    params, bn = random_tree(shapes, np.random.RandomState(seed))
    return EXPORT[name](params, bn)


def _rollout_costs(name, sd, rng):
    """The same candidates' summed costs through the JAX model (loaded by
    the JAX torch_import) and the port's (loaded by the port's)."""
    jcfg, cfg = _cfgs(name)
    params, bn = IMPORT[name](sd)
    model = timport.model_from_torch(cfg, sd, device="cpu")
    start, goal = start_goal(rng, H, W)
    goal.masks = [(rng.rand(H, W) > 0.8).astype(np.float32) for _ in goal.masks]
    acts = np.zeros((6, 3, 5), np.float32)
    acts[..., :2] = rng.uniform(-0.05, 0.05, (6, 3, 2))
    gi, gm, _ = prepare_goals(goal, 3)
    s_norm = normalize(start.state, LOCOBOT_LOW, LOCOBOT_HIGH)
    want = JRolloutEngine(jcfg)(
        jax.tree_util.tree_map(jnp.asarray, params),
        jax.tree_util.tree_map(jnp.asarray, bn), jnp.asarray(start.img),
        jnp.asarray(s_norm), jnp.asarray(start.qpos), jnp.asarray(acts),
        jnp.asarray(gi), jnp.asarray(gm), jax.random.PRNGKey(0))
    t = lambda a: torch.tensor(np.asarray(a, np.float32))
    got = RolloutEngine(cfg, device="cpu")(
        model, t(start.img), t(s_norm), t(start.qpos), t(acts), t(gi), t(gm),
        torch.Generator().manual_seed(0))
    return got.double().numpy(), np.asarray(want, np.float64), model


@pytest.mark.parametrize("name", MODELS)
def test_reference_state_dict_runs_as_in_jax(name, rng):
    """A reference state dict loads strictly into the port's model, and
    its rollout costs equal the JAX model's on the same dict."""
    sd = reference_state_dict(name)
    got, want, model = _rollout_costs(name, sd, rng)
    np.testing.assert_allclose(got, want, rtol=COST_RTOL)
    # one map: the bridge's state dict is convert.py's of the JAX trees
    ref = convert.svg_state_dict(*IMPORT[name](sd))
    mine = timport.state_dict_from_torch(_cfgs(name)[1], sd)
    assert set(mine) == set(ref) == set(model.state_dict())
    for k in ref:
        assert torch.equal(mine[k], ref[k]), k


def test_unflipped_transpose_weight_is_rejected(rng, monkeypatch):
    """A planted fault: the reference's ConvTranspose2d weights taken
    without their spatial flip (svg_vec's decoder: upc1 and the output
    layer) move the costs far past the tolerance."""
    sd = reference_state_dict("svg_vec")
    monkeypatch.setattr(timport, "conv_transpose_w", lambda w: np.transpose(
        w, (2, 3, 0, 1)).copy())
    got, want, _ = _rollout_costs("svg_vec", sd, rng)
    assert np.abs(got / want - 1.0).max() > 100 * COST_RTOL


@pytest.mark.parametrize("name", MODELS)
def test_export_equals_jax_export(name):
    """The port's export of a model equals the JAX export of the same
    weights key for key and bit for bit (and so the dict it was loaded
    from)."""
    jcfg, cfg = _cfgs(name)
    sd = reference_state_dict(name, seed=1)
    model = timport.model_from_torch(cfg, sd, device="cpu")
    got = texport.export_state_dict(model, cfg)
    want = EXPORT[name](*IMPORT[name](sd))
    assert list(got) == list(want)
    for k, w in want.items():
        assert got[k].dtype == w.dtype and np.array_equal(got[k], w), k
        assert np.array_equal(w, sd[k]), k


def test_pt_round_trip_is_the_identity(tmp_path):
    """save_torch_checkpoint -> torch.load -> model_from_torch gives the
    model's state dict bit for bit, and the JAX loader reads the file."""
    jcfg, cfg = _cfgs("svg")
    model = timport.model_from_torch(cfg, reference_state_dict("svg", 2),
                                     device="cpu")
    path = str(tmp_path / "ckpt_7.pt")
    texport.save_torch_checkpoint(path, model, cfg, step=7)
    blob = torch.load(path, map_location="cpu", weights_only=False)
    assert blob["step"] == 7 and "optimizer" in blob
    back = timport.model_from_torch(cfg, path, device="cpu").state_dict()
    for k, v in model.state_dict().items():
        assert torch.equal(back[k], v), k
    want = jimport.load_torch_state_dict(path)
    got = timport.load_torch_state_dict(path)
    assert set(got) == set(want)
    assert all(np.array_equal(got[k], want[k]) for k in want)


def test_export_cli(tmp_path):
    """`python -m ...models.torch_export` turns a ckpt_<step>.npz into the
    reference's .pt on --device cpu; without --device it needs the card."""
    jcfg, cfg = _cfgs("det")
    model = timport.model_from_torch(cfg, reference_state_dict("det", 3),
                                     device="cpu")
    params, bn = convert.jax_flat_trees(model)
    npz = tckpt.save_checkpoint(str(tmp_path), 12, {"params": params,
                                                    "bn": bn})
    flags = ["--dynamics_model_ckpt", npz]
    for f in dataclasses.fields(Config):  # the config's non-default fields
        v = getattr(cfg, f.name)
        if v != f.default and v is not None:
            flags += [f"--{f.name}", str(v)]
    out = texport.main(flags + ["--device", "cpu"])
    assert out == os.path.splitext(npz)[0] + ".pt"
    blob = torch.load(out, map_location="cpu", weights_only=False)
    assert blob["step"] == 12
    want = texport.export_state_dict(model, cfg)
    assert set(blob["model"]) == set(want)
    for k, v in want.items():
        assert np.array_equal(blob["model"][k].numpy(), v), k
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            texport.main(flags)


def test_unknown_models_are_refused():
    _, cfg = _cfgs("cdna_det")
    with pytest.raises(ValueError, match="no torch import"):
        timport.state_dict_from_torch(cfg, {})
    with pytest.raises(ValueError, match="no torch export"):
        texport.export_state_dict(None, cfg.replace(model="copy"))
