"""The port's parallel layouts (parallel/mesh.py) held on the CPU: gloo
worlds of 2 and 4 processes (tests/torch_mesh_cases.py) against the port's
one-process step and the JAX package's sharded step on its 8-device
virtual mesh (tests/test_multichip.py's config, batch and tolerances),
with the draws injected alike: DDP, FSDP2 and the 2x2 (data, model)
layout; BatchNorm's statistics left per rank, which breaks it; the leaf
rule; the file shards; sharded checkpoints across layouts and world
sizes; and candidate-sharded plans in float32 and int8."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.parallel.mesh import get_mesh, replicate, shard_batch
from robot_aware_control_tpu.training.step import make_train_step as jmake_train_step
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg as tsvg
from robot_aware_control_tpu_torch.parallel import mesh as pmesh
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.training import checkpoint as ckpt
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
import torch_mesh_cases as cases
from torch_train_cases import flat, one_torch_thread, random_tree  # noqa: F401

# tests/test_multichip.py:test_param_sharding_variants_match_replicated
STEP1 = dict(rtol=2e-4, atol=1e-5)
STEP2 = dict(rtol=5e-3, atol=1e-4)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX trees (the init's shapes filled from a seed: jit-compiling
    the init would take longer than the step), and the gloo worlds of 2
    and 4 started on them, to run while the JAX step compiles. The world
    of 2 restores a sharded checkpoint written first, here, by a
    one-process trainer with --sharded_checkpoint."""
    jcfg = JConfig(**cases.TINY)
    shapes = jax.eval_shape(lambda: jsvg.init(jax.random.PRNGKey(0), jcfg))
    nested = random_tree(shapes, np.random.RandomState(0))
    params, bn = map(flat, nested)
    d = tmp_path_factory.mktemp("mesh")
    t = PredictionTrainer(cases.trainer_config(str(d / "w1"),
                                               sharded_checkpoint=True),
                          device="cpu")
    t.train()
    t.logger.close()
    path = ckpt.latest_checkpoint(t.log_dir)
    w2 = cases.start(cases.world2_cases, 2, str(d), params, bn, path,
                     str(d / "w2"))
    w4 = cases.start(cases.world4_cases, 4, str(d), params, bn)
    return dict(jcfg=jcfg, nested=nested, params=params, bn=bn, w1_saved=cases.trainer_state(t),
                w1_path=path, w2_dir=str(d / "w2"), w2=w2, w4=w4)


@pytest.fixture(scope="module")
def ref(runs):
    """The JAX data-parallel step on the 8-device mesh (two steps,
    jax.random.normal patched to the fixed stand-in) and the port's
    one-process step."""
    jcfg, params, bn = runs["jcfg"], runs["params"], runs["bn"]
    normal = jax.random.normal
    jax.random.normal = lambda key, shape=(), dtype=jnp.float32: jnp.asarray(
        cases.fixed_normal(tuple(shape)), dtype)
    try:
        tstep, tx = jmake_train_step(jcfg)
        mesh = get_mesh(8)
        nested = runs["nested"]
        p, b = replicate(mesh, nested[0]), replicate(mesh, nested[1])
        o = replicate(mesh, tx.init(nested[0]))
        batch = shard_batch(mesh, cases.tiny_batch(), batch_axis_index=1)
        key = replicate(mesh, jax.random.PRNGKey(1))
        prob = replicate(mesh, jnp.float32(1.0))
        jm = []
        for _ in range(2):
            p, b, o, m = tstep(p, b, o, batch, key, prob)
            jm.append({k: float(v) for k, v in jax.device_get(m).items()})
    finally:
        jax.random.normal = normal
    port = cases.train_steps(Config(**cases.TINY), params, bn)
    return {"jax": (jm, flat(jax.device_get(p))), "port": port}


def _match(got, want, lr):
    (gm, gp), (wm, wp) = got, want
    for k in wm[0]:
        np.testing.assert_allclose(gm[0][k], wm[0][k], **STEP1, err_msg=k)
        np.testing.assert_allclose(gm[1][k], wm[1][k], **STEP2, err_msg=k)
    assert set(gp) == set(wp)
    for k, v in wp.items():
        # Adam's first steps move each coordinate by about lr; where a
        # gradient sits at float32 noise its sign may differ by layout
        np.testing.assert_allclose(gp[k], v, rtol=0, atol=5 * lr, err_msg=k)


def test_port_step_matches_jax_sharded_step(ref):
    """The one-process port step against JAX's step sharded over 8 devices."""
    _match(ref["port"], ref["jax"], Config().lr)


@pytest.fixture(scope="module")
def world2(runs):
    """The world of 2: DDP, FSDP2, per-rank BatchNorm, the FSDP2 trainer's
    checkpoints, the mesh plans."""
    return dict(cases.result(runs["w2"]), w1_saved=runs["w1_saved"],
                w1_path=runs["w1_path"], w2_dir=runs["w2_dir"])


@pytest.mark.parametrize("layout", ["ddp", "fsdp"])
def test_world2_layout_matches_replicated_and_jax(ref, world2, layout):
    """DDP and FSDP2 at world 2 (each rank half the batch): two steps give
    the one-process step's and JAX's sharded step's metrics and
    parameters."""
    _match(world2[layout], ref["port"], Config().lr)
    _match(world2[layout], ref["jax"], Config().lr)


def test_per_rank_batchnorm_statistics_break_the_step(ref, world2):
    """Left to each rank's half of the batch, BatchNorm's statistics give
    another step: the check above sees it."""
    with pytest.raises(AssertionError):
        _match(world2["ddp_per_rank_bn"], ref["port"], Config().lr)


@pytest.fixture(scope="module")
def world4(runs):
    """The world of 4: the 2x2 (data, model) layout and the leaf rule."""
    return cases.result(runs["w4"])


def test_2x2_data_model_layout_matches_replicated_and_jax(ref, world4):
    """The (data, model) layout on 4 ranks (--mesh_axes dp,tp), each
    parameter's output channels sharded over the model pair and the batch
    over the data pair: the one-process and JAX steps."""
    _match(world4["model"], ref["port"], Config().lr)
    _match(world4["model"], ref["jax"], Config().lr)


def test_leaf_rule_mesh_and_batch_helpers(world4):
    """A 64-channel conv shards its output channels over the model axis
    (dim 0 of OIHW, the last dim of a cell's (k, k, I, O)); a 1-channel
    conv replicates; the model axis is innermost (ranks 0, 1 share a data
    index); replicate makes every rank's parameters rank 0's; a rank keeps
    its data index's half of the batch, and make_global_batch
    gathers the halves back into the global batch."""
    rule = world4["leaf_rule"]
    assert rule["conv_64"] and rule["conv_1"] and rule["cell_64"]
    assert rule["coords"] == [(0, 0), (0, 1), (1, 0), (1, 1)]
    assert rule["replicated"] == 0.0
    assert rule["local_batch"] == 4 and rule["global_equal"]


def test_host_shard_files_partition():
    """Per-rank file shards are disjoint and cover everything; one rank
    keeps the list (tests/test_multichip.py)."""
    files = [f"f{i}" for i in range(11)]
    shards = [pmesh.host_shard_files(files, i, 4) for i in range(4)]
    flat_files = [f for s in shards for f in s]
    assert sorted(flat_files) == sorted(files)
    assert len(set(flat_files)) == len(files)
    assert pmesh.host_shard_files(files, 0, 1) == files
    assert pmesh.host_shard_files(files) == files  # no process group


def test_batch_split_and_padding():
    """shard_batch keeps a rank's slice: axis 1 of time-first arrays, axis
    0 of the per-element keys; pad_to_multiple repeats the edge."""
    class Mesh:  # rank 1 of a data axis of 2
        mesh_dim_names = ("data",)
        get_local_rank = staticmethod(lambda axis: 1)
        size = staticmethod(lambda dim: 2)

    batch = {"images": np.arange(24).reshape(2, 4, 3),
             "batch_weight": np.arange(4.0), "step": 3}
    got = pmesh.shard_batch(Mesh(), batch)
    np.testing.assert_array_equal(got["images"], batch["images"][:, 2:])
    np.testing.assert_array_equal(got["batch_weight"], [2.0, 3.0])
    assert got["step"] == 3
    assert pmesh.shard_batch(None, batch) is not batch
    x, n = pmesh.pad_to_multiple(np.arange(5), 0, 4)
    assert n == 5 and list(x) == [0, 1, 2, 3, 4, 4, 4, 4]
    assert pmesh.batch_axis_for("batch_weight") == 0
    assert pmesh.batch_axis_for("images") == 1


def _assert_state_equal(got, want):
    assert got["step"] == want["step"]
    for tree in ("params", "bn", "opt"):
        assert set(got[tree]) == set(want[tree]), tree
        for k, v in want[tree].items():
            np.testing.assert_array_equal(got[tree][k], v, err_msg=k)


def test_world1_sharded_checkpoint_restores_into_fsdp_world2(world2):
    """A sharded checkpoint written by one process restores into an FSDP2
    trainer at world 2: parameters, BatchNorm statistics, Adam's state and
    the step."""
    assert world2["w1_path"].endswith(f"ckpt_{world2['w1_saved']['step']}")
    _assert_state_equal(world2["checkpoint"]["restored"], world2["w1_saved"])
    assert world2["checkpoint"]["sharded_params"] == "DTensor"


def test_fsdp_world2_checkpoint_resumes_a_replicated_world1_trainer(world2):
    """The FSDP2 trainer's checkpoint (a ckpt_<step>/ directory, world 2)
    is what a one-process replicated trainer's auto-resume finds, and it
    restores that trainer to the world-2 state."""
    trained = world2["checkpoint"]["trained"]
    cfg = cases.trainer_config(world2["w2_dir"])
    t = PredictionTrainer(cfg, device="cpu")
    path = ckpt.latest_checkpoint(t.log_dir)
    assert path.endswith(f"ckpt_{trained['step']}")
    t._resume()
    _assert_state_equal(cases.trainer_state(t), trained)
    t.logger.close()


def test_each_rank_reads_its_share(world2):
    """Batch sizes are global: at world 2 a synthetic batch of 4 gives each
    rank 2 rows of its own seed, and the loaders' host sharding gives rank
    0 every other file and half the batch."""
    feed = world2["feed"]
    assert feed["rows"] == 2
    assert feed["rank_sums"][0] != feed["rank_sums"][1]
    assert feed["files"] == [0, 2, 4, 6, 8] and feed["batch"] == 4


def test_layout_refuses_what_does_not_divide_at_world2(world2):
    """A global batch of 3 does not divide over 2 data ranks; a model axis
    of 4 does not divide a world of 2."""
    assert "batch_size=3" in world2["refusals"]["batch"]
    assert "model_axis_size=4" in world2["refusals"]["model_axis"]


@pytest.mark.parametrize("quant", ["none", "int8"])
def test_mesh_plan_equals_unsharded_plan(world2, quant):
    """CEMPolicy(mesh=) at world 2, each rank rolling out half the
    candidates (under int8 with each conv's scale all-reduced), plans what
    the unsharded policy plans, bit for bit, one request at a time and
    batched."""
    cfg = Config(**dict(cases.PLAN, plan_quantize=quant))
    policy = CEMPolicy(cfg, tsvg.init(cfg, seed=3, device="cpu"), device="cpu")
    want = cases.plan_requests(policy)
    got = world2["plans"][quant]
    for g, w in zip(got["singles"], want["singles"]):
        np.testing.assert_array_equal(g, w)
    for g, w in zip(got["batched"], want["singles"]):
        np.testing.assert_array_equal(g, w)


def test_layout_needs_a_process_group():
    """Without a process group a layout refuses and every rank is rank 0
    of 1; param_sharding takes its three layouts only."""
    with pytest.raises(RuntimeError, match="process group"):
        pmesh.Layout(Config())
    assert pmesh.process_info() == (0, 1)
    assert pmesh.data_info(Config(model_axis_size=2)) == (0, 1)
    with pytest.raises(ValueError, match="param_sharding"):
        Config(param_sharding="pipeline")
    assert torch.distributed.is_available()
