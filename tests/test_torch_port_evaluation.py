"""The port's evaluation tools (evaluation/vis_tools.py, debug_tools.py,
fvd.py, i3d.py, evaluate_checkpoint.py and obj_movement.py's checkpoint
route) held against the JAX package on the CPU.

Tolerances: the I3D's 400 logits and the random embedder's 400 features to
1e-4 of the largest |value| (float32 convolution stacks of 57 and 3
layers, on the JAX package's weights carried through its save_npz and
in-memory arrays); frechet_distance is the same numpy code (1e-12); FVD
of the same predictions through the same embedder weights 1e-3 relative
(a Frechet distance of 5 samples in 400 dimensions amplifies float32
differences of the embeddings); checkpoint metrics 1e-4 relative (eval
steps with the prior's mean, as tests/test_torch_port_trainer.py holds
them); rollout frames 1e-4, costs 1e-5. Max pools pad with -inf where
XLA's "SAME" window hangs over the edge; the networks pool ReLU outputs,
so the pool is also held on signed inputs, where a planted zero pad
shows."""

import json
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data import loader as jloader
from robot_aware_control_tpu.evaluation import debug_tools as jdebug
from robot_aware_control_tpu.evaluation import evaluate_checkpoint as jeval
from robot_aware_control_tpu.evaluation import fvd as jfvd
from robot_aware_control_tpu.evaluation import i3d as ji3d
from robot_aware_control_tpu.evaluation import obj_movement as jmove
from robot_aware_control_tpu.evaluation import vis_tools as jvis
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.training.trainer import PredictionTrainer as JTrainer
from robot_aware_control_tpu.utils.state import State as JState
from robot_aware_control_tpu_torch import convert
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data import collect
from robot_aware_control_tpu_torch.data import loader as tloader
from robot_aware_control_tpu_torch.evaluation import (
    debug_tools,
    evaluate_checkpoint,
    fvd,
    i3d,
    obj_movement,
    vis_tools,
)
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from robot_aware_control_tpu_torch.utils.state import State
from torch_experiment_cases import EMBED_TOL, I3D_TOL, videos
from torch_train_cases import random_tree
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

METRIC_RTOL = 1e-4
FVD_RTOL = 1e-3
FRAME_TOL = 1e-4
COST_TOL = 1e-5


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / np.abs(want).max())


# ------------------------------------------------------------------ I3D
@pytest.fixture(scope="module", autouse=True)
def fast_jax_inits():
    """The JAX I3D's and SVG's inits dispatch op by op, a compile each
    (about 45 s and 30 s on the CPU): the I3D's is replaced by He-scaled
    numpy weights of its tree (JAX uses it for the tree's structure in
    load_npz and convert_tf_checkpoint), the SVG's and the random FVD
    embedder are jitted. The JAX evaluation functions share one trainer a
    config, whose jitted eval steps then compile once (each function loads
    the checkpoint into it)."""
    shapes = jax.eval_shape(ji3d.init, jax.random.PRNGKey(0))
    r = np.random.RandomState(3)
    tree = jax.tree_util.tree_map_with_path(
        lambda p, s: np.asarray(
            r.randn(*s.shape) * np.sqrt(2.0 / np.prod(s.shape[:-1]))
            if p[-1].key == "w" else
            (r.uniform(0.5, 1.5, s.shape) if p[-1].key == "moving_var"
             else r.uniform(-0.1, 0.1, s.shape)), np.float32), shapes)
    trainers = {}

    def shared_trainer(cfg):
        if cfg not in trainers:
            trainers[cfg] = JTrainer(cfg)
        return trainers[cfg]

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(ji3d, "init", lambda key=None: tree)
        mp.setattr(jsvg, "init", jax.jit(jsvg.init, static_argnums=1))
        mp.setattr(jeval, "PredictionTrainer", shared_trainer)
        mp.setattr(jfvd, "default_embed_fn", jax.jit(jfvd.default_embed_fn))
        yield


@pytest.fixture(scope="module")
def jax_i3d(tmp_path_factory):
    """JAX I3D weights saved by the JAX save_npz."""
    path = str(tmp_path_factory.mktemp("i3d") / "i3d.npz")
    params = ji3d.init()
    ji3d.save_npz(params, path)
    return params, path


def test_i3d_embed_matches_jax(jax_i3d):
    """embed at B = 2, T = 8, 48x64 on weights the JAX package wrote: the
    port's logits within 1e-4 of the largest |logit|; the content hash of
    the loaded weights is JAX's digest of the same file."""
    params, path = jax_i3d
    x = videos(2, 8, 48, 64)
    want = np.asarray(jax.jit(ji3d.embed)(params, x))
    model = i3d.load_npz(path, "cpu")
    got = i3d.embed(model, x).numpy()
    assert got.shape == want.shape == (2, 400)
    assert _rel(got, want) <= I3D_TOL
    assert i3d.content_hash(model) == ji3d.content_hash(ji3d.load_npz(path))


def test_i3d_npz_round_trips_both_ways(jax_i3d, tmp_path):
    """The port's save_npz loads through the JAX load_npz with the same
    digest and arrays; a missing key raises; verify_npz and the CLI
    (--device cpu) check the file against the port's copy of the
    manifest."""
    params, path = jax_i3d
    model = i3d.load_npz(path, "cpu")
    out = str(tmp_path / "port.npz")
    i3d.save_npz(model, out)
    back = ji3d.load_npz(out)
    assert ji3d.content_hash(back) == ji3d.content_hash(params)
    flat = i3d.to_flat(model)
    with np.load(path) as z:
        assert set(z.files) == set(flat)
        for k in z.files:
            np.testing.assert_array_equal(flat[k], z[k], err_msg=k)
    report = i3d.main(["--verify", out, "--device", "cpu"])
    assert report == ji3d.verify_npz(out)
    assert report["n_params"] == 12704544 and report["pin"].startswith("unpinned")
    del flat["Logits/b"]
    np.savez(str(tmp_path / "short.npz"), **flat)
    with pytest.raises(KeyError, match="Logits/b"):
        i3d.load_npz(str(tmp_path / "short.npz"), "cpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            i3d.main(["--verify", out])


def test_i3d_converts_tf_names_as_jax(jax_i3d):
    """convert_tf_checkpoint renames TF-Hub variables as the JAX package's
    does (a variable table made from the JAX weights)."""
    params, _ = jax_i3d
    flat = ji3d._flatten(params)
    branch = {"b0": ("Branch_0", "Conv3d_0a_1x1"), "b1a": ("Branch_1", "Conv3d_0a_1x1"),
              "b1b": ("Branch_1", "Conv3d_0b_3x3"), "b2a": ("Branch_2", "Conv3d_0a_1x1"),
              "b2b": ("Branch_2", "Conv3d_0b_3x3"), "b3": ("Branch_3", "Conv3d_0b_1x1")}
    leaf = {"w": "conv_3d/w", "beta": "batch_norm/beta",
            "moving_mean": "batch_norm/moving_mean",
            "moving_var": "batch_norm/moving_variance"}
    tf = {}
    for k, v in flat.items():
        parts = k.split("/")
        if parts[0] == "Logits":
            tf[f"RGB/inception_i3d/Logits/Conv3d_0c_1x1/conv_3d/{parts[1]}"] = v
        elif parts[0].startswith("Mixed"):
            b, c = branch[parts[1]]
            tf[f"RGB/inception_i3d/{parts[0]}/{b}/{c}/{leaf[parts[2]]}"] = v
        else:
            tf[f"RGB/inception_i3d/{parts[0]}/{leaf[parts[1]]}"] = v
    got = i3d.to_flat(i3d.convert_tf_checkpoint(tf, "cpu"))
    want = ji3d._flatten(ji3d.convert_tf_checkpoint(tf))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


POOLS = [((1, 3, 3), (1, 2, 2), (2, 4, 7, 9, 3)),
         ((3, 3, 3), (2, 2, 2), (1, 5, 6, 5, 2)),
         ((2, 2, 2), (2, 2, 2), (2, 3, 5, 4, 3)),
         ((3, 3, 3), (1, 1, 1), (1, 3, 4, 4, 2))]


def _zero_padded_pool(x, window, stride):
    return torch.nn.functional.max_pool3d(i3d.same_pad(x, window, stride),
                                          window, stride)


@pytest.mark.parametrize("window,stride,shape", POOLS)
def test_max_pool_pads_as_reduce_window(window, stride, shape):
    """max_pool3d_same on signed inputs equals JAX's reduce_window "SAME"
    pool (-inf padding), odd and even extents; a planted zero pad is
    rejected."""
    x = np.random.RandomState(0).randn(*shape).astype(np.float32) - 1.0
    want = np.asarray(ji3d._maxpool(jnp.asarray(x), window, stride))
    xt = torch.from_numpy(x).permute(0, 4, 1, 2, 3)
    got = i3d.max_pool3d_same(xt, window, stride).permute(0, 2, 3, 4, 1)
    np.testing.assert_array_equal(got.numpy(), want)
    planted = _zero_padded_pool(xt, window, stride).permute(0, 2, 3, 4, 1)
    assert planted.shape == want.shape
    if any(p for n, k, s in zip(shape[1:4], window, stride)
           for p in i3d.same_pads(n, k, s)):
        assert not np.array_equal(planted.numpy(), want)


# ------------------------------------------------------------------ FVD
@pytest.fixture(scope="module")
def jax_embedder():
    ws, w_out = jax.jit(jfvd._random_embedder_params)(jax.random.PRNGKey(42))
    return [np.asarray(w) for w in ws], np.asarray(w_out)


def test_random_embedder_matches_jax(jax_embedder):
    """The random embedder on the JAX package's weights (seed 42), at 2
    videos of 8 frames of 48x64: within 1e-4 of the largest |feature|. The
    port's own weights come from a torch.Generator, seeded alike."""
    x = videos(2, 8, 48, 64, seed=1)
    want = np.asarray(jfvd.default_embed_fn(x))
    got = fvd.default_embed_fn(x, params=jax_embedder, device="cpu").numpy()
    assert got.shape == want.shape == (2, 400)
    assert _rel(got, want) <= EMBED_TOL
    ws, w_out = fvd.random_embedder_params()
    assert [w.shape for w in ws] == [w.shape for w in jax_embedder[0]]
    again = fvd.random_embedder_params()
    assert all(np.array_equal(a, b) for a, b in zip(ws + [w_out],
                                                    again[0] + [again[1]]))


def test_frechet_distance_and_fvd_match_jax(jax_embedder):
    """frechet_distance (numpy, copied) and fvd through an injected
    embedder and through the random embedder on JAX's weights; the caveat
    strings."""
    r = np.random.RandomState(2)
    a, b = r.randn(30, 6), r.randn(30, 6) + 0.3
    args = (a.mean(0), np.cov(a, rowvar=False), b.mean(0),
            np.cov(b, rowvar=False))
    np.testing.assert_allclose(fvd.frechet_distance(*args),
                               jfvd.frechet_distance(*args), rtol=1e-12)
    real, fake = videos(6, 4, 16, 16, seed=3), videos(6, 4, 16, 16, seed=4)
    embed = lambda v: np.asarray(v, np.float32).reshape(len(v), -1)[:, :50]
    np.testing.assert_allclose(fvd.fvd(real, fake, embed, device="cpu"),
                               jfvd.fvd(real, fake, embed), rtol=1e-9)
    port_embed = lambda v: fvd.default_embed_fn(v, params=jax_embedder,
                                                device="cpu")
    np.testing.assert_allclose(fvd.fvd(real, fake, port_embed, device="cpu"),
                               jfvd.fvd(real, fake), rtol=FVD_RTOL)
    assert fvd.embedder_caveat(None) == jfvd.embedder_caveat(None)
    i3d_fn = fvd.make_i3d_embed_fn(device="cpu")
    assert i3d_fn.caveat == jfvd.make_i3d_embed_fn().caveat
    assert fvd.embedder_caveat(embed) is None


# --------------------------------------------------- checkpoint evaluation
@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """6 LocobotPush episodes (16x16) in an HDF5 tree labelled
    high-movement, and a checkpoint of a small svg with He-scaled random
    weights written by the port's trainer (Adam state at count 0)."""
    root = tmp_path_factory.mktemp("ckpt")
    kw = dict(model="svg", g_dim=8, z_dim=2, image_height=16, image_width=16,
              action_dim=5, robot_dim=5, robot_joint_dim=5, n_past=1,
              n_future=2, n_eval=4, video_length=5, demo_length=5,
              batch_size=5, test_batch_size=2, model_use_mask=True,
              model_use_robot_state=True, reconstruction_loss="dontcare_l1",
              compute_dtype="float32", sample_mean=True, data_threads=1,
              experiment="train_locobot_singleview",
              data_root=str(root / "tree"), log_dir=str(root / "logs"),
              impute_autograsp_action=False, seed=0)
    files = collect.collect_training_data("LocobotPush", 6, kw["data_root"],
                                          Config(**kw), seed=4, device="cpu")
    labels = str(root / "obj_movement.pkl")
    with open(labels, "wb") as f:
        pickle.dump({p: i != 2 for i, p in enumerate(files)}, f)
    kw["world_error_dict"] = labels
    jcfg = JConfig(**kw)
    shapes = jax.eval_shape(lambda k: jsvg.init(k, jcfg), jax.random.PRNGKey(0))
    params, bn = random_tree(shapes, np.random.RandomState(5))
    tr = PredictionTrainer(Config(**kw, jobname="src"), device="cpu")
    tr.model.load_state_dict(convert.svg_state_dict(params, bn), strict=True)
    tr._save(0)
    tr.logger.close()
    return kw, os.path.join(tr.log_dir, "ckpt_0.npz")


def _assert_metrics(got, want):
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRIC_RTOL, err_msg=k)


def test_evaluate_checkpoint_matches_jax(checkpoint):
    """evaluate_checkpoint (the experiment's test set: no transfer set for
    train_locobot_singleview; from the HDF5 files and from record shards of
    them), evaluate_on_movement_set (the high-movement videos' test split,
    also through the CLI) and evaluate_obj_movement on one checkpoint: the
    metrics of the JAX package's, autoregressive world PSNR included."""
    kw, path = checkpoint
    want = jeval.evaluate_checkpoint(JConfig(**kw, jobname="j"), path)
    got = evaluate_checkpoint.evaluate_checkpoint(Config(**kw, jobname="t1"),
                                                  path, device="cpu")
    assert "autoreg_world_psnr" in want
    _assert_metrics(got, want)
    # the same episodes as record shards (the route without h5py): the
    # test split's metrics, bit for bit
    from robot_aware_control_tpu_torch.data import records

    pairs = tloader.discover_hdf5(kw["data_root"])
    shards = records.convert_to_records(
        Config(**kw), [p for p, _ in pairs], [r for _, r in pairs],
        os.path.join(os.path.dirname(path), "shards"))
    assert evaluate_checkpoint.evaluate_checkpoint(
        Config(**kw, jobname="t6"), path, device="cpu",
        record_dir=os.path.dirname(shards[0])) == got
    want = jmove.evaluate_on_movement_set(JConfig(**kw, jobname="j"), path)
    got = obj_movement.evaluate_on_movement_set(Config(**kw, jobname="t2"),
                                                path, device="cpu")
    _assert_metrics(got, want)
    got = obj_movement.main(["--dynamics_model_ckpt", path, "--device", "cpu"]
                            + [a for k, v in dict(kw, jobname="t3").items()
                               for a in (f"--{k}", str(v))])
    _assert_metrics(got, want)
    _assert_metrics(
        evaluate_checkpoint.evaluate_obj_movement(Config(**kw, jobname="t7"),
                                                  path, device="cpu"),
        jeval.evaluate_obj_movement(JConfig(**kw, jobname="j"), path))


def test_evaluate_fvd_matches_jax(checkpoint, jax_embedder, monkeypatch):
    """predict_videos and evaluate_fvd over the train loader's first batch
    (5 videos) with the random embedder on JAX's weights: the same videos
    and FVD; the caveat beside the number."""
    kw, path = checkpoint
    monkeypatch.setattr(fvd, "random_embedder_params",
                        lambda seed=42: jax_embedder)
    jtrain, _ = jloader.create_locobot_loaders(JConfig(**kw))
    ttrain, _ = tloader.create_locobot_loaders(Config(**kw))
    want = jeval.evaluate_fvd(JConfig(**kw, jobname="j"), path, loader=jtrain)
    got = evaluate_checkpoint.evaluate_fvd(Config(**kw, jobname="t4"), path,
                                           loader=ttrain, device="cpu")
    assert set(got) == set(want) == {"fvd", "fvd_caveat"}
    assert got["fvd_caveat"] == want["fvd_caveat"]
    assert np.isfinite(got["fvd"])
    np.testing.assert_allclose(got["fvd"], want["fvd"], rtol=FVD_RTOL)


def test_evaluate_checkpoint_cli(checkpoint):
    """The CLI with --device cpu prints the metrics; without --device it
    runs on the card, and raises without one."""
    kw, path = checkpoint
    argv = ["--dynamics_model_ckpt", path] + [
        a for k, v in dict(kw, jobname="t5").items() for a in (f"--{k}", str(v))]
    metrics = evaluate_checkpoint.main(argv + ["--device", "cpu"])
    assert np.isfinite(metrics["autoreg_world_psnr"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            evaluate_checkpoint.main(argv)


# ------------------------------------------------------ debug, cost tools
def test_action_rollout_and_costs_match_jax(checkpoint, monkeypatch, tmp_path):
    """action_rollout's gif frames (the top-k imagined futures of the 10
    synthetic sweeps, the prior's mean) and cost_along_trajectory against
    the JAX package's; save_cost_plot writes the series."""
    kw, path = checkpoint
    frames = {}
    for name, mod in (("jax", jdebug), ("port", debug_tools)):
        monkeypatch.setattr(mod, "save_gif", lambda p, f, fps=2, name=name:
                            frames.setdefault(name, (p, np.stack(f))))
    fields = dict(kw, horizon=3, topk=3, action_candidates=10)
    r = np.random.RandomState(6)
    img = r.rand(16, 16, 3).astype(np.float32)
    state = np.array([0.3, 0.05, 0.1, 0.0, 0.0], np.float32)
    qpos = r.uniform(-0.3, 0.3, 5).astype(np.float32)
    jdebug.action_rollout(JConfig(**fields), path,
                          JState(img=img, state=state, qpos=qpos),
                          str(tmp_path / "j"))
    debug_tools.action_rollout(Config(**fields), path,
                               State(img=img, state=state, qpos=qpos),
                               str(tmp_path / "t"), device="cpu")
    assert frames["port"][1].shape == frames["jax"][1].shape == (3, 16, 48, 3)
    np.testing.assert_allclose(frames["port"][1], frames["jax"][1],
                               atol=FRAME_TOL)
    assert os.path.basename(frames["port"][0]) == "action_rollout.gif"
    imgs = r.rand(5, 16, 16, 3).astype(np.float32)
    masks = (r.rand(5, 16, 16) > 0.7).astype(np.float32)
    goal, gmask = r.rand(16, 16, 3).astype(np.float32), masks[-1]
    for rt in ("dontcare", "dense"):
        c = dict(kw, reward_type=rt)
        want = jvis.cost_along_trajectory(JConfig(**c), imgs, masks, goal, gmask)
        got = vis_tools.cost_along_trajectory(Config(**c), imgs, masks, goal,
                                              gmask, device="cpu")
        np.testing.assert_allclose(got, np.asarray(want), atol=COST_TOL)
    out = vis_tools.save_cost_plot(got, str(tmp_path / "c" / "cost.png"))
    with open(out + ".json") as f:
        assert np.allclose(json.load(f), got)
    np.testing.assert_array_equal(vis_tools._render_curve(got),
                                  jvis._render_curve(got))
