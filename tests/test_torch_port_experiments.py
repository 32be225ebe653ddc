"""The port's record route and paper experiments (data/collect.py's record
writer, data/records.py's split loaders, experiments/pick.py and
experiments/transfer.py) held against the JAX package on the CPU.

The record route is held bit for bit: shards written from episodes in
memory equal `convert_to_records` of the same episodes' HDF5 files, and
the record loaders split the same episodes as the HDF5 loaders. Against
the JAX package's own collection the shards hold the envs' tolerances
(tests/test_torch_port_control.py: 1e-6, joints 1e-5, masks and images
equal). eval_transfer on a checkpoint carried from JAX equals JAX's to
1e-4 relative (float32 convolution stacks). The experiments run end to
end at the tiny sizes of tests/test_transfer_experiment.py with h5py
hidden."""

import json
import os
import sys
import time

import jax
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data import collect as jcollect
from robot_aware_control_tpu.data import loader as jloader
from robot_aware_control_tpu.data import records as jrecords
from robot_aware_control_tpu.experiments import pick as jpick
from robot_aware_control_tpu.experiments import transfer as jtransfer
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.training import checkpoint as jckpt
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data import collect, demo_io, records
from robot_aware_control_tpu_torch.data import loader as tloader
from robot_aware_control_tpu_torch.experiments import pick, transfer
from torch_experiment_cases import shards_equal
from torch_train_cases import random_tree
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

TOL = 1e-6
JOINT_TOL = 1e-5
EVAL_RTOL = 1e-4
# the tiny experiment of tests/test_transfer_experiment.py
TINY = ["--g_dim", "8", "--z_dim", "2", "--image_height", "16",
        "--image_width", "16", "--batch_size", "2", "--test_batch_size", "2",
        "--niter", "1", "--epoch_size", "1", "--n_eval", "3",
        "--demo_length", "5", "--num_episodes", "4",
        "--compute_dtype", "float32", "--robot_dim", "5",
        "--action_dim", "5", "--robot_joint_dim", "5",
        "--impute_autograsp_action", "false", "--data_threads", "1"]
# the record route's episodes: LocobotPick at pick's training config
ROUTE = dict(demo_length=6, image_height=48, image_width=64, seed=3,
             data_threads=1, batch_size=3, test_batch_size=2)


def _pick_cfgs(root):
    """pick's training config over `root` in both packages, the window the
    episodes' 6 frames."""
    return (pick.train_cfg(Config(**ROUTE), root).replace(video_length=6),
            jpick.train_cfg(JConfig(**ROUTE), root).replace(video_length=6))


@pytest.fixture(scope="module")
def route(tmp_path_factory):
    """7 LocobotPick episodes (seed 3) written as HDF5 by the port's
    collect_training_data and, from the same seed in memory, as record
    shards; the port's and the JAX package's convert_to_records of the
    HDF5 files, 3 episodes a shard."""
    root = tmp_path_factory.mktemp("route")
    data_root = str(root / "data_pick")
    cfg, jcfg = _pick_cfgs(data_root)
    files = collect.collect_training_data("LocobotPick", 7, data_root, cfg,
                                          seed=3, device="cpu")
    eps = list(collect.training_episodes("LocobotPick", 7, data_root, cfg,
                                         seed=3, device="cpu"))
    out = dict(root=root, data_root=data_root, cfg=cfg, jcfg=jcfg,
               files=files, eps=eps)
    out["memory"] = str(root / "memory")
    collect.write_training_records(eps, out["memory"], cfg,
                                   episodes_per_shard=3)
    out["port"] = str(root / "port")
    records.convert_to_records(cfg, files, ["locobot_c0"] * 7, out["port"],
                               episodes_per_shard=3)
    return out


def test_record_shards_equal_convert_to_records(route):
    """Episodes collected in memory and written as shards equal, bit for
    bit, the port's and the JAX package's convert_to_records of the same
    episodes' HDF5 files (3 shards of up to 3 episodes, each episode's
    file path the HDF5 route's)."""
    assert len(os.listdir(route["memory"])) == 6
    assert shards_equal(route["memory"], route["port"])
    jdir = str(route["root"] / "jax_convert")
    jrecords.convert_to_records(route["jcfg"], route["files"],
                                ["locobot_c0"] * 7, jdir, episodes_per_shard=3)
    assert shards_equal(route["memory"], jdir)
    ds = records.RecordDataset(route["memory"])
    assert [ds.meta(i)["file_path"] for i in range(len(ds))] == route["files"]


def test_record_shards_hold_jax_collection(route, tmp_path):
    """The JAX package's collect_training_data of the same seed, converted
    by its convert_to_records: the same episodes within the envs'
    tolerances (images and masks equal)."""
    jcfg = route["jcfg"]
    jfiles = jcollect.collect_training_data("LocobotPick", 7, str(tmp_path),
                                            jcfg, seed=3)
    assert [os.path.basename(f) for f in jfiles] == \
        [os.path.basename(f) for f in route["files"]]
    jdir = str(tmp_path / "records")
    jrecords.convert_to_records(jcfg, jfiles, ["locobot_c0"] * 7, jdir,
                                episodes_per_shard=3)
    got, want = records.RecordDataset(route["memory"]), records.RecordDataset(jdir)
    assert len(got) == len(want) == 7
    for i in range(7):
        g, w = got[i], want[i]
        for k in ("images", "masks"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
        for k in ("states", "actions", "qpos"):
            np.testing.assert_allclose(g[k], w[k], err_msg=k,
                                       atol=JOINT_TOL if k == "qpos" else TOL)


def test_record_shards_reject_unquantized_images(route, tmp_path):
    """A planted fault: the observations written as the env's floats,
    without the uint8 quantization the HDF5 files hold. The shards then
    differ from convert_to_records'. (The bool cast of the masks is the
    other cast before preprocessing; the envs' masks are {0, 1} floats,
    so it changes no value here.)"""
    env = collect._make_env("LocobotPick", route["cfg"], 3, "cpu")
    planted = []  # the same episodes again: the same env seed
    for path, ep in route["eps"]:
        obs = env.generate_demo("pick_place")["obs"]
        planted.append((path, dict(ep, observations=np.stack(
            [o["observation"] for o in obs]))))
    out = str(tmp_path / "planted")
    collect.write_training_records(planted, out, route["cfg"],
                                   episodes_per_shard=3)
    assert not shards_equal(out, route["port"])


def _split(loaders):
    return [list(ld.dataset.file_paths if hasattr(ld.dataset, "file_paths")
                 else ld.dataset._traj_names) for ld in loaders]


def test_record_split_equals_the_hdf5_routes(route, monkeypatch):
    """The record loaders of train_locobot_pick put the same episodes into
    train and test, in the same order, as the port's and the JAX package's
    HDF5 loaders over the tree (seeded shuffle by path, the head split
    clamped to 1 test episode), with the same batch sizes and seeds. A
    planted fault, an unshuffled split, is rejected."""
    cfg = route["cfg"]
    want = _split(jloader.create_locobot_pick_loaders(route["jcfg"]))
    hdf5 = tloader.create_locobot_pick_loaders(cfg)
    got = records.create_record_loaders(cfg, route["memory"])
    assert _split(hdf5) == want == _split(got)
    assert [len(w) for w in want] == [6, 1]
    for g, h in zip(got, hdf5):
        assert (g.batch_size, g.seed, g.shuffle, g.drop_last, g.num_workers) \
            == (h.batch_size, h.seed, h.shuffle, h.drop_last, h.num_workers)
    monkeypatch.setattr(tloader, "_seeded_shuffle",
                        lambda pairs, seed: sorted(pairs))
    assert _split(records.create_record_loaders(cfg, route["memory"])) != want
    with pytest.raises(ValueError, match="head-split"):
        records.create_record_loaders(cfg.replace(experiment="train_robonet"),
                                      route["memory"])


def test_reader_takes_an_episode_in_memory(route):
    """The HDF5 reader's items of an episode read from its file and of the
    same episode in memory, bit for bit."""
    cfg = route["cfg"]
    from robot_aware_control_tpu_torch.data.robonet_hdf5 import RoboNetHDF5Dataset

    a = RoboNetHDF5Dataset(route["files"], ["locobot_c0"] * 7, cfg)
    b = RoboNetHDF5Dataset(route["files"], ["locobot_c0"] * 7, cfg,
                           episodes=[e for _, e in route["eps"]])
    for i in (0, 6):
        x, y = a[i], b[i]
        assert set(x) == set(y)
        for k in x:
            if isinstance(x[k], np.ndarray):
                assert x[k].dtype == y[k].dtype
                np.testing.assert_array_equal(x[k], y[k], err_msg=k)
            else:
                assert x[k] == y[k], k
    with pytest.raises(ValueError, match="episodes for"):
        RoboNetHDF5Dataset(route["files"], ["locobot_c0"] * 7, cfg,
                           episodes=[route["eps"][0][1]])


def test_has_h5py(monkeypatch):
    """has_h5py says whether h5py is installed; a failure to import
    anything else on the way raises."""
    assert demo_io.has_h5py()
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert not demo_io.has_h5py()
    monkeypatch.delitem(sys.modules, "h5py")
    import builtins

    real = builtins.__import__

    def broken(name, *a, **k):
        if name == "h5py":
            raise ModuleNotFoundError("No module named 'h5py_defs'",
                                      name="h5py_defs")
        return real(name, *a, **k)

    monkeypatch.setattr(builtins, "__import__", broken)
    with pytest.raises(ModuleNotFoundError, match="h5py_defs"):
        demo_io.has_h5py()


# ----------------------------------------------------------- configs
def _fields_equal(got: Config, want: JConfig):
    shared = set(got.__dict__) & set(want.__dict__)
    assert len(shared) == len(got.__dict__)
    diff = {k: (getattr(got, k), getattr(want, k)) for k in shared
            if getattr(got, k) != getattr(want, k)}
    assert not diff


def test_experiment_configs_match_jax():
    """train_cfg, plan_cfg and _base_cfg equal the JAX package's field for
    field (every field of the port's Config), from a non-default config."""
    kw = dict(niter=7, robot_cost_weight=0.0, world_cost_weight=0.5,
              horizon=4, replan_every=2, opt_iter=3, action_candidates=9,
              topk=3, demo_timescale=2, max_episode_length=7, num_episodes=9,
              n_eval=12, video_length=9)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    _fields_equal(pick.train_cfg(cfg, "/d"), jpick.train_cfg(jcfg, "/d"))
    _fields_equal(pick.plan_cfg(cfg, pick.train_cfg(cfg, "/d"), "/e"),
                  jpick.plan_cfg(jcfg, jpick.train_cfg(jcfg, "/d"), "/e"))
    _fields_equal(transfer._base_cfg(cfg, jobname="x", data_root="/d"),
                  jtransfer._base_cfg(jcfg, jobname="x", data_root="/d"))


# ----------------------------------------------------------- eval_transfer
def test_eval_transfer_matches_jax(tmp_path, monkeypatch):
    """eval_transfer on one checkpoint written by the JAX package (an svg
    with He-scaled random weights) over 4 ModifiedLocobotPush episodes:
    the port's metrics equal JAX's to 1e-4, from the HDF5 files and from
    the same episodes in memory alike. (JAX's eval_transfer initialises
    the model it loads the checkpoint into op by op, some 15 s on the CPU:
    the test jits that init.)"""
    monkeypatch.setattr(jsvg, "init", jax.jit(jsvg.init, static_argnums=1))
    argv = TINY + ["--video_length", "5", "--n_past", "1", "--n_future", "2",
                   "--log_dir", str(tmp_path)]
    from robot_aware_control_tpu.config import argparser as jargparser
    from robot_aware_control_tpu_torch.config import argparser

    cfg = transfer._base_cfg(argparser(argv)[0], model_use_mask=True,
                             model_use_robot_state=True,
                             reconstruction_loss="dontcare_l1")
    jcfg = jtransfer._base_cfg(jargparser(argv)[0], model_use_mask=True,
                               model_use_robot_state=True,
                               reconstruction_loss="dontcare_l1")
    shapes = jax.eval_shape(lambda k: jsvg.init(k, jcfg), jax.random.PRNGKey(0))
    params, bn = random_tree(shapes, np.random.RandomState(0))
    path = jckpt.save_checkpoint(str(tmp_path), 3, {"params": params,
                                                    "bn": bn})
    root = str(tmp_path / "modified")
    files = collect.collect_training_data("ModifiedLocobotPush", 4, root, cfg,
                                          seed=5, device="cpu")
    want = jtransfer.eval_transfer(jcfg, path, files)
    got = transfer.eval_transfer(cfg, path, files, device="cpu")
    eps = [e for _, e in collect.training_episodes(
        "ModifiedLocobotPush", 4, root, cfg, seed=5, device="cpu")]
    in_memory = transfer.eval_transfer(cfg, path, files, device="cpu",
                                       episodes=eps)
    assert set(got) == set(want) == set(in_memory)
    assert want["world_loss"] > 0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=EVAL_RTOL, err_msg=k)
        assert in_memory[k] == got[k], k


# ----------------------------------------------------------- end to end
def test_pick_main_on_the_record_route(tmp_path, monkeypatch, capsys):
    """pick.main end to end on the CPU with h5py hidden: record shards,
    the trainer on them, eval demos in memory, the learned pick runner;
    pick_results.json with the JAX experiment's keys, finite."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    t0 = time.perf_counter()
    result = pick.main(TINY + [
        "--demo_length", "6", "--video_length", "8", "--horizon", "3", "--opt_iter", "1",
        "--action_candidates", "4", "--topk", "2", "--max_episode_length",
        "3", "--log_dir", str(tmp_path), "--device", "cpu"])
    seconds = time.perf_counter() - t0
    assert "data route: record shards (h5py not installed)" in capsys.readouterr().out
    with open(tmp_path / "pick_results.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(result))
    assert set(saved) == {"ckpt", "episodes", "summary"}
    assert set(saved["summary"]) == set(saved["episodes"]) == {
        "goal_progress", "push_progress", "final_obj_dist", "success",
        "object_success", "gripper_success", "episode_reward"}
    assert all(len(v) == 4 for v in saved["episodes"].values())
    assert all(np.isfinite(v) for v in saved["summary"].values())
    assert os.listdir(tmp_path / "data_pick" / "records")
    assert seconds < 30


def test_transfer_main_on_the_record_route(tmp_path, monkeypatch, capsys):
    """transfer.main end to end on the CPU with h5py hidden (the tiny run
    of tests/test_transfer_experiment.py): transfer_results.json with the
    JAX experiment's keys, finite."""
    monkeypatch.setitem(sys.modules, "h5py", None)
    t0 = time.perf_counter()
    result = transfer.main(TINY + [
        "--n_past", "1", "--n_future", "2", "--video_length", "5",
        "--log_dir", str(tmp_path), "--jobname", "tx", "--device", "cpu"])
    seconds = time.perf_counter() - t0
    assert "data route: record shards" in capsys.readouterr().out
    with open(tmp_path / "transfer_results.json") as f:
        saved = json.load(f)
    assert saved == json.loads(json.dumps(result))
    assert set(saved) == {"robot_aware", "vanilla",
                          "world_mse_ratio_vanilla_over_ra"}
    keys = {"recon_loss", "robot_loss", "world_loss", "psnr", "ssim", "kld",
            "world_psnr"}
    assert set(saved["robot_aware"]) == set(saved["vanilla"]) == keys
    assert saved["robot_aware"]["world_loss"] > 0
    assert np.isfinite(saved["world_mse_ratio_vanilla_over_ra"])
    assert seconds < 30


def test_experiments_run_on_the_card_by_default(tmp_path):
    """Without --device both experiments run on the card, and raise
    without one before any work."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs")
    for main in (pick.main, transfer.main):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            main(TINY + ["--log_dir", str(tmp_path)])
    assert not os.listdir(tmp_path)
