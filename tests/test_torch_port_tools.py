"""The port's data tools, sweeps, YAML helpers, profiling and DMC wrapper
held against the JAX package on the CPU: mask-data reports, the world
change rate, the action gif, the mask dataset, grid expansion and metric
reads, a sweep with a failing trial, YAML files across the packages, the
step timer's EMA, a chrome trace, device memory stats and the dm_control
gate (with a stand-in suite module for what JAX's wrapper does)."""

import json
import os
import sys
import time
import types

import h5py
import numpy as np
import pytest
import torch

from robot_aware_control_tpu import config as jconfig
from robot_aware_control_tpu.data import tools as jtools
from robot_aware_control_tpu.envs import dmc_env as jdmc
from robot_aware_control_tpu.robot.mask_renderer import (
    CapsuleMaskRenderer as JRenderer,
)
from robot_aware_control_tpu.training import sweep as jsweep
from robot_aware_control_tpu.utils import profiling as jprof
from robot_aware_control_tpu_torch import config as tconfig
from robot_aware_control_tpu_torch.data import tools
from robot_aware_control_tpu_torch.data.robonet_hdf5 import write_trajectory_hdf5
from robot_aware_control_tpu_torch.envs import dmc_env
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from robot_aware_control_tpu_torch.training import sweep
from robot_aware_control_tpu_torch.utils import profiling
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)


# ------------------------------------------------------------------- tools
def test_check_mask_data_equal_jax(tmp_path):
    """Reports of valid, empty, covering, non-binary, short and missing
    mask streams equal JAX's."""
    r = np.random.RandomState(0)
    T, H, W = 4, 8, 10
    frames = (r.rand(T, H, W, 3) * 255).astype(np.uint8)
    box = np.zeros((T, H, W), np.uint8)
    box[:, 2:5, 3:6] = 1
    cases = {"valid": box, "empty": np.zeros_like(box),
             "covering": np.ones_like(box), "nonbinary": box * 2,
             "short": box[:2]}
    paths = []
    for name, masks in cases.items():
        p = str(tmp_path / f"{name}.hdf5")
        write_trajectory_hdf5(p, frames, np.zeros((T, 5)), np.zeros((T - 1, 5)),
                              masks, np.zeros((T, 5)))
        paths.append(p)
    p = str(tmp_path / "nomask.hdf5")
    with h5py.File(p, "w") as hf:
        hf.create_dataset("frames", data=frames)
    paths.append(p)
    got, want = tools.check_mask_data(paths), jtools.check_mask_data(paths)
    assert got == want
    assert [got[p]["ok"] for p in paths] == [True, False, False, True, False,
                                             False]


def test_world_change_rate_and_action_gif_equal_jax(tmp_path):
    """world_change_rate on uint8 and float frames, masks with and
    without a channel axis, and a single frame; the action gif's frames."""
    r = np.random.RandomState(1)
    T, H, W = 5, 12, 16
    masks = (r.rand(T, H, W) > 0.7).astype(np.float32)
    for imgs in ((r.rand(T, H, W, 3) * 255).astype(np.uint8),
                 r.rand(T, H, W, 3).astype(np.float32)):
        for m in (masks, masks[..., None]):
            assert tools.world_change_rate(imgs, m) == \
                jtools.world_change_rate(imgs, m)
        assert tools.world_change_rate(imgs[:1], masks[:1]) == 0.0
    imgs = r.rand(4, 48, 64, 3).astype(np.float32)
    acts, states = r.rand(3, 5), r.rand(4, 5)
    got = tools.visualize_actions(imgs, acts, states, str(tmp_path / "t.gif"))
    want = jtools.visualize_actions(imgs, acts, states, str(tmp_path / "j.gif"))
    import imageio.v2 as imageio

    a, b = imageio.mimread(got), imageio.mimread(want)
    assert len(a) == len(b) == 3
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)


def test_generate_mask_dataset_equal_jax(tmp_path):
    """Masks of 6 locobot configurations rendered by an env's renderer
    (the capsule kernel's plain version here, one launch) and stored beside
    their joints, as JAX's tool stores them; an env without a renderer
    stores its current mask for each."""
    q = np.random.RandomState(2).uniform(-0.6, 0.6, (6, 5)).astype(np.float32)
    jenv = types.SimpleNamespace(renderer=JRenderer((48, 64)),
                                 get_flattened_state=lambda: None,
                                 set_flattened_state=lambda s: None)
    tenv = types.SimpleNamespace(renderer=CapsuleMaskRenderer((48, 64),
                                                              device="cpu"))
    want = jtools.generate_mask_dataset(jenv, q, str(tmp_path / "j" / "m.hdf5"))
    got = tools.generate_mask_dataset(tenv, q, str(tmp_path / "t" / "m.hdf5"))
    with h5py.File(got, "r") as g, h5py.File(want, "r") as w:
        assert list(g.keys()) == list(w.keys()) == ["masks", "qpos"]
        for k in g.keys():
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k][()], w[k][()])
        assert g["masks"][()].any()
    mask = np.zeros((48, 64, 1), np.float32)
    mask[3:9, 4:7] = 1
    bare = types.SimpleNamespace(get_robot_mask=lambda: mask)
    with h5py.File(tools.generate_mask_dataset(bare, q[:2], str(tmp_path / "b.h5")),
                   "r") as f:
        np.testing.assert_array_equal(f["masks"][()], np.stack([mask] * 2) > 0)


# -------------------------------------------------------------- sweep, yaml
def test_expand_grid_and_read_metric_equal_jax(tmp_path):
    grid = {"lr": [1e-3, 1e-4], "g_dim": [8, 16]}
    got = sweep.expand_grid(tconfig.Config(jobname="s"), grid)
    want = jsweep.expand_grid(jconfig.Config(jobname="s"), grid)
    assert [(c.jobname, c.lr, c.g_dim) for c in got] == \
        [(c.jobname, c.lr, c.g_dim) for c in want]
    assert len({c.jobname for c in got}) == 4
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for rec in ({"step": 0, "train/loss": 2.0}, {"test/psnr": 9.0},
                    {"train/loss": 1.5}):
            f.write(json.dumps(rec) + "\n")
    for metric in ("train/loss", "test/psnr", "absent"):
        assert sweep._read_metric(str(tmp_path), metric) == \
            jsweep._read_metric(str(tmp_path), metric)
    assert sweep._read_metric(str(tmp_path / "none"), "train/loss") is None


def test_run_sweep_picks_the_best_and_reports_a_failing_trial(tmp_path,
                                                              monkeypatch):
    """Two det trials on synthetic data train on the CPU; the best by the
    last train/loss is returned. A trial that always fails (planted) is
    tried max_failures + 1 times, keeps its errors and scores None."""
    base = tconfig.Config(
        model="det", experiment="synthetic", g_dim=8, image_height=16,
        image_width=16, batch_size=2, test_batch_size=2, niter=1,
        epoch_size=1, n_past=1, n_future=2, n_eval=3, video_length=4,
        checkpoint_interval=5, eval_interval=5, compute_dtype="float32",
        robot_dim=5, action_dim=5, robot_joint_dim=5, model_use_mask=True,
        model_use_robot_state=True, reconstruction_loss="l1",
        log_dir=str(tmp_path), jobname="sw")
    best, results = sweep.run_sweep(base, {"lr": [1e-3, 1e-4]},
                                    metric="train/loss", device="cpu")
    values = [r["value"] for r in results]
    assert len(results) == 2 and all(np.isfinite(v) for v in values)
    assert best.lr == results[int(np.argmin(values))]["config"].lr
    assert all(r["errors"] == [] for r in results)

    from robot_aware_control_tpu_torch.training import trainer

    real = trainer.PredictionTrainer

    def planted(cfg, device="cuda"):
        if cfg.lr == 1e-4:
            raise RuntimeError("planted trial failure")
        return real(cfg, device=device)

    monkeypatch.setattr(trainer, "PredictionTrainer", planted)
    best, results = sweep.run_sweep(base.replace(jobname="sw2"),
                                    {"lr": [1e-3, 1e-4]}, metric="train/loss",
                                    max_failures=1, device="cpu")
    assert best.lr == 1e-3 and results[1]["value"] is None
    assert len(results[1]["errors"]) == 2
    assert "planted trial failure" in results[1]["errors"][0]


def test_yaml_files_read_across_packages(tmp_path):
    """A port config through the port's YAML (round trip, overrides) and
    the JAX package's from_yaml; a JAX config's YAML (all 157 fields)
    through the port's from_yaml, the mesh fields too (model_axis_size 2
    loads). Unknown keys raise KeyError; a JAX-only field (wandb) away from
    its default raises NotImplementedError."""
    fields = dict(g_dim=17, reward_type="dontcare", camera_ids=(1, 2),
                  experiment="train_sawyer_multiview", lr=1e-4, multiview=True)
    cfg = tconfig.Config(**fields)
    path = str(tmp_path / "t.yaml")
    tconfig.to_yaml(cfg, path)
    assert tconfig.from_yaml(path) == cfg
    assert tconfig.from_yaml(path, g_dim=99) == cfg.replace(g_dim=99)
    jcfg = jconfig.from_yaml(path)
    for k in tconfig.Config.__dataclass_fields__:
        got, want = getattr(cfg, k), getattr(jcfg, k)
        tup = k in ("camera_ids", "mesh_axes")
        assert (tuple(got) if tup else got) == (tuple(want) if tup else want), k
    jpath = str(tmp_path / "j.yaml")
    jconfig.to_yaml(jconfig.Config(**fields), jpath)
    assert tconfig.from_yaml(jpath) == cfg
    assert set(tconfig.JAX_ONLY_DEFAULTS) == \
        set(jconfig.Config.__dataclass_fields__) - set(
            tconfig.Config.__dataclass_fields__)
    for k, v in tconfig.JAX_ONLY_DEFAULTS.items():
        assert getattr(jconfig.Config(), k) == (tuple(v) if isinstance(v, list)
                                                else v), k
    bad = str(tmp_path / "bad.yaml")
    with open(bad, "w") as f:
        f.write("not_a_flag: 3\n")
    with pytest.raises(KeyError):
        tconfig.from_yaml(bad)
    # the mesh fields are the port's too (parallel/mesh.py)
    mesh = dict(num_devices=4, model_axis_size=2, mesh_axes=("dp", "tp"),
                param_sharding="model")
    jconfig.to_yaml(jconfig.Config(**mesh), jpath)
    assert tconfig.from_yaml(jpath) == tconfig.Config(**mesh)
    jconfig.to_yaml(jconfig.Config(wandb=True), jpath)
    with pytest.raises(NotImplementedError, match="wandb"):
        tconfig.from_yaml(jpath)


# --------------------------------------------------------------- profiling
def test_step_timer_equal_jax_and_trace_writes(tmp_path, monkeypatch):
    """The step timer's EMA and throughput over planted step times equal
    JAX's; a CPU trace writes a chrome trace with the ops inside it; a
    disabled trace writes nothing; no CUDA gives no memory stats."""
    durations = [0.03, 0.01, 0.02, 0.05]
    timers = []
    for mod in (profiling, jprof):
        clock = iter(np.cumsum([0.0] + [d for d in durations for d in (d, 0.0)]))
        monkeypatch.setattr(mod.time, "perf_counter", lambda: float(next(clock)))
        t = mod.StepTimer(alpha=0.5)
        for _ in durations:
            with t:
                pass
        timers.append((t.ema_s, t.throughput(64)))
        monkeypatch.setattr(mod.time, "perf_counter", time.perf_counter)
    assert timers[0] == timers[1] and timers[0][0] > 0
    assert profiling.StepTimer().throughput(64) == 0.0
    with profiling.trace(str(tmp_path)) as path:
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert path == os.path.join(str(tmp_path), "profile", "trace.json")
    assert any("mm" in e.get("name", "") for e in events)
    with profiling.trace(str(tmp_path / "off"), enabled=False) as off:
        assert off is None
    assert not os.path.exists(tmp_path / "off")
    assert profiling.device_memory_stats() == {}


# --------------------------------------------------------------------- dmc
class _FakeSuite:
    """A stand-in for dm_control.suite: one task whose observation and
    pixels follow the step count."""

    class _Env:
        def __init__(self, seed):
            self.t = 0
            self.seed = seed
            self.physics = self

        def render(self, h, w, camera_id=0):
            return np.full((h, w, 3), (self.t * 40 + self.seed) % 256, np.uint8)

        def _ts(self):
            return types.SimpleNamespace(
                observation={"position": np.arange(3.0) + self.t,
                             "velocity": np.array([[self.t, -1.0]])},
                reward=None if self.t == 0 else 0.5 * self.t,
                last=lambda: self.t >= 2)

        def reset(self):
            self.t = 0
            return self._ts()

        def step(self, action):
            self.t += int(np.sum(action) > 0) + 1
            return self._ts()

    @classmethod
    def load(cls, domain, task, task_kwargs):
        return cls._Env(task_kwargs["random"])


def test_dmc_wrapper_gate_and_equal_jax(monkeypatch):
    """Without dm_control both wrappers raise RuntimeError naming it; with
    a stand-in suite the port's reset and step equal JAX's."""
    monkeypatch.setitem(sys.modules, "dm_control", None)
    for mod in (dmc_env, jdmc):
        with pytest.raises(RuntimeError, match="dm_control"):
            mod.DMCEnv()
    monkeypatch.setitem(sys.modules, "dm_control",
                        types.SimpleNamespace(suite=_FakeSuite))
    monkeypatch.setitem(sys.modules, "dm_control.suite", _FakeSuite)
    envs = [mod.DMCEnv(image_size=(6, 8), seed=3) for mod in (dmc_env, jdmc)]
    outs = [[e.reset()] + [e.step(a) for a in ([1.0], [-1.0])] for e in envs]
    for got, want in zip(*outs):
        if isinstance(want, tuple):
            assert got[1:] == want[1:]
            got, want = got[0], want[0]
        for k in ("observation", "states"):
            assert got[k].dtype == want[k].dtype == np.float32
            np.testing.assert_array_equal(got[k], want[k])
