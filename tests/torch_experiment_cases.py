"""The experiments slice's checks that run on the card as well as on the
CPU (not a test module; imports no JAX): the record route's shards, the
I3D and the random FVD embedder, the CycleGAN translator and train step,
and a push episode under --cyclegan. `chip_smoke.py` (phase 16) and
tests/test_torch_port_gpu.py share them."""

from __future__ import annotations

import glob
import json
import os
import time

import numpy as np
import torch

from robot_aware_control_tpu_torch.baselines import cyclegan
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.episode_runner import PushEpisodeRunner
from robot_aware_control_tpu_torch.data import demo_io
from robot_aware_control_tpu_torch.data.collect import (
    training_episodes,
    write_training_records,
)
from robot_aware_control_tpu_torch.data.records import create_record_loaders
from robot_aware_control_tpu_torch.evaluation import fvd, i3d
from robot_aware_control_tpu_torch.experiments import pick

# card against CPU on the same weights, TF32 off: float32 convolutions
# summed in another order. The I3D's 57 layers and the embedder's 3 are
# held relative to the largest |output|, the translator's [0, 1] images
# absolutely.
I3D_TOL = 1e-4
EMBED_TOL = 1e-4
CYCLEGAN_TOL = 1e-4

# phase 16's experiments at the Config defaults' widths (svg, g_dim 128,
# z_dim 10, rnn_size 256, bf16, 48x64; pick's plans at N = 30, horizon 5,
# opt_iter 10, topk 5), cut in depth only: one epoch of a few batches, 8
# training episodes (pick: 6 eval episodes of at most 10 steps), and
# transfer's window at the episodes' 12 frames (its default 31 exceeds the
# default demo_length of 12, which the reader refuses in either package)
EXPERIMENT_CUTS = {"niter": 1, "epoch_size": 4, "num_episodes": 8}
TRANSFER_CUTS = dict(EXPERIMENT_CUTS, video_length=12)


def flags(fields: dict) -> list:
    return [a for k, v in fields.items() for a in (f"--{k}", str(v))]


def record_route(out_dir: str, device, n: int = 8, seed: int = 0,
                 fields=None, record_dir=None) -> dict:
    """n LocobotPick episodes collected on `device` and written as record
    shards (under `record_dir`, by default <out_dir>/records) with pick's
    training config, as experiments/pick.py does without h5py, each under
    the HDF5 path it would have in out_dir: the seconds, episodes/s, the
    shards and the train/test split (episode file names)."""
    cfg = Config(**dict(fields or {}, seed=seed))
    t0 = time.perf_counter()
    eps = list(training_episodes("LocobotPick", n, out_dir, cfg, seed=seed,
                                 device=device))
    collect_s = time.perf_counter() - t0
    tcfg = pick.train_cfg(cfg, out_dir).replace(
        video_length=min(cfg.video_length, min(len(e["observations"])
                                               for _, e in eps)))
    record_dir = record_dir or os.path.join(out_dir, "records")
    shards = write_training_records(eps, record_dir, tcfg)
    seconds = time.perf_counter() - t0
    train, test = create_record_loaders(tcfg, record_dir)
    name = lambda ds: [os.path.basename(p) for p in ds.dataset.file_paths]
    return dict(episodes=n, collect_s=collect_s, seconds=seconds,
                episodes_per_s=n / seconds, shards=len(shards),
                record_dir=record_dir, train=name(train), test=name(test),
                video_length=tcfg.video_length)


def shards_equal(dir_a: str, dir_b: str) -> bool:
    """Whether two shard trees hold the same arrays, bit for bit, and the
    same episode lists."""
    a = sorted(glob.glob(os.path.join(dir_a, "shard_*.npz")))
    b = sorted(glob.glob(os.path.join(dir_b, "shard_*.npz")))
    if [os.path.basename(p) for p in a] != [os.path.basename(p) for p in b]:
        return False
    for pa, pb in zip(a, b):
        with np.load(pa) as za, np.load(pb) as zb:
            if sorted(za.files) != sorted(zb.files) or not all(
                    za[k].dtype == zb[k].dtype and np.array_equal(za[k], zb[k])
                    for k in za.files):
                return False
        with open(pa + ".json") as fa, open(pb + ".json") as fb:
            if json.load(fa) != json.load(fb):
                return False
    return True


def shards_close(dir_a: str, dir_b: str, tol: float) -> dict:
    """Two shard trees of the same episodes collected on two devices: the
    episode lists and keys equal, the images and masks equal, the states,
    actions and joints within `tol` (the envs' physics on the card equals
    the CPU's to float32 rounding, tests/torch_sim_cases.py). Returns the
    largest difference of each array and whether the trees agree."""
    a = sorted(glob.glob(os.path.join(dir_a, "shard_*.npz")))
    b = sorted(glob.glob(os.path.join(dir_b, "shard_*.npz")))
    same = [os.path.basename(p) for p in a] == [os.path.basename(p) for p in b]
    diffs = {}
    for pa, pb in zip(a, b):
        with open(pa + ".json") as fa, open(pb + ".json") as fb:
            same &= json.load(fa) == json.load(fb)
        with np.load(pa) as za, np.load(pb) as zb:
            same &= sorted(za.files) == sorted(zb.files)
            for k in za.files:
                d = float(np.abs(za[k].astype(np.float64) - zb[k]).max())
                diffs[k] = max(diffs.get(k, 0.0), d)
    ok = same and all(diffs.get(k, 1.0) == 0.0 for k in ("images", "masks")) \
        and all(v <= tol for v in diffs.values())
    return dict(diffs=diffs, equal_lists=same, ok=bool(ok))


def videos(B: int = 2, T: int = 8, H: int = 48, W: int = 64, seed: int = 0):
    return np.random.RandomState(seed).rand(B, T, H, W, 3).astype(np.float32)


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    got, want = got.float().cpu(), want.float().cpu()
    return float((got - want).abs().max() / want.abs().max())


def i3d_card_vs_cpu(dev, **shape) -> dict:
    """The seed-42 I3D's embedding of the same videos on `dev` and on the
    CPU: the error relative to the largest |logit|."""
    x = videos(**shape)
    cpu = i3d.init(42, "cpu")
    card = i3d.init(42, dev)
    want, got = i3d.embed(cpu, x), i3d.embed(card, x)
    return dict(rel_err=_rel(got, want), shape=list(got.shape),
                finite=bool(torch.isfinite(got).all()))


def random_embed_card_vs_cpu(dev, **shape) -> dict:
    """The random FVD embedder (seed 42) on `dev` against the CPU."""
    x = videos(**shape)
    want = fvd.default_embed_fn(x, device="cpu")
    got = fvd.default_embed_fn(x, device=dev)
    return dict(rel_err=_rel(got, want), shape=list(got.shape))


def cyclegan_card_vs_cpu(dev, H: int = 48, W: int = 64) -> dict:
    """The seed-0 CycleGAN (the runner's default size: ngf 64, 6 blocks)
    translating the same images on `dev` and on the CPU, and one
    train_step on `dev` (batch 2): the translator's max |diff| and the
    step's losses."""
    imgs = np.random.RandomState(1).rand(2, H, W, 3).astype(np.float32)
    want = cyclegan.CycleGANTranslator(cyclegan.init(0, device="cpu"))(imgs)
    got = cyclegan.CycleGANTranslator(cyclegan.init(0, device=dev))(imgs)
    gan = cyclegan.CycleGAN(0, device=dev)
    r = np.random.RandomState(2)
    losses = gan.train_step(r.uniform(-1, 1, (2, H, W, 3)),
                            r.uniform(-1, 1, (2, H, W, 3)))
    return dict(max_diff=float(np.abs(got - want).max()), losses=losses,
                finite=bool(np.isfinite(got).all()
                            and all(np.isfinite(v) for v in losses.values())))


# a 2-step LocobotPush episode through the simulator (GT CEM at N = 30,
# horizon 5, opt_iter 10) with its observations translated by the CycleGAN
CYCLEGAN_EPISODE = dict(env="LocobotPush", use_env_dynamics=True,
                        cyclegan=True, max_episode_length=3, replan_every=1,
                        demo_length=6, num_episodes=1, record_video_interval=0,
                        jobname="cyclegan")


def cyclegan_episode(dev, log_dir: str) -> dict:
    """A PushEpisodeRunner episode with --cyclegan on `dev`, following a
    demo made in memory by demo_from_history: its stats, actions and how
    many observations the translator took."""
    cfg = Config(**dict(CYCLEGAN_EPISODE, log_dir=log_dir))
    runner = PushEpisodeRunner(cfg, device=dev)
    calls = []
    translate = runner.translator

    def counted(img):
        calls.append(img.shape)
        return translate(img)

    runner.translator = counted
    env = runner.env
    demo = demo_io.demo_from_history(env, env.generate_demo("straight_push"))
    actions = []
    step = env.step

    def recorded(a):
        actions.append(np.asarray(a, np.float32))
        return step(a)

    env.step = recorded
    try:
        stats = runner.run_episode(0, demo)
    finally:
        runner.logger.close()
    return dict(stats=stats, actions=np.stack(actions).tolist(),
                translated=len(calls),
                finite=bool(all(np.isfinite(v) for v in stats.values())))
