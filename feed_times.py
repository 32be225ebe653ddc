#!/usr/bin/env python3
"""Times the port's PredictionTrainer with its data feed, on one NVIDIA
GPU: frames/s of every epoch and the seconds each waited in
next(train_iter), for

  synthetic     svg at bench.py:136-156's width (g_dim 256, z_dim 64, bf16,
                remat conv), batch 32, 31-frame videos: chip_smoke.py's
                trainer phase;
  det           the det model at that width, batch 32, 12-frame videos:
                chip_smoke.py's det trainer;
  synthetic128  svg, batch 128, 31-frame videos: chip_smoke.py's data
                phase's synthetic trainer;
  records       svg, batch 128, 31-frame videos, fed by
                DataLoader(RecordDataset) with 5 threads over the record
                shards in --records (512 episodes in 8 shards of 64, written
                there with numpy alone if it holds none);

and one shuffled epoch of that loader alone on the host (episodes/s, and
the shard decodes where the checkout counts them). `--only smoke` runs
instead the checkout's own chip_smoke.py trainer checks (its trainer
phase, then its copy baseline and det trainers, each one epoch with an
eval epoch), after building the kernels, and reads the frames/s each
trainer logs.

    python3 feed_times.py --records DIR [--only a,b] [--niter 3]
                          [--switch_interval S]

Every trainer takes niter epochs of epoch_size 2 and runs no eval epoch, so
no hand kernel is built. A copy of this script run from the root of
another checkout (say the parent commit, unpacked by `git archive`) times
that checkout's trainer on the same shards, so that versions are compared
in one call in turns: parent, change, change, parent. A checkout without
data/records.py (before the data loaders were ported) skips `records` and
the loader. --switch_interval sets sys.setswitchinterval (seconds) before
anything runs. Prints the card's name and power limit, then one JSON line
{"card": ..., "switch_interval": ..., "trainers": {name: {"frames_per_s":
[per epoch], "seconds": ..., "last_epoch": {"seconds", "data_wait_s"}}},
"loader": ..., "smoke": {"trainer": [...], "det": [...]}}.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import tempfile
import time

import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "tests"))
from torch_train_small import TRAIN  # noqa: E402

from robot_aware_control_tpu_torch.config import Config  # noqa: E402
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer  # noqa: E402

EPISODES = 512  # 4 batches of 128
SHARD = 64


def configs(niter: int) -> dict:
    base = dict(TRAIN, experiment="synthetic", test_batch_size=16,
                niter=niter, epoch_size=2, n_eval=10, eval_interval=1000,
                checkpoint_interval=1000)
    return {
        "synthetic": dict(base, batch_size=32, video_length=31),
        "det": dict(base, model="det", batch_size=32, video_length=12, n_eval=6),
        "synthetic128": dict(base, batch_size=128, video_length=31),
        "records": dict(base, batch_size=128, video_length=31, data_threads=5),
    }


def run_trainer(name: str, cfg_kw: dict, records: str) -> dict:
    """One trainer's epochs: frames/s from its metrics.jsonl, the epoch and
    wait seconds where the trainer keeps them (last_epoch, the last epoch
    only), else from its log."""
    with tempfile.TemporaryDirectory(dir=os.path.dirname(os.path.abspath(__file__))) as d:
        cfg = Config(**dict(cfg_kw, log_dir=d, jobname=name))
        if name == "records":
            from torch_data_cases import RecordTrainer

            tr = RecordTrainer(cfg, records)
        else:
            tr = PredictionTrainer(cfg)
        t = time.perf_counter()
        tr.train()
        seconds = time.perf_counter() - t
        with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
            fps = [json.loads(line)["train/frames_per_sec"] for line in f
                   if "train/frames_per_sec" in line]
        last = getattr(tr, "last_epoch", None)
        tr.logger.close()
    del tr
    gc.collect()
    torch.cuda.empty_cache()
    return {"frames_per_s": fps, "seconds": seconds, "last_epoch": last}


def loader_epoch(records: str) -> dict:
    """One shuffled epoch of the records trainer's loader on the host."""
    from robot_aware_control_tpu_torch.data.loader import DataLoader
    from robot_aware_control_tpu_torch.data.records import RecordDataset

    ds = RecordDataset(os.path.join(records, "train"))
    loader = DataLoader(ds, 128, num_workers=5, seed=0)
    t = time.perf_counter()
    n = sum(b["images"].shape[1] for b in loader)
    s = time.perf_counter() - t
    return {"episodes": n, "seconds": s, "episodes_per_s": n / s,
            "shards": len(ds.paths), "decodes": getattr(ds, "decodes", None)}


def smoke_trainers() -> dict:
    """chip_smoke.py's check_trainer and check_copy_and_resume of this
    checkout: the train/frames_per_sec that each trainer epoch logs."""
    import chip_smoke
    from robot_aware_control_tpu_torch.ops import kernels
    from robot_aware_control_tpu_torch.training.logger import RunLogger

    fps = []
    scalars = RunLogger.scalars

    def recording(self, metrics, step, prefix=""):
        if prefix == "train/" and "frames_per_sec" in metrics:
            fps.append(float(metrics["frames_per_sec"]))
        return scalars(self, metrics, step, prefix)

    kernels.build()
    RunLogger.scalars = recording
    try:
        chip_smoke.check_trainer()
        n = len(fps)
        chip_smoke.check_copy_and_resume()
    finally:
        RunLogger.scalars = scalars
    return {"trainer": fps[:n], "det": fps[n:]}


def write_shards(records: str, cfg_kw: dict):
    from torch_data_cases import write_record_split

    cfg = Config(**cfg_kw)
    t = time.perf_counter()
    write_record_split(os.path.join(records, "train"), EPISODES, cfg, 0,
                       episodes_per_shard=SHARD)
    write_record_split(os.path.join(records, "test"), 32, cfg, 1,
                       episodes_per_shard=SHARD)
    print(f"wrote {EPISODES} + 32 episodes in {time.perf_counter() - t:.1f} s",
          flush=True)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--records", required=True,
                    help="record shard root (train/, test/); written if empty")
    ap.add_argument("--only", default="synthetic,det,synthetic128,records,loader")
    ap.add_argument("--niter", type=int, default=3)
    ap.add_argument("--switch_interval", type=float, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("feed_times: no CUDA device is available", file=sys.stderr)
        return 1
    if args.switch_interval is not None:
        sys.setswitchinterval(args.switch_interval)
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60
    ).stdout.strip().splitlines()[0]
    print(card)
    has_records = os.path.exists(os.path.join(
        os.path.dirname(os.path.abspath(__file__)),
        "robot_aware_control_tpu_torch", "data", "records.py"))
    only = args.only.split(",")
    cfgs = configs(args.niter)
    if (has_records and {"records", "loader"} & set(only)
            and not os.path.isdir(os.path.join(args.records, "train"))):
        write_shards(args.records, cfgs["records"])
    out = {"card": card, "switch_interval": sys.getswitchinterval(),
           "trainers": {}, "loader": None}
    for name in ("synthetic", "det", "synthetic128", "records"):
        if name not in only or (name == "records" and not has_records):
            continue
        r = run_trainer(name, cfgs[name], args.records)
        out["trainers"][name] = r
        print(f"{name}: frames/s by epoch "
              + ", ".join(f"{v:.1f}" for v in r["frames_per_s"])
              + f"; last epoch {r['last_epoch']}", flush=True)
    if "smoke" in only:
        out["smoke"] = smoke_trainers()
        print(f"smoke trainers: {out['smoke']}", flush=True)
    if "loader" in only and has_records:
        out["loader"] = loader_epoch(args.records)
        print(f"loader: {out['loader']}", flush=True)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
