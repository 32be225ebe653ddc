"""Packed record shards: preprocessed episodes in fixed-shape npz shards
(counterpart of `robot_aware_control_tpu/data/records.py`; reference:
robonet/robonet/datasets/util/hdf5_2_records.py, record_dataset.py).

Each trajectory is decoded and preprocessed once (resize, normalization,
autograsp: the HDF5 reader's semantics), and many episodes are packed into
compressed `shard_<i>.npz` files, each with a `.json` list of its episodes'
robot, folder and file path. Reading them needs numpy alone, so this is the
data route on a machine without h5py; shards written by either package
read in the other. `create_record_loaders` splits a shard tree's episodes
as the HDF5 loaders of the head-split locobot experiments and of
train_sawyer_multiview split their files (data/loader.py), by the file
paths the shards carry; `create_record_transfer_loader` takes the latter's
held-out view.
"""

from __future__ import annotations

import glob
import json
import os
import threading
from collections import OrderedDict
from typing import Dict, Iterable, List, Optional, Sequence

import numpy as np

from robot_aware_control_tpu_torch.config import Config

_KEYS = ("images", "states", "actions", "masks", "qpos")


def write_records(items: Iterable[dict], out_dir: str, video_length: int,
                  episodes_per_shard: int = 64) -> List[str]:
    """Packs episode dicts (the HDF5 reader's items: `_KEYS` arrays, robot,
    folder, file_path) into shards, each episode cut to `video_length`
    frames. Returns the shard paths."""
    os.makedirs(out_dir, exist_ok=True)
    shards: List[str] = []
    buf: Dict[str, list] = {k: [] for k in _KEYS}
    metas: List[dict] = []

    def flush():
        path = os.path.join(out_dir, f"shard_{len(shards):05d}.npz")
        np.savez_compressed(path, **{k: np.stack(v) for k, v in buf.items() if v})
        with open(path + ".json", "w") as f:
            json.dump(metas, f)
        shards.append(path)
        for v in buf.values():
            v.clear()
        metas.clear()

    for item in items:
        for k in _KEYS:
            n = video_length - 1 if k == "actions" else video_length
            buf[k].append(np.asarray(item[k])[:n])
        metas.append({"robot": item["robot"], "folder": item["folder"],
                      "file_path": item["file_path"]})
        if len(metas) >= episodes_per_shard:
            flush()
    if metas:
        flush()
    return shards


def convert_to_records(config: Config, hdf5_files: List[str],
                       robot_viewpoints: List[str], out_dir: str,
                       episodes_per_shard: int = 64,
                       episodes: Optional[Sequence] = None,
                       device="cuda") -> List[str]:
    """Preprocesses HDF5 trajectories with the reader (its RandomState
    seeded with config.seed) and packs them into shards; episodes are cut
    to config.video_length frames. `episodes`, where given, holds each
    file's content in memory (the reader's `episodes=`: preprocessed
    episodes or raw-layout trees), and the files need not exist; `device`
    renders the masks of raw-layout trajectories."""
    from robot_aware_control_tpu_torch.data.robonet_hdf5 import RoboNetHDF5Dataset

    ds = RoboNetHDF5Dataset(hdf5_files, robot_viewpoints, config,
                            episodes=episodes, device=device)
    return write_records((ds[i] for i in range(len(ds))), out_dir,
                         config.video_length, episodes_per_shard)


class RecordDataset:
    """Shard-backed dataset with the loader's __getitem__/__len__ contract
    (reference: record_dataset.py).

    Decoded shards stay in memory, the least recently used dropped first
    once they hold more than `cache_bytes` (the newest is always kept), so
    a shuffled epoch over a tree that fits decodes each shard once. The
    loader's worker threads share the cache: a shard is decoded by one
    thread under its own lock while others decode other shards (zlib
    releases the GIL), and `decodes` counts the shard decodes."""

    def __init__(self, shard_dir: str, config: Optional[Config] = None,
                 cache_bytes: int = 8 << 30):
        self.paths = sorted(glob.glob(os.path.join(shard_dir, "shard_*.npz")))
        if not self.paths:
            raise FileNotFoundError(f"no shards under {shard_dir}")
        self._meta = []
        self._index = []  # (shard_idx, episode_idx)
        for si, p in enumerate(self.paths):
            with open(p + ".json") as f:
                metas = json.load(f)
            self._meta.append(metas)
            self._index.extend((si, ei) for ei in range(len(metas)))
        self.cache_bytes = cache_bytes
        self.decodes = 0
        self._cache: "OrderedDict[int, Dict[str, np.ndarray]]" = OrderedDict()
        self._cached_bytes = 0
        self._lock = threading.Lock()  # the cache and the counts
        self._shard_locks = [threading.Lock() for _ in self.paths]

    def __len__(self):
        return len(self._index)

    def _shard(self, si: int):
        with self._shard_locks[si]:
            with self._lock:
                shard = self._cache.get(si)
                if shard is not None:
                    self._cache.move_to_end(si)
                    return shard
            with np.load(self.paths[si]) as z:
                shard = {k: z[k] for k in z.files}
            with self._lock:
                self.decodes += 1
                self._cache[si] = shard
                self._cached_bytes += _nbytes(shard)
                while self._cached_bytes > self.cache_bytes and len(self._cache) > 1:
                    _, old = self._cache.popitem(last=False)
                    self._cached_bytes -= _nbytes(old)
            return shard

    def meta(self, idx: int) -> dict:
        """The robot, folder and file path of episode `idx`, read from the
        shard's list (no shard decoded)."""
        si, ei = self._index[idx]
        return self._meta[si][ei]

    def __getitem__(self, idx: int) -> dict:
        si, ei = self._index[idx]
        shard = self._shard(si)
        out = {k: shard[k][ei] for k in shard}
        out.update(self._meta[si][ei])
        out["idx"] = idx
        return out


def _nbytes(shard: Dict[str, np.ndarray]) -> int:
    return sum(v.nbytes for v in shard.values())


class RecordSubset:
    """The episodes `indices` of a RecordDataset (its shard cache shared),
    renumbered from 0."""

    def __init__(self, dataset: RecordDataset, indices: List[int]):
        self.dataset = dataset
        self.indices = list(indices)

    def __len__(self):
        return len(self.indices)

    def __getitem__(self, idx: int) -> dict:
        return dict(self.dataset[self.indices[idx]], idx=idx)

    @property
    def file_paths(self) -> List[str]:
        return [self.dataset.meta(i)["file_path"] for i in self.indices]


def _record_pairs(ds: RecordDataset, views_dir: str, dirs):
    """(file path, episode index) of the shards' episodes that the HDF5
    route's `_scan_view_dirs` finds: files in `<views_dir>/<view>/` for a
    view of `dirs`."""
    pairs = []
    for i in range(len(ds)):
        path = ds.meta(i)["file_path"]
        view_dir = os.path.dirname(path)
        if (os.path.basename(view_dir) in dirs
                and os.path.basename(os.path.dirname(view_dir)) == views_dir):
            pairs.append((path, i))
    return pairs


def _record_loader(ds: RecordDataset, pairs, seed: int, bs: int,
                   config: Config, shard: bool = True, **kw):
    from robot_aware_control_tpu_torch.data import loader as L

    # this rank's share of the global batch and (but for a transfer
    # loader) of the episodes, as the HDF5 route's loaders take them
    if shard:
        pairs = L._host_shard(pairs, config)
    bs = L._host_batch(bs, config)
    sub = RecordSubset(ds, [i for _, i in pairs])
    return L.DataLoader(sub, min(bs, max(len(sub), 1)),
                        num_workers=config.data_threads, seed=seed, **kw)


def create_record_loaders(config: Config, record_dir: str):
    """Train and test loaders over the shards under `record_dir` with the
    split of config.experiment's HDF5 loaders (data/loader.py): episodes
    sorted by file path and shuffled by config.seed, then the head split
    and its clamp (`head_split`) of the head-split locobot experiments, or
    the train/test split of train_sawyer_multiview over its train views;
    and the batch sizes, seeds and loader options of `_mk_loader`. So the
    two routes put the same episodes into train and test."""
    from robot_aware_control_tpu_torch.data import loader as L

    if (config.experiment != "train_sawyer_multiview"
            and config.experiment not in L.HEAD_SPLITS):
        raise ValueError(
            f"record shards split only the head-split experiments "
            f"{sorted(L.HEAD_SPLITS)} and train_sawyer_multiview, not "
            f"{config.experiment!r}")
    ds = RecordDataset(record_dir)
    if config.experiment == "train_sawyer_multiview":
        pairs = L._seeded_shuffle(_record_pairs(
            ds, "sawyer_views", L.SAWYER_TRAIN_DIRS), config.seed)
        if not pairs:
            raise FileNotFoundError(f"no sawyer train-view episodes under "
                                    f"{record_dir}")
        train, test = L.train_test_split(pairs, config.train_val_split,
                                         config.seed)
    else:
        pairs = L._seeded_shuffle(
            [(ds.meta(i)["file_path"], i) for i in range(len(ds))], config.seed)
        train, test = L.head_split(pairs, *L.HEAD_SPLITS[config.experiment])
    return (_record_loader(ds, train, config.seed, config.batch_size, config),
            _record_loader(ds, test, config.seed + 1, config.test_batch_size,
                           config))


def create_record_transfer_loader(config: Config, record_dir: str):
    """The transfer loader of config.experiment's HDF5 route over the
    shards: for train_sawyer_multiview the held-out sudri2_c1 view as
    `create_sawyer_transfer_loader` takes it (movement filter, seeded
    shuffle, the first 500, the train side of the split); None for an
    experiment whose record route has none (the head-split experiments
    have no transfer loader on either route). FileNotFoundError where the
    shards hold no such episode."""
    from robot_aware_control_tpu_torch.data import loader as L

    if config.experiment != "train_sawyer_multiview":
        return None
    ds = RecordDataset(record_dir)
    pairs = L._movement_filter(config, _record_pairs(
        ds, "sawyer_views", L.SAWYER_TEST_DIRS))
    pairs = L._seeded_shuffle(pairs, config.seed)[:500]
    if not pairs:
        raise FileNotFoundError(f"no sawyer transfer episodes under {record_dir}")
    take, _ = L.train_test_split(pairs, config.train_val_split, config.seed)
    return _record_loader(ds, take or pairs, config.seed + 2,
                          config.test_batch_size, config, shard=False,
                          drop_last=False)
