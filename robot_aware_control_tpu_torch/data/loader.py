"""Host data pipeline: threaded decode, time-first batches, and device
prefetch (counterpart of `robot_aware_control_tpu/data/loader.py`;
reference: src/dataset/robonet/robonet_dataset.py:434-467 and the
per-robot loader factories of src/dataset/*/*_dataloaders.py).

Worker threads decode episodes and stack them time-first (T, B, ...); a
batch's order, file sets and (with one worker) contents equal the JAX
package's. `device_prefetch` stages each batch in pinned host memory and
copies it to the GPU on a side stream while the previous batch computes.

As the JAX loaders shard files and batches over JAX processes, the port's
shard them over the data axis of the process group (`_host_shard`,
`_host_batch`); without a process group they keep every file and the
whole batch.
"""

from __future__ import annotations

import collections
import glob
import os
import queue
import threading
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from robot_aware_control_tpu_torch.config import Config

_STACK_KEYS = (
    "images", "states", "actions", "masks", "qpos", "heatmaps",
    "raw_actions", "raw_states",
)
_META_KEYS = ("robot", "folder", "file_path", "idx")
_PER_ELEM_KEYS = ("low", "high", "raw_low", "raw_high", "high_movement")


def collate_time_first(items: Sequence[Dict]) -> Dict:
    """Stack per-episode dicts into a time-first batch
    (reference transpose: robonet_dataset.py:434-451)."""
    batch: Dict = {}
    for k in _STACK_KEYS:
        if k in items[0]:
            batch[k] = np.stack([it[k] for it in items], axis=1)
    for k in _META_KEYS:
        if k in items[0]:
            batch[k] = [it[k] for it in items]
    for k in _PER_ELEM_KEYS:
        if k in items[0]:
            batch[k] = np.stack([np.asarray(it[k]) for it in items])
    return batch


def _put(q: queue.Queue, item, stop: threading.Event) -> bool:
    """Puts `item` unless `stop` is set first; returns whether it did."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


class _Failed:
    """An exception of a producer thread, to be raised by the consumer."""

    def __init__(self, error: BaseException):
        self.error = error


class DataLoader:
    """Threaded, seeded, infinite or epoch iteration over a dataset with
    __getitem__/__len__ returning per-episode dicts. Worker w collates
    batches w, w + num_workers, ...; the consumer gets them in order. A
    worker's exception is raised by the consumer; a consumer that stops
    early stops the workers."""

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 num_workers: int = 4, seed: int = 0, drop_last: bool = True):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.num_workers = max(num_workers, 1)
        self.seed = seed
        self.drop_last = drop_last

    def __len__(self):
        n = len(self.dataset)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _epoch_indices(self, epoch: int) -> List[List[int]]:
        idx = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState(self.seed + epoch).shuffle(idx)
        return [idx[i * self.batch_size:(i + 1) * self.batch_size].tolist()
                for i in range(len(self))]

    def _iter_epoch(self, epoch: int) -> Iterator[Dict]:
        batches = self._epoch_indices(epoch)
        q: queue.Queue = queue.Queue(maxsize=2 * self.num_workers)
        stop = threading.Event()

        def worker(worker_id):
            try:
                for bi in range(worker_id, len(batches), self.num_workers):
                    if stop.is_set():
                        return
                    items = [self.dataset[i] for i in batches[bi]]
                    if not _put(q, (bi, collate_time_first(items)), stop):
                        return
            except BaseException as e:  # raised again by the consumer
                _put(q, (None, _Failed(e)), stop)
                return
            _put(q, (None, None), stop)

        threads = [threading.Thread(target=worker, args=(w,), daemon=True)
                   for w in range(self.num_workers)]
        for t in threads:
            t.start()
        finished, buffered, want = 0, {}, 0
        try:
            while finished < self.num_workers or buffered:
                if want in buffered:
                    yield buffered.pop(want)
                    want += 1
                    continue
                bi, batch = q.get()
                if isinstance(batch, _Failed):
                    raise batch.error
                if bi is None:
                    finished += 1
                    continue
                buffered[bi] = batch
        finally:
            stop.set()

    def __iter__(self):
        return self._iter_epoch(0)

    def infinite(self) -> Iterator[Dict]:
        epoch = 0
        while True:
            yield from self._iter_epoch(epoch)
            epoch += 1


def batch_to_device(batch: Dict, device, stream=None):
    """The batch with each numpy array as a tensor on `device` (others
    unchanged), and the event after its copies (None on the CPU). On the
    CPU the tensors share the arrays' memory. On a GPU each array is
    staged in pinned host memory and copied on `stream` (the current
    stream if None); the caller makes its stream wait for the event."""
    device = torch.device(device)
    arrays = {k: torch.from_numpy(v) for k, v in batch.items()
              if isinstance(v, np.ndarray)}
    if device.type != "cuda":
        return {**batch, **arrays}, None
    stream = stream or torch.cuda.current_stream(device)
    with torch.cuda.stream(stream):
        arrays = {k: v.pin_memory().to(device, non_blocking=True)
                  for k, v in arrays.items()}
        event = torch.cuda.Event()
        event.record(stream)
    return {**batch, **arrays}, event


def device_batch(batch: Dict, device) -> Dict:
    """`batch_to_device` for use on the current stream at once."""
    out, event = batch_to_device(batch, device)
    if event is not None:
        torch.cuda.current_stream(event.device).wait_event(event)
    return out


def _hand_over(staged):
    """A staged batch for the consumer: its stream waits for the copy's
    event, and each tensor is recorded on that stream, so that the caching
    allocator does not give its memory to a later copy while the
    consumer's kernels may still read it."""
    batch, event = staged
    if event is not None:
        current = torch.cuda.current_stream(event.device)
        current.wait_event(event)
        for v in batch.values():
            if isinstance(v, torch.Tensor):
                v.record_stream(current)
    return batch


def device_prefetch(it: Iterator[Dict], device="cuda", size: int = 2):
    """Yields the batches of `it` with their numpy arrays as tensors on
    `device`, the copies of the next `size - 1` batches issued ahead.

    `it` runs on the caller's thread. The launching thread gives the GIL
    up at every torch call, and a Python-bound producer thread beside it
    takes it each time: with the synthetic generator in such a thread the
    batch-128 trainer's first epoch ran at 0.45-0.59x the frames/s of the
    generator on the caller's thread (H100, `feed_times.py`). DataLoader
    decodes in threads of its own, mostly in numpy and zlib, which release
    the GIL.

    On a GPU each batch is pinned and copied on a side stream and handed
    over with `_hand_over`; the host allocator keeps a pinned block until
    the copy from it has ended. On the CPU the tensors share the arrays'
    memory. An exception of `it` is raised after the batches before it;
    closing the generator closes `it`."""
    device = torch.device(device)
    stream = torch.cuda.Stream(device) if device.type == "cuda" else None
    source = iter(it)
    staged: collections.deque = collections.deque()
    error = None
    try:
        while True:
            try:
                batch = next(source)
            except StopIteration:
                break
            except Exception as e:  # raised after the staged batches
                error = e
                break
            staged.append(batch_to_device(batch, device, stream))
            if len(staged) >= size:
                yield _hand_over(staged.popleft())
        while staged:
            yield _hand_over(staged.popleft())
        if error is not None:
            raise error
    finally:
        close = getattr(source, "close", None)
        if close is not None:
            close()


# ---------------------------------------------------------------------------
# loader factories mirroring the reference experiment dispatch
# (reference: src/dataset/robonet/robonet_dataloaders.py:21-80,
#  src/dataset/locobot/locobot_singleview_dataloader.py:12-147)


def discover_hdf5(root: str, subdirs: Optional[List[str]] = None):
    """List (path, robot_viewpoint) pairs under data_root."""
    pairs = []
    roots = [os.path.join(root, s) for s in subdirs] if subdirs else [root]
    for r in roots:
        for path in sorted(glob.glob(os.path.join(r, "**", "*.hdf5"), recursive=True)):
            pairs.append((path, os.path.basename(os.path.dirname(path))))
    return pairs


def train_test_split(pairs, split: float, seed: int = 0):
    idx = np.arange(len(pairs))
    np.random.RandomState(seed).shuffle(idx)
    cut = int(len(pairs) * split)
    return [pairs[i] for i in idx[:cut]], [pairs[i] for i in idx[cut:]]


def _host_shard(pairs, config: Config):
    """This rank's disjoint share of the files (parallel/mesh.py:
    host_shard_files, by the rank's data index; the ranks of one model
    group read the same files). Every rank keeps at least one file, so that
    its loader can fill its slice of the global batch."""
    from robot_aware_control_tpu_torch.parallel.mesh import (
        data_info,
        host_shard_files,
    )

    shard = host_shard_files(pairs, *data_info(config))
    return shard if shard else list(pairs)[:1]


def _host_batch(bs: int, config: Config) -> int:
    """This rank's share of a batch: batch sizes are global, split over
    the data axis of the process group (the whole batch without one)."""
    from robot_aware_control_tpu_torch.parallel.mesh import data_info

    return max(1, bs // data_info(config)[1])


def _mk_loader(config: Config, pairs, seed: int, bs: int, shuffle=True,
               drop_last=True, device="cuda"):
    from robot_aware_control_tpu_torch.data.robonet_hdf5 import RoboNetHDF5Dataset

    ds = RoboNetHDF5Dataset(
        [p for p, _ in pairs], [r for _, r in pairs], config, seed=seed,
        device=device)
    # never let a small split produce zero batches (drop_last)
    return DataLoader(ds, min(bs, max(len(ds), 1)),
                      num_workers=config.data_threads, seed=seed,
                      shuffle=shuffle, drop_last=drop_last)


def _split_loaders(config: Config, pairs, device="cuda"):
    """Shuffled train/test split + loaders (the create_loaders shape shared
    by robonet/sawyer factories)."""
    if not pairs:
        raise FileNotFoundError(f"no hdf5 under {config.data_root}")
    train, test = train_test_split(pairs, config.train_val_split, config.seed)
    train, test = _host_shard(train, config), _host_shard(test, config)
    return (
        _mk_loader(config, train, config.seed, _host_batch(config.batch_size, config),
                   device=device),
        _mk_loader(config, test, config.seed + 1,
                   _host_batch(config.test_batch_size, config), device=device),
    )


def create_loaders(config: Config, device="cuda"):
    """Train/test loaders over every HDF5 under data_root (reference:
    robonet_dataloaders.py:21-80)."""
    return _split_loaders(config, discover_hdf5(config.data_root), device=device)


def create_transfer_loader(config: Config, device="cuda"):
    """Held-out files disjoint from create_loaders' training split: the
    first finetune_num_test of its test side (reference pattern:
    locobot_singleview_dataloader.py:97-147 loads an unseen-robot
    directory; the experiment-keyed transfer loaders below do)."""
    pairs = discover_hdf5(config.data_root)
    _, test_pairs = train_test_split(pairs, config.train_val_split, config.seed)
    held = test_pairs[: config.finetune_num_test]
    if not held:
        raise FileNotFoundError(f"no held-out hdf5 under {config.data_root}")
    return _mk_loader(config, held, config.seed + 2,
                      min(config.test_batch_size, len(held)), shuffle=False,
                      drop_last=False, device=device)


# --- per-robot viewpoint directories (the de-facto dataset layout API) -----
# (reference: robonet_dataloaders.py:13-18, sawyer_dataloaders.py:14-17,
#  widowx_dataloaders.py:18, locobot_singleview_dataloader.py:11)
BAXTER_TRAIN_DIRS = ["left_c0"]
WIDOWX_TRAIN_DIRS = ["widowx1_c0"]
# robonet multi-robot training uses ALL sawyer views incl. sudri2_c1 ...
ROBONET_SAWYER_DIRS = [
    "sudri0_c0", "sudri0_c1", "sudri0_c2", "sudri2_c0", "sudri2_c1",
    "sudri2_c2", "vestri_table2_c0", "vestri_table2_c1", "vestri_table2_c2",
]
# ... while the sawyer-multiview experiment holds sudri2_c1 out for
# zero-shot viewpoint transfer (sawyer_dataloaders.py:14-17)
SAWYER_TRAIN_DIRS = [
    "sudri0_c0", "sudri0_c1", "sudri0_c2", "sudri2_c0", "sudri2_c2",
    "vestri_table2_c0", "vestri_table2_c1", "vestri_table2_c2",
]
SAWYER_TEST_DIRS = ["sudri2_c1"]
LOCOBOT_FOLDERS = ["c0", "c1", "c2", "c3"]


def _scan_view_dirs(config: Config, robot: str, views_dir: str, dirs):
    """(path, f"{robot}_{view}") pairs under data_root/views_dir/<view>/
    (reference: robonet_dataloaders.py:137-208 get_*_data)."""
    pairs = []
    for d in dirs:
        root = os.path.join(config.data_root, views_dir, d)
        for path in sorted(glob.glob(os.path.join(root, "*.hdf5"))):
            pairs.append((path, f"{robot}_{d}"))
    return pairs


def _seeded_shuffle(pairs, seed: int):
    """(path, robot_viewpoint) pairs sorted by path, then shuffled by a
    RandomState of `seed`."""
    pairs = sorted(pairs, key=lambda x: x[0])
    idx = np.arange(len(pairs))
    np.random.RandomState(seed).shuffle(idx)
    return [pairs[i] for i in idx]


def _movement_filter(config: Config, pairs):
    """Keep only high-movement videos when --world_error_dict is given
    (reference: sawyer/widowx finetune+transfer loaders filter on the
    motion-info `high_error` labels, sawyer_dataloaders.py:22-33); without
    it every file passes."""
    if not config.world_error_dict:
        return pairs
    from robot_aware_control_tpu_torch.evaluation.obj_movement import (
        load_movement_metadata,
    )

    meta = load_movement_metadata(config.world_error_dict)
    return [p for p in pairs if meta.get(p[0], False)]


def head_split(pairs, n_test: int, n_train: int):
    """Reference's head-split convention: first n_test files test, next
    n_train train (locobot_singleview_dataloader.py:108-121). n_test clamps
    on tiny trees so the train side is never empty. Returns (train, test)."""
    if n_test >= len(pairs):
        n_test = max(1, len(pairs) // 5)
    return pairs[n_test:n_test + n_train], pairs[:n_test]


def _head_split_loaders(config: Config, pairs, n_test: int, n_train: int,
                        device="cuda"):
    if not pairs:
        raise FileNotFoundError(f"no hdf5 under {config.data_root}")
    train, test = head_split(pairs, n_test, n_train)
    train, test = _host_shard(train, config), _host_shard(test, config)
    return (
        _mk_loader(config, train, config.seed, _host_batch(config.batch_size, config),
                   device=device),
        _mk_loader(config, test, config.seed + 1,
                   _host_batch(config.test_batch_size, config), device=device),
    )


def _finetune_split_loaders(config: Config, pairs, device="cuda"):
    """Few-shot split: first finetune_num_test files test, next
    finetune_num_train train (reference: sawyer_dataloaders.py:36-45)."""
    if not pairs:
        raise FileNotFoundError(f"no hdf5 under {config.data_root}")
    nte, ntr = config.finetune_num_test, config.finetune_num_train
    if nte >= len(pairs):
        nte = max(1, len(pairs) // 5)
    test = pairs[:nte]
    train = pairs[nte:nte + ntr]
    train, test = _host_shard(train, config), _host_shard(test, config)
    return (
        _mk_loader(config, train, config.seed, _host_batch(config.batch_size, config),
                   drop_last=False, device=device),
        _mk_loader(config, test, config.seed + 1,
                   _host_batch(config.test_batch_size, config), drop_last=False,
                   device=device),
    )


def create_robonet_loaders(config: Config, device="cuda"):
    """Multi-robot RoboNet training mix: baxter left_c0 + widowx widowx1_c0
    + all sawyer views, shuffled then train/test split (reference:
    robonet_dataloaders.py:21-80)."""
    pairs = (
        _scan_view_dirs(config, "baxter", "baxter_views", BAXTER_TRAIN_DIRS)
        + _scan_view_dirs(config, "widowx", "widowx_views", WIDOWX_TRAIN_DIRS)
        + _scan_view_dirs(config, "sawyer", "sawyer_views", ROBONET_SAWYER_DIRS)
    )
    return _split_loaders(config, _seeded_shuffle(pairs, config.seed),
                          device=device)


def create_sawyer_loaders(config: Config, device="cuda"):
    """Sawyer multiview training over SAWYER_TRAIN_DIRS, holding the
    sudri2_c1 viewpoint out (reference: sawyer_dataloaders.py:126-197)."""
    pairs = _scan_view_dirs(config, "sawyer", "sawyer_views", SAWYER_TRAIN_DIRS)
    return _split_loaders(config, _seeded_shuffle(pairs, config.seed),
                          device=device)


def create_sawyer_transfer_loader(config: Config, device="cuda"):
    """Zero-shot eval on the held-out sudri2_c1 sawyer viewpoint, disjoint
    from SAWYER_TRAIN_DIRS (reference: sawyer_dataloaders.py:84-123; first
    500 files, train side of the split)."""
    pairs = _movement_filter(
        config,
        _scan_view_dirs(config, "sawyer", "sawyer_views", SAWYER_TEST_DIRS),
    )
    pairs = _seeded_shuffle(pairs, config.seed)[:500]
    if not pairs:
        raise FileNotFoundError("no sawyer transfer hdf5 found")
    take, _ = train_test_split(pairs, config.train_val_split, config.seed)
    return _mk_loader(config, take or pairs, config.seed + 2,
                      _host_batch(config.test_batch_size, config), drop_last=False,
                      device=device)


def create_sawyer_finetune_loaders(config: Config, device="cuda"):
    """Few-shot finetune on the held-out sawyer viewpoint (reference:
    sawyer_dataloaders.py:19-81, high-error filtered)."""
    pairs = _movement_filter(
        config,
        _scan_view_dirs(config, "sawyer", "sawyer_views", SAWYER_TEST_DIRS),
    )
    return _finetune_split_loaders(config, _seeded_shuffle(pairs, config.seed),
                                   device=device)


def create_widowx_finetune_loaders(config: Config, device="cuda"):
    """(reference: widowx_dataloaders.py:10-64)"""
    pairs = _movement_filter(
        config,
        _scan_view_dirs(config, "widowx", "widowx_views", WIDOWX_TRAIN_DIRS),
    )
    return _finetune_split_loaders(config, _seeded_shuffle(pairs, config.seed),
                                   device=device)


def create_widowx_transfer_loader(config: Config, device="cuda"):
    """(reference: widowx_dataloaders.py:67-103; first 300 files)"""
    pairs = _movement_filter(
        config,
        _scan_view_dirs(config, "widowx", "widowx_views", WIDOWX_TRAIN_DIRS),
    )
    pairs = _seeded_shuffle(pairs, config.seed)[:300]
    if not pairs:
        raise FileNotFoundError("no widowx transfer hdf5 found")
    return _mk_loader(config, pairs, config.seed + 2,
                      _host_batch(config.test_batch_size, config), drop_last=False,
                      device=device)


def create_franka_transfer_loader(config: Config, device="cuda"):
    """Zero-shot eval on the lab franka data, a robot never seen in
    training (reference: franka_dataloader.py:12-44: franka_views/c0,
    seeded shuffle, first 400 files, unshuffled loader)."""
    pairs = _scan_view_dirs(config, "franka", "franka_views", ["c0"])
    pairs = _seeded_shuffle(pairs, config.seed)[:400]
    if not pairs:
        raise FileNotFoundError("no franka transfer hdf5 found")
    return _mk_loader(config, pairs, config.seed + 2,
                      _host_batch(config.test_batch_size, config), shuffle=False,
                      drop_last=False, device=device)


def _locobot_pairs(config: Config, views_dir: str, folders):
    """Locobot file pairs: reference layout <data_root>/<views_dir>/<c*>
    first, falling back to the collected flat layout
    <data_root>/locobot_c0/traj_*.hdf5."""
    pairs = _scan_view_dirs(config, "locobot", views_dir, folders)
    if pairs:
        return pairs
    return [(p, vp) for p, vp in discover_hdf5(config.data_root)
            if "locobot" in vp]


# (n_test, n_train) of the head-split locobot experiments, shared with the
# record route (data/records.py:create_record_loaders)
HEAD_SPLITS = {"train_locobot_singleview": (200, 3000),
               "train_locobot_table": (1000, 10000),
               "train_locobot_pick": (500, 100000)}


def create_locobot_loaders(config: Config, device="cuda"):
    """Locobot singleview training over c0..c3 (reference:
    locobot_singleview_dataloader.py:95-146; first 200 test, next 3000
    train)."""
    pairs = _locobot_pairs(config, "locobot_views", LOCOBOT_FOLDERS)
    return _head_split_loaders(config, _seeded_shuffle(pairs, config.seed),
                               *HEAD_SPLITS["train_locobot_singleview"],
                               device=device)


def create_locobot_finetune_loaders(config: Config, device="cuda"):
    """(reference: locobot_singleview_dataloader.py:12-60)"""
    pairs = _locobot_pairs(config, "locobot_views", LOCOBOT_FOLDERS)
    return _finetune_split_loaders(config, _seeded_shuffle(pairs, config.seed),
                                   device=device)


def create_locobot_transfer_loader(config: Config, device="cuda"):
    """Zero-shot eval on unseen locobot data for train_robonet, a robot
    absent from the robonet training mix (reference:
    locobot_singleview_dataloader.py:62-93; first 400 files)."""
    pairs = _locobot_pairs(config, "locobot_views", LOCOBOT_FOLDERS)
    pairs = _seeded_shuffle(pairs, config.seed)[:400]
    if not pairs:
        raise FileNotFoundError("no locobot transfer hdf5 found")
    return _mk_loader(config, pairs, config.seed + 2,
                      _host_batch(config.test_batch_size, config), drop_last=False,
                      device=device)


def create_locobot_table_loaders(config: Config, device="cuda"):
    """(reference: locobot_table_dataloaders.py:95-143; table task data
    under locobot_table_views/c0, first 1000 test, next 10000 train)."""
    pairs = _locobot_pairs(config, "locobot_table_views", ["c0"])
    return _head_split_loaders(config, _seeded_shuffle(pairs, config.seed),
                               *HEAD_SPLITS["train_locobot_table"], device=device)


def create_locobot_pick_loaders(config: Config, device="cuda"):
    """(reference: locobot_pick_dataloaders.py:11-58; pick task data under
    locobot_pick_views/c0, first 500 test, rest train)."""
    pairs = _locobot_pairs(config, "locobot_pick_views", ["c0"])
    return _head_split_loaders(config, _seeded_shuffle(pairs, config.seed),
                               *HEAD_SPLITS["train_locobot_pick"], device=device)


def create_movement_loaders(config: Config, device="cuda"):
    """Loaders restricted to videos labeled high-movement by the copy
    baseline (reference: robonet_dataloaders.py:210-327 and the
    obj_movement.pkl metadata)."""
    if not config.world_error_dict:
        raise ValueError("--world_error_dict required for movement loaders")
    from robot_aware_control_tpu_torch.evaluation.obj_movement import (
        load_movement_metadata,
    )

    meta = load_movement_metadata(config.world_error_dict)
    pairs = [p for p in discover_hdf5(config.data_root) if meta.get(p[0], False)]
    if not pairs:
        raise FileNotFoundError("no high-movement videos found")
    return _split_loaders(config, pairs, device=device)


def create_finetune_loaders(config: Config, device="cuda"):
    """Few-shot finetune split: first finetune_num_train files train,
    next finetune_num_test test (reference:
    locobot_singleview_dataloader.py:62-96)."""
    pairs = discover_hdf5(config.data_root)
    if not pairs:
        raise FileNotFoundError(f"no hdf5 under {config.data_root}")
    ntr, nte = config.finetune_num_train, config.finetune_num_test
    train_pairs, test_pairs = pairs[:ntr], pairs[ntr:ntr + nte]
    if not test_pairs:  # tiny trees: reuse the tail of train for eval
        test_pairs = train_pairs[-1:]
    train_pairs, test_pairs = _host_shard(train_pairs, config), _host_shard(test_pairs, config)
    return (
        _mk_loader(config, train_pairs, config.seed,
                   _host_batch(config.batch_size, config), device=device),
        _mk_loader(config, test_pairs, config.seed + 1,
                   _host_batch(config.test_batch_size, config), device=device),
    )


# ---------------------------------------------------------------------------
# demo-video training data (reference: src/dataset/mujoco/video_dataset.py
# and mujoco/dataloaders.py: prediction models trained on demo HDF5 files,
# the image stream selected by --video_type)


class DemoVideoDataset:
    """Episode dicts from runner demo files (data/demo_io.py layout).

    --video_type picks the image stream: "observations" (robot visible;
    also saved under the reference's name "robot_demo"),
    "object_only_demo" / "object_inpaint_demo" (robot-free renders)
    (reference: video_dataset.py:20,27-37 reads `hf[config.video_type]`).
    Actions are clipped to [-1, 1] like the reference (:44-45)."""

    def __init__(self, files, config: Config, seed: Optional[int] = None):
        self._files = list(files)
        self._cf = config
        self._horizon = config.n_past + config.n_future
        self._rng = np.random.RandomState(config.seed if seed is None else seed)

    def __len__(self):
        return len(self._files)

    def __getitem__(self, idx: int) -> Dict:
        from robot_aware_control_tpu_torch.data import demo_io

        cfg = self._cf
        demo = demo_io.load_demo(self._files[idx])
        key = cfg.video_type if cfg.video_type in demo else "observations"
        frames = np.asarray(demo[key])
        ep_len = frames.shape[0]
        if ep_len < self._horizon:
            raise ValueError(f"{self._files[idx]}: {ep_len} < {self._horizon}")
        start = 0
        if ep_len > self._horizon:
            start = int(self._rng.randint(0, ep_len - self._horizon + 1))
        end = start + self._horizon
        imgs = frames[start:end].astype(np.float32)
        if imgs.max() > 1.5:
            imgs /= 255.0
        masks = np.asarray(demo["masks"][start:end], np.float32)
        if masks.ndim == 3:
            masks = masks[..., None]
        states = np.asarray(demo["robot_state"][start:end], np.float32)
        rd = cfg.robot_dim
        if states.shape[-1] < rd:
            states = np.pad(states, [(0, 0), (0, rd - states.shape[-1])])
        actions = np.clip(
            np.asarray(demo["actions"][start:end - 1], np.float32), -1, 1
        )
        ad = cfg.action_dim
        if actions.shape[-1] < ad:
            actions = np.pad(actions, [(0, 0), (0, ad - actions.shape[-1])])
        qpos = np.asarray(demo["qpos"][start:end], np.float32)
        jd = cfg.robot_joint_dim
        if qpos.shape[-1] < jd:
            qpos = np.pad(qpos, [(0, 0), (0, jd - qpos.shape[-1])])
        return {
            "images": imgs, "states": states, "actions": actions[:, :ad],
            "masks": masks, "qpos": qpos, "robot": "locobot",
            "folder": os.path.basename(os.path.dirname(self._files[idx])),
            "file_path": self._files[idx], "idx": idx,
        }


def create_demo_video_loaders(config: Config, demo_dir: Optional[str] = None):
    """Train/test loaders over a directory of demo HDF5s (reference:
    mujoco/dataloaders.py:12-30 create_split/create_loaders)."""
    from robot_aware_control_tpu_torch.data import demo_io

    files = demo_io.list_demos(demo_dir or config.demo_dir or config.data_root)
    if not files:
        raise FileNotFoundError("no demo hdf5 files found")
    pairs = [(f, "locobot") for f in files]
    train_pairs, test_pairs = train_test_split(pairs, config.train_val_split, 0)
    train_pairs = train_pairs or pairs
    test_pairs = test_pairs or pairs[-1:]

    def mk(prs, seed, bs):
        return DataLoader(
            DemoVideoDataset([p for p, _ in prs], config, seed=seed),
            batch_size=bs, num_workers=config.data_threads or 1, seed=seed,
            drop_last=False)

    return (
        mk(_host_shard(train_pairs, config), config.seed,
           _host_batch(config.batch_size, config)),
        mk(_host_shard(test_pairs, config), config.seed + 1,
           _host_batch(config.test_batch_size, config)),
    )
