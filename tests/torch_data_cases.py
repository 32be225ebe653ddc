"""The data slice's checks that run on the card as well as on the CPU (not
a test module; imports no JAX): a float64 bilinear reference for the
native resize, record shards made with numpy alone, a trainer fed by
them, and the prefetch check that `chip_smoke.py` and
tests/test_torch_port_gpu.py both run."""

import os

import numpy as np
import torch

from robot_aware_control_tpu_torch.data.loader import DataLoader, device_prefetch
from robot_aware_control_tpu_torch.data.records import RecordDataset, write_records
from robot_aware_control_tpu_torch.data.synthetic import generate_episode
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer

# the native resize against the float64 reference: float32 sample
# coordinates and weights, 2.5e-6 at 64x85 -> 48x64 on the CPU
RESIZE_TOL = 1e-5


def bilinear_reference(img: np.ndarray, w: int, h: int) -> np.ndarray:
    """(H, W, C) -> (h, w, C) float64, half-pixel centres, edge-clamped:
    the semantics of native/resize.cpp and cv2.INTER_LINEAR."""
    H, W = img.shape[:2]
    ys = np.maximum((np.arange(h) + 0.5) * (H / h) - 0.5, 0.0)
    xs = np.maximum((np.arange(w) + 0.5) * (W / w) - 0.5, 0.0)
    y0, x0 = ys.astype(np.int64), xs.astype(np.int64)
    y1, x1 = np.minimum(y0 + 1, H - 1), np.minimum(x0 + 1, W - 1)
    wy = (ys - y0)[:, None, None]
    wx = (xs - x0)[None, :, None]
    x = np.asarray(img, np.float64)
    top = x[y0][:, x0] * (1 - wx) + x[y0][:, x1] * wx
    bot = x[y1][:, x0] * (1 - wx) + x[y1][:, x1] * wx
    return top * (1 - wy) + bot * wy


def synthetic_items(n: int, T: int, cfg, seed: int):
    """n episode dicts of data/synthetic.generate_episode in the HDF5
    reader's item layout."""
    rng = np.random.RandomState(seed)
    for i in range(n):
        ep = generate_episode(rng, T, cfg.image_height, cfg.image_width,
                              cfg.action_dim, cfg.robot_dim, cfg.robot_joint_dim)
        ep["file_path"] = f"synthetic_{seed}_{i}"
        yield ep


def write_record_split(out_dir: str, n: int, cfg, seed: int,
                       episodes_per_shard: int = 64):
    """Record shards of n synthetic episodes of cfg.video_length frames."""
    return write_records(synthetic_items(n, cfg.video_length, cfg, seed),
                         out_dir, cfg.video_length, episodes_per_shard)


class RecordTrainer(PredictionTrainer):
    """PredictionTrainer fed by record shards under <record_root>/train and
    <record_root>/test (the JAX trainer has no records experiment)."""

    def __init__(self, cfg, record_root: str, device="cuda"):
        super().__init__(cfg, device=device)
        self.record_root = record_root

    def _setup_data(self):
        cfg = self.cfg
        self.transfer_loader = None
        train = RecordDataset(os.path.join(self.record_root, "train"))
        test = RecordDataset(os.path.join(self.record_root, "test"))
        return (DataLoader(train, cfg.batch_size, num_workers=cfg.data_threads,
                           seed=cfg.seed),
                DataLoader(test, cfg.test_batch_size,
                           num_workers=cfg.data_threads, seed=cfg.seed + 1))


def eval_cells(cfg, test_batches: int, cells_a_step: int = 6) -> int:
    """Cell launches of one trainer eval epoch over test_batches batches
    (1-step and autoregressive, video_length // n_eval windows of n_eval - 1
    model steps) and its eval gif's rollout (one window)."""
    steps = cfg.n_eval - 1
    return cells_a_step * steps * (2 * (cfg.video_length // cfg.n_eval)
                                   * test_batches + 1)


def prefetch_check(loader, device, sleep_cycles: int = 20_000_000) -> dict:
    """One epoch of `loader` through device_prefetch against the host
    batches it was made from, bit for bit. Before each comparison the
    consumer's stream sleeps, so that the side stream's copies of later
    batches run while this batch is still to be read: a copy into memory
    the consumer has not finished with would show as a mismatch. The
    comparisons stay on the device until the end of the epoch."""
    device = torch.device(device)
    host = []

    def tee():
        for batch in loader:
            host.append(batch)
            yield batch

    diffs = []
    keys = set()
    for i, batch in enumerate(device_prefetch(tee(), device)):
        if device.type == "cuda":
            torch.cuda._sleep(sleep_cycles)
        for k, v in batch.items():
            if isinstance(v, torch.Tensor):
                keys.add(k)
                ref = torch.from_numpy(host[i][k])
                if device.type == "cuda":
                    ref = ref.pin_memory().to(device, non_blocking=True)
                diffs.append((v != ref).sum())
            elif v != host[i][k]:
                raise AssertionError(f"batch {i}: {k} {v} != {host[i][k]}")
    mismatched = int(torch.stack(diffs).sum()) if diffs else 0
    return {"batches": len(host), "keys": sorted(keys), "mismatched": mismatched}
