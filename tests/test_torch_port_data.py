"""The port's data slice held against the JAX package on the CPU: the HDF5
reader's items on both resize routes, files, demos and record shards
written by one package and read by the other, the loaders' batches and
every factory's file lists, the demo-video dataset, the copy baseline's
movement labels, device_prefetch, the eval gif and the HTML report, and
the trainer on HDF5 trees handing its steps the JAX trainer's windows.
Fixture files are written in tmp_path; nothing is read from outside."""

import ctypes
import json
import os
import pickle
import subprocess
import sys
import threading
import time

import cv2
import h5py
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data import demo_io as jdemo
from robot_aware_control_tpu.data import loader as jloader
from robot_aware_control_tpu.data import native as jnative
from robot_aware_control_tpu.data import records as jrecords
from robot_aware_control_tpu.data import robonet_hdf5 as jhdf5
from robot_aware_control_tpu.evaluation import obj_movement as jmove
from robot_aware_control_tpu.models import svg as jsvg
from robot_aware_control_tpu.training import html_report as jhtml
from robot_aware_control_tpu.training import plot as jplot
from robot_aware_control_tpu.training.trainer import PredictionTrainer as JTrainer
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data import demo_io, native, records
from robot_aware_control_tpu_torch.data import loader as tloader
from robot_aware_control_tpu_torch.data import robonet_hdf5 as thdf5
from robot_aware_control_tpu_torch.evaluation import obj_movement as tmove
from robot_aware_control_tpu_torch.training import html_report, plot
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer, main
from torch_data_cases import RESIZE_TOL, bilinear_reference, prefetch_check
from torch_train_cases import JAX_TRAIN_KEYS
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

# the reader at RoboNet's stored size, resized to the model's 48x64
BASE = dict(image_height=48, image_width=64, action_dim=5, robot_dim=5,
            robot_joint_dim=7, video_length=8, n_past=1, n_future=5, seed=3,
            data_threads=1)
STORED = (64, 85)
SAWYER_LOW = np.array([0.4, -0.2, 0.05, -1.0, 0.0], np.float32)
SAWYER_HIGH = np.array([0.8, 0.2, 0.35, 1.0, 1.0], np.float32)


def _episode(seed, T=12, hw=STORED, adim=5, sdim=5, jdim=5):
    """uint8 frames, a rectangular robot mask a frame, states, actions and
    qpos; states in [0, 1] (normalized for stored-bound robots, metres
    inside the locobot workspace for locobot and franka)."""
    r = np.random.RandomState(seed)
    images = (r.rand(T, *hw, 3) * 255).astype(np.uint8)
    masks = np.zeros((T, *hw), np.uint8)
    bh, bw = hw[0] // 6 + 1, hw[1] // 6 + 1
    for t in range(T):
        y, x = r.randint(0, hw[0] - bh), r.randint(0, hw[1] - bw)
        masks[t, y:y + bh, x:x + bw] = 1
    states = (r.rand(T, sdim) * [0.3, 0.4, 0.2, 1.0, 1.0][:sdim]
              + [0.1, -0.2, 0.1, 0.0, 0.0][:sdim]).astype(np.float32)
    actions = r.uniform(-0.05, 0.05, (T - 1, adim)).astype(np.float32)
    qpos = r.rand(T, jdim).astype(np.float32)
    return images, states, actions, masks, qpos


def _write(path, seed, robot="locobot", bounds=False, writer=jhdf5, **kw):
    low, high = (SAWYER_LOW, SAWYER_HIGH) if bounds else (None, None)
    writer.write_trajectory_hdf5(str(path), *_episode(seed, **kw), robot=robot,
                                 low=low, high=high)
    return str(path)


def _assert_items_equal(got, want, where=""):
    assert set(got) == set(want), where
    for k, v in want.items():
        if isinstance(v, np.ndarray):
            g = got[k].numpy() if isinstance(got[k], torch.Tensor) else got[k]
            assert g.dtype == v.dtype, f"{where} {k}"
            np.testing.assert_array_equal(g, v, err_msg=f"{where} {k}")
        elif isinstance(v, (list, tuple)) and v and isinstance(v[0], np.ndarray):
            for a, b in zip(got[k], v):
                np.testing.assert_array_equal(a, b, err_msg=f"{where} {k}")
        else:
            assert got[k] == v, f"{where} {k}: {got[k]} != {v}"


@pytest.fixture(scope="session")
def jax_resize_lib(tmp_path_factory):
    """The JAX package's `native/resize.cpp` built with its own flags into
    this process's tmp directory and bound with its argtypes. The JAX
    binding builds that library in place, next to its source, so several
    test processes build one file at once; one that loads a half-written
    file keeps no library for the rest of the process and its reader then
    samples the nearest pixels. Its own build, here, is whole."""
    src = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        jnative.__file__))), "native", "resize.cpp")
    so = str(tmp_path_factory.mktemp("jax_resize") / "_resize.so")
    subprocess.run(["c++", "-O3", "-shared", "-fPIC", "-o", so, src],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(so)
    fp, i = ctypes.POINTER(ctypes.c_float), ctypes.c_int
    lib.bilinear_resize_batch_f32.argtypes = [fp, i, i, i, i, fp, i, i]
    return lib


def assert_jax_route_bilinear():
    """Fails unless the JAX reader's cv2-less resize is the bilinear one:
    a float64 bilinear reference within RESIZE_TOL, where the nearest-pixel
    fallback of `robonet_hdf5._resize` is 0.1-0.5 off on this probe."""
    img = np.random.RandomState(5).rand(*STORED, 3).astype(np.float32)
    got = jhdf5._resize(img, 64, 48)
    err = float(np.abs(got - bilinear_reference(img, 64, 48)).max())
    assert jnative.available() and err < RESIZE_TOL, (
        f"the JAX reader's resize is not bilinear (max error {err:.3g}); "
        "its native library did not load")


@pytest.fixture(params=["cv2", "native", "native_after_failed_build"])
def route(request, monkeypatch, jax_resize_lib):
    """The resize route of both readers: cv2, or both forced onto their
    C++ resize (their sources are the same file's copies). On the native
    route the JAX binding is handed the library built here; in the third
    route its process had first recorded a failed build (`_TRIED` with no
    library), as a process that lost the build race does."""
    if request.param.startswith("native"):
        if request.param == "native_after_failed_build":
            monkeypatch.setattr(jnative, "_TRIED", True)
            monkeypatch.setattr(jnative, "_LIB", None)
        monkeypatch.setattr(jnative, "_LIB", jax_resize_lib)
        monkeypatch.setattr(jnative, "_TRIED", True)
        monkeypatch.setattr(jhdf5, "_HAS_CV2", False)
        monkeypatch.setattr(thdf5, "_HAS_CV2", False)
        assert thdf5.resize_route() == "native"
        assert_jax_route_bilinear()
    return request.param


def test_jax_route_check_rejects_nearest_pixels(monkeypatch):
    """With the JAX binding's failed build planted and no library handed
    to it, its reader samples the nearest pixels, and the route check that
    guards the native cases fails loudly instead of letting them compare
    against those samples."""
    monkeypatch.setattr(jnative, "_TRIED", True)
    monkeypatch.setattr(jnative, "_LIB", None)
    monkeypatch.setattr(jhdf5, "_HAS_CV2", False)
    with pytest.raises(AssertionError, match="not bilinear"):
        assert_jax_route_bilinear()


# name: (view, file options, config options, dataset options)
ITEM_CASES = {
    # autograsp imputation (4 stored action dims), states padded 4 -> 5,
    # qpos 5 -> 7, snippet draws (12 frames, 8 read)
    "locobot_autograsp": ("locobot_c0", dict(adim=4, sdim=4), {}, {}),
    "franka_eef_shift": ("franka_c0", dict(robot="franka"), {}, {}),
    "sawyer_bounds_camera_raw": (
        "sawyer_sudri0_c0", dict(robot="sawyer", bounds=True),
        dict(preprocess_action="camera_raw"), {}),
    "sawyer_finetune_raw_outputs": (
        "sawyer_sudri2_c1", dict(robot="sawyer", bounds=True),
        dict(preprocess_action="camera_raw", experiment="finetune_sawyer_view"),
        {}),
    "state_infer": ("locobot_c1", {}, dict(preprocess_action="state_infer"), {}),
    "action_zero_pad": ("locobot_c0", dict(adim=3),
                        dict(impute_autograsp_action=False), {}),
    "img_augmentation": ("locobot_c0", {}, dict(img_augmentation=True), {}),
    "heatmaps": ("locobot_c0", {}, dict(model_use_heatmap=True), {}),
    "movement_labels": ("locobot_c0", {}, dict(load_movement_info=True), {}),
    "preload_ram": ("locobot_c2", {}, dict(preload_ram=True), {}),
    "load_snippet": ("locobot_c0", {}, {}, dict(load_snippet=True)),
}


@pytest.mark.parametrize("case", list(ITEM_CASES))
def test_reader_items_equal_jax(tmp_path, route, case):
    """Three files read in the order 0, 1, 2, 0, 2 by RoboNetHDF5Dataset of
    each package (one RandomState each, drawn in the JAX order: snippet
    start, crop, jitter): every item equal bit for bit, arrays and their
    dtypes, on the cv2 route and on the native one (also after a failed
    JAX build was recorded in the process)."""
    view, file_kw, cfg_kw, ds_kw = ITEM_CASES[case]
    files = [_write(tmp_path / view / f"t{i}.hdf5", 10 * i + 1, **file_kw)
             for i in range(3)]
    kw = dict(BASE, **cfg_kw)
    if cfg_kw.get("load_movement_info"):
        kw["world_error_dict"] = str(tmp_path / "obj_movement.pkl")
        with open(kw["world_error_dict"], "wb") as f:
            pickle.dump({files[0]: True, files[2]: False}, f)
    jds = jhdf5.RoboNetHDF5Dataset(files, [view] * 3, JConfig(**kw), **ds_kw)
    tds = thdf5.RoboNetHDF5Dataset(files, [view] * 3, Config(**kw), **ds_kw)
    for i in (0, 1, 2, 0, 2):
        _assert_items_equal(tds[i], jds[i], f"{case} item {i}")
    if cfg_kw.get("load_movement_info"):
        assert [tds[i]["high_movement"] for i in range(3)] == [True, False, False]


def test_native_resize_against_cv2_and_float64():
    """The C++ resize against a float64 bilinear reference (within
    RESIZE_TOL, 1e-5) and against cv2 (3e-6 apart at 64x85 -> 48x64, and
    at the augmentation's 44x59 crop -> 48x64); masks re-binarised with
    != 0: the pixels where the routes disagree, counted, must be under
    0.1% (0 measured on these inputs)."""
    r = np.random.RandomState(0)
    cases = [(STORED, (64, 48)), ((44, 59), (64, 48)), ((48, 64), (16, 16))]
    for (H, W), (w, h) in cases:
        img = r.rand(H, W, 3).astype(np.float32)
        got = native.bilinear_resize(img, w, h)
        assert np.abs(got - bilinear_reference(img, w, h)).max() < RESIZE_TOL
        assert np.abs(got - cv2.resize(img, (w, h), interpolation=cv2.INTER_LINEAR)
                      ).max() < 3e-6
        masks = np.zeros((50, H, W), np.float32)
        for m in masks:
            y, x = r.randint(0, H - 10), r.randint(0, W - 10)
            m[y:y + 9, x:x + 11] = 1.0
        a = native.bilinear_resize_batch(masks[..., None], w, h)[..., 0] != 0
        b = np.stack([cv2.resize(m, (w, h), interpolation=cv2.INTER_LINEAR)
                      for m in masks]) != 0
        assert (a != b).sum() <= 1e-3 * a.size, ((H, W), (a != b).sum())
    grey = native.bilinear_resize(r.rand(8, 8).astype(np.float32), 16, 12)
    assert grey.shape == (12, 16)


def test_missing_resize_raises_with_the_compiler_error(tmp_path, monkeypatch):
    """Without cv2 and with a native build that fails, the reader raises
    with the compiler's message (the JAX reader would sample the nearest
    pixels, another image)."""
    bad = tmp_path / "resize.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", str(bad))
    monkeypatch.setattr(native, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_error", None)
    monkeypatch.setattr(thdf5, "_HAS_CV2", False)
    path = _write(tmp_path / "locobot_c0" / "t.hdf5", 0)
    ds = thdf5.RoboNetHDF5Dataset([path], ["locobot_c0"], Config(**BASE))
    assert not native.available()
    with pytest.raises(RuntimeError, match="could not be built.*resize.cpp"):
        ds[0]


def test_loaders_and_trainer_import_without_h5py_cv2_imageio(tmp_path):
    """With h5py, cv2 and imageio blocked from import (the H100 machine
    has no h5py and no imageio): the loaders and the trainer import, the
    reader's resize route is native, record shards load through the
    DataLoader, and the gif writer writes nothing."""
    code = (
        "import sys\n"
        "for m in ('h5py', 'cv2', 'imageio'):\n"
        "    sys.modules[m] = None\n"
        "import numpy as np\n"
        "from robot_aware_control_tpu_torch.data import loader, records, robonet_hdf5\n"
        "from robot_aware_control_tpu_torch.training import plot, trainer\n"
        "assert robonet_hdf5.resize_route() == 'native'\n"
        "item = {'images': np.ones((3, 4, 4, 3), np.float32),\n"
        "        'states': np.zeros((3, 5), np.float32),\n"
        "        'actions': np.zeros((2, 5), np.float32),\n"
        "        'masks': np.zeros((3, 4, 4, 1), np.float32),\n"
        "        'qpos': np.zeros((3, 7), np.float32),\n"
        "        'robot': 'locobot', 'folder': 'c0', 'file_path': 'f'}\n"
        f"records.write_records([item] * 4, {str(tmp_path)!r}, 3, 2)\n"
        f"ds = records.RecordDataset({str(tmp_path)!r})\n"
        "batches = list(loader.DataLoader(ds, 2, num_workers=2))\n"
        "assert [b['images'].shape for b in batches] == [(3, 2, 4, 4, 3)] * 2\n"
        f"assert plot.save_gif({str(tmp_path / 'x.gif')!r}, [item['images'][0]]) is None\n"
        "print('ok')\n"
    )
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=repo,
                       env=dict(os.environ, PYTHONPATH=repo),
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0 and r.stdout.split() == ["ok"], r.stderr
    assert not (tmp_path / "x.gif").exists()


def test_raw_robonet_file_raises(tmp_path):
    """A file in the public RoboNet raw layout (env and policy groups)
    whose required paths are missing raises RawSchemaError naming them:
    the reader takes that layout (data/raw_robonet.py) and refuses a
    drifted file loudly, with its schema diff."""
    from robot_aware_control_tpu_torch.data.raw_robonet import RawSchemaError

    path = str(tmp_path / "sawyer_views" / "sudri0_c0" / "raw.hdf5")
    os.makedirs(os.path.dirname(path))
    with h5py.File(path, "w") as hf:
        hf.create_group("env")
        hf.create_group("policy")
    ds = thdf5.RoboNetHDF5Dataset([path], ["sawyer_sudri0_c0"], Config(**BASE),
                                  device="cpu")
    with pytest.raises(RawSchemaError) as err:
        ds[0]
    assert "raw.hdf5 does not parse" in str(err.value)
    assert "missing required: env/state, policy/actions" in str(err.value)


# ------------------------------------------------ files across packages
def test_files_read_across_packages(tmp_path):
    """Trajectory files, demo files and record shards written by either
    package read in the other: equal items, demos and shard arrays."""
    cfg = dict(BASE, video_length=12)
    for writer, reader in ((thdf5, jhdf5), (jhdf5, thdf5)):
        d = tmp_path / writer.__name__.split(".")[0]
        files = [_write(d / "sawyer_sudri0_c0" / f"t{i}.hdf5", i, robot="sawyer",
                        bounds=True, writer=writer) for i in range(2)]
        want = jhdf5.RoboNetHDF5Dataset(files, ["sawyer_sudri0_c0"] * 2,
                                        JConfig(**cfg))
        got = thdf5.RoboNetHDF5Dataset(files, ["sawyer_sudri0_c0"] * 2,
                                       Config(**cfg))
        for i in range(2):
            _assert_items_equal(got[i], want[i])
        demo = {"observations": np.arange(24, dtype=np.uint8).reshape(2, 3, 4),
                "actions": np.ones((1, 2), np.float32), "pushed_obj": 3,
                "name": "push"}
        writer_io = demo_io if writer is thdf5 else jdemo
        reader_io = jdemo if writer is thdf5 else demo_io
        writer_io.save_demo(str(d / "demos" / "demo_0.hdf5"), demo)
        loaded = reader_io.load_demo(str(d / "demos" / "demo_0.hdf5"))
        assert set(loaded) == set(demo) | {"robot_demo"}
        np.testing.assert_array_equal(loaded["robot_demo"], demo["observations"])
        assert loaded["name"] == "push" and int(loaded["pushed_obj"]) == 3
        assert reader_io.list_demos(str(d / "demos")) == [str(d / "demos" / "demo_0.hdf5")]
        (records if writer is thdf5 else jrecords).convert_to_records(
            (Config if writer is thdf5 else JConfig)(**cfg), files,
            ["sawyer_sudri0_c0"] * 2, str(d / "rec"))
        rds = (jrecords if writer is thdf5 else records).RecordDataset(str(d / "rec"))
        assert len(rds) == 2
        for i in range(2):
            item = rds[i]
            for k in ("images", "states", "actions", "masks", "qpos"):
                np.testing.assert_array_equal(item[k], want[i][k][:12 - (k == "actions")])
            assert item["file_path"] == files[i] and item["idx"] == i


def test_convert_to_records_shards_equal(tmp_path):
    """Both converters over the same files (3 episodes, 2 a shard): the
    same shard files, arrays bit for bit, the same episode lists."""
    files = [_write(tmp_path / "locobot_c0" / f"t{i}.hdf5", i) for i in range(3)]
    out = {}
    for name, mod, C in (("jax", jrecords, JConfig), ("port", records, Config)):
        paths = mod.convert_to_records(C(**BASE), files, ["locobot_c0"] * 3,
                                       str(tmp_path / name), episodes_per_shard=2)
        out[name] = [os.path.basename(p) for p in paths]
    assert out["jax"] == out["port"] == ["shard_00000.npz", "shard_00001.npz"]
    for shard in out["jax"]:
        with np.load(tmp_path / "jax" / shard) as a, np.load(tmp_path / "port" / shard) as b:
            assert a.files == b.files
            for k in a.files:
                assert a[k].dtype == b[k].dtype
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        with open(tmp_path / "jax" / f"{shard}.json") as a, \
                open(tmp_path / "port" / f"{shard}.json") as b:
            assert json.load(a) == json.load(b)


def _record_items(n, seed=0):
    """n tiny episodes (3 frames of 8x8) in the HDF5 reader's item layout."""
    rng = np.random.RandomState(seed)
    return [{"images": rng.rand(3, 8, 8, 3).astype(np.float32),
             "states": rng.rand(3, 5).astype(np.float32),
             "actions": rng.rand(2, 5).astype(np.float32),
             "masks": rng.rand(3, 8, 8, 1).astype(np.float32),
             "qpos": rng.rand(3, 7).astype(np.float32),
             "robot": "locobot", "folder": "c0", "file_path": f"f{i}"}
            for i in range(n)]


def test_record_dataset_under_many_threads(tmp_path):
    """16 threads (more than the cores) read 4 shards through a cache that
    holds one, the interpreter switching threads every microsecond: every
    item equals the shard's own arrays (an unlocked cache evicts under a
    reader)."""
    items = _record_items(16)
    records.write_records(items, str(tmp_path), 3, 4)
    ds = records.RecordDataset(str(tmp_path), cache_bytes=1)
    errors = []

    def reader(seed):
        order = np.random.RandomState(seed).permutation(16).tolist() * 3
        try:
            for i in order:
                got = ds[i]
                for k in ("images", "states", "actions", "masks", "qpos"):
                    if not np.array_equal(got[k], items[i][k]):
                        errors.append((i, k))
        except Exception as e:  # reported below
            errors.append(repr(e))

    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=reader, args=(s,)) for s in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert errors == []
    assert ds.decodes > 4  # the one-shard cache evicted under the readers


@pytest.mark.parametrize("cache_bytes,decodes", [(None, 8), (1, None)])
def test_record_dataset_shuffled_epoch_decodes(tmp_path, cache_bytes, decodes):
    """A shuffled epoch of 3 loader threads over 8 shards of 4 episodes,
    batch 4: the same batches as the JAX RecordDataset's. At the default
    budget each shard is decoded once; through a one-shard cache nearly
    every item decodes its shard again (more than 16 of the 32)."""
    items = _record_items(32)
    records.write_records(items, str(tmp_path), 3, 4)
    kw = {} if cache_bytes is None else {"cache_bytes": cache_bytes}
    ds = records.RecordDataset(str(tmp_path), **kw)
    got = list(tloader.DataLoader(ds, 4, num_workers=3, seed=5))
    want = list(jloader.DataLoader(jrecords.RecordDataset(str(tmp_path)), 4,
                                   num_workers=1, seed=5))
    assert len(got) == len(want) == 8
    for g, w in zip(got, want):
        assert g["file_path"] == w["file_path"]
        for k in ("images", "states", "actions", "masks", "qpos"):
            np.testing.assert_array_equal(g[k], w[k], err_msg=k)
    if decodes is None:
        assert ds.decodes > 16
    else:
        assert ds.decodes == decodes


def test_record_dataset_decodes_a_shard_once_for_many_readers(tmp_path):
    """8 threads asking for one shard's episodes at once: it is decoded
    once and every thread gets its arrays."""
    items = _record_items(8)
    records.write_records(items, str(tmp_path), 3, 8)
    ds = records.RecordDataset(str(tmp_path))
    start = threading.Barrier(8)
    got = [None] * 8

    def reader(i):
        start.wait()
        got[i] = ds[i]

    threads = [threading.Thread(target=reader, args=(i,)) for i in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert ds.decodes == 1
    for i, g in enumerate(got):
        np.testing.assert_array_equal(g["images"], items[i]["images"])


# --------------------------------------------------------------- loaders
@pytest.mark.parametrize("workers,T", [(1, 12), (3, 8)])
def test_loader_batches_equal_jax(tmp_path, workers, T):
    """DataLoader over 7 files, batch 2, two epochs of infinite() and one
    of __iter__: the same batches in the same order. One worker: every
    array bit for bit with snippet draws (12-frame episodes). Three
    workers share the dataset's RandomState in both packages, so the
    episodes are exactly video_length long (nothing is drawn): the same
    batches bit for bit."""
    files = [_write(tmp_path / "locobot_c0" / f"t{i}.hdf5", i, T=T) for i in range(7)]
    kw = dict(BASE, data_threads=workers)
    j = jloader.DataLoader(jhdf5.RoboNetHDF5Dataset(files, ["locobot_c0"] * 7,
                                                     JConfig(**kw)), 2,
                           num_workers=workers, seed=5)
    t = tloader.DataLoader(thdf5.RoboNetHDF5Dataset(files, ["locobot_c0"] * 7,
                                                     Config(**kw)), 2,
                           num_workers=workers, seed=5)
    assert len(t) == len(j) == 3
    for jit, tit, n in ((j.infinite(), t.infinite(), 6), (iter(j), iter(t), 3)):
        for b in range(n):
            _assert_items_equal(next(tit), next(jit), f"batch {b}")
        tit.close()
        jit.close()


def test_loader_raises_a_worker_error_and_stops_early():
    """A dataset error reaches the consumer; a consumer that stops after
    one batch stops the workers (no item past the queue's reach is
    read)."""
    class Failing:
        def __len__(self):
            return 8

        def __getitem__(self, i):
            if i == 5:
                raise KeyError("item 5")
            return {"images": np.full((2, 1), i, np.float32), "idx": i}

    loader = tloader.DataLoader(Failing(), 2, shuffle=False, num_workers=2)
    got = []
    with pytest.raises(KeyError, match="item 5"):
        for batch in loader:
            got.append(batch["idx"])
    # the error may overtake batch 1, which another worker makes
    assert got and got == [[0, 1], [2, 3]][:len(got)]

    read = []

    class Counting:
        def __len__(self):
            return 400

        def __getitem__(self, i):
            read.append(i)
            return {"images": np.zeros((1,), np.float32)}

    it = iter(tloader.DataLoader(Counting(), 1, shuffle=False, num_workers=2))
    next(it)
    it.close()
    time.sleep(1.5)
    n = len(read)
    time.sleep(1.0)
    assert len(read) == n < 20


def _split_tree(root):
    """One or more files in every view directory the factories scan, plus
    demos; each a 3-frame 8x8 episode."""
    dirs = (["baxter_views/left_c0", "widowx_views/widowx1_c0", "franka_views/c0",
             "locobot_table_views/c0", "locobot_pick_views/c0"]
            + [f"sawyer_views/{d}" for d in tloader.ROBONET_SAWYER_DIRS]
            + [f"locobot_views/{d}" for d in tloader.LOCOBOT_FOLDERS])
    files = []
    for n, d in enumerate(dirs):
        for i in range(2 + n % 3):
            files.append(_write(root / d / f"traj_{i}.hdf5", 0, T=3, hw=(8, 8),
                                bounds=True))
    for i in range(5):
        jdemo.save_demo(str(root / "demos" / f"demo_{i}.hdf5"), {
            "observations": np.zeros((3, 8, 8, 3), np.uint8),
            "masks": np.zeros((3, 8, 8), np.uint8),
            "robot_state": np.zeros((3, 5), np.float32),
            "actions": np.zeros((2, 5), np.float32),
            "qpos": np.zeros((3, 5), np.float32)})
    meta = {f: i % 2 == 0 for i, f in enumerate(files)}
    with open(root / "obj_movement.pkl", "wb") as f:
        pickle.dump(meta, f)
    return files


FACTORIES = [
    "create_loaders", "create_transfer_loader", "create_robonet_loaders",
    "create_sawyer_loaders", "create_sawyer_transfer_loader",
    "create_sawyer_finetune_loaders", "create_widowx_finetune_loaders",
    "create_widowx_transfer_loader", "create_franka_transfer_loader",
    "create_locobot_loaders", "create_locobot_finetune_loaders",
    "create_locobot_transfer_loader", "create_locobot_table_loaders",
    "create_locobot_pick_loaders", "create_movement_loaders",
    "create_finetune_loaders", "create_demo_video_loaders",
]


def _loader_spec(loader):
    ds = loader.dataset
    files = ds._traj_names if hasattr(ds, "_traj_names") else ds._files
    robots = getattr(ds, "_traj_robots", None)
    return (list(files), robots, loader.batch_size,
            loader.shuffle, loader.drop_last, loader.seed, loader.num_workers,
            ds._rng.get_state()[1].tolist()[:4])


@pytest.fixture(scope="module")
def split_tree(tmp_path_factory):
    root = tmp_path_factory.mktemp("views")
    _split_tree(root)
    return root


@pytest.mark.parametrize("factory,movement", [
    (f, m) for f in FACTORIES for m in (False, True)
    if m or f != "create_movement_loaders"])  # that one needs the labels
def test_factory_file_lists_equal_jax(split_tree, factory, movement):
    """Every loader factory on a tree with each view layout (and the
    demo directory), with and without --world_error_dict: the same
    train/test/transfer files and viewpoints in the same order, batch
    sizes, shuffling, drop_last, seeds, worker counts and dataset seeds."""
    kw = dict(BASE, data_root=str(split_tree), batch_size=3, test_batch_size=2,
              finetune_num_train=4, finetune_num_test=2,
              demo_dir=str(split_tree / "demos"))
    if movement:
        kw["world_error_dict"] = str(split_tree / "obj_movement.pkl")
    want = getattr(jloader, factory)(JConfig(**kw))
    got = getattr(tloader, factory)(Config(**kw))
    if not isinstance(want, tuple):
        want, got = (want,), (got,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert _loader_spec(g) == _loader_spec(w)
        assert len(g) == len(w)


def test_demo_video_items_equal_jax(tmp_path):
    """DemoVideoDataset over demos with an object-only stream, 6-dim
    actions past [-1, 1] and short states/qpos: items equal bit for bit
    (the snippet drawn from one RandomState in both), for the inpainted
    stream and for the fallback to observations."""
    r = np.random.RandomState(0)
    files = []
    for i in range(3):
        demo = {"observations": (r.rand(9, 8, 8, 3) * 255).astype(np.uint8),
                "object_inpaint_demo": (r.rand(9, 8, 8, 3) * 255).astype(np.uint8),
                "masks": (r.rand(9, 8, 8) > 0.7).astype(np.uint8),
                "robot_state": r.rand(9, 3).astype(np.float32),
                "actions": r.uniform(-2, 2, (8, 4)).astype(np.float32),
                "qpos": r.rand(9, 4).astype(np.float32)}
        files.append(str(tmp_path / f"demo_{i}.hdf5"))
        jdemo.save_demo(files[-1], demo)
    for video_type in ("object_inpaint_demo", "object_only_demo"):
        kw = dict(BASE, video_type=video_type, n_future=4)
        j = jloader.DemoVideoDataset(files, JConfig(**kw), seed=2)
        t = tloader.DemoVideoDataset(files, Config(**kw), seed=2)
        for i in (0, 1, 2, 1):
            _assert_items_equal(t[i], j[i], f"{video_type} {i}")


# ------------------------------------------------------- movement labels
def test_copy_world_error_and_labels_match_jax(tmp_path):
    """copy_world_error within 1e-6 of JAX's on reader items; the labels
    make_movement_metadata writes equal JAX's; each package loads the
    other's pickle."""
    files = [_write(tmp_path / "locobot_c0" / f"t{i}.hdf5", i) for i in range(4)]
    ds = thdf5.RoboNetHDF5Dataset(files, ["locobot_c0"] * 4,
                                  Config(**dict(BASE, video_length=12)))
    for i in range(4):
        item = ds[i]
        want = jmove.copy_world_error(item["images"], item["masks"])
        got = tmove.copy_world_error(item["images"], item["masks"])
        assert abs(got - want) <= 1e-6, (got, want)
    errs = sorted(tmove.copy_world_error(ds[i]["images"], ds[i]["masks"])
                  for i in range(4))
    threshold = (errs[1] + errs[2]) / 2  # two videos above, two below
    want = jmove.make_movement_metadata(ds, threshold, str(tmp_path / "j.pkl"))
    got = tmove.make_movement_metadata(ds, threshold, str(tmp_path / "t.pkl"))
    assert got == want and sum(got.values()) == 2
    assert tmove.load_movement_metadata(str(tmp_path / "j.pkl")) == want
    assert jmove.load_movement_metadata(str(tmp_path / "t.pkl")) == want
    # the checkpoint route (evaluate_on_movement_set) reads the labels of
    # --world_error_dict, as the JAX one does
    with pytest.raises(ValueError, match="world_error_dict"):
        tmove.main(["--data_root", str(tmp_path), "--dynamics_model_ckpt", "x",
                    "--device", "cpu"])
    meta = tmove.main(["--data_root", str(tmp_path), "--video_length", "12",
                       "--image_height", "48", "--image_width", "64",
                       "--robot_joint_dim", "7", "--action_dim", "5"])
    assert set(meta) == set(files)


# --------------------------------------------------------- device_prefetch
def test_device_prefetch_on_the_cpu(tmp_path):
    """On the CPU: every batch of a loader's epoch, its arrays as tensors
    sharing the host arrays' values and the rest unchanged, in order."""
    files = [_write(tmp_path / "locobot_c0" / f"t{i}.hdf5", i) for i in range(5)]
    ds = thdf5.RoboNetHDF5Dataset(files, ["locobot_c0"] * 5, Config(**BASE))
    out = prefetch_check(tloader.DataLoader(ds, 2, num_workers=2, seed=1), "cpu")
    assert out == {"batches": 2, "mismatched": 0, "keys": [
        "actions", "high", "images", "low", "masks", "qpos", "states"]}


def test_device_prefetch_raises_the_source_error():
    def source():
        yield {"x": np.zeros(2, np.float32)}
        yield {"x": np.ones(2, np.float32)}
        raise ValueError("decode failed")

    got = []
    with pytest.raises(ValueError, match="decode failed"):
        for batch in tloader.device_prefetch(source(), "cpu"):
            got.append(batch["x"].tolist())
    assert got == [[0.0, 0.0], [1.0, 1.0]]


def test_device_prefetch_stops_when_abandoned():
    """A consumer that stops after one batch closes the source: no batch
    past the `size` staged ones is pulled."""
    pulled, closed = [], threading.Event()

    def source():
        try:
            for i in range(1000):
                pulled.append(i)
                yield {"x": np.full(1, i, np.float32)}
        finally:
            closed.set()

    it = tloader.device_prefetch(source(), "cpu", size=2)
    assert next(it)["x"].item() == 0
    it.close()
    assert closed.wait(timeout=10)
    assert len(pulled) == 2


def test_device_prefetch_of_one_pulls_a_batch_when_asked():
    """size=1, as the trainer draws its train batches: the source is
    pulled once per batch handed over, never ahead."""
    pulled = []

    def source():
        for i in range(3):
            pulled.append(i)
            yield {"x": np.full(1, i, np.float32)}

    it = tloader.device_prefetch(source(), "cpu", size=1)
    for i in range(3):
        assert next(it)["x"].item() == i
        assert pulled == list(range(i + 1))
    assert list(it) == []


def test_device_prefetch_runs_the_source_on_the_callers_thread():
    """Every batch is made on the consumer's thread: a producer thread
    would take the GIL from the thread that launches the steps."""
    threads = []

    def source():
        for i in range(4):
            threads.append(threading.get_ident())
            yield {"x": np.full(1, i, np.float32)}

    got = [b["x"].item() for b in tloader.device_prefetch(source(), "cpu")]
    assert got == [0, 1, 2, 3]
    assert threads == [threading.get_ident()] * 4


# ------------------------------------------------------- plots and report
def test_eval_gif_and_report_equal_jax(tmp_path):
    """eval_gif of the same truth, predictions and masks: the same gif
    bytes (and 4 frames of 2 rows x 3 columns); build_report of the same
    run directory: the same HTML."""
    r = np.random.RandomState(0)
    truth = r.rand(4, 3, 8, 8, 3).astype(np.float32)
    preds = r.rand(4, 3, 8, 8, 3).astype(np.float32)
    masks = (r.rand(4, 3, 8, 8, 1) > 0.5).astype(np.float32)
    a = jplot.eval_gif(str(tmp_path / "j.gif"), truth, preds, masks=masks)
    b = plot.eval_gif(str(tmp_path / "t.gif"), truth, preds, masks=masks)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    import imageio.v2 as imageio

    frames = imageio.mimread(b)
    assert len(frames) == 4 and frames[0].shape[:2] == (16, 24)
    with open(tmp_path / "metrics.jsonl", "w") as f:
        for step in range(3):
            f.write(json.dumps({"train/loss": 1.0 / (step + 1), "step": step,
                                "eval/autoreg_psnr": 20.0 + step}) + "\n")
        f.write(json.dumps({"eval/rollout": b, "step": 2}) + "\n")
        f.write('{"eval/x": NaN, "step": 3}\n')
    pa = jhtml.build_report(str(tmp_path), "j.html")
    pb = html_report.build_report(str(tmp_path), "t.html")
    with open(pa) as fa, open(pb) as fb:
        assert fa.read() == fb.read()
    assert html_report.parse_metrics(str(tmp_path / "metrics.jsonl")) == \
        jhtml.parse_metrics(str(tmp_path / "metrics.jsonl"))
    assert html_report.svg_line_chart("k", [(0, 1.0), (1, 2.0)]) == \
        jhtml.svg_line_chart("k", [(0, 1.0), (1, 2.0)])


# --------------------------------------------------------------- trainer
TRAINER_KW = dict(g_dim=8, z_dim=2, image_height=16, image_width=16,
                  action_dim=5, robot_dim=5, robot_joint_dim=7, n_past=1,
                  n_future=2, n_eval=3, video_length=6, batch_size=2,
                  test_batch_size=2, niter=1, epoch_size=2, eval_interval=1,
                  checkpoint_interval=1, model_use_mask=True,
                  reconstruction_loss="dontcare_l1", compute_dtype="float32",
                  optimizer="adam", lr=1e-3, data_threads=1)
JAX_EVAL_KEYS = {"recon_loss", "robot_loss", "world_loss", "psnr", "ssim", "kld"}
# experiment: (extra config, transfer loader expected)
TRAINER_CASES = {
    "train_locobot_singleview": (dict(model_use_heatmap=True,
                                      load_movement_info=True,
                                      movement_weight=2.0,
                                      world_error_dict="obj_movement.pkl"),
                                 False),
    "train_robonet": ({}, True),  # the CLI's default experiment
    "train_all_views": ({}, True),  # any other name: every file under data_root
}


@pytest.fixture(scope="module")
def trainer_tree(tmp_path_factory):
    """Locobot views c0-c3 (2 files each), and baxter, widowx and two
    sawyer views (2 each): 8-frame 24x32 episodes with stored bounds (read
    where the viewpoint, the directory's name, names no locobot or franka:
    every view of an experiment that discovers all files), and movement
    labels on every other file."""
    root = tmp_path_factory.mktemp("tree")
    files, n = [], 0
    for d in [f"locobot_views/{c}" for c in tloader.LOCOBOT_FOLDERS]:
        files += [_write(root / d / f"t{i}.hdf5", (n := n + 1), T=8, hw=(24, 32),
                         bounds=True) for i in range(2)]
    for d, robot in (("baxter_views/left_c0", "baxter"),
                     ("widowx_views/widowx1_c0", "widowx"),
                     ("sawyer_views/sudri0_c0", "sawyer"),
                     ("sawyer_views/sudri2_c1", "sawyer")):
        files += [_write(root / d / f"t{i}.hdf5", (n := n + 1), T=8, hw=(24, 32),
                         robot=robot, bounds=True) for i in range(2)]
    with open(root / "obj_movement.pkl", "wb") as f:
        pickle.dump({p: i % 2 == 0 for i, p in enumerate(files)}, f)
    return root


def _records(path):
    with open(path) as f:
        recs = [json.loads(line) for line in f]
    return [(sorted(set(r) - {"wall_s"}), r["step"],
             [os.path.basename(v) for v in r.values() if isinstance(v, str)])
            for r in recs]


def _recorder(record, step=None, metrics=None, preds=False):
    """A step that records the window it is handed (as numpy) and calls
    `step`, or returns `metrics` (JAX stand-ins that compile nothing)."""
    def to_np(window):
        return {k: np.array(v) for k, v in window.items()}

    if step is not None:  # the port's real step
        def port_step(window, *args):
            record.append((to_np(window),) + tuple(
                float(np.float32(a)) for a in args if isinstance(a, float)))
            return step(window, *args)
        return port_step

    def jax_step(*args):
        if preds:  # eval: (params, bn, window, key)
            window = args[2]
            record.append((to_np(window),))
            n, B = window["images"].shape[:2]
            return ({k: np.full(n - 1, 0.5, np.float32) for k in metrics},
                    np.zeros((n - 1, B) + window["images"].shape[2:], np.float32))
        params, bn, opt, window, _, sched = args
        record.append((to_np(window), float(sched)))
        return params, bn, opt, {k: np.float32(0.5) for k in metrics}
    return jax_step


@pytest.mark.parametrize("experiment", list(TRAINER_CASES))
def test_trainer_on_hdf5_hands_its_steps_the_jax_windows(trainer_tree, tmp_path,
                                                         experiment):
    """The port's PredictionTrainer and the JAX one on the same HDF5 tree
    (one loader thread each, niter 1, 2 batches of 2 videos): their train
    steps are handed the same windows (frames, masks, states, actions;
    heatmaps and movement weights for the heatmap model with
    --load_movement_info) bit for bit, in the same order, with the same
    scheduled-sampling probability; their eval steps the same windows
    (test and transfer loaders, then the gif's rollout); and they log the
    same keys at the same steps (train/, eval/, transfer/ where the
    experiment has a transfer loader, eval/rollout). The JAX trainer's
    steps are recorders returning its steps' metric keys (held against
    its real steps in test_torch_port_trainer.py), so nothing of JAX
    compiles; the port's steps are its real ones, recorded on the way."""
    extra, has_transfer = TRAINER_CASES[experiment]
    kw = dict(TRAINER_KW, experiment=experiment, data_root=str(trainer_tree),
              **extra)
    if "world_error_dict" in kw:
        kw["world_error_dict"] = str(trainer_tree / kw["world_error_dict"])
    rec = {"jax": {"train": [], "eval": []}, "port": {"train": [], "eval": []}}
    with pytest.MonkeyPatch.context() as mp:
        # the JAX model's parameters are never read by the recorders
        mp.setattr(jsvg, "init", lambda key, cfg: ({}, {}))
        jtr = JTrainer(JConfig(**dict(kw, log_dir=str(tmp_path / "jax"),
                                      num_devices=1, async_checkpoint=False)))
    jtr.train_step = _recorder(rec["jax"]["train"], metrics=JAX_TRAIN_KEYS)
    jtr.eval_step_ar = jtr.eval_step_1 = _recorder(
        rec["jax"]["eval"], metrics=JAX_EVAL_KEYS, preds=True)
    jtr.train()
    jtr.logger.close()
    tr = PredictionTrainer(Config(**dict(kw, log_dir=str(tmp_path / "port"))),
                           device="cpu")
    tr.train_step = _recorder(rec["port"]["train"], step=tr.train_step)
    tr.eval_step_ar = _recorder(rec["port"]["eval"], step=tr.eval_step_ar)
    tr.eval_step_1 = _recorder(rec["port"]["eval"], step=tr.eval_step_1)
    tr.train()
    tr.logger.close()
    assert (tr.transfer_loader is not None) == has_transfer
    for kind in ("train", "eval"):
        want, got = rec["jax"][kind], rec["port"][kind]
        assert len(got) == len(want) > 0, kind
        for n, (g, w) in enumerate(zip(got, want)):
            _assert_items_equal(g[0], w[0], f"{kind} window {n}")
            assert g[1:] == w[1:], f"{kind} window {n}"
    windows = rec["port"]["train"]
    assert len(windows) == 2 * 2  # 2 videos an epoch, 2 windows each
    if extra.get("model_use_heatmap"):
        assert {"heatmaps", "batch_weight"} <= set(windows[0][0])
        assert {1.0, 2.0} >= set(np.concatenate([w[0]["batch_weight"] for w in windows]))
    want = _records(os.path.join(jtr.log_dir, "metrics.jsonl"))
    got = _records(os.path.join(tr.log_dir, "metrics.jsonl"))
    assert got == want
    keys = {k for r in got for k in r[0]}
    assert ("transfer/autoreg_psnr" in keys) == has_transfer
    assert {"train/loss", "train/frames_per_sec", "eval/1step_psnr",
            "eval/rollout"} <= keys
    assert os.path.isfile(os.path.join(tr.log_dir, "eval_0.gif"))


@pytest.mark.parametrize("experiment", [None, "train_locobot_singleview"])
def test_trainer_cli_on_an_hdf5_tree(trainer_tree, tmp_path, experiment):
    """The port's trainer CLI on the CPU on an HDF5 tree, with the default
    experiment (train_robonet: the robonet views, transfer eval on the
    locobot views) and with train_locobot_singleview for a heatmap svg:
    it trains, evaluates, writes checkpoints, the eval gif and the report;
    a second run resumes."""
    args = ["--device", "cpu", "--data_root", str(trainer_tree), "--log_dir",
            str(tmp_path), "--jobname", "cli", "--niter", "2"]
    for k, v in TRAINER_KW.items():
        if k != "niter":
            args += [f"--{k}", str(v).lower() if isinstance(v, bool) else str(v)]
    if experiment:
        args += ["--experiment", experiment, "--model_use_heatmap", "true"]
    main(args)
    run = tmp_path / "cli"
    assert {"ckpt_4.npz", "ckpt_8.npz", "eval_0.gif", "eval_1.gif",
            "report.html", "log.txt"} <= set(os.listdir(run))
    recs = [json.loads(line) for line in open(run / "metrics.jsonl")]
    keys = {k for r in recs for k in r}
    assert ("transfer/autoreg_psnr" in keys) == (experiment is None)
    assert all(np.isfinite(r["train/loss"]) for r in recs if "train/loss" in r)
    with open(run / "log.txt") as f:
        log = f.read()
    assert "for data" in log and "saved checkpoint" in log
    main(args)  # resumes at step 8: trains nothing more
    assert "auto-resumed" in open(run / "log.txt").read()
