"""The port's raw public-RoboNet route held against the JAX package on the
CPU: decode of jpg, mp4 and raw frames in RGB and BGR, the resize choice,
the mismatch flags and the autograsp column, annotations and load_data,
the metadata table (no pandas in the port) against JAX's pandas table,
the schema canary, raw dataset items (sawyer through the chain render,
locobot through the mask kernel's plain version) for files and for trees
in memory, the converter and its CLI, record shards of raw trees split as
the HDF5 loaders of train_sawyer_multiview split the files, and the
trainer on them. Planted faults: a mask env that raises, pandas blocked,
no cv2. Fixture files are written in tmp_path."""

import os
import random
import sys
import warnings

import h5py
import numpy as np
import pytest

from robot_aware_control_tpu.config import Config as JConfig
from robot_aware_control_tpu.data import loader as jloader
from robot_aware_control_tpu.data import raw_robonet as jrr
from robot_aware_control_tpu.data import records as jrecords
from robot_aware_control_tpu.data import robonet_hdf5 as jhdf5
from robot_aware_control_tpu.robot import kinematic_chain as jchain
from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.data import raw_robonet as rr
from robot_aware_control_tpu_torch.data import loader as tloader
from robot_aware_control_tpu_torch.data import records
from robot_aware_control_tpu_torch.data import robonet_hdf5 as thdf5
from robot_aware_control_tpu_torch.data.collect import write_training_records
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.robot import kinematic_chain as tchain
from robot_aware_control_tpu_torch.training.trainer import PredictionTrainer
from torch_experiment_cases import shards_equal
from torch_raw_cases import (
    RAW_LAYOUT,
    RAW_TRAIN,
    SAWYER_HIGH,
    SAWYER_LOW,
    raw_episode,
    raw_trees,
)
from torch_train_cases import one_torch_thread  # noqa: F401 (autouse)

T = 9
SMALL_HW = (48, 64)
# the JAX raw tests' reader config
BASE = dict(data_root="", video_length=6, n_past=1, n_future=5, action_dim=5,
            impute_autograsp_action=True, image_width=64, image_height=48,
            seed=11, robot_dim=5, robot_joint_dim=7, preprocess_action="raw",
            experiment="train_robonet", img_augmentation=False)


_JAX_MASK_ENVS = {}


@pytest.fixture(autouse=True)
def shared_jax_mask_envs(monkeypatch):
    """The JAX mask envs of one robot, size and view made once for the
    module: each jits its render on first use, and the JAX reader and
    converter make a new env for every dataset or call."""
    make = jchain.get_mask_env

    def shared(robot, **kw):
        key = (robot, tuple(sorted(kw.items())))
        if key not in _JAX_MASK_ENVS:
            _JAX_MASK_ENVS[key] = make(robot, **kw)
        return _JAX_MASK_ENVS[key]

    monkeypatch.setattr(jchain, "get_mask_env", shared)


def _ep(seed, ncam=1, hw=SMALL_HW, robot="sawyer", adim=4):
    return raw_episode(np.random.RandomState(seed), T, hw, ncam, adim, robot)


def _write(path, ep, writer=jrr, **kw):
    return writer.write_raw_robonet_hdf5(str(path), *ep, SAWYER_LOW,
                                         SAWYER_HIGH, **kw)


def _equal(got, want, where=""):
    """Equal values of equal types; arrays of equal dtype, bit for bit."""
    if isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _equal(got[k], want[k], f"{where}.{k}")
    elif isinstance(want, (tuple, list)):
        assert len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _equal(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, (where, got, want)


# ------------------------------------------------------------------ decode
@pytest.mark.parametrize("encoding", ["jpg", "mp4", "raw"])
def test_decode_equal_jax(tmp_path, encoding):
    """A two-camera trajectory written by each package's writer and held
    in memory as a tree: its metadata row and each camera's frames (in
    RGB, from RGB and BGR storage; shrunk with INTER_AREA, grown with
    INTER_CUBIC, and at the stored size) equal the JAX reader's of the JAX
    writer's file, bit for bit and type for type; the port's writer makes
    the file its tree reads as."""
    ep = _ep(1, ncam=2)
    for fmt in ("RGB", "BGR"):
        kw = dict(encoding=encoding, image_format=fmt,
                  extra_metadata={"contains_annotation": True, "n": 3})
        jpath = _write(tmp_path / f"j{fmt}.hdf5", ep, **kw)
        tpath = _write(tmp_path / f"t{fmt}.hdf5", ep, writer=rr, **kw)
        tree = rr.raw_robonet_tree(*ep, SAWYER_LOW, SAWYER_HIGH, **kw)
        want = jrr.load_metadata_dict(jpath)
        row = rr.load_metadata_dict(tpath)
        _equal({k: v for k, v in row.items() if k != "sha256"},
               {k: v for k, v in want.items() if k != "sha256"}, fmt)
        _equal(rr.load_metadata_dict(tree),
               {k: v for k, v in want.items() if k != "sha256"}, fmt)
        with h5py.File(jpath, "r") as jf, h5py.File(tpath, "r") as tf:
            for dims in ((24, 32), (64, 85), SMALL_HW):
                for cam in (0, 1):
                    w = jrr.load_camera_imgs(cam, jf, want, dims, 2, 5)
                    for src in (tf, tree):
                        _equal(rr.load_camera_imgs(cam, src, row, dims, 2, 5),
                               w, f"{encoding} {fmt} {dims} cam {cam}")
    if encoding == "raw":
        # stored pixels come back exactly, RGB from either storage
        with h5py.File(jpath, "r") as jf:
            np.testing.assert_array_equal(
                rr.load_camera_imgs(1, jf, want, SMALL_HW), ep[0][:, 1])


def test_tree_reads_as_the_file_written_from_it(tmp_path):
    """Every group, dataset and attribute of the file `write_tree` writes
    reads back as the tree holds it (values, dtypes and types, names in
    h5py's order), and scalar strings read as bytes in both."""
    tree = rr.raw_robonet_tree(*_ep(2, ncam=2), SAWYER_LOW, SAWYER_HIGH,
                               extra_metadata={"flag": True, "w": 0.5})
    path = rr.write_tree(str(tmp_path / "t.hdf5"), tree)

    def walk(a, b, where):
        assert list(a.keys()) == list(b.keys()), where
        _equal(dict(a.attrs.items()), dict(b.attrs.items()), where + "@")
        for k in a.keys():
            if rr._is_group(a[k]):
                walk(a[k], b[k], f"{where}/{k}")
            else:
                _equal(dict(a[k].attrs.items()), dict(b[k].attrs.items()), k)
                if a[k].shape == ():
                    _equal(a[k][()], b[k][()], k)
                else:
                    _equal(np.asarray(a[k]), np.asarray(b[k]), k)
                    _equal(a[k][1:3], b[k][1:3], k)

    with h5py.File(path, "r") as hf:
        walk(tree, hf, "")
        assert tree["file_version"][()] == hf["file_version"][()] == b"0.1.0"


def test_loader_flags_annotations_and_load_data_equal_jax(tmp_path):
    """load_actions (autograsp imputation, PAD_ZERO, CLEAVE, ERROR),
    load_states, load_annotations (and their absence) and load_data with
    seeded snippet windows and chosen cameras: the port on the file and on
    the tree equals JAX on the file."""
    ep = _ep(3, ncam=2)
    boxes = np.random.RandomState(4).randint(5, 40, (T, 2, 2, 2, 2))
    boxes[..., 1, :] = boxes[..., 0, :] + 6
    kw = dict(encoding="jpg", extra_metadata={"contains_annotation": True})
    path = _write(tmp_path / "a.hdf5", ep, **kw)
    with h5py.File(path, "a") as hf:
        hf["env"].create_dataset("bbox_annotations", data=boxes.astype(np.int32))
    tree = rr.raw_robonet_tree(*ep, SAWYER_LOW, SAWYER_HIGH, **kw)
    tree["env"].create_dataset("bbox_annotations", data=boxes.astype(np.int32))
    md_j, md_t = jrr.load_metadata_dict(path), rr.load_metadata_dict(path)
    A, S = jrr.ACTION_MISMATCH, jrr.STATE_MISMATCH
    params = [dict(target_adim=5), dict(target_adim=6, impute_autograsp_action=False,
                                        action_mismatch=A.PAD_ZERO),
              dict(target_adim=2, action_mismatch=A.CLEAVE),
              dict(target_sdim=7, state_mismatch=S.PAD_ZERO),
              dict(target_sdim=3, state_mismatch=S.CLEAVE)]
    with h5py.File(path, "r") as hf:
        for p in params:
            for fn in ("load_actions", "load_states"):
                want = getattr(jrr, fn)(hf, md_j, jrr.LoaderParams(**p))
                for src in (hf, tree):
                    _equal(getattr(rr, fn)(src, md_t, rr.LoaderParams(**p)),
                           want, f"{fn} {p}")
        for fn, p in (("load_actions", dict(target_adim=2)),
                      ("load_states", dict(target_sdim=3))):
            with pytest.raises(ValueError):
                getattr(jrr, fn)(hf, md_j, jrr.LoaderParams(**p))
            with pytest.raises(ValueError, match="permits neither"):
                getattr(rr, fn)(tree, md_t, rr.LoaderParams(**p))
        p = dict(img_size=(24, 32))
        want = jrr.load_annotations(hf, md_j, jrr.LoaderParams(**p), [1, 0])
        _equal(rr.load_annotations(tree, md_t, rr.LoaderParams(**p), [1, 0]), want)
        assert want.sum() == T * 2 * 2
        bare = {k: v for k, v in md_t.items() if k != "contains_annotation"}
        z = rr.load_annotations(tree, bare, rr.LoaderParams(
            zero_if_missing_annotation=True, **p), [0])
        assert z.shape == (T, 1, 24, 32, 2) and z.sum() == 0
        with pytest.raises(AssertionError, match="no bbox"):
            rr.load_annotations(tree, bare, rr.LoaderParams(**p), [0])
    p = dict(target_adim=5, img_size=(24, 32), cams_to_load=[1, 0], load_T=4,
             load_annotations=True)
    for rng in (0, 7):
        want = jrr.load_data(path, md_j, jrr.LoaderParams(**p), rng=rng)
        _equal(rr.load_data(path, md_t, rr.LoaderParams(**p), rng=rng), want)
        _equal(rr.load_data(tree, md_t, rr.LoaderParams(
            check_sha256=False, **p), rng=rng), want)
    with pytest.raises(ValueError, match="check_sha256"):
        rr.load_data(tree, md_t, rr.LoaderParams(**p))
    with pytest.raises(IndexError):
        rr.load_data(tree, md_t, rr.LoaderParams(
            check_sha256=False, cams_to_load=[2]))
    with h5py.File(path, "a") as hf:  # the row's checksum guards the file
        hf["env"]["state"][0, 0] = 99.0
    with pytest.raises(ValueError, match="checksum drift"):
        rr.load_data(path, md_t, rr.LoaderParams(**p))


# ---------------------------------------------------------------- metadata
def test_metadata_table_equal_jax_pandas_table(tmp_path, monkeypatch):
    """A directory and an explicit file list: the port's table (pandas
    blocked from import) against JAX's pandas table: files, columns, each
    row, select_objects by a name and by an exact set, a row filter by a
    boolean list, and shuffled files under one random.Random seed. The
    port caches its rows under its own name and never reads JAX's
    meta_data.pkl (a corrupt one planted there is left as it was)."""
    d = tmp_path / "db"
    specs = [("toys",), ("toys", "cloth"), ("cloth",), ("toys",)]
    for i, oc in enumerate(specs):
        _write(d / f"traj{i}.hdf5", _ep(10 + i), encoding="raw",
               object_classes=oc,
               camera_configuration="sudri0" if i < 2 else "vestri1")
    want = jrr.load_metadata(str(d))
    files = [str(d / f"traj{i}.hdf5") for i in (3, 1)]
    want_listed = jrr.load_metadata(files)
    monkeypatch.setitem(sys.modules, "pandas", None)
    with open(d / "meta_data.pkl", "wb") as f:
        f.write(b"not a pickle")
    for cache in (False, True, True):  # built, cached, read from the cache
        got = rr.load_metadata(str(d), cache=cache)
        assert got.files == want.files and len(got) == len(want) == 4
        assert got.keys() == list(want.keys())
        for f in want.files:
            row, jrow = got.get_file_metadata(f), want.get_file_metadata(f)
            assert list(row) == list(jrow.index)
            for k in row:
                np.testing.assert_array_equal(row[k], jrow[k], err_msg=k)
        for sel in ("toys", "cloth", ["cloth", "toys"]):
            assert got.select_objects(sel).files == \
                want.select_objects(sel).files
        mask = [c == "sudri0" for c in got.column("camera_configuration")]
        assert mask == [c == "sudri0" for c in
                        want.frame["camera_configuration"]]
        sub = got[mask]
        assert sub.files == want[mask].files and "camera_configuration" in sub
        assert sub.select_objects("cloth").files == \
            want[mask].select_objects("cloth").files
        assert got.get_shuffled_files(random.Random(3)) == \
            want.get_shuffled_files(random.Random(3))
    assert os.path.exists(d / rr.CACHE_NAME)
    assert open(d / "meta_data.pkl", "rb").read() == b"not a pickle"
    assert rr.load_metadata(files).files == want_listed.files
    # a file added to the directory rebuilds the port's cache
    _write(d / "traj9.hdf5", _ep(19), encoding="raw")
    assert len(rr.load_metadata(str(d))) == 5


def test_schema_canary_equal_jax(tmp_path):
    """Drifted layouts (missing paths, unknown keys, env and policy as
    datasets) raise RawSchemaError naming the same diff as JAX's, for the
    file and for a tree; a good trajectory reports none."""
    bad = tmp_path / "bad.hdf5"
    with h5py.File(bad, "w") as hf:
        env = hf.create_group("env")
        env.create_dataset("teleport_log", data=np.zeros(3))
        hf.create_group("wizardry")
        hf.create_group("policy").create_dataset("actionz", data=np.zeros(3))
    flat = tmp_path / "flat.hdf5"
    with h5py.File(flat, "w") as hf:
        hf.create_dataset("env", data=np.zeros(3))
        hf.create_dataset("policy", data=np.zeros(3))
    tree = rr.TreeGroup()
    tree.create_group("env").create_dataset("teleport_log", data=np.zeros(3))
    tree.create_group("wizardry")
    tree.create_group("policy").create_dataset("actionz", data=np.zeros(3))
    for path in (bad, flat):
        with pytest.raises(jrr.RawSchemaError) as j:
            jrr.load_metadata_dict(str(path))
        with pytest.raises(rr.RawSchemaError) as t:
            rr.load_metadata_dict(str(path))
        assert str(t.value).split("\n")[1:] == str(j.value).split("\n")[1:]
        with h5py.File(path, "r") as hf:
            assert rr.schema_report(hf) == jrr.schema_report(hf)
    with h5py.File(bad, "r") as hf:
        assert rr.schema_report(tree) == jrr.schema_report(hf)
    with pytest.raises(rr.RawSchemaError, match="policy/actionz"):
        rr.load_metadata_dict(tree)
    good = rr.raw_robonet_tree(*_ep(5), SAWYER_LOW, SAWYER_HIGH)
    assert rr.schema_report(good) == \
        "missing required: (none)\nunknown keys: (none)"
    assert rr.is_raw_robonet(good) and not rr.is_raw_robonet(rr.TreeGroup())


# ------------------------------------------------------------ dataset items
# name: (viewpoint dir, episode options, file options, config options,
# dataset options)
RAW_ITEM_CASES = {
    # RoboNet's stored size: INTER_AREA to 64x85, then bilinear to 48x64
    "sawyer_jpg_stored_size": ("sawyer_sudri0_c0", dict(hw=(240, 320)), {},
                               {}, {}),
    "locobot_kernel": ("locobot_c0", dict(robot="locobot"),
                       dict(robot="locobot"), {}, {}),
    "mp4_bgr": ("sawyer_sudri0_c0", {},
                dict(encoding="mp4", image_format="BGR"), {}, {}),
    "multicam_view_c1": ("sawyer_sudri0_c1", dict(ncam=2), {}, {}, {}),
    "multiview": ("sawyer_sudri0_c0", dict(ncam=2), {},
                  dict(multiview=True, camera_ids=(0, 1), image_height=96),
                  {}),
    "multiview_id_out_of_range": ("sawyer_sudri0_c0", dict(ncam=2), {},
                                  dict(multiview=True, camera_ids=(1, 4),
                                       image_height=96), {}),
    "multiview_unsuffixed_dir": ("sawyer_sudri0", dict(ncam=2), {},
                                 dict(multiview=True, camera_ids=(0, 1),
                                      image_height=96), {}),
    # no view suffix: stream 0, the default camera of the robot's chain
    "viewpoint_without_suffix": ("sawyer", dict(ncam=2), {}, {}, {}),
    # train_robonet's other views (data/loader.py: baxter left_c0, widowx
    # widowx1_c0): their chains at 64x85
    "baxter_left_c0": ("baxter_left_c0", {}, dict(robot="baxter"), {}, {}),
    "widowx_widowx1_c0": ("widowx_widowx1_c0", {}, dict(robot="widowx"), {},
                          {}),
    "unknown_robot_zero_masks": ("mystery_c0", {}, dict(robot="mysterybot"),
                                 {}, {}),
    "snippets_and_augmentation": ("sawyer_sudri0_c0", {}, {},
                                  dict(video_length=4, img_augmentation=True,
                                       preprocess_action="state_infer"),
                                  dict(load_snippet=True)),
}


@pytest.mark.parametrize("case", list(RAW_ITEM_CASES))
def test_raw_items_equal_jax(tmp_path, case):
    """Two raw trajectories read by RoboNetHDF5Dataset of each package in
    the order 0, 1, 0 (one RandomState each: snippet starts, crops,
    jitter): every item equal bit for bit, from the port's reader of the
    files and of the same trajectories as trees in memory; the masks
    rendered by the chain (sawyer), the capsule kernel's plain version
    (locobot) or zero (a robot with no measured chain)."""
    view, ep_kw, file_kw, cfg_kw, ds_kw = RAW_ITEM_CASES[case]
    eps = [_ep(20 + i, **ep_kw) for i in range(2)]
    files = [_write(tmp_path / view / f"traj{i}.hdf5", e, **file_kw)
             for i, e in enumerate(eps)]
    trees = [rr.raw_robonet_tree(*e, SAWYER_LOW, SAWYER_HIGH, **file_kw)
             for e in eps]
    kw = dict(BASE, **cfg_kw)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        jds = jhdf5.RoboNetHDF5Dataset(files, [view] * 2, JConfig(**kw), **ds_kw)
        tds = thdf5.RoboNetHDF5Dataset(files, [view] * 2, Config(**kw),
                                       device="cpu", **ds_kw)
        mds = thdf5.RoboNetHDF5Dataset(files, [view] * 2, Config(**kw),
                                       device="cpu", episodes=trees, **ds_kw)
        for i in (0, 1, 0):
            want = jds[i]
            got, mem = tds[i], mds[i]
            assert set(got) == set(want) == set(mem)
            for k, v in want.items():
                _equal(got[k], v, f"{case} {i} {k}")
                _equal(mem[k], v, f"{case} {i} {k} (tree)")
    masks = want["masks"]
    if case == "unknown_robot_zero_masks":
        assert masks.sum() == 0
    else:
        assert masks.sum() > 0
    if case == "multiview_id_out_of_range":
        # once a file in each of the three readers
        assert sum("out of range" in str(w.message) for w in caught) == 6


def test_mask_env_error_raises_where_jax_gives_zero_masks(tmp_path, monkeypatch):
    """A planted mask-env failure (a kernel build error, say) makes the
    JAX reader zero the masks silently; the port's reader raises it, for
    the chain robots and for locobot's kernel. Only a robot with no
    measured chain gets zero masks (test_raw_items_equal_jax)."""
    path = _write(tmp_path / "sawyer_sudri0_c0" / "t.hdf5", _ep(30))
    loco = _write(tmp_path / "locobot_c0" / "t.hdf5", _ep(31, robot="locobot"),
                  robot="locobot")

    def broken(*a, **k):
        raise RuntimeError("planted: the mask kernel did not build")

    monkeypatch.setattr(jchain, "get_mask_env", broken)
    assert jhdf5.RoboNetHDF5Dataset([path], ["sawyer_sudri0_c0"],
                                    JConfig(**BASE))[0]["masks"].sum() == 0
    monkeypatch.setattr(tchain, "get_mask_env", broken)
    ds = thdf5.RoboNetHDF5Dataset([path], ["sawyer_sudri0_c0"], Config(**BASE),
                                  device="cpu")
    with pytest.raises(RuntimeError, match="planted"):
        ds[0]
    monkeypatch.undo()
    monkeypatch.setattr(kernels, "capsule_mask_render", broken)
    ds = thdf5.RoboNetHDF5Dataset([loco], ["locobot_c0"], Config(**BASE),
                                  device="cpu")
    with pytest.raises(RuntimeError, match="planted"):
        ds[0]


def test_without_cv2_decode_and_resize_raise(tmp_path, monkeypatch):
    """Without cv2 (planted) the port decodes no jpg or mp4 and resizes no
    frame, and the reader raises, where the JAX reader would sample the
    nearest pixels; raw frames at the target size still read."""
    ep = _ep(40)
    jpg = rr.raw_robonet_tree(*ep, SAWYER_LOW, SAWYER_HIGH)
    mp4 = rr.raw_robonet_tree(*ep, SAWYER_LOW, SAWYER_HIGH, encoding="mp4")
    raw = rr.raw_robonet_tree(*ep, SAWYER_LOW, SAWYER_HIGH, encoding="raw")
    monkeypatch.setattr(rr, "_HAS_CV2", False)
    for tree in (jpg, mp4):
        with pytest.raises(RuntimeError, match="requires OpenCV"):
            rr.load_camera_imgs(0, tree, rr.load_metadata_dict(tree), SMALL_HW)
    md = rr.load_metadata_dict(raw)
    np.testing.assert_array_equal(
        rr.load_camera_imgs(0, raw, md, SMALL_HW), ep[0][:, 0])
    with pytest.raises(RuntimeError, match="requires OpenCV"):
        rr.load_camera_imgs(0, raw, md, (24, 32))
    with pytest.raises(RuntimeError, match="requires OpenCV"):
        rr.raw_robonet_tree(*ep, SAWYER_LOW, SAWYER_HIGH)
    ds = thdf5.RoboNetHDF5Dataset(["sawyer_sudri0_c0/t.hdf5"],
                                  ["sawyer_sudri0_c0"], Config(**BASE),
                                  device="cpu", episodes=[raw])
    with pytest.raises(RuntimeError, match="requires OpenCV"):
        ds[0]  # raw frames at 48x64, decoded to 64x85: a resize


# --------------------------------------------------------------- converter
def test_convert_raw_robonet_and_cli_equal_jax(tmp_path, capsys):
    """The converter (masks rendered on the CPU here) and its CLI against
    JAX's on the same raw files: every dataset and attribute of each
    written file equal, for a sawyer view (chain) and for locobot_c0 (the
    kernel's plain version); converted_tree of a tree equals the file."""
    for view, robot in (("sawyer_sudri0_c0", "sawyer"), ("locobot_c0", "locobot")):
        src = tmp_path / "raw" / view
        eps = [_ep(50 + i, robot=robot) for i in range(2)]
        for i, e in enumerate(eps):
            _write(src / f"traj{i}.hdf5", e, robot=robot)
        jout, tout, cout = (str(tmp_path / x / view) for x in ("j", "t", "c"))
        want = jrr.convert_raw_robonet(str(src), jout, view)
        got = rr.convert_raw_robonet(str(src), tout, view, device="cpu")
        assert [os.path.basename(p) for p in got] == \
            [os.path.basename(p) for p in want] == ["traj0_c0.hdf5", "traj1_c0.hdf5"]
        rr.main(["--robonet_dir", str(src), "--out", cout, "--viewpoint", view,
                 "--device", "cpu"])
        assert f"wrote 2 trajectories to {cout}" in capsys.readouterr().out
        env = tchain.get_mask_env(robot, image_size=(64, 85), camera_key=view,
                                  device="cpu")
        for i, w in enumerate(want):
            tree = rr.raw_robonet_tree(*eps[i], SAWYER_LOW, SAWYER_HIGH,
                                       robot=robot)
            mem = rr.converted_tree(tree, rr.load_metadata_dict(tree), env,
                                    rr.LoaderParams(img_size=(64, 85)), 0,
                                    robot, f"traj{i}.hdf5")
            with h5py.File(w, "r") as jf:
                assert jf["mask"].dtype == np.bool_ and jf["mask"][()].any()
                for p in (got[i], os.path.join(cout, os.path.basename(w))):
                    with h5py.File(p, "r") as tf:
                        assert list(tf.keys()) == list(jf.keys())
                        _equal(dict(tf.attrs.items()), dict(jf.attrs.items()))
                        for k in jf.keys():
                            _equal(tf[k][()], jf[k][()], k)
                assert list(mem.keys()) == list(jf.keys())
                _equal(dict(mem.attrs.items()), dict(jf.attrs.items()))
                for k in jf.keys():
                    _equal(mem[k][()], jf[k][()], k)


# ----------------------------------------------------------------- records
def _split(loaders):
    return [list(ld.dataset.file_paths if hasattr(ld.dataset, "file_paths")
                 else ld.dataset._traj_names) for ld in loaders]


def _layout_files(root, trees):
    for path, _, tree in trees:
        rr.write_tree(path, tree)
    return root


def test_raw_records_equal_and_split_as_the_hdf5_route(tmp_path):
    """Raw trees of the sawyer multiview layout (3 + 2 train-view
    trajectories, 1 of the held-out sudri2_c1 view, 2 locobot) written as
    record shards through the reader (write_training_records) equal the
    shards JAX's convert_to_records makes of the same trees as files, bit
    for bit; and the record loaders of train_sawyer_multiview put the
    same episodes into train, test and transfer, with the same batch
    sizes, seeds and options, as the port's and JAX's HDF5 loaders over
    those files."""
    root = str(tmp_path / "data")
    trees = raw_trees(root, T=T, hw=SMALL_HW, seed=3)
    _layout_files(root, trees)
    kw = dict(BASE, video_length=T, data_root=root,
              experiment="train_sawyer_multiview", batch_size=2,
              test_batch_size=2, data_threads=1)
    cfg, jcfg = Config(**kw), JConfig(**kw)
    rec = str(tmp_path / "records")
    write_training_records([(p, t) for p, _, t in trees], rec, cfg,
                           viewpoint=[v for _, v, _ in trees],
                           episodes_per_shard=3, device="cpu")
    want_rec = str(tmp_path / "jrecords")
    jrecords.convert_to_records(jcfg, [p for p, _, _ in trees],
                                [v for _, v, _ in trees], want_rec,
                                episodes_per_shard=3)
    assert shards_equal(rec, want_rec)
    want = _split(jloader.create_sawyer_loaders(jcfg))
    hdf5 = tloader.create_sawyer_loaders(cfg, device="cpu")
    got = records.create_record_loaders(cfg, rec)
    assert _split(hdf5) == want == _split(got)
    assert [len(w) for w in want] == [4, 1]
    for g, h in zip(got, hdf5):
        assert (g.batch_size, g.seed, g.shuffle, g.drop_last, g.num_workers) \
            == (h.batch_size, h.seed, h.shuffle, h.drop_last, h.num_workers)
    jt = jloader.create_sawyer_transfer_loader(jcfg)
    tt = records.create_record_transfer_loader(cfg, rec)
    assert _split([tt]) == _split([jt]) == [[trees[5][0]]]
    assert (tt.batch_size, tt.seed, tt.shuffle, tt.drop_last) == \
        (jt.batch_size, jt.seed, jt.shuffle, jt.drop_last)
    assert records.create_record_transfer_loader(
        cfg.replace(experiment="train_locobot_pick"), rec) is None
    with pytest.raises(ValueError, match="head-split"):
        records.create_record_loaders(cfg.replace(experiment="train_robonet"),
                                      rec)


def test_trainer_trains_on_raw_records(tmp_path):
    """train_sawyer_multiview on record shards of raw trees (the card's
    route, no h5py needed) at a small size: it trains an epoch, evaluates
    on test and on the held-out transfer view, and logs finite losses."""
    import json

    root = str(tmp_path / "data")
    trees = raw_trees(root, T=T, hw=SMALL_HW, seed=4, layout=RAW_LAYOUT[:3])
    cfg = Config(**dict(RAW_TRAIN, model="det", g_dim=8, image_height=16,
                        image_width=16, batch_size=2, test_batch_size=1,
                        niter=1, epoch_size=1, n_past=1, n_future=2, n_eval=3,
                        video_length=T, checkpoint_interval=1, eval_interval=1,
                        compute_dtype="float32", data_threads=1,
                        log_dir=str(tmp_path / "log"), jobname="raw"))
    rec = str(tmp_path / "records")
    write_training_records([(p, t) for p, _, t in trees], rec, cfg,
                           viewpoint=[v for _, v, _ in trees], device="cpu")
    tr = PredictionTrainer(cfg, device="cpu", record_dir=rec)
    tr.train()
    assert tr.transfer_loader is not None
    with open(os.path.join(tr.log_dir, "metrics.jsonl")) as f:
        rows = [json.loads(line) for line in f if line.strip()]
    losses = [r[k] for r in rows for k in r if k.endswith("recon_loss")]
    assert losses and all(np.isfinite(v) for v in losses)
    assert any(k.startswith("transfer/") for r in rows for k in r)
