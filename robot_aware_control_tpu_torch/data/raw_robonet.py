"""Raw public-RoboNet ingestion: mp4/jpg-in-HDF5 decode, metadata, convert
(counterpart of `robot_aware_control_tpu/data/raw_robonet.py`; reference:
robonet/robonet/datasets/util/hdf5_loader.py:25-187,
util/metadata_helper.py:84-172, src/dataset/collect_mask_data.py:154-192).

The public RoboNet release stores each trajectory as an HDF5 file with
video-encoded frames under `env/cam{i}_video` (an mp4 byte stream or one
jpg dataset a frame), actions under `policy/actions`, `misc` datasets and
`metadata` attrs.

  * `load_metadata` / `load_metadata_dict`: the metadata table, plain
    Python (no pandas) with the JAX table's API, and its own cache file
    (`meta_data_rows.pkl`; the JAX package's pandas `meta_data.pkl` is
    never read, removed or written).
  * `load_camera_imgs` / `load_states` / `load_actions` / `load_qpos` /
    `load_annotations` / `load_data`: one trajectory decoded (mp4 through
    OpenCV's ffmpeg, jpg through imdecode, raw passed through) with the
    release loader's mismatch flags, autograsp imputation, RGB/BGR order
    and INTER_AREA/INTER_CUBIC choice. Without cv2 the decode and the
    resize raise: there is no nearest-pixel stand-in.
  * `raw_robonet_tree`: a trajectory in the raw layout held in memory as a
    `TreeGroup` of `TreeDataset`s with `attrs`, which reads as h5py reads
    the file `write_raw_robonet_hdf5` writes from it. Every reader here
    takes an h5py file or such a tree, so a machine without h5py reads the
    layout too (data/robonet_hdf5.py, data/records.py).
  * `convert_raw_robonet` / `main`: raw files -> the preprocessed layout
    (frames, mask, states, actions, qpos, bounds and attrs), the masks
    rendered on `--device` (the GPU unless `--device cpu`) by the measured
    kinematic-chain renderer, or the capsule-mask kernel for locobot.
"""

from __future__ import annotations

import glob
import gzip
import hashlib
import io
import os
import pickle
import random
import re
import tempfile
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except ImportError:
    _HAS_CV2 = False


class ACTION_MISMATCH:
    """(reference: hdf5_loader.py:13-16)"""

    ERROR = 0
    PAD_ZERO = 1
    CLEAVE = 2


class STATE_MISMATCH:
    """(reference: hdf5_loader.py:19-22)"""

    ERROR = 0
    PAD_ZERO = 1
    CLEAVE = 2


@dataclass
class LoaderParams:
    """Default hparams of the reference loader (hdf5_loader.py:25-37)."""

    target_adim: int = 5
    target_sdim: int = 5
    state_mismatch: int = STATE_MISMATCH.ERROR
    action_mismatch: int = ACTION_MISMATCH.ERROR
    img_size: Tuple[int, int] = (48, 64)  # (height, width)
    cams_to_load: Sequence[int] = field(default_factory=lambda: [0])
    impute_autograsp_action: bool = True
    load_annotations: bool = False
    zero_if_missing_annotation: bool = False
    load_T: int = 0
    check_sha256: bool = True


def _require_cv2(what: str):
    if not _HAS_CV2:
        raise RuntimeError(f"{what} requires OpenCV (cv2), which is not "
                           "installed")


# ---------------------------------------------------------------------------
# the layout in memory


def _as_read(value):
    """An attribute value as h5py reads it back: str and bytes as they
    are, numbers and arrays as numpy scalars and arrays."""
    if isinstance(value, (str, bytes)):
        return value
    a = np.asarray(value)
    return a[()] if a.ndim == 0 else a


class TreeAttrs(dict):
    """A node's attributes: values stored as h5py reads them back, names in
    h5py's order (by name)."""

    def __setitem__(self, key, value):
        super().__setitem__(key, _as_read(value))

    def keys(self):
        return sorted(super().keys())

    def items(self):
        return [(k, self[k]) for k in self.keys()]


class TreeDataset:
    """An HDF5 dataset in memory. `data` is what the writer passes to
    `create_dataset`; reads give fresh arrays, and `[()]` of a string the
    bytes h5py gives."""

    def __init__(self, data):
        self.data = data if isinstance(data, str) else np.asarray(data)
        self.attrs = TreeAttrs()

    @property
    def shape(self):
        return () if isinstance(self.data, str) else self.data.shape

    def __getitem__(self, index):
        if isinstance(self.data, str):
            if index != ():
                raise IndexError(f"scalar string dataset read with {index!r}")
            return self.data.encode()
        out = self.data[index]
        return out.copy() if isinstance(out, np.ndarray) else out

    def __array__(self, dtype=None, copy=None):
        return np.array(self.data, dtype=dtype)


class TreeGroup:
    """An HDF5 group in memory: members by name (paths with "/" reach
    into subgroups), listed in h5py's order (by name), and `attrs`."""

    def __init__(self):
        self._members: Dict[str, Union["TreeGroup", TreeDataset]] = {}
        self.attrs = TreeAttrs()

    def create_group(self, name: str) -> "TreeGroup":
        self._members[name] = TreeGroup()
        return self._members[name]

    def create_dataset(self, name: str, data) -> TreeDataset:
        self._members[name] = TreeDataset(data)
        return self._members[name]

    def _walk(self, path: str):
        node = self
        for part in path.split("/"):
            if not isinstance(node, TreeGroup) or part not in node._members:
                raise KeyError(path)
            node = node._members[part]
        return node

    def __getitem__(self, path: str):
        return self._walk(path)

    def __contains__(self, path: str) -> bool:
        try:
            self._walk(path)
        except KeyError:
            return False
        return True

    def keys(self):
        return sorted(self._members)

    def __len__(self):
        return len(self._members)


def _is_group(node) -> bool:
    """An h5py group or a TreeGroup (datasets of either have no keys)."""
    return hasattr(node, "keys")


def write_tree(path: str, tree: TreeGroup, compression: Optional[str] = None):
    """Writes a tree to an HDF5 file, member for member (h5py imported
    here; ImportError naming it where it is missing)."""
    from robot_aware_control_tpu_torch.data.demo_io import require_h5py

    h5py = require_h5py()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)

    def put(dst, src):
        for k, v in src.attrs.items():
            dst.attrs[k] = v
        for name in src._members:  # in creation order, as the writers make them
            node = src._members[name]
            if isinstance(node, TreeGroup):
                put(dst.create_group(name), node)
            else:
                kw = {} if compression is None or np.ndim(node.data) == 0 else {
                    "compression": compression}
                ds = dst.create_dataset(name, data=node.data, **kw)
                for k, v in node.attrs.items():
                    ds.attrs[k] = v

    with h5py.File(path, "w") as hf:
        put(hf, tree)
    return path


# ---------------------------------------------------------------------------
# schema canary


def is_raw_robonet(hf) -> bool:
    """True when the file (or tree) is in the public-RoboNet raw layout."""
    return "env" in hf and "policy" in hf


class RawSchemaError(Exception):
    """Raised when a file fails to parse as a raw public-RoboNet
    trajectory. Carries a tree diff (required paths that are absent, keys
    this loader does not know), so schema drift shows as a named list."""


# the layout this loader understands (metadata_helper.py:84-131,
# hdf5_loader.py:40-77 read exactly these paths)
_KNOWN_TOP_KEYS = {"env", "policy", "misc", "metadata", "file_version"}
_KNOWN_ENV_KEYS = {"state", "qpos", "low_bound", "high_bound",
                   "bbox_annotations", "finger_sensors", "obs_dict"}
_CAM_GROUP_RE = r"cam\d+_video"
_REQUIRED_PATHS = ("env", "env/state", "policy", "policy/actions")


def schema_report(hf) -> str:
    """Human-readable diff of one open file (or tree) against the raw
    layout: the required paths that are missing, and the keys unknown to
    this loader. Never raises."""
    missing = [p for p in _REQUIRED_PATHS if p not in hf]
    unknown: List[str] = [k for k in hf.keys() if k not in _KNOWN_TOP_KEYS]
    env = hf["env"] if "env" in hf else None
    if env is not None and not _is_group(env):
        missing.append(f"env is not a group (found {type(env).__name__})")
        env = None
    if env is not None:
        unknown += [f"env/{k}" for k in env.keys()
                    if k not in _KNOWN_ENV_KEYS
                    and not re.fullmatch(_CAM_GROUP_RE, k)]
        n_cams = int(env.attrs.get("n_cams", 0))
        cam_groups = [k for k in env.keys() if re.fullmatch(_CAM_GROUP_RE, k)]
        if n_cams and len(cam_groups) != n_cams:
            missing.append(f"env@n_cams says {n_cams} streams but "
                           f"{len(cam_groups)} cam*_video groups exist")
        elif not n_cams and not cam_groups:
            missing.append("env@n_cams attr (no camera streams declared)")
    if "policy" in hf:
        pol = hf["policy"]
        if _is_group(pol):
            unknown += [f"policy/{k}" for k in pol.keys() if k != "actions"]
        else:
            missing.append(f"policy is not a group (found {type(pol).__name__})")
    return "\n".join([
        "missing required: " + (", ".join(missing) if missing else "(none)"),
        "unknown keys: " + (", ".join(sorted(unknown)) if unknown else "(none)"),
    ])


# ---------------------------------------------------------------------------
# metadata (reference: metadata_helper.py:84-172)


def metadata_row(hf, name: str = "<in-memory tree>") -> Dict:
    """One open file's (or tree's) metadata row; a parse failure raises
    RawSchemaError with the layout diff."""
    try:
        return _metadata_row(hf)
    except (KeyError, IndexError, AttributeError, ValueError) as e:
        raise RawSchemaError(
            f"{name} does not parse as a raw public-RoboNet trajectory "
            f"({type(e).__name__}: {e}).\n" + schema_report(hf)) from e


def load_metadata_dict(source) -> Dict:
    """A trajectory's metadata row, with the fields of the reference helper
    (metadata_helper.py:84-131) and the `raw` frame encoding. `source` is a
    file path (the row then carries the file's sha256) or a tree."""
    if not isinstance(source, (str, os.PathLike)):
        return metadata_row(source)
    from robot_aware_control_tpu_torch.data.demo_io import require_h5py

    h5py = require_h5py()
    buf = _read_pinned(source, None)
    with h5py.File(io.BytesIO(buf), "r") as hf:
        md = metadata_row(hf, os.path.basename(source))
    md["sha256"] = hashlib.sha256(buf).hexdigest()
    return md


def _str(v):
    return v.decode() if isinstance(v, bytes) else v


def _metadata_row(hf) -> Dict:
    md: Dict = {"file_version": hf["file_version"][()] if "file_version" in hf
                else "unknown"}
    md["sdim"] = hf["env"]["state"].shape[1]
    md["state_T"] = hf["env"]["state"].shape[0]
    md["adim"] = hf["policy"]["actions"].shape[1]
    md["action_T"] = hf["policy"]["actions"].shape[0]

    n_cams = hf["env"].attrs.get("n_cams", 0)
    if n_cams:
        md["ncam"] = int(n_cams)
        enc = _str(hf["env"].attrs.get("cam_encoding", "jpg"))
        cam0 = hf["env"]["cam0_video"]
        if enc == "mp4":
            md["frame_dim"] = tuple(int(x) for x in
                                    cam0["frames"].attrs["shape"][:2])
            md["img_T"] = int(cam0["frames"].attrs["T"])
            md["img_encoding"] = "mp4"
            fmt = cam0["frames"].attrs["image_format"]
        elif enc == "raw":
            md["frame_dim"] = tuple(int(x) for x in cam0["frames"].shape[1:3])
            md["img_T"] = int(cam0["frames"].shape[0])
            md["img_encoding"] = "raw"
            fmt = cam0["frames"].attrs.get("image_format", "RGB")
        else:
            f0 = cam0["frame0"]
            md["frame_dim"] = tuple(int(x) for x in f0.attrs["shape"][:2])
            md["img_T"] = len(cam0)
            md["img_encoding"] = "jpg"
            fmt = f0.attrs["image_format"]
        md["image_format"] = _str(fmt)

    for group, derived in (("misc", False), ("metadata", True)):
        if group not in hf:
            continue
        items = (hf[group].attrs.items() if derived
                 else ((k, hf[group][k][()]) for k in hf[group].keys()))
        for k, v in items:
            if k in md:
                raise ValueError(f"{group}/{k} collides with a derived field")
            md[k] = _str(v) if derived else v
    for k in ("low_bound", "high_bound"):
        if k not in md and k in hf["env"]:
            md[k] = np.asarray(hf["env"][k][0])
    return md


_ABSENT = object()


class MetadataTable:
    """The metadata of many trajectories (reference MetaDataContainer,
    metadata_helper.py:13-81): one row (a dict) a file, in file-name order;
    the JAX table's API without pandas. `table[mask]` keeps the rows where
    a sequence of booleans is true; `column(key)` gives one field of every
    row (None where a row lacks it), to build such masks."""

    def __init__(self, base_path: str, names: Sequence[str],
                 rows: Sequence[Dict],
                 file_paths: Optional[Dict[str, str]] = None):
        self._base_path = base_path
        self._names = list(names)
        self._rows = list(rows)
        # basename -> full path, so explicit file lists (no common base
        # dir) keep their real locations
        self._file_paths = file_paths or {}

    @property
    def files(self) -> List[str]:
        return [self._file_paths.get(f, os.path.join(self._base_path, f))
                for f in self._names]

    def get_file_metadata(self, fname: str) -> Dict:
        return self._rows[self._names.index(os.path.basename(fname))]

    def column(self, key: str) -> list:
        return [row.get(key) for row in self._rows]

    def select_objects(self, obj_class_name):
        """Select by object class: a single name matches any trajectory
        containing it; a list matches the exact class set. Class lists may
        be stored as real lists or comma-joined attr strings."""

        def classes(x):
            return x.split(",") if isinstance(x, str) else list(x)

        col = self.column("object_classes")
        if isinstance(obj_class_name, str):
            return self[[obj_class_name in classes(x) for x in col]]
        return self[[set(obj_class_name) == set(classes(x)) for x in col]]

    def get_shuffled_files(self, rng: Optional[random.Random] = None) -> List[str]:
        files = self.files
        (rng or random).shuffle(files)
        return files

    def __getitem__(self, mask):
        mask = [bool(m) for m in mask]
        if len(mask) != len(self._rows):
            raise ValueError(f"a mask of {len(mask)} for {len(self._rows)} rows")
        keep = [i for i, m in enumerate(mask) if m]
        return MetadataTable(self._base_path, [self._names[i] for i in keep],
                             [self._rows[i] for i in keep], self._file_paths)

    def keys(self) -> List[str]:
        """Every field of any row, in the order first seen (pandas' column
        order for the same rows)."""
        out: Dict[str, None] = {}
        for row in self._rows:
            out.update(dict.fromkeys(row))
        return list(out)

    def __contains__(self, item):
        return item in self.keys()

    def __len__(self):
        return len(self._rows)


CACHE_NAME = "meta_data_rows.pkl"


def load_metadata(files: Union[str, Sequence[str]], cache: bool = True
                  ) -> MetadataTable:
    """The metadata table of a directory or an explicit file list
    (reference: metadata_helper.py:133-172). A directory's table is cached
    in its `meta_data_rows.pkl` (gzip-compressed pickle of the rows this
    function wrote), rebuilt when the directory's files change."""
    if isinstance(files, str):
        base_path = os.path.expanduser(files)
        flist = sorted(glob.glob(os.path.join(base_path, "*.hdf5")))
        if not flist:
            raise ValueError(f"no hdf5 files found in {base_path}!")
        pkl = os.path.join(base_path, CACHE_NAME)
        names = [os.path.basename(f) for f in flist]
        if cache and os.path.exists(pkl):
            with gzip.open(pkl, "rb") as f:
                cached_names, rows = pickle.load(f)
            if set(cached_names) == set(names):
                return MetadataTable(base_path, cached_names, rows)
            os.remove(pkl)
    else:
        base_path = ""
        flist = sorted(files)
        pkl = None
    names = [os.path.basename(f) for f in flist]
    rows = [load_metadata_dict(f) for f in flist]
    if pkl is not None and cache:
        with gzip.open(pkl, "wb") as f:
            pickle.dump((names, rows), f)
    return MetadataTable(base_path, names, rows, dict(zip(names, flist)))


# ---------------------------------------------------------------------------
# per-trajectory decode (behavioural spec: hdf5_loader.py:40-187)


def _decode_mp4(byte_array: np.ndarray) -> List[np.ndarray]:
    """mp4 byte stream -> list of RGB frames. OpenCV's VideoCapture reads
    from paths only, so the stream round-trips through a temp file."""
    _require_cv2("mp4-encoded RoboNet files")
    fd, path = tempfile.mkstemp(suffix=".mp4")
    try:
        with os.fdopen(fd, "wb") as f:
            f.write(np.asarray(byte_array).tobytes())
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame[:, :, ::-1].copy())  # BGR -> RGB
        cap.release()
    finally:
        os.remove(path)
    return frames


def _materialize_frames(cam_group, encoding: str, start: int,
                        count: int) -> List[np.ndarray]:
    """`count` decoded frames from `start` of one camera group, whatever
    its encoding. mp4 decodes the whole stream and slices; jpg and raw
    read only the window."""
    if encoding == "mp4":
        return _decode_mp4(np.asarray(cam_group["frames"]))[start:start + count]
    if encoding == "jpg":
        _require_cv2("jpg-encoded RoboNet files")
        return [cv2.imdecode(np.asarray(cam_group[f"frame{t}"]),
                             cv2.IMREAD_COLOR)[:, :, ::-1]
                for t in range(start, start + count)]
    if encoding == "raw":
        return list(np.asarray(cam_group["frames"][start:start + count]))
    raise ValueError(
        f"unknown frame encoding {encoding!r} (expected mp4, jpg or raw)")


def _resize_frame(img: np.ndarray, src_hw: Tuple[int, int],
                  dst_hw: Tuple[int, int]) -> np.ndarray:
    """cv2 resize with INTER_AREA when shrinking, INTER_CUBIC when growing
    (the release loader's rule, hdf5_loader.py:52-54). Without cv2 it
    raises: another resize would be another image."""
    if src_hw == dst_hw:
        return img
    _require_cv2("resizing RoboNet frames")
    dst_h, dst_w = dst_hw
    shrinking = dst_h * dst_w < src_hw[0] * src_hw[1]
    interp = cv2.INTER_AREA if shrinking else cv2.INTER_CUBIC
    return cv2.resize(img, (dst_w, dst_h), interpolation=interp)


def load_camera_imgs(cam_index: int, hf, file_metadata,
                     target_dims: Tuple[int, int], start_time: int = 0,
                     n_load: Optional[int] = None) -> np.ndarray:
    """One camera's frames as uint8 (T, H, W, 3) at `target_dims`, in RGB
    order whatever the stored order."""
    src_hw = tuple(int(x) for x in file_metadata["frame_dim"])
    if n_load is None:
        n_load = int(file_metadata["img_T"])
    group = hf["env"][f"cam{cam_index}_video"]
    frames = _materialize_frames(group, file_metadata["img_encoding"],
                                 start_time, n_load)
    images = np.stack(
        [_resize_frame(f, src_hw, tuple(target_dims)) for f in frames]
    ).astype(np.uint8, copy=False)
    stored_order = file_metadata["image_format"]
    if stored_order == "RGB":
        return images
    if stored_order == "BGR":
        return images[:, :, :, ::-1]
    raise NotImplementedError(f"channel order {stored_order!r}")


def _fit_feature_width(arr: np.ndarray, target: int, policy: int,
                       label: str) -> np.ndarray:
    """A (T, D) array's width fitted to the loader target under `policy`, a
    bitmask of the MISMATCH flags: PAD_ZERO appends zero columns, CLEAVE
    drops trailing ones, ERROR refuses both (hdf5_loader.py:80-133)."""
    width = arr.shape[1]
    if width == target:
        return arr
    if width < target and policy & STATE_MISMATCH.PAD_ZERO:
        fill = np.zeros((arr.shape[0], target - width), dtype=np.float32)
        return np.concatenate((arr, fill), axis=-1)
    if width > target and policy & STATE_MISMATCH.CLEAVE:
        return arr[:, :target]
    raise ValueError(
        f"cannot reconcile {label} width {width} with target {target}: "
        f"mismatch policy {policy} permits neither padding nor cleaving")


def load_states(hf, md, params: LoaderParams) -> np.ndarray:
    """eef states (T, sdim) fitted to `target_sdim` (hdf5_loader.py:80-95)."""
    return _fit_feature_width(np.asarray(hf["env"]["state"]),
                              params.target_sdim, params.state_mismatch,
                              "state")


def load_qpos(hf, md=None, params=None) -> np.ndarray:
    """Joint positions, unfitted (hdf5_loader.py:98-100)."""
    return np.asarray(hf["env"]["qpos"])


def _autograsp_grip_commands(hf, md) -> np.ndarray:
    """The (T-1, 1) gripper command column of an `autograsp` trajectory:
    at t, whichever workspace bound the next gripper state lies past the
    midpoint of (the bounds' gripper entries)."""
    grip_next = np.asarray(hf["env"]["state"])[1:, -1]
    hi = np.asarray(md["high_bound"])[-1]
    lo = np.asarray(md["low_bound"])[-1]
    return np.where(grip_next > (hi + lo) / 2.0, hi, lo)[:, None]


def load_actions(hf, md, params: LoaderParams) -> np.ndarray:
    """Actions (T-1, adim) fitted to `target_adim`. A file one column short
    whose policy is `autograsp` gets the imputed gripper command appended
    (hdf5_loader.py:103-133); anything else goes through the mismatch
    policy."""
    actions = np.asarray(hf["policy"]["actions"])
    impute = (params.impute_autograsp_action
              and params.target_adim == actions.shape[1] + 1
              and md["primitives"] == "autograsp")
    if impute:
        return np.concatenate((actions, _autograsp_grip_commands(hf, md)),
                              axis=-1)
    return _fit_feature_width(actions, params.target_adim,
                              params.action_mismatch, "action")


def load_annotations(hf, md, params: LoaderParams,
                     cams_to_load: Sequence[int]) -> np.ndarray:
    """Object bbox annotations -> one-hot centre maps a (frame, camera,
    object) at the target resolution, with the reference's truncating
    centre arithmetic (hdf5_loader.py:136-154)."""
    n_frames = int(md["img_T"])
    tgt_h, tgt_w = params.img_size
    maps = np.zeros((n_frames, len(cams_to_load), tgt_h, tgt_w, 2),
                    dtype=np.float32)
    if not md.get("contains_annotation", False):
        if params.zero_if_missing_annotation:
            return maps
        raise AssertionError("trajectory carries no bbox annotations "
                             "(set zero_if_missing_annotation to tolerate this)")
    boxes = np.asarray(hf["env"]["bbox_annotations"]).astype(np.int32)
    boxes = boxes[:n_frames, list(cams_to_load)]  # (T, cam, obj, corner, hw)
    src_h, src_w = (int(x) for x in md["frame_dim"])
    scale = np.array([tgt_h / float(src_h), tgt_w / float(src_w)])
    # per-corner rescale, then the corners' midpoint truncated toward zero:
    # the reference's int((h1 + h2) / 2)
    centers = np.trunc((boxes * scale - 1.0).mean(axis=3)).astype(np.int64)
    tt, cc, oo = np.indices(centers.shape[:3])
    maps[tt, cc, centers[..., 0], centers[..., 1], oo] = 1.0
    return maps


def _read_pinned(f_name: str, expect_sha: Optional[str]) -> bytes:
    """The trajectory file's bytes; with a checksum, held to the metadata
    row's."""
    if not os.path.isfile(f_name):
        raise IOError(f"no such trajectory file: {f_name}")
    with open(f_name, "rb") as f:
        buf = f.read()
    if expect_sha is not None and hashlib.sha256(buf).hexdigest() != expect_sha:
        raise ValueError(
            f"checksum drift on {os.path.basename(f_name)}: the file no "
            f"longer matches its metadata row; rebuild the cache")
    return buf


def _snippet_window(md, load_T: int, rng: random.Random) -> Tuple[int, int]:
    """(start, length) of the window to load, bounded by the shortest
    aligned stream (states, frames, actions + 1); a `load_T` shorter than
    that draws the start uniformly, end inclusive (hdf5_loader.py:167-171)."""
    usable = min(int(md["state_T"]), int(md["img_T"]),
                 int(md["action_T"]) + 1)
    if usable <= 1:
        raise ValueError(f"trajectory too short to use: {usable} aligned steps")
    if 1 < load_T < usable:
        return rng.randint(0, usable - load_T), load_T
    return 0, usable


def load_data(source, file_metadata, params: LoaderParams, rng=None):
    """One trajectory -> (images (T, ncam, H, W, 3), actions, states, qpos
    [, annotations]). `source` is a file path (its bytes checked against
    the row's sha256 under `check_sha256`), an open h5py file or a tree;
    `rng` seeds the snippet draw (hdf5_loader.py:157-187)."""
    rng = random.Random(rng)
    if isinstance(source, (str, os.PathLike)):
        from robot_aware_control_tpu_torch.data.demo_io import require_h5py

        h5py = require_h5py()
        sha = file_metadata["sha256"] if params.check_sha256 else None
        with h5py.File(io.BytesIO(_read_pinned(source, sha)), "r") as hf:
            return _load_open(hf, file_metadata, params, rng)
    if params.check_sha256:
        raise ValueError("check_sha256 needs a file's bytes; an open file or "
                         "a tree is read with check_sha256=False")
    return _load_open(source, file_metadata, params, rng)


def _load_open(hf, file_metadata, params: LoaderParams, rng: random.Random):
    t0, n_steps = _snippet_window(file_metadata, params.load_T, rng)
    ncam = int(file_metadata["ncam"])
    bad_cams = [c for c in params.cams_to_load if not 0 <= c < ncam]
    if bad_cams:
        raise IndexError(f"camera indices {bad_cams} outside the file's "
                         f"{ncam} streams")
    images = np.stack(
        [load_camera_imgs(c, hf, file_metadata, params.img_size, t0, n_steps)
         for c in params.cams_to_load], axis=1)  # (T, ncam_sel, H, W, 3)
    actions = load_actions(hf, file_metadata, params)
    actions = actions.astype(np.float32)[t0:t0 + n_steps - 1]
    states = load_states(hf, file_metadata, params)
    states = states.astype(np.float32)[t0:t0 + n_steps]
    qpos = load_qpos(hf).astype(np.float32)[t0:t0 + n_steps]
    if params.load_annotations:
        annot = load_annotations(hf, file_metadata, params, params.cams_to_load)
        return images, actions, states, qpos, annot[t0:t0 + n_steps]
    return images, actions, states, qpos


# ---------------------------------------------------------------------------
# writer: the raw public-RoboNet layout, in memory or as a file


def _encode_jpg(frame: np.ndarray) -> np.ndarray:
    ok, enc = cv2.imencode(".jpg", frame)
    if not ok:
        raise RuntimeError("cv2.imencode could not encode a jpg")
    return enc.ravel()


def _encode_mp4(frames: np.ndarray) -> np.ndarray:
    """(T, H, W, 3) BGR uint8 frames -> the mp4v byte stream OpenCV's
    VideoWriter makes of them."""
    T, H, W, _ = frames.shape
    fd, tmp = tempfile.mkstemp(suffix=".mp4")
    os.close(fd)
    try:
        vw = cv2.VideoWriter(tmp, cv2.VideoWriter_fourcc(*"mp4v"), 10.0, (W, H))
        if not vw.isOpened():
            raise RuntimeError("OpenCV's mp4 encoder is unavailable")
        for frame in frames:
            vw.write(frame)
        vw.release()
        with open(tmp, "rb") as f:
            return np.frombuffer(f.read(), np.uint8)
    finally:
        os.remove(tmp)


def raw_robonet_tree(
    images: np.ndarray,  # (T, H, W, 3) uint8 RGB, or (T, ncam, H, W, 3)
    states: np.ndarray,
    actions: np.ndarray,
    qpos: np.ndarray,
    low_bound: np.ndarray,
    high_bound: np.ndarray,
    robot: str = "sawyer",
    encoding: str = "jpg",
    image_format: str = "RGB",
    primitives: str = "autograsp",
    camera_configuration: str = "sudri0",
    object_classes: Sequence[str] = ("toys",),
    extra_metadata: Optional[Dict] = None,
) -> TreeGroup:
    """A trajectory in the public-RoboNet raw layout (the format
    metadata_helper.py:84-131 and hdf5_loader.py:40-77 read), in memory:
    env group with one encoded video a camera, state, qpos and bounds;
    policy/actions; an empty misc group; metadata attrs."""
    images = np.asarray(images, np.uint8)
    if images.ndim == 4:
        images = images[:, None]
    T, ncam, H, W, _ = images.shape
    if encoding not in ("jpg", "mp4", "raw"):
        raise ValueError(encoding)
    if encoding != "raw":
        _require_cv2(f"{encoding}-encoding RoboNet frames")
    low_bound = np.asarray(low_bound, np.float32)
    high_bound = np.asarray(high_bound, np.float32)
    tree = TreeGroup()
    tree.create_dataset("file_version", data="0.1.0")
    env = tree.create_group("env")
    env.attrs["n_cams"] = ncam
    env.attrs["cam_encoding"] = encoding
    for c in range(ncam):
        grp = env.create_group(f"cam{c}_video")
        # frames in the labelled channel order (the input is true RGB);
        # the encoders take BGR, so that an RGB-order decode gives
        # `image_format`-order pixels
        if encoding == "jpg":
            for t in range(T):
                frame = images[t, c]
                ds = grp.create_dataset(f"frame{t}", data=_encode_jpg(
                    frame[:, :, ::-1] if image_format == "RGB" else frame))
                ds.attrs["shape"] = np.array([H, W, 3])
                ds.attrs["image_format"] = image_format
            continue
        if encoding == "mp4":
            frames = images[:, c]
            ds = grp.create_dataset("frames", data=_encode_mp4(
                frames[..., ::-1] if image_format == "RGB" else frames))
        else:
            ds = grp.create_dataset(
                "frames", data=(images[:, c, :, :, ::-1]
                                if image_format == "BGR" else images[:, c]))
        ds.attrs["shape"] = np.array([H, W, 3])
        ds.attrs["T"] = T
        ds.attrs["image_format"] = image_format
    env.create_dataset("state", data=np.asarray(states, np.float32))
    env.create_dataset("qpos", data=np.asarray(qpos, np.float32))
    env.create_dataset("low_bound",
                       data=np.tile(low_bound, (T, 1)).astype(np.float32))
    env.create_dataset("high_bound",
                       data=np.tile(high_bound, (T, 1)).astype(np.float32))
    tree.create_group("policy").create_dataset(
        "actions", data=np.asarray(actions, np.float32))
    tree.create_group("misc")  # present but empty, like many release files
    meta = tree.create_group("metadata")
    meta.attrs["robot"] = robot
    meta.attrs["primitives"] = primitives
    meta.attrs["camera_configuration"] = camera_configuration
    meta.attrs["object_classes"] = ",".join(object_classes)
    meta.attrs["action_space"] = "x,y,z,theta,grasp"
    for k, v in (extra_metadata or {}).items():
        meta.attrs[k] = v
    return tree


def write_raw_robonet_hdf5(path: str, *args, **kwargs) -> str:
    """Writes `raw_robonet_tree(*args, **kwargs)` to an HDF5 file."""
    return write_tree(path, raw_robonet_tree(*args, **kwargs))


# ---------------------------------------------------------------------------
# raw -> preprocessed converter (reference: collect_mask_data.py:154-192)


def converted_tree(hf, md, env, params: LoaderParams, cam_index: int,
                   robot: str, traj_name: str) -> TreeGroup:
    """One raw trajectory (an open file or a tree, its metadata row `md`)
    in the preprocessed layout the trainer reads: frames of camera
    `cam_index` at params.img_size, masks rendered by the mask env `env`
    from the file's qpos, states and actions fitted by `params`, the last
    rows of the bounds, and the attrs cam_idx, robot and traj_name."""
    qpos = load_qpos(hf)
    low_bound = np.asarray(hf["env"]["low_bound"][-1])
    high_bound = np.asarray(hf["env"]["high_bound"][-1])
    actions = load_actions(hf, md, params)
    states = load_states(hf, md, params)
    images = load_camera_imgs(cam_index, hf, md, params.img_size)
    masks = np.asarray(env.generate_masks(qpos)).astype(bool)
    if masks.ndim == 4:
        masks = masks[..., 0]
    out = TreeGroup()
    out.create_dataset("mask", data=masks)
    out.attrs["cam_idx"] = cam_index
    out.attrs["robot"] = robot
    out.attrs["traj_name"] = traj_name
    for k, v in (("low_bound", low_bound), ("high_bound", high_bound),
                 ("states", states), ("actions", actions), ("frames", images),
                 ("qpos", qpos)):
        out.create_dataset(k, data=v)
    return out


def convert_raw_robonet(
    files: Union[str, Sequence[str]],
    target_dir: str,
    viewpoint_key: str,
    cam_index: int = 0,
    image_size: Tuple[int, int] = (64, 85),  # (H, W), reference target_dims
    params: Optional[LoaderParams] = None,
    thick: bool = False,
    device="cuda",
) -> List[str]:
    """Decodes raw trajectories, renders their robot masks on `device` with
    the mask env of `viewpoint_key` (a calibration key such as
    "sawyer_sudri0_c0": it picks the robot and the camera extrinsics), and
    writes each as `<name>_c<cam_index>.hdf5` in the preprocessed layout
    (gzip-compressed datasets). Returns the written paths."""
    from robot_aware_control_tpu_torch.data.demo_io import require_h5py
    from robot_aware_control_tpu_torch.robot.kinematic_chain import get_mask_env

    h5py = require_h5py()
    md_table = load_metadata(files)
    params = params or LoaderParams(img_size=image_size,
                                    cams_to_load=[cam_index])
    robot = viewpoint_key.split("_")[0]
    env = get_mask_env(robot, image_size=image_size, camera_key=viewpoint_key,
                       thick=thick, device=device)
    os.makedirs(target_dir, exist_ok=True)
    written = []
    for f_name in md_table.files:
        md = md_table.get_file_metadata(f_name)
        with h5py.File(f_name, "r") as hf:
            out = converted_tree(hf, md, env, params, cam_index, robot,
                                 os.path.basename(f_name))
        parts = os.path.basename(f_name).split(".")
        parts[-2] += f"_c{cam_index}"
        out_path = os.path.join(target_dir, ".".join(parts))
        written.append(write_tree(out_path, out, compression="gzip"))
    return written


def main(argv: Optional[Sequence[str]] = None):
    """CLI of the raw -> preprocessed converter; the masks render on the
    GPU unless --device cpu:

        python -m robot_aware_control_tpu_torch.data.raw_robonet \\
            --robonet_dir /path/to/robonet/hdf5 --out data/robonet_pre \\
            --viewpoint sawyer_sudri0_c0 [--cam_index 0] [--thick] \\
            [--device cpu]
    """
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--robonet_dir", required=True,
                    help="directory of public-RoboNet hdf5 trajectories")
    ap.add_argument("--out", required=True,
                    help="target directory for the preprocessed layout")
    ap.add_argument("--viewpoint", required=True,
                    help="calibration key, e.g. sawyer_sudri0_c0: picks "
                         "the robot chain and the camera extrinsics")
    ap.add_argument("--cam_index", type=int, default=0)
    ap.add_argument("--image_size", type=int, nargs=2, default=(64, 85),
                    metavar=("H", "W"))
    ap.add_argument("--thick", action="store_true",
                    help="render dilated planner masks")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback")
    args = ap.parse_args(argv)
    written = convert_raw_robonet(
        args.robonet_dir, args.out, args.viewpoint,
        cam_index=args.cam_index, image_size=tuple(args.image_size),
        thick=args.thick, device=args.device)
    print(f"wrote {len(written)} trajectories to {args.out}")


if __name__ == "__main__":
    main()
