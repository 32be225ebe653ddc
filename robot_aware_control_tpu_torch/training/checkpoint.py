"""Checkpoints with auto-resume: the `ckpt_<step>.npz` contract of
`robot_aware_control_tpu/training/checkpoint.py:51-139` (reference:
src/prediction/trainer.py:829-897).

A checkpoint is one .npz of named flat trees, each a {keystr: array} dict
in the JAX package's layouts (`convert.py`), stored under
`<tree>|<keystr>` with the step under `__step__`, so that a file written
by either package loads in the other. `latest_checkpoint` finds the
newest `ckpt_<step>` of a log dir; `load_checkpoint` restores the named
trees a caller asks for (a finetune load leaves out "opt"). Files are read
without pickle. The JAX package's orbax directories (sharded checkpoints)
are not read here.
"""

from __future__ import annotations

import os
import re
import threading
from typing import Dict, Optional, Tuple

import numpy as np

_WRITERS: list = []
_ERRORS: list = []
_WRITERS_LOCK = threading.Lock()
_WRITE_SERIAL = threading.Lock()


def save_checkpoint(log_dir: str, step: int, trees: Dict[str, dict],
                    background: bool = False) -> str:
    """trees: named flat trees, e.g. {"params": {keystr: array}, "bn": ...,
    "opt": ...}, host numpy arrays. background=True writes the file on a
    thread and returns at once; `wait_for_checkpoints` joins the writers
    (and raises what one of them raised). Returns the file's path."""
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"ckpt_{step}.npz")
    arrs = {f"{name}|{key}": np.asarray(v)
            for name, tree in trees.items() for key, v in tree.items()}
    arrs["__step__"] = np.asarray(step)
    if background:
        t = threading.Thread(target=_write_npz, args=(path, arrs, True),
                             daemon=True)
        with _WRITERS_LOCK:
            _WRITERS.append(t)
        t.start()
        return path
    _write_npz(path, arrs)
    return path


def _write_npz(path: str, arrs: Dict[str, np.ndarray], record=False):
    try:
        with _WRITE_SERIAL:
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **arrs)
            os.replace(tmp, path)
    except OSError as e:
        if not record:
            raise
        with _WRITERS_LOCK:
            _ERRORS.append(e)


def wait_for_checkpoints():
    """Join all outstanding background checkpoint writers; raise the first
    error one of them met."""
    with _WRITERS_LOCK:
        pending, _WRITERS[:] = _WRITERS[:], []
    for t in pending:
        t.join()
    with _WRITERS_LOCK:
        errors, _ERRORS[:] = _ERRORS[:], []
    if errors:
        raise errors[0]


def latest_checkpoint(log_dir: str) -> Optional[str]:
    """Newest ckpt_<step>[.npz] by step (reference: trainer.py:846-861),
    after the background writers have published their files."""
    wait_for_checkpoints()
    if not os.path.isdir(log_dir):
        return None
    best, best_step = None, -1
    for fn in os.listdir(log_dir):
        m = re.fullmatch(r"ckpt_(\d+)(\.npz)?", fn)
        if m and int(m.group(1)) > best_step:
            best_step = int(m.group(1))
            best = os.path.join(log_dir, fn)
    return best


def load_checkpoint(path: str, templates: Dict[str, dict]
                    ) -> Tuple[Dict[str, dict], int]:
    """Restore the named flat trees of `templates` ({name: {keystr:
    array}}, giving the keys and shapes expected). Names missing from
    `templates` are skipped (a finetune skips the optimizer,
    trainer.py:892-896); a template key missing from the file, or of
    another shape, raises. Returns ({name: {keystr: array}}, step)."""
    wait_for_checkpoints()  # a background writer may still hold this file
    if os.path.isdir(path):
        raise NotImplementedError(
            f"{path}: sharded (orbax) checkpoints are not ported yet")
    with np.load(path, allow_pickle=False) as data:
        flat = {k: data[k] for k in data.files}
    step = int(flat.pop("__step__"))
    out = {}
    for name, template in templates.items():
        prefix = f"{name}|"
        sub = {k[len(prefix):]: v for k, v in flat.items()
               if k.startswith(prefix)}
        if template and not sub:
            raise KeyError(f"checkpoint has no tree named {name!r}")
        tree = {}
        for key, leaf in template.items():
            if key not in sub:
                raise KeyError(f"checkpoint missing leaf {name}|{key}")
            if sub[key].shape != np.shape(leaf):
                raise ValueError(
                    f"shape mismatch for {name}|{key}: ckpt {sub[key].shape}"
                    f" vs model {np.shape(leaf)}")
            tree[key] = sub[key]
        out[name] = tree
    return out, step
