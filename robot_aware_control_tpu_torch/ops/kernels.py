"""Hand-written CUDA kernels of the planning path, with their plain versions.

Two kernels replace the JAX package's two Pallas kernels
(`robot_aware_control_tpu/ops/pallas_kernels.py`):

  * `capsule_mask_render`  (csrc/capsule_mask.cu): segment parameters
    (M, S, 6) -> robot masks (M, h, w) in {0, 1};
  * `conv_lstm_cell`: one ConvLSTM cell, gates accumulated in float32,
    outputs in the input's type. bf16 cells whose channel counts are
    multiples of 8 on 16-byte aligned tensors (the planner's) take the
    wgmma/TMA kernel of csrc/conv_lstm_cell_sm90.cu; other bf16 shapes the
    WMMA kernel and float32 cells the CUDA-core kernel of
    csrc/conv_lstm_cell.cu. The path depends only on dtype, shape and
    alignment.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; there is no fallback from one to the
other. The kernels have no backward: their outputs are written through raw
pointers and carry no autograd node, so on CUDA tensors a wrapper raises
when autograd is recording and an input requires grad, instead of
returning outputs that would silently cut the gradient. The sources are
compiled with nvcc into plain-C shared libraries on first use (into
`_build/` beside this package, keyed by the source's hash) and loaded with
ctypes. Every launch adds one to `launches[<name>]`.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
import time

import torch
import torch.nn.functional as F

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")

# The mask kernel's tiles and skip rule (csrc/capsule_mask.cu; its header
# note argues why a skipped test is a miss). A warp renders MASK_TILE =
# (rows, columns) pixels, 4 adjacent pixels a lane, and tests a capsule only
# where the tile's pixel centres meet the capsule's box grown by
# max(|ra|, |rb|) + MASK_MARGIN_PX + MASK_MARGIN_REL * mag, with mag the sum
# of the capsule's six |parameters|. A capsule whose mag is not below
# MASK_MAX_MAGNITUDE (or not finite) is tested on every tile.
MASK_TILE = (16, 8)
MASK_MARGIN_PX = 1.0
MASK_MARGIN_REL = 2.0 ** -16
MASK_MAX_MAGNITUDE = 2.0 ** 60
# 48 bytes of shared memory a capsule: 192 KB, within Hopper's 227 KB a
# block (the launch opts in past the default 48 KB)
MASK_MAX_SEGMENTS = 4096

# library name -> (source file, extra nvcc flags). -fmad=false keeps the
# mask kernel's arithmetic rounding step by step like its plain version;
# -Xptxas -v puts registers and spills into `build_log`.
SOURCES = {
    "capsule_mask": ("capsule_mask.cu", [
        "-fmad=false", "-Xptxas", "-v",
        f"-DMASK_TILE_ROWS={MASK_TILE[0]}", f"-DMASK_TILE_COLS={MASK_TILE[1]}",
        f"-DMASK_MARGIN_PX={MASK_MARGIN_PX.hex()}f",
        f"-DMASK_MARGIN_REL={MASK_MARGIN_REL.hex()}f",
        f"-DMASK_MAX_MAGNITUDE={MASK_MAX_MAGNITUDE.hex()}f"]),
    "conv_lstm_cell": ("conv_lstm_cell.cu", ["-Xptxas", "-v"]),
    "conv_lstm_cell_sm90": ("conv_lstm_cell_sm90.cu", ["-Xptxas", "-v"]),
}

# "conv_lstm_cell" counts every cell launch, "conv_lstm_cell_sm90" those of
# them that took the wgmma/TMA kernel
launches = {"capsule_mask_render": 0, "conv_lstm_cell": 0,
            "conv_lstm_cell_sm90": 0}
# library name -> compiler output and seconds of the build in this process
build_log: dict = {}

_libs: dict = {}
_lock = threading.Lock()


def reset_launches():
    for k in launches:
        launches[k] = 0


def _nvcc() -> str:
    """nvcc of $CUDA_HOME, else the one on PATH, else the default toolkit's."""
    home = os.environ.get("CUDA_HOME")
    nvcc = (os.path.join(home, "bin", "nvcc") if home
            else shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError(f"nvcc not found at {nvcc}: set CUDA_HOME")
    return nvcc


def _lib_path(name: str) -> str:
    src, flags = SOURCES[name]
    with open(os.path.join(_CSRC, src), "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(flags).encode()).hexdigest()
    return os.path.join(BUILD_DIR, f"{name}_{digest[:16]}.so")


def build(names=None) -> dict:
    """Compiles the named kernel libraries (all by default) that are not
    built yet, one nvcc process per source, all started together. Returns
    {name: path}. Raises with the compiler's output if a build fails."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    paths = {n: _lib_path(n) for n in names}
    procs = {}
    t0 = time.perf_counter()
    for n in names:
        if os.path.exists(paths[n]):
            continue
        src, flags = SOURCES[n]
        tmp = f"{paths[n]}.{os.getpid()}.tmp"
        cmd = [_nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
               *flags, "-o", tmp, os.path.join(_CSRC, src)]
        procs[n] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    failed = []
    for n, (tmp, p) in procs.items():
        out, _ = p.communicate()
        if p.returncode != 0:
            failed.append(f"{SOURCES[n][0]}:\n{out}")
        else:
            os.replace(tmp, paths[n])  # atomic: concurrent processes see whole files
            build_log[n] = {"output": out,
                            "seconds": time.perf_counter() - t0}
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return paths


def _lib(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(build([name])[name])
            ptr, i = ctypes.c_void_p, ctypes.c_int
            if name == "capsule_mask":
                lib.capsule_mask_render.argtypes = [ptr, ptr, i, i, i, i, ptr]
                lib.capsule_mask_render.restype = i
            elif name == "conv_lstm_cell_sm90":
                lib.conv_lstm_cell_sm90.argtypes = [ptr] * 9 + [i] * 6 + [ptr]
                lib.conv_lstm_cell_sm90.restype = i
                lib.conv_lstm_cell_sm90_schedule.argtypes = [i] * 6 + [ptr]
                lib.conv_lstm_cell_sm90_schedule.restype = i
            else:
                for fn in (lib.conv_lstm_cell_f32, lib.conv_lstm_cell_bf16):
                    fn.argtypes = [ptr] * 7 + [i] * 6 + [ptr]
                    fn.restype = i
            _libs[name] = lib
        return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


def _check_no_grad(name: str, *tensors):
    """Raises when autograd would record the call: the kernels have no
    backward, and their outputs would silently cut the gradient."""
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        raise RuntimeError(
            f"{name} has no backward: call it under torch.no_grad() or on "
            "tensors that do not require grad (training takes the autograd "
            "path, ops/lstm.py:conv_lstm_cell_autograd)")


def _check_err(err: int, name: str):
    if err != 0:
        raise RuntimeError(f"{name} launch failed with CUDA error {err}")


# ---------------------------------------------------------------------------
# capsule masks


def capsule_mask_render_plain(segs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """segs (M, S, 6) [au, av, bu, bv, ra, rb] in pixel space -> masks
    (M, h, w) float32: a pixel centre is inside when its squared distance
    to a capsule's axis is at most the squared lerped radius. Same
    operations in the same order as the kernel (and the Pallas kernel)."""
    dev = segs.device
    py = (torch.arange(h, device=dev, dtype=torch.float32) + 0.5)[:, None]
    px = (torch.arange(w, device=dev, dtype=torch.float32) + 0.5)[None, :]
    au, av, bu, bv, ra, rb = segs.float()[..., None, None].unbind(2)
    dx = bu - au
    dy = bv - av
    seg_len2 = dx * dx + dy * dy + 1e-8
    t = torch.clamp(((px - au) * dx + (py - av) * dy) / seg_len2, 0.0, 1.0)
    ex = px - (au + t * dx)
    ey = py - (av + t * dy)
    dist2 = ex * ex + ey * ey
    rad = ra * (1.0 - t) + rb * t
    return (dist2 <= rad * rad).any(1).float()


def capsule_mask_boxes(segs: torch.Tensor) -> torch.Tensor:
    """segs (M, S, 6) float32 -> (M, S, 4) [lo_u, hi_u, lo_v, hi_v]: each
    capsule's box as the mask kernel computes it, in the same float32
    operations; (-inf, inf) where the kernel tests the capsule everywhere."""
    au, av, bu, bv, ra, rb = segs.float().unbind(-1)
    mag = au.abs() + av.abs() + bu.abs() + bv.abs() + ra.abs() + rb.abs()
    grow = torch.maximum(ra.abs(), rb.abs()) + (MASK_MARGIN_PX
                                                + mag * MASK_MARGIN_REL)
    box = torch.stack([torch.minimum(au, bu) - grow,
                       torch.maximum(au, bu) + grow,
                       torch.minimum(av, bv) - grow,
                       torch.maximum(av, bv) + grow], -1)
    everywhere = torch.tensor([-torch.inf, torch.inf, -torch.inf, torch.inf],
                              device=segs.device)
    return torch.where((mag < MASK_MAX_MAGNITUDE)[..., None], box, everywhere)


def capsule_mask_tests_kept(segs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """segs (M, S, 6) -> (M, S, h, w) bool: the pixel-capsule tests the mask
    kernel does, those of the (warp tile, capsule) pairs whose box test
    passes. It skips the others as misses."""
    rows, cols = MASK_TILE
    dev = segs.device

    def centres(n, step):  # first and last pixel centre of each tile
        start = torch.arange(0, n, step, device=dev)
        last = torch.clamp(start + step, max=n) - 1
        return start.float() + 0.5, last.float() + 0.5

    x_lo, x_hi = centres(w, cols)
    y_lo, y_hi = (c[:, None] for c in centres(h, rows))
    lo_u, hi_u, lo_v, hi_v = capsule_mask_boxes(segs)[..., None, None].unbind(2)
    kept = ~((x_hi < lo_u) | (x_lo > hi_u) | (y_hi < lo_v) | (y_lo > hi_v))
    return kept.repeat_interleave(rows, 2).repeat_interleave(cols, 3)[
        ..., :h, :w]


def capsule_mask_render(segs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """segs (M, S, 6) float32 -> masks (M, h, w) float32 in {0, 1}."""
    _check(segs.dim() == 3 and segs.shape[-1] == 6,
           f"segs must be (M, S, 6), got {tuple(segs.shape)}")
    if segs.device.type == "cpu":
        return capsule_mask_render_plain(segs, h, w)
    _check(segs.is_cuda, f"unsupported device {segs.device}")
    _check_no_grad("capsule_mask_render", segs)
    _check(segs.dtype == torch.float32, f"segs must be float32, got {segs.dtype}")
    _check(segs.is_contiguous(), "segs must be contiguous")
    _check(h > 0 and w > 0 and h * w < 2 ** 31, f"bad mask size {h}x{w}")
    M, S = segs.shape[0], segs.shape[1]
    _check(S <= MASK_MAX_SEGMENTS,
           f"at most {MASK_MAX_SEGMENTS} capsules a mask, got {S}")
    out = torch.empty((M, h, w), device=segs.device, dtype=torch.float32)
    if M == 0:  # nothing to launch
        return out
    lib = _lib("capsule_mask")
    with torch.cuda.device(segs.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.capsule_mask_render(segs.data_ptr(), out.data_ptr(),
                                      M, S, h, w, stream)
    _check_err(err, "capsule_mask_render")
    launches["capsule_mask_render"] += 1
    return out


# ---------------------------------------------------------------------------
# ConvLSTM cell


def conv_lstm_cell_plain(x, h, c, w, b):
    """x (B,H,W,Cx), h/c (B,H,W,C), w (k,k,Cx+C,4C) HWIO, b (4C,) float32.
    Gates in float32 from the inputs' values (as the Pallas kernel
    accumulates), outputs rounded to x's type. Returns (h_new, c_new)."""
    k = w.shape[0]
    xh = torch.cat([x, h], -1).float().permute(0, 3, 1, 2)
    g = F.conv2d(xh, w.float().permute(3, 2, 0, 1), b.float(), padding=k // 2)
    i, f, o, gc = g.permute(0, 2, 3, 1).chunk(4, -1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(gc)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype)


_CELL_FN = {torch.float32: "conv_lstm_cell_f32",
            torch.bfloat16: "conv_lstm_cell_bf16"}


def _check_cell(x, h, c, w, b):
    """Checks the shapes of a cell's inputs; returns (B, H, W, Cx, C, k)."""
    _check(x.dim() == 4 and h.dim() == 4 and h.shape == c.shape
           and x.shape[:3] == h.shape[:3],
           f"x {tuple(x.shape)} and h/c {tuple(h.shape)} must be NHWC "
           "with equal B, H, W")
    Bn, H, W, Cx = x.shape
    C = h.shape[-1]
    k = w.shape[0]
    _check(w.dim() == 4 and tuple(w.shape) == (k, k, Cx + C, 4 * C)
           and k % 2 == 1,
           f"w must be (k, k, {Cx + C}, {4 * C}) with odd k, "
           f"got {tuple(w.shape)}")
    _check(tuple(b.shape) == (4 * C,), f"b must be ({4 * C},)")
    return Bn, H, W, Cx, C, k


def _check_cuda_cell(x, h, c, w, b):
    _check(x.is_cuda, f"unsupported device {x.device}")
    _check_no_grad("conv_lstm_cell", x, h, c, w, b)
    _check(all(t.device == x.device for t in (h, c, w, b)),
           "all inputs must be on one device")
    _check(x.dtype in _CELL_FN and h.dtype == c.dtype == w.dtype == x.dtype,
           f"x, h, c, w must share float32 or bfloat16, got "
           f"{x.dtype}/{h.dtype}/{c.dtype}/{w.dtype}")
    _check(b.dtype == torch.float32, "b must be float32")
    _check(all(t.is_contiguous() for t in (x, h, c, w, b)),
           "inputs must be contiguous")
    _check(x.numel() < 2 ** 31 and h.numel() < 2 ** 31
           and w.numel() < 2 ** 31, "inputs too large for 32-bit indexing")


def takes_sm90(x, h, c, w) -> bool:
    """Whether a CUDA cell takes the wgmma/TMA kernel: bf16, channel counts
    that are multiples of 8 (TMA's 16-byte row strides) and 16-byte aligned
    tensors."""
    return (x.dtype == torch.bfloat16 and x.shape[-1] % 8 == 0
            and h.shape[-1] % 8 == 0
            and all(t.data_ptr() % 16 == 0 for t in (x, h, c, w)))


@functools.lru_cache(maxsize=None)
def _sm90_schedule(Bn, H, W, Cx, C, k, device) -> dict:
    out = (ctypes.c_longlong * 3)()
    with torch.cuda.device(device):
        err = _lib("conv_lstm_cell_sm90").conv_lstm_cell_sm90_schedule(
            Bn, H, W, Cx, C, k, ctypes.addressof(out))
    _check_err(err, "conv_lstm_cell_sm90_schedule")
    return dict(zip(("tiles", "grid", "steps"), out))


def sm90_schedule(Bn, H, W, Cx, C, k, device=None) -> dict:
    """The wgmma/TMA kernel's stream-K schedule on `device`: output tiles,
    persistent blocks (clusters of two, one block an SM) and k-steps summed
    over the blocks (each a product of 128 x 256 x 64)."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return dict(_sm90_schedule(Bn, H, W, Cx, C, k, index))


def _launch_cell(fn_name, dims, x, h, c, w, b):
    Bn, H, W, Cx, C, k = dims
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        args = [x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
                b.data_ptr(), h_out.data_ptr(), c_out.data_ptr()]
        if fn_name == "conv_lstm_cell_sm90":
            s = sm90_schedule(Bn, H, W, Cx, C, k, x.device)
            # float32 partials of tiles cut between blocks, two slots a
            # block; per tile an arrival and a done counter, zeroed
            ws = torch.empty(2 * s["grid"] * 128 * 256, device=x.device)
            counters = torch.zeros(2 * s["tiles"], device=x.device,
                                   dtype=torch.int32)
            args += [ws.data_ptr(), counters.data_ptr()]
            fn = _lib("conv_lstm_cell_sm90").conv_lstm_cell_sm90
        else:
            fn = getattr(_lib("conv_lstm_cell"), fn_name)
        err = fn(*args, Bn, H, W, Cx, C, k, stream)
    _check_err(err, fn_name)
    launches["conv_lstm_cell"] += 1
    if fn_name == "conv_lstm_cell_sm90":
        launches["conv_lstm_cell_sm90"] += 1
    return h_out, c_out


def conv_lstm_cell(x, h, c, w, b):
    """One ConvLSTM cell (gate order i, f, o, g). Returns (h_new, c_new)."""
    dims = _check_cell(x, h, c, w, b)
    if x.device.type == "cpu":
        return conv_lstm_cell_plain(x, h, c, w, b)
    _check_cuda_cell(x, h, c, w, b)
    fn_name = ("conv_lstm_cell_sm90" if takes_sm90(x, h, c, w)
               else _CELL_FN[x.dtype])
    return _launch_cell(fn_name, dims, x, h, c, w, b)


def conv_lstm_cell_wmma(x, h, c, w, b):
    """The WMMA kernel of csrc/conv_lstm_cell.cu on any bf16 CUDA cell.
    `conv_lstm_cell` sends it only the shapes TMA cannot describe; this
    entry point times it beside the wgmma kernel at the planner's shapes."""
    dims = _check_cell(x, h, c, w, b)
    _check_cuda_cell(x, h, c, w, b)
    _check(x.dtype == torch.bfloat16, "the WMMA kernel takes bfloat16")
    return _launch_cell("conv_lstm_cell_bf16", dims, x, h, c, w, b)
