"""Hand-written CUDA kernels of the planning path, with their plain versions.

Two kernels replace the JAX package's two Pallas kernels
(`robot_aware_control_tpu/ops/pallas_kernels.py`):

  * `capsule_mask_render`  (csrc/capsule_mask.cu): segment parameters
    (M, S, 6) -> robot masks (M, h, w) in {0, 1};
  * `conv_lstm_cell`: one ConvLSTM cell, gates accumulated in float32,
    outputs in the input's type. Every bf16 cell takes the wgmma/TMA
    kernel of csrc/conv_lstm_cell_sm90.cu, every float32 cell the
    CUDA-core kernel of csrc/conv_lstm_cell_f32.cu (FFMA, no TF32; its
    tile shape chosen per launch, `f32_schedule`). The kernels read x, h
    and c as NHWC with contiguous channels at their pixel stride (views of
    padded buffers, `padded_nhwc`, are read in place) and write h' and c'
    in the layout in which they read h. What the wgmma/TMA kernel cannot
    read in place the wrapper stages first (`stage_cell`): x, h or c whose
    pixel stride is not a multiple of 8 elements, or whose pointer is not
    16-byte aligned, is copied into a `padded_nhwc` view, and the weights
    (k, k, Cx + C, 4C) into a gate-packed copy where C is not a multiple of
    8 (`sm90_weights`). The route depends only on dtype, and each kernel's
    result for a batch entry depends on that entry's inputs alone: not on
    B, not on where the entry sits in the batch, not on the order in which
    blocks finish (the planner's batched and single plans rely on it,
    planning/cem.py).

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; there is no fallback from one to the
other. The kernels have no backward: their outputs are written through raw
pointers and carry no autograd node, so on CUDA tensors a wrapper raises
when autograd is recording and an input requires grad, instead of
returning outputs that would silently cut the gradient. The sources are
compiled with nvcc into plain-C shared libraries on first use (into
`_build/` beside this package, keyed by the hash of the source, the headers
of csrc/ and the flags) and loaded with ctypes. Every launch adds one to
`launches[<name>]`.
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
from torch.utils.weak import WeakIdKeyDictionary

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
    "conv_lstm_cell_sm90": ("conv_lstm_cell_sm90.cu", ["-Xptxas", "-v"]),
    "conv_lstm_cell_f32": ("conv_lstm_cell_f32.cu", ["-Xptxas", "-v"]),
}

# "conv_lstm_cell" counts every cell launch, "conv_lstm_cell_sm90" and
# "conv_lstm_cell_f32" those of them that took the wgmma/TMA kernel and the
# float32 kernel
launches = {"capsule_mask_render": 0, "conv_lstm_cell": 0,
            "conv_lstm_cell_sm90": 0, "conv_lstm_cell_f32": 0}
# inputs of CUDA cells that `stage_cell` copied before the launch (x, h or
# c into a padded view; not the weights' packed copy, made once a version)
staged = {"inputs": 0}
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
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in [src] + sorted(n for n in os.listdir(_CSRC) if n.endswith(".h")):
        with open(os.path.join(_CSRC, f), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}_{digest.hexdigest()[:16]}.so")


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


def bind(name: str, lib):
    """Sets the argument types of library `name`'s functions on `lib` (a
    ctypes.CDLL of it). Returns lib."""
    ptr, i = ctypes.c_void_p, ctypes.c_int
    if name == "capsule_mask":
        fns = [(lib.capsule_mask_render, [ptr, ptr, i, i, i, i, ptr])]
    elif name == "conv_lstm_cell_sm90":
        # pointers, B, H, W, Cx, C, k, the four pixel strides, the
        # weights' gate stride and tail block column, the stream
        fns = [(lib.conv_lstm_cell_sm90, [ptr] * 9 + [i] * 12 + [ptr]),
               (lib.conv_lstm_cell_sm90_schedule, [i] * 7 + [ptr])]
    else:
        # pointers, B, H, W, Cx, C, k, the four pixel strides, the tile
        # shape, the stream
        fns = [(lib.conv_lstm_cell_f32, [ptr] * 7 + [i] * 11 + [ptr]),
               (lib.conv_lstm_cell_f32_schedule, [i] * 6 + [ptr])]
    for fn, types in fns:
        fn.argtypes = types
        fn.restype = i
    return lib


def _lib(name: str):
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = bind(name, ctypes.CDLL(build([name])[name]))
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
    accumulates), outputs rounded to x's type. Takes views of padded
    buffers (`padded_nhwc`) as they are; returns contiguous (h_new, c_new)."""
    k = w.shape[0]
    xh = torch.cat([x, h], -1).float().permute(0, 3, 1, 2)
    g = F.conv2d(xh, w.float().permute(3, 2, 0, 1), b.float(), padding=k // 2)
    i, f, o, gc = g.permute(0, 2, 3, 1).chunk(4, -1)
    c_new = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(gc)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new.to(x.dtype), c_new.to(x.dtype)


def round_up(n: int, m: int = 8) -> int:
    return -(-n // m) * m


# columns of the narrow tail's block in packed weights: the 8 hidden
# channels from C rounded down to 64, of each gate
TAIL_COLUMNS = 4 * 8


def pack_gate_weights(w: torch.Tensor, C: int) -> torch.Tensor:
    """w (k, k, Cin, 4C) -> the wgmma/TMA kernel's copy (k, k, Cin, 4 Cp +
    32), Cp = round_up(C, 64): each gate's C columns followed by zeros, so
    that every gate starts on a 128-byte boundary (TMA starts a box only on
    a 16-byte one, and boxes whose rows straddle 128-byte lines are
    slower), then a block of 32 columns: the 8 channels from C rounded
    down to 64 of each gate (zeros past C), which the kernel's narrow tail
    loads as one box. w itself where C is a multiple of 64."""
    Cp = round_up(C, 64)
    if Cp == C:
        return w
    k, _, cin, _ = w.shape
    t0 = C // 64 * 64
    gates = w.new_zeros(k, k, cin, 4, Cp)
    gates[..., :C] = w.reshape(k, k, cin, 4, C)
    return torch.cat([gates.reshape(k, k, cin, 4 * Cp),
                      gates[..., t0:t0 + 8].reshape(k, k, cin, TAIL_COLUMNS)], -1)


# weights -> (their version, data pointer, the packed copy): one copy per
# weight tensor, made again when the tensor is written or replaced
_sm90_packed = WeakIdKeyDictionary()


def sm90_weights(w: torch.Tensor, C: int):
    """The weights as the wgmma/TMA kernel takes them and their gate
    stride: w and C where C is a multiple of 8 and w is 16-byte aligned;
    else a copy made once per version of w: `pack_gate_weights`' (any C
    not a multiple of 8, odd C too) and round_up(C, 64), or, for a
    misaligned w of such a C, an aligned clone and C. An inference tensor
    has no version to key the copy by: it gets a copy per call. Only that
    kernel reads the copy; every other path takes w (k, k, Cin, 4C)."""
    if C % 8 == 0 and w.data_ptr() % 16 == 0:
        return w, C
    copy = ((lambda: w.clone()) if C % 8 == 0
            else (lambda: pack_gate_weights(w, C)))
    cw = C if C % 8 == 0 else round_up(C, 64)
    if w.is_inference():
        return copy(), cw
    stamp = (w._version, w.data_ptr())
    hit = _sm90_packed.get(w)
    if hit is None or hit[0] != stamp:
        # a plain tensor even when a planner runs under inference_mode
        with torch.inference_mode(False), torch.no_grad():
            hit = (stamp, copy())
        _sm90_packed[w] = hit
    return hit[1], cw


def padded_nhwc(B, H, W, C, dtype=torch.bfloat16, device=None,
                zero: bool = False) -> torch.Tensor:
    """A (B, H, W, C) tensor that is a view of a (B, H, W, round_up(C, 8))
    buffer: its pixel stride is a multiple of 8 elements (16 bytes in bf16),
    which TMA needs, so the wgmma/TMA cell kernel reads such views of any
    channel count in place. The lanes past C are never read by the cell
    kernels; `zero` zeroes the buffer, else it is uninitialised."""
    make = torch.zeros if zero else torch.empty
    return make(B, H, W, round_up(C), dtype=dtype, device=device)[..., :C]


def pixel_stride(t: torch.Tensor):
    """The pixel stride of an NHWC tensor whose channels are contiguous and
    whose B, H and W are dense above them (a contiguous tensor, or a view
    of the first channels of one), in elements; None for any other layout."""
    if t.dim() != 4:
        return None
    B, H, W, C = t.shape
    ld = t.stride(2)
    if (t.stride(3) != 1 and C > 1) or ld < C:
        return None
    return ld if t.stride(1) == W * ld and t.stride(0) == H * W * ld else None


def empty_nhwc_like(t: torch.Tensor) -> torch.Tensor:
    """An uninitialised tensor of t's shape, dtype, device and pixel stride."""
    B, H, W, C = t.shape
    ld = pixel_stride(t) or C
    return torch.empty(B, H, W, ld, dtype=t.dtype, device=t.device)[..., :C]


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
           f"w must be (k, k, {Cx + C}, {4 * C}) with odd k, got "
           f"{tuple(w.shape)}")
    _check(tuple(b.shape) == (4 * C,), f"b must be ({4 * C},)")
    return Bn, H, W, Cx, C, k


def _check_cuda_cell(x, h, c, w, b):
    _check(x.is_cuda, f"unsupported device {x.device}")
    _check_no_grad("conv_lstm_cell", x, h, c, w, b)
    _check(all(t.device == x.device for t in (h, c, w, b)),
           "all inputs must be on one device")
    _check(x.dtype in (torch.float32, torch.bfloat16)
           and h.dtype == c.dtype == w.dtype == x.dtype,
           f"x, h, c, w must share float32 or bfloat16, got "
           f"{x.dtype}/{h.dtype}/{c.dtype}/{w.dtype}")
    _check(b.dtype == torch.float32, "b must be float32")
    _check(w.is_contiguous() and b.is_contiguous(),
           "w and b must be contiguous")


def tma_ready(t: torch.Tensor) -> bool:
    """Whether the wgmma/TMA kernel reads x, h or c in place: NHWC with
    contiguous channels and B, H, W dense above them, a pixel stride that
    is a multiple of 8 elements (TMA's 16-byte strides) and a 16-byte
    aligned pointer. A contiguous cell of 260 or 252 channels is not;
    the same cell on views of padded buffers (`padded_nhwc`) is."""
    ld = pixel_stride(t)
    return ld is not None and ld % 8 == 0 and t.data_ptr() % 16 == 0


def _stage(t: torch.Tensor, ready) -> torch.Tensor:
    if ready(t):
        return t
    staged["inputs"] += t.is_cuda
    return padded_nhwc(*t.shape, dtype=t.dtype, device=t.device).copy_(t)


def stage_cell(x, h, c, w):
    """A cell's inputs as the CUDA kernel of their type reads them:
    (x, h, c, weights, gate stride). bf16 (the wgmma/TMA kernel): x, h and
    c themselves where `tma_ready`, else copies into `padded_nhwc` views
    (their pad lanes uninitialised: the kernel never reads them), and
    `sm90_weights`. float32: x, h and c themselves where their pixel
    stride is defined, else such copies, and w with C. Takes CPU tensors
    too (the CPU tests check the contract there); only copies of CUDA
    tensors are counted in `staged`."""
    C = h.shape[-1]
    if x.dtype == torch.bfloat16:
        ready, (wk, cw) = tma_ready, sm90_weights(w, C)
    else:
        ready, wk, cw = (lambda t: pixel_stride(t) is not None), w, C
    return _stage(x, ready), _stage(h, ready), _stage(c, ready), wk, cw


@functools.lru_cache(maxsize=None)
def _sm90_schedule(Bn, H, W, Cx, C, k, device) -> dict:
    out = (ctypes.c_longlong * 7)()
    with torch.cuda.device(device):
        err = _lib("conv_lstm_cell_sm90").conv_lstm_cell_sm90_schedule(
            Bn, H, W, Cx, C, k, int(C % 8 != 0), ctypes.addressof(out))
    _check_err(err, "conv_lstm_cell_sm90_schedule")
    return dict(zip(("tiles", "grid", "steps", "slots", "slot_floats",
                     "macs", "tail"), out))


def sm90_schedule(Bn, H, W, Cx, C, k, device=None) -> dict:
    """The wgmma/TMA kernel's schedule on `device`: output tiles, persistent
    blocks (clusters of two, one block an SM), k-steps summed over the
    blocks (most a product of 128 x 256 x 64; a tap's short step in the
    tail layout 128 x 256 x 32), the workspace slots its partial sums take
    and the float32 values of one, the multiply-adds its products do, and
    whether the cell takes the tail layout (det's 260 or 258 channels, on
    `sm90_weights`' packed copy: csrc/conv_lstm_cell_sm90_geom.h)."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return dict(_sm90_schedule(Bn, H, W, Cx, C, k, index))


@functools.lru_cache(maxsize=None)
def _f32_schedule(Bn, H, W, Cx, C, k, device) -> dict:
    out = (ctypes.c_longlong * 8)()
    with torch.cuda.device(device):
        err = _lib("conv_lstm_cell_f32").conv_lstm_cell_f32_schedule(
            Bn, H, W, Cx, C, k, ctypes.addressof(out))
    _check_err(err, "conv_lstm_cell_f32_schedule")
    return dict(zip(("shape", "bm", "nh", "threads", "tiles",
                     "blocks_per_sm", "sms", "macs"), out))


def f32_schedule(Bn, H, W, Cx, C, k, device=None) -> dict:
    """The float32 kernel's schedule on `device`: its tile shape (index
    into csrc/conv_lstm_cell_f32_geom.h's shapes: 128 x 32 where the
    launch fills two waves of resident blocks, else 64 x 32), the pixels
    (bm) and hidden channels (nh) of a tile, threads a block, tiles (one
    block each, heaviest rows first), blocks resident on an SM, SMs, and
    the multiply-adds the blocks do."""
    dev = torch.device("cuda" if device is None else device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    return dict(_f32_schedule(Bn, H, W, Cx, C, k, index))


def launch_f32(dims, x, h, c, w, b, shape=None):
    """The float32 kernel of conv_lstm_cell_f32.cu on w (k, k, Cx + C, 4C),
    at tile shape `shape` (default: `f32_schedule`'s choice; any shape
    gives the same bits). h' and c' are allocated in h's layout."""
    Bn, H, W, Cx, C, k = dims
    if shape is None:
        shape = f32_schedule(Bn, H, W, Cx, C, k, x.device)["shape"]
    h_out, c_out = empty_nhwc_like(h), empty_nhwc_like(h)
    lds = [pixel_stride(t) for t in (x, h, c, h_out)]
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("conv_lstm_cell_f32").conv_lstm_cell_f32(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
            b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
            Bn, H, W, Cx, C, k, *lds, shape, stream)
    _check_err(err, "conv_lstm_cell_f32")
    launches["conv_lstm_cell"] += 1
    launches["conv_lstm_cell_f32"] += 1
    return h_out, c_out


def launch_sm90(dims, x, h, c, wk, cw, b):
    """The wgmma/TMA kernel on weights wk in its layout, gate q's columns at
    q cw .. q cw + C: w itself (cw = C), or, with cw > C, a copy whose
    gates are padded to cw columns and followed by the narrow tail's block
    (`sm90_weights`). h' and c' are allocated in h's layout."""
    Bn, H, W, Cx, C, k = dims
    h_out, c_out = empty_nhwc_like(h), empty_nhwc_like(h)
    lds = [pixel_stride(t) for t in (x, h, c, h_out)]
    s = sm90_schedule(Bn, H, W, Cx, C, k, x.device)
    # float32 partial sums of tiles cut between blocks; per tile an
    # arrival and a done counter, zeroed
    ws = torch.empty(s["slots"] * s["slot_floats"], device=x.device)
    counters = torch.zeros(2 * s["tiles"], device=x.device, dtype=torch.int32)
    tcol = 4 * cw if cw != C else -1  # where the tail block starts
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib("conv_lstm_cell_sm90").conv_lstm_cell_sm90(
            x.data_ptr(), h.data_ptr(), c.data_ptr(), wk.data_ptr(),
            b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(), ws.data_ptr(),
            counters.data_ptr(), Bn, H, W, Cx, C, k, *lds, cw, tcol, stream)
    _check_err(err, "conv_lstm_cell_sm90")
    launches["conv_lstm_cell"] += 1
    launches["conv_lstm_cell_sm90"] += 1
    return h_out, c_out


def conv_lstm_cell(x, h, c, w, b):
    """One ConvLSTM cell (gate order i, f, o, g), w (k, k, Cx + C, 4C).
    Returns (h_new, c_new), both in the layout in which the kernel reads h:
    h's own (a view of a padded buffer where h is one), or on CUDA, where
    `stage_cell` had to copy h, the padded layout of its copy."""
    dims = _check_cell(x, h, c, w, b)
    if x.device.type == "cpu":
        h_new, c_new = conv_lstm_cell_plain(x, h, c, w, b)
        if h.is_contiguous():
            return h_new, c_new
        return (empty_nhwc_like(h).copy_(h_new),
                empty_nhwc_like(h).copy_(c_new))
    _check_cuda_cell(x, h, c, w, b)
    x, h, c, wk, cw = stage_cell(x, h, c, w)
    _check(all(t.shape[0] * t.stride(0) < 2 ** 31 for t in (x, h, c))
           and wk.numel() < 2 ** 31, "inputs too large for 32-bit indexing")
    if x.dtype == torch.float32:
        return launch_f32(dims, x, h, c, w, b)
    return launch_sm90(dims, x, h, c, wk, cw, b)
