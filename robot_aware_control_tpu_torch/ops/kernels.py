"""Hand-written CUDA kernels of the planning path, with their plain versions.

Two kernels replace the JAX package's two Pallas kernels
(`robot_aware_control_tpu/ops/pallas_kernels.py`):

  * `capsule_mask_render`  (csrc/capsule_mask.cu): segment parameters
    (M, S, 6) -> robot masks (M, h, w) in {0, 1};
  * `conv_lstm_cell`       (csrc/conv_lstm_cell.cu): one ConvLSTM cell,
    gates accumulated in float32, outputs in the input's type.

Each wrapper takes its plain PyTorch version for tensors on the CPU and
launches its kernel for CUDA tensors; there is no fallback from one to the
other. The sources are compiled with nvcc into plain-C shared libraries on
first use (into `_build/` beside this package, keyed by the source's hash)
and loaded with ctypes. Every launch adds one to `launches[<name>]`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading

import torch
import torch.nn.functional as F

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# library name -> (source file, extra nvcc flags). -fmad=false keeps the
# mask kernel's arithmetic rounding step by step like its plain version.
SOURCES = {
    "capsule_mask": ("capsule_mask.cu", ["-fmad=false"]),
    "conv_lstm_cell": ("conv_lstm_cell.cu", []),
}

launches = {"capsule_mask_render": 0, "conv_lstm_cell": 0}

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
            else:
                for fn in (lib.conv_lstm_cell_f32, lib.conv_lstm_cell_bf16):
                    fn.argtypes = [ptr] * 7 + [i] * 6 + [ptr]
                    fn.restype = i
            _libs[name] = lib
        return lib


def _check(cond: bool, msg: str):
    if not cond:
        raise ValueError(msg)


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


def capsule_mask_render(segs: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """segs (M, S, 6) float32 -> masks (M, h, w) float32 in {0, 1}."""
    _check(segs.dim() == 3 and segs.shape[-1] == 6,
           f"segs must be (M, S, 6), got {tuple(segs.shape)}")
    if segs.device.type == "cpu":
        return capsule_mask_render_plain(segs, h, w)
    _check(segs.is_cuda, f"unsupported device {segs.device}")
    _check(segs.dtype == torch.float32, f"segs must be float32, got {segs.dtype}")
    _check(segs.is_contiguous(), "segs must be contiguous")
    _check(h > 0 and w > 0 and h * w < 2 ** 31, f"bad mask size {h}x{w}")
    M, S = segs.shape[0], segs.shape[1]
    out = torch.empty((M, h, w), device=segs.device, dtype=torch.float32)
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


def conv_lstm_cell(x, h, c, w, b):
    """One ConvLSTM cell (gate order i, f, o, g). Returns (h_new, c_new)."""
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
    if x.device.type == "cpu":
        return conv_lstm_cell_plain(x, h, c, w, b)
    _check(x.is_cuda, f"unsupported device {x.device}")
    _check(all(t.device == x.device for t in (h, c, w, b)),
           "all inputs must be on one device")
    _check(x.dtype in _CELL_FN and h.dtype == c.dtype == w.dtype == x.dtype,
           f"x, h, c, w must share float32 or bfloat16, got "
           f"{x.dtype}/{h.dtype}/{c.dtype}/{w.dtype}")
    _check(b.dtype == torch.float32, "b must be float32")
    _check(all(t.is_contiguous() for t in (x, h, c, w, b)),
           "inputs must be contiguous")
    _check(Bn * H * W * max(Cx, C) < 2 ** 31 and w.numel() < 2 ** 31,
           "inputs too large for 32-bit indexing")
    h_out = torch.empty_like(h)
    c_out = torch.empty_like(c)
    fn = getattr(_lib("conv_lstm_cell"), _CELL_FN[x.dtype])
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(x.data_ptr(), h.data_ptr(), c.data_ptr(), w.data_ptr(),
                 b.data_ptr(), h_out.data_ptr(), c_out.data_ptr(),
                 Bn, H, W, Cx, C, k, stream)
    _check_err(err, "conv_lstm_cell")
    launches["conv_lstm_cell"] += 1
    return h_out, c_out
