"""I3D (Inflated Inception-V1 3D) video network, for FVD (counterpart of
`robot_aware_control_tpu/evaluation/i3d.py`).

Reference parity: the reference computes FVD with the TF-Hub I3D
Kinetics-400 network (reference: src/prediction/evaluation/
frechet_video_distance/frechet_video_distance.py:37-56, module
"deepmind/i3d-kinetics-400/1"). TF-Hub is out of reach offline, so this
module holds the architecture ("Quo Vadis" I3D: Inception-V1 inflated to
3-D, 400-way logits) with a weight-import hook:

  * `init(seed)`: random init (He fan-in) from a torch.Generator, for
    shape tests and self-consistent FVD runs,
  * `load_npz(path)`: converted weights from an .npz whose keys are the
    JAX module's parameter paths (`<block>/<unit>/w`, `/beta`,
    `/moving_mean`, `/moving_var`, kernels DHWIO); `save_npz` writes them,
    so a file of either package loads in the other; `convert_tf_checkpoint`
    maps TF-Hub variable names onto them,
  * `embed(model, videos)`: (B, T, H, W, 3) in [0, 1] -> (B, 400) logits,
    the embedding FVD uses.

Every unit is Conv3D (no bias) + BatchNorm (beta only, scale fixed at 1,
eps 1e-3: the TF-Slim I3D convention) + ReLU. Convolutions and max pools
pad as XLA's "SAME" does: the odd element at the high end (stride 2 of
an even extent pads 2, 3 for the 7-tap kernel), max pools with -inf. The
network runs on its device (NCDHW); kernels are stored in F.conv3d's
OIDHW layout.
"""

from __future__ import annotations

import json
import os
from typing import Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robot_aware_control_tpu_torch.ops.nn import same_pads
from robot_aware_control_tpu_torch.utils.device import resolve_device

NUM_CLASSES = 400

# Inception-V1 mixed-block branch widths: (b0_1x1, b1_reduce, b1_3x3,
# b2_reduce, b2_3x3, b3_pool_proj)
MIXED = {
    "Mixed_3b": (64, 96, 128, 16, 32, 32),
    "Mixed_3c": (128, 128, 192, 32, 96, 64),
    "Mixed_4b": (192, 96, 208, 16, 48, 64),
    "Mixed_4c": (160, 112, 224, 24, 64, 64),
    "Mixed_4d": (128, 128, 256, 24, 64, 64),
    "Mixed_4e": (112, 144, 288, 32, 64, 64),
    "Mixed_4f": (256, 160, 320, 32, 128, 128),
    "Mixed_5b": (256, 160, 320, 32, 128, 128),
    "Mixed_5c": (384, 192, 384, 48, 128, 128),
}
MIXED_ORDER = list(MIXED)
# the port's copy of the JAX package's pinned structure of a converted file
MANIFEST_PATH = os.path.join(os.path.dirname(__file__), "i3d_manifest.json")
# OIDHW <-> DHWIO
_TO_JAX = (2, 3, 4, 1, 0)
_FROM_JAX = (4, 3, 0, 1, 2)


def same_pad(x: torch.Tensor, window, stride, value: float = 0.0):
    """x (N, C, D, H, W) padded as XLA's "SAME" pads it for `window` and
    `stride` over (D, H, W), with `value`."""
    pads = []
    for n, k, s in reversed(list(zip(x.shape[2:], window, stride))):
        pads += same_pads(n, k, s)
    return F.pad(x, pads, value=value) if any(pads) else x


def conv3d_same(x, w, stride=(1, 1, 1)):
    """3-D convolution, "SAME" zero padding, w OIDHW."""
    return F.conv3d(same_pad(x, w.shape[2:], stride), w, stride=stride)


def max_pool3d_same(x, window, stride):
    """Max pool with "SAME" padding by -inf (`lax.reduce_window` with init
    -inf): a window hanging over the edge takes the max of what it covers."""
    return F.max_pool3d(same_pad(x, window, stride, -float("inf")), window,
                        stride)


class Unit(nn.Module):
    """Conv3D (no bias) + BatchNorm (beta, moving statistics; scale 1, eps
    1e-3) + ReLU."""

    def __init__(self, k, cin: int, cout: int, stride=(1, 1, 1), device=None):
        super().__init__()
        self.stride = tuple(stride)
        self.w = nn.Parameter(torch.empty(cout, cin, *k, device=device))
        self.beta = nn.Parameter(torch.zeros(cout, device=device))
        self.register_buffer("moving_mean", torch.zeros(cout, device=device))
        self.register_buffer("moving_var", torch.ones(cout, device=device))

    def forward(self, x):
        y = conv3d_same(x, self.w, self.stride)
        inv = torch.rsqrt(self.moving_var + 1e-3)[:, None, None, None]
        y = (y - self.moving_mean[:, None, None, None]) * inv \
            + self.beta[:, None, None, None]
        return F.relu(y)


class Mixed(nn.Module):
    def __init__(self, cin: int, widths, device=None):
        super().__init__()
        b0, b1r, b1, b2r, b2, b3 = widths
        one, three = (1, 1, 1), (3, 3, 3)
        self.b0 = Unit(one, cin, b0, device=device)
        self.b1a = Unit(one, cin, b1r, device=device)
        self.b1b = Unit(three, b1r, b1, device=device)
        self.b2a = Unit(one, cin, b2r, device=device)
        self.b2b = Unit(three, b2r, b2, device=device)
        self.b3 = Unit(one, cin, b3, device=device)

    def forward(self, x):
        return torch.cat([
            self.b0(x), self.b1b(self.b1a(x)), self.b2b(self.b2a(x)),
            self.b3(max_pool3d_same(x, (3, 3, 3), (1, 1, 1)))], 1)


class Logits(nn.Module):
    def __init__(self, cin: int, device=None):
        super().__init__()
        self.w = nn.Parameter(torch.empty(NUM_CLASSES, cin, 1, 1, 1,
                                          device=device))
        self.b = nn.Parameter(torch.zeros(NUM_CLASSES, device=device))


class I3D(nn.Module):
    """The JAX module's parameter tree as modules of the same names."""

    def __init__(self, device=None):
        super().__init__()
        self.Conv3d_1a_7x7 = Unit((7, 7, 7), 3, 64, (2, 2, 2), device)
        self.Conv3d_2b_1x1 = Unit((1, 1, 1), 64, 64, device=device)
        self.Conv3d_2c_3x3 = Unit((3, 3, 3), 64, 192, device=device)
        cin = 192
        for name in MIXED_ORDER:
            w = MIXED[name]
            setattr(self, name, Mixed(cin, w, device))
            cin = w[0] + w[2] + w[4] + w[5]
        self.Logits = Logits(cin, device)
        self.requires_grad_(False)

    def forward(self, x):
        """x (B, 3, T, H, W) in [-1, 1] -> (B, 400)."""
        x = self.Conv3d_1a_7x7(x)
        x = max_pool3d_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Conv3d_2c_3x3(self.Conv3d_2b_1x1(x))
        x = max_pool3d_same(x, (1, 3, 3), (1, 2, 2))
        x = self.Mixed_3c(self.Mixed_3b(x))
        x = max_pool3d_same(x, (3, 3, 3), (2, 2, 2))
        for name in ("Mixed_4b", "Mixed_4c", "Mixed_4d", "Mixed_4e", "Mixed_4f"):
            x = getattr(self, name)(x)
        x = max_pool3d_same(x, (2, 2, 2), (2, 2, 2))
        x = self.Mixed_5c(self.Mixed_5b(x))
        # spatial average pool, the 1x1x1 logits conv, then the temporal
        # average of the frame logits
        x = x.mean(dim=(3, 4), keepdim=True)
        y = F.conv3d(x, self.Logits.w) + self.Logits.b[:, None, None, None]
        return y.mean(dim=(2, 3, 4))


def _flat_names(model: I3D):
    """(state-dict name, JAX path) of every leaf."""
    for name in model.state_dict():
        yield name, name.replace(".", "/")


def to_flat(model: I3D) -> Dict[str, np.ndarray]:
    """The JAX module's flat {path: float32 array}, kernels DHWIO."""
    sd = model.state_dict()
    out = {}
    for name, path in _flat_names(model):
        a = sd[name].detach().float().cpu().numpy()
        out[path] = np.ascontiguousarray(
            a.transpose(_TO_JAX) if a.ndim == 5 else a)
    return out


def from_flat(flat: Dict[str, np.ndarray], device="cuda") -> I3D:
    """An I3D on `device` holding the JAX module's flat parameters; raises
    on a missing or extra key, or a shape other than the JAX module's."""
    model = I3D(device=resolve_device(device))
    names = dict(_flat_names(model))
    want, have = set(names.values()), set(flat)
    if want != have:
        missing = sorted(want - have)[:5]
        extra = sorted(have - want)[:5]
        raise KeyError(f"I3D npz key mismatch; missing={missing} extra={extra}")
    sd = {}
    for name, path in names.items():
        a = np.asarray(flat[path], np.float32)
        if a.ndim == 5:
            a = a.transpose(_FROM_JAX)
        sd[name] = torch.tensor(a)
    model.load_state_dict(sd, strict=True)
    return model.eval()


def init(seed: int = 0, device="cuda") -> I3D:
    """Random init: He fan-in normal kernels drawn on the CPU by a
    torch.Generator of `seed` (the same weights on every device), zero
    beta and moving means, unit moving variances."""
    model = I3D(device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (Unit, Logits)):
                cout, cin, *k = mod.w.shape
                fan_in = cin * int(np.prod(k))
                std = np.sqrt((1.0 if isinstance(mod, Logits) else 2.0) / fan_in)
                mod.w.copy_(torch.randn(mod.w.shape, generator=g) * std)
    return model.to(resolve_device(device)).eval()


@torch.no_grad()
def embed(model: I3D, videos) -> torch.Tensor:
    """videos (B, T, H, W, 3) float in [0, 1], array or tensor -> (B, 400)
    logits on the model's device. I3D takes [-1, 1] inputs
    (frechet_video_distance.py preprocess)."""
    x = (videos if torch.is_tensor(videos)
         else torch.from_numpy(np.asarray(videos, np.float32)))
    x = x.to(next(model.parameters()).device, torch.float32)
    return model((x * 2.0 - 1.0).permute(0, 4, 1, 2, 3).contiguous())


def save_npz(model: I3D, path: str):
    np.savez(path, **to_flat(model))


def load_npz(path: str, device="cuda") -> I3D:
    """Converted I3D weights saved by save_npz / convert_tf_checkpoint (of
    either package)."""
    with np.load(path) as data:
        flat = {k: data[k] for k in data.files}
    return from_flat(flat, device)


# TF-Hub variable-name mapping for offline conversion (run on any machine
# with tensorflow and the i3d-kinetics-400 SavedModel, then ship the npz):
#   RGB/inception_i3d/<Block>/<...>/conv_3d/w           -> <path>/w
#   RGB/inception_i3d/<Block>/<...>/batch_norm/beta     -> <path>/beta
#   RGB/inception_i3d/<Block>/<...>/batch_norm/moving_mean -> /moving_mean
#   RGB/inception_i3d/<Block>/<...>/batch_norm/moving_variance -> /moving_var
#   branch dirs: Branch_0/Conv3d_0a_1x1 -> b0; Branch_1/Conv3d_0a_1x1 -> b1a,
#   Branch_1/Conv3d_0b_3x3 -> b1b; Branch_2 -> b2a/b2b; Branch_3/Conv3d_0b_1x1
#   -> b3; Logits/Conv3d_0c_1x1/conv_3d/{w,b} -> Logits/{w,b}.
def convert_tf_checkpoint(tf_vars: dict, device="cuda") -> I3D:
    """dict of TF variable name -> np.ndarray -> an I3D holding them. Pure
    renaming per the table above, each array reshaped to the JAX module's
    shape."""
    out = {}
    bn = {"beta": "beta", "moving_mean": "moving_mean",
          "moving_variance": "moving_var"}
    branch = {
        ("Branch_0", "Conv3d_0a_1x1"): "b0",
        ("Branch_1", "Conv3d_0a_1x1"): "b1a",
        ("Branch_1", "Conv3d_0b_3x3"): "b1b",
        ("Branch_2", "Conv3d_0a_1x1"): "b2a",
        ("Branch_2", "Conv3d_0b_3x3"): "b2b",
        ("Branch_3", "Conv3d_0b_1x1"): "b3",
    }
    for name, arr in tf_vars.items():
        parts = name.split("/")
        if "inception_i3d" in parts:
            parts = parts[parts.index("inception_i3d") + 1:]
        if parts[0] == "Logits":
            out[f"Logits/{'w' if parts[-1] == 'w' else 'b'}"] = arr
            continue
        block = parts[0]
        if block.startswith("Mixed"):
            base, rest = f"{block}/{branch[(parts[1], parts[2])]}", parts[3:]
        else:
            base, rest = block, parts[1:]
        if rest[0] == "conv_3d":
            out[f"{base}/w"] = arr
        elif rest[0] == "batch_norm":
            out[f"{base}/{bn[rest[1]]}"] = arr
    shapes = jax_shapes()
    for k in shapes:
        if k not in out:
            raise KeyError(f"TF checkpoint missing {k}")
    return from_flat({k: np.reshape(out[k], s) for k, s in shapes.items()},
                     device)


def jax_shapes() -> Dict[str, Tuple[int, ...]]:
    """{JAX path: shape} of every leaf, kernels DHWIO."""
    return {name.replace(".", "/"): tuple(t.permute(_TO_JAX).shape
                                          if t.ndim == 5 else t.shape)
            for name, t in I3D(device="meta").state_dict().items()}


# ---------------------------------------------------------------------------
# one-command convert-and-verify: on a machine with the TF-Hub module,
# `python -m ...evaluation.i3d --convert <module_dir_or_npz> --out
# i3d_kinetics400.npz` writes the weight file, verified against the pinned
# manifest (i3d_manifest.json: the key/shape table and a content-hash pin).


def content_hash(model_or_flat) -> str:
    """Deterministic sha256 over the parameter content in the JAX layout
    (sorted keys, shapes, float32 bytes): invariant to npz zip timestamps,
    and the JAX package's digest of the same weights."""
    import hashlib

    flat = (to_flat(model_or_flat) if isinstance(model_or_flat, nn.Module)
            else model_or_flat)
    h = hashlib.sha256()
    for k in sorted(flat):
        a = np.ascontiguousarray(np.asarray(flat[k], np.float32))
        h.update(k.encode())
        h.update(repr(a.shape).encode())
        h.update(a.tobytes())
    return h.hexdigest()


def verify_npz(path: str, device="cuda") -> dict:
    """Structure- and pin-check a converted weight file against the
    manifest, loading it onto `device`. Returns {'content_sha256',
    'n_params', 'pin': 'match'|'unpinned ...'}; raises on key or shape
    drift or a hash other than the pinned one."""
    flat = to_flat(load_npz(path, device))  # raises on a key-set mismatch
    with open(MANIFEST_PATH) as f:
        manifest = json.load(f)
    for k, shape in manifest["keys"].items():
        if list(np.shape(flat[k])) != shape:
            raise ValueError(
                f"shape drift at {k}: file has {list(np.shape(flat[k]))}, "
                f"manifest pins {shape}")
    digest = content_hash(flat)
    pinned = manifest.get("content_sha256")
    if pinned is None:
        pin = "unpinned (fill manifest content_sha256 on first real convert)"
    elif pinned == digest:
        pin = "match"
    else:
        raise ValueError(f"content hash {digest} does not match the pinned "
                         f"{pinned}")
    n = int(sum(np.size(v) for v in flat.values()))
    return {"content_sha256": digest, "n_params": n, "pin": pin}


def _load_tf_vars(src: str) -> dict:
    """TF variable name -> array, from (a) an .npz of raw TF-Hub variables
    (`np.savez(out, **{v.name: reader.get_tensor(v.name) ...})` on any TF
    machine), or (b) a TF-Hub SavedModel / checkpoint directory (needs
    tensorflow here)."""
    if src.endswith(".npz"):
        with np.load(src) as data:
            return {k: data[k] for k in data.files}
    try:
        import tensorflow as tf  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            "converting directly from a TF-Hub module needs tensorflow; "
            "alternatively dump the variables to an .npz on any TF machine "
            "and pass that file instead") from e
    ckpt = src
    if os.path.isdir(src):
        for cand in (os.path.join(src, "variables", "variables"),
                     os.path.join(src, "variables")):
            if os.path.exists(cand + ".index"):
                ckpt = cand
                break
    reader = tf.train.load_checkpoint(ckpt)
    return {name: reader.get_tensor(name)
            for name in reader.get_variable_to_shape_map()}


def main(argv=None):
    """CLI: --convert <tfhub_dir|tf_vars.npz> --out <weights.npz>, or
    --verify <weights.npz>; the weights load onto --device (the GPU unless
    --device cpu). Prints the content sha256 either way."""
    import argparse

    ap = argparse.ArgumentParser(description=main.__doc__)
    ap.add_argument("--convert", help="TF-Hub module dir / checkpoint "
                    "prefix / raw-variable npz to convert")
    ap.add_argument("--out", default="i3d_kinetics400.npz",
                    help="converted weight file to write")
    ap.add_argument("--verify", help="converted npz to check against the "
                    "pinned manifest")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; there is no fallback")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    if args.convert:
        save_npz(convert_tf_checkpoint(_load_tf_vars(args.convert), device),
                 args.out)
        report = {"wrote": args.out, **verify_npz(args.out, device)}
    elif args.verify:
        report = verify_npz(args.verify, device)
    else:
        ap.error("pass --convert or --verify")
    print(json.dumps(report))
    return report


if __name__ == "__main__":
    main()
