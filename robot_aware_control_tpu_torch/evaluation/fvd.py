"""Frechet Video Distance (counterpart of
`robot_aware_control_tpu/evaluation/fvd.py`; reference:
src/prediction/evaluation/frechet_video_distance/frechet_video_distance.py:
37-120): the Frechet distance between Gaussian fits of video embeddings.
The reference pulls a TF1 I3D network from TF-hub, out of reach offline,
so the embedding is pluggable:

  * the default: a fixed-seed random 3-D conv feature pyramid
    (spatiotemporal convolutions and pooling -> a 400-d embedding),
    its weights drawn on the CPU by a torch.Generator of seed 42, so the
    same weights on every device. Random-feature Frechet distances are
    well defined and grow with the mismatch of the distributions; they are
    comparable between runs of this embedder, not to I3D-FVD;
  * `make_i3d_embed_fn`: the I3D of evaluation/i3d.py, with converted
    weights (reference-comparable) or random ones (self-consistent only).

`frechet_distance` is the reference's math (frechet_video_distance.py:
107-120), in numpy. The embedders run on `device` (the GPU unless the
caller asks for the CPU), convolutions and max pools padded as XLA's
"SAME" pads them.
"""

from __future__ import annotations

import sys
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from robot_aware_control_tpu_torch.evaluation.i3d import conv3d_same, max_pool3d_same
from robot_aware_control_tpu_torch.utils.device import resolve_device

EMBED_DIM = 400
_SHAPES = [(3, 5, 5, 3, 32), (3, 3, 3, 32, 64), (3, 3, 3, 64, 128)]  # DHWIO


def random_embedder_params(seed: int = 42) -> Tuple[List[np.ndarray], np.ndarray]:
    """The embedder's 3-layer 3-D conv pyramid, He-scaled normal kernels
    (DHWIO, the JAX layout) and its (128, 400) projection, float32 numpy
    drawn by a torch.Generator of `seed`."""
    g = torch.Generator().manual_seed(seed)
    ws = [(torch.randn(s, generator=g) * np.sqrt(2.0 / np.prod(s[:-1]))).numpy()
          for s in _SHAPES]
    w_out = (torch.randn(128, EMBED_DIM, generator=g) * np.sqrt(1.0 / 128)).numpy()
    return ws, w_out


@torch.no_grad()
def default_embed_fn(videos, params=None, device="cuda") -> torch.Tensor:
    """videos (B, T, H, W, 3) float [0, 1] -> (B, EMBED_DIM) embeddings on
    `device`; `params` as `random_embedder_params` gives them (default:
    seed 42)."""
    dev = resolve_device(device)
    ws, w_out = params if params is not None else random_embedder_params()
    x = videos if torch.is_tensor(videos) else torch.from_numpy(
        np.asarray(videos, np.float32))
    x = (x.to(dev, torch.float32) * 2.0 - 1.0).permute(0, 4, 1, 2, 3)
    for w in ws:  # [-1, 1] like I3D
        w = torch.tensor(np.asarray(w, np.float32), device=dev)
        x = F.relu(conv3d_same(x, w.permute(4, 3, 0, 1, 2), (1, 2, 2)))
        x = max_pool3d_same(x, (2, 2, 2), (2, 2, 2))
    feat = x.mean(dim=(2, 3, 4))  # global average pool
    return feat @ torch.tensor(np.asarray(w_out, np.float32), device=dev)


def _sqrtm_psd(mat):
    """Matrix square root of a symmetric PSD matrix via eigh."""
    vals, vecs = np.linalg.eigh((mat + mat.T) / 2.0)
    vals = np.clip(vals, 0, None)
    return (vecs * np.sqrt(vals)) @ vecs.T


def frechet_distance(mu1, sigma1, mu2, sigma2):
    """||mu1-mu2||^2 + Tr(s1 + s2 - 2 sqrt(s1 s2))
    (reference: frechet_video_distance.py:107-120)."""
    diff = mu1 - mu2
    s1 = _sqrtm_psd(sigma1)
    covmean = _sqrtm_psd(s1 @ sigma2 @ s1)
    return float(diff @ diff + np.trace(sigma1 + sigma2 - 2.0 * covmean))


def make_i3d_embed_fn(weights_path: Optional[str] = None,
                      device="cuda") -> Callable:
    """The I3D embedding (evaluation/i3d.py, the reference's TF-Hub
    i3d-kinetics-400 architecture) on `device`. With `weights_path` (a
    converted npz) FVD values are comparable to the reference's; without
    it the I3D runs with random init (seed 42): self-consistent only."""
    from robot_aware_control_tpu_torch.evaluation import i3d

    model = (i3d.load_npz(weights_path, device) if weights_path
             else i3d.init(42, device))

    def embed(videos):
        return i3d.embed(model, videos)

    embed.caveat = (
        None if weights_path else
        "I3D weights not loaded (offline build): random-init I3D — FVD "
        "values are self-consistent, NOT comparable to reference I3D-FVD"
    )
    return embed


def embedder_caveat(embed_fn: Optional[Callable]) -> Optional[str]:
    """The caveat that travels with every FVD number: None only for an I3D
    with loaded weights."""
    if embed_fn is None:
        return (
            "random-feature embedder (no I3D weights): FVD values are "
            "self-consistent, NOT comparable to reference I3D-FVD"
        )
    return getattr(embed_fn, "caveat", None)


def fvd(real_videos, fake_videos, embed_fn: Optional[Callable] = None,
        i3d_weights: Optional[str] = None, device="cuda") -> float:
    """real/fake (B, T, H, W, 3) float [0, 1]. Pass `i3d_weights` (a
    converted npz, see evaluation/i3d.py) for reference-comparable
    I3D-FVD; without `embed_fn` the random embedder runs on `device`."""
    if embed_fn is None and i3d_weights is not None:
        embed_fn = make_i3d_embed_fn(i3d_weights, device)
    embed = embed_fn or (lambda v: default_embed_fn(v, device=device))
    caveat = embedder_caveat(embed_fn)
    if caveat:
        print(f"[fvd] {caveat}", file=sys.stderr)
    e1 = np.asarray(torch.as_tensor(embed(real_videos)).cpu(), np.float64)
    e2 = np.asarray(torch.as_tensor(embed(fake_videos)).cpu(), np.float64)
    mu1, mu2 = e1.mean(0), e2.mean(0)
    s1 = np.cov(e1, rowvar=False)
    s2 = np.cov(e2, rowvar=False)
    return frechet_distance(mu1, s1, mu2, s2)
