"""CycleGAN domain-transfer baseline (counterpart of
`robot_aware_control_tpu/baselines/cyclegan.py`).

The reference vendors pytorch-CycleGAN-and-pix2pix (reference:
src/cyclegan/models/cycle_gan_model.py:8-194, networks.py:119-615) and uses
it to translate goal and observation images between robot domains for the
zero-shot transfer baseline (reference: src/mbrl/push_episode_runner.py:
264-283, the --cyclegan flag, src/config/__init__.py:147). The port
follows the JAX package's network, which departs from the vendored one in
its padding:

  * ResNet generator (c7s1-64, d128, d256, n resnet blocks, u128, u64,
    c7s1-3, tanh) and 70x70 PatchGAN discriminator, NHWC, instance
    normalization (biased variance, eps 1e-5, a scale and a bias),
    reflection padding ahead of the 7x7 and the blocks' 3x3 convolutions,
    XLA's "SAME" padding elsewhere (the odd pixel at the high end);
  * the up-sampling blocks are `lax.conv_transpose` with stride 2 and
    "SAME" padding, whose kernel (HWIO) is not flipped: `ConvTranspose2x`
    stores it in the OIHW order of every convolution here and flips it
    once, for F.conv_transpose2d;
  * `CycleGAN.train_step` updates both generators (LSGAN + cycle L1 +
    identity L1) and then both discriminators on fakes drawn through the
    50-image history pool, whose draws come from np.random.RandomState(0)
    in the JAX order; two Adam optimizers (b1 0.5);
  * `CycleGANTranslator` is the inference wrapper the episode runners call.

Parameters are drawn by a torch.Generator from the seed, N(0, 0.02) as the
JAX `nn.conv_init`. `convert.cyclegan_state_dict` carries the JAX
package's `CycleGANParams`, `convert.cyclegan_flat` writes them back, and
`load_cyclegan_checkpoint` reads a `ckpt_<step>.npz` with a "cyclegan"
tree of either package.
"""

from __future__ import annotations

from typing import List

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from robot_aware_control_tpu_torch.ops.nn import Conv2d
from robot_aware_control_tpu_torch.utils.device import resolve_device


class InstanceNorm(nn.Module):
    """(x - mean) * rsqrt(var + eps) * scale + bias over H, W of each
    sample and channel (NHWC), the variance biased."""

    def __init__(self, c: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(c, device=device))
        self.bias = nn.Parameter(torch.zeros(c, device=device))

    def forward(self, x):
        var, mu = torch.var_mean(x, dim=(1, 2), keepdim=True, unbiased=False)
        return (x - mu) * torch.rsqrt(var + self.eps) * self.weight + self.bias


class ConvTranspose2x(nn.Module):
    """`lax.conv_transpose(x, w, strides=(2, 2), padding="SAME")` of a
    k x k HWIO kernel, NHWC: the input dilated by 2, padded as JAX pads it
    (pad_a low: k - 1 for k < 3, else ceil(k / 2)) and convolved with the
    kernel unflipped. F.conv_transpose2d flips its kernel, so the forward
    flips it once and crops torch's full output (pad k - 1 low) to JAX's
    2H x 2W window."""

    def __init__(self, cin: int, cout: int, k: int = 3, device=None):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cout, cin, k, k, device=device))
        self.bias = nn.Parameter(torch.zeros(cout, device=device))
        pad_a = k - 1 if k < 3 else -(-k // 2)
        self.crop = k - 1 - pad_a

    def forward(self, x):
        H, W = x.shape[1:3]
        w = self.weight.permute(1, 0, 2, 3).flip(2, 3)
        y = F.conv_transpose2d(x.permute(0, 3, 1, 2), w, self.bias, stride=2)
        c = self.crop
        return y[:, :, c:c + 2 * H, c:c + 2 * W].permute(0, 2, 3, 1)


def _refl(x, p: int):
    """Reflection padding of H and W by p (NHWC)."""
    return F.pad(x.permute(0, 3, 1, 2), (p, p, p, p),
                 mode="reflect").permute(0, 2, 3, 1)


class ResBlock(nn.Module):
    def __init__(self, c: int, device=None):
        super().__init__()
        self.c1 = Conv2d(c, c, 3, padding="valid", device=device)
        self.in1 = InstanceNorm(c, device=device)
        self.c2 = Conv2d(c, c, 3, padding="valid", device=device)
        self.in2 = InstanceNorm(c, device=device)

    def forward(self, h):
        r = F.relu(self.in1(self.c1(_refl(h, 1))))
        return h + self.in2(self.c2(_refl(r, 1)))


class Generator(nn.Module):
    """ResNet generator (reference: networks.py:315-395): x (B, H, W, 3) in
    [-1, 1] -> (B, H, W, 3) in [-1, 1]."""

    def __init__(self, in_ch: int = 3, ngf: int = 64, n_blocks: int = 6,
                 device=None):
        super().__init__()
        self.c1 = Conv2d(in_ch, ngf, 7, padding="valid", device=device)
        self.c1_in = InstanceNorm(ngf, device=device)
        self.d1 = Conv2d(ngf, ngf * 2, 3, stride=2, device=device)
        self.d1_in = InstanceNorm(ngf * 2, device=device)
        self.d2 = Conv2d(ngf * 2, ngf * 4, 3, stride=2, device=device)
        self.d2_in = InstanceNorm(ngf * 4, device=device)
        self.blocks = nn.ModuleList(ResBlock(ngf * 4, device)
                                    for _ in range(n_blocks))
        self.u1 = ConvTranspose2x(ngf * 4, ngf * 2, device=device)
        self.u1_in = InstanceNorm(ngf * 2, device=device)
        self.u2 = ConvTranspose2x(ngf * 2, ngf, device=device)
        self.u2_in = InstanceNorm(ngf, device=device)
        self.out = Conv2d(ngf, in_ch, 7, padding="valid", device=device)

    def forward(self, x):
        h = F.relu(self.c1_in(self.c1(_refl(x, 3))))
        h = F.relu(self.d1_in(self.d1(h)))
        h = F.relu(self.d2_in(self.d2(h)))
        for blk in self.blocks:
            h = blk(h)
        h = F.relu(self.u1_in(self.u1(h)))
        h = F.relu(self.u2_in(self.u2(h)))
        return torch.tanh(self.out(_refl(h, 3)))


class Discriminator(nn.Module):
    """70x70 PatchGAN (reference: networks.py:538-583)."""

    def __init__(self, in_ch: int = 3, ndf: int = 64, device=None):
        super().__init__()
        self.c1 = Conv2d(in_ch, ndf, 4, stride=2, device=device)
        self.c2 = Conv2d(ndf, ndf * 2, 4, stride=2, device=device)
        self.c2_in = InstanceNorm(ndf * 2, device=device)
        self.c3 = Conv2d(ndf * 2, ndf * 4, 4, stride=2, device=device)
        self.c3_in = InstanceNorm(ndf * 4, device=device)
        self.c4 = Conv2d(ndf * 4, ndf * 8, 4, device=device)
        self.c4_in = InstanceNorm(ndf * 8, device=device)
        self.out = Conv2d(ndf * 8, 1, 4, device=device)

    def forward(self, x):
        h = F.leaky_relu(self.c1(x), 0.2)
        h = F.leaky_relu(self.c2_in(self.c2(h)), 0.2)
        h = F.leaky_relu(self.c3_in(self.c3(h)), 0.2)
        h = F.leaky_relu(self.c4_in(self.c4(h)), 0.2)
        return self.out(h)


class CycleGANNets(nn.Module):
    """The four networks of the JAX `CycleGANParams`, by its field names."""

    def __init__(self, in_ch: int = 3, ngf: int = 64, ndf: int = 64,
                 n_blocks: int = 6, device=None):
        super().__init__()
        self.g_ab = Generator(in_ch, ngf, n_blocks, device)  # A -> B
        self.g_ba = Generator(in_ch, ngf, n_blocks, device)  # B -> A
        self.d_a = Discriminator(in_ch, ndf, device)  # discriminates A
        self.d_b = Discriminator(in_ch, ndf, device)  # discriminates B


def init(seed: int = 0, in_ch: int = 3, ngf: int = 64, ndf: int = 64,
         n_blocks: int = 6, device="cuda") -> CycleGANNets:
    """Weights N(0, 0.02) drawn on the CPU by a torch.Generator of `seed`
    (the same weights on every device), biases 0, norms' scales 1."""
    nets = CycleGANNets(in_ch, ngf, ndf, n_blocks, device="cpu")
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, p in nets.named_parameters():
            if p.ndim == 4:
                p.copy_(torch.randn(p.shape, generator=g) * 0.02)
            elif name.endswith("bias"):
                p.zero_()
            else:
                p.fill_(1.0)
    return nets.to(resolve_device(device))


def _lsgan(pred, target: float):
    return ((pred - target) ** 2).mean()


class CycleGAN:
    """Training container: the G and D updates and the host-side image
    pool (reference training loop: src/cyclegan/train.py,
    cycle_gan_model.py:104-194)."""

    def __init__(self, seed: int = 0, lr: float = 2e-4,
                 lambda_cycle: float = 10.0, lambda_id: float = 0.5,
                 in_ch: int = 3, n_blocks: int = 6, pool_size: int = 50,
                 device="cuda"):
        self.nets = init(seed, in_ch=in_ch, n_blocks=n_blocks, device=device)
        self.lambda_cycle = lambda_cycle
        self.lambda_id = lambda_id
        self.lr = lr
        self.reset_optimizers()
        self._pool_a: List[torch.Tensor] = []
        self._pool_b: List[torch.Tensor] = []
        self.pool_size = pool_size
        self._rng = np.random.RandomState(0)

    def reset_optimizers(self):
        """Fresh Adam states (b1 0.5) for the generators and the
        discriminators, over the networks' current parameters."""
        n = self.nets
        self.g_opt = torch.optim.Adam(
            [*n.g_ab.parameters(), *n.g_ba.parameters()], self.lr,
            betas=(0.5, 0.999))
        self.d_opt = torch.optim.Adam(
            [*n.d_a.parameters(), *n.d_b.parameters()], self.lr,
            betas=(0.5, 0.999))

    def _pool(self, pool, fakes):
        """50-image history pool (reference: util/image_pool.py semantics),
        drawing from the RandomState in the JAX order."""
        out = []
        for f in fakes:
            if len(pool) < self.pool_size:
                pool.append(f)
                out.append(f)
            elif self._rng.rand() > 0.5:
                i = self._rng.randint(len(pool))
                out.append(pool[i])
                pool[i] = f
            else:
                out.append(f)
        return torch.stack(out)

    def train_step(self, real_a, real_b):
        """real_a/real_b (B, H, W, 3) in [-1, 1] (arrays or tensors). One
        generator update, then one discriminator update on pooled fakes.
        Returns {"g_loss", "d_loss"} as floats."""
        n = self.nets
        dev = next(n.parameters()).device
        real_a, real_b = (torch.as_tensor(np.asarray(x, np.float32), device=dev)
                          if not torch.is_tensor(x) else x.to(dev)
                          for x in (real_a, real_b))
        lc, li = self.lambda_cycle, self.lambda_id
        d_params = [*n.d_a.parameters(), *n.d_b.parameters()]
        for p in d_params:
            p.requires_grad_(False)
        fake_b = n.g_ab(real_a)
        fake_a = n.g_ba(real_b)
        g_loss = (
            _lsgan(n.d_b(fake_b), 1.0)
            + _lsgan(n.d_a(fake_a), 1.0)
            + lc * (n.g_ba(fake_b) - real_a).abs().mean()
            + lc * (n.g_ab(fake_a) - real_b).abs().mean()
            + lc * li * (n.g_ba(real_a) - real_a).abs().mean()
            + lc * li * (n.g_ab(real_b) - real_b).abs().mean()
        )
        self.g_opt.zero_grad(set_to_none=True)
        g_loss.backward()
        self.g_opt.step()
        for p in d_params:
            p.requires_grad_(True)
        fake_a = self._pool(self._pool_a, fake_a.detach())
        fake_b = self._pool(self._pool_b, fake_b.detach())
        d_loss = 0.5 * (
            _lsgan(n.d_a(real_a), 1.0) + _lsgan(n.d_a(fake_a), 0.0)
            + _lsgan(n.d_b(real_b), 1.0) + _lsgan(n.d_b(fake_b), 0.0)
        )
        self.d_opt.zero_grad(set_to_none=True)
        d_loss.backward()
        self.d_opt.step()
        return {"g_loss": g_loss.item(), "d_loss": d_loss.item()}


class CycleGANTranslator:
    """Inference wrapper the runners use to translate observations and
    goals across robot domains (reference: push_episode_runner.py:
    264-283), on the networks' device."""

    def __init__(self, nets: CycleGANNets, direction: str = "ab"):
        self.gen = (nets.g_ab if direction == "ab" else nets.g_ba).eval()
        self.device = next(self.gen.parameters()).device

    @torch.no_grad()
    def __call__(self, img):
        """img (H, W, 3) or (B, H, W, 3) float [0, 1] -> the same shape in
        [0, 1], numpy float32."""
        x = torch.as_tensor(np.asarray(img, np.float32), device=self.device)
        single = x.ndim == 3
        if single:
            x = x[None]
        y = (self.gen(x * 2.0 - 1.0) + 1.0) / 2.0
        return (y[0] if single else y).cpu().numpy()


def load_cyclegan_checkpoint(nets: CycleGANNets, path: str) -> CycleGANNets:
    """Loads the "cyclegan" tree of a ckpt_<step>.npz (JAX keys:
    `.g_ab['c1']['w']`, ...; either package's) into `nets`, strictly."""
    from robot_aware_control_tpu_torch import convert
    from robot_aware_control_tpu_torch.training import checkpoint as ckpt

    trees, _ = ckpt.load_checkpoint(path, {"cyclegan": convert.cyclegan_flat(nets)})
    nets.load_state_dict(
        convert.cyclegan_state_dict_from_flat(trees["cyclegan"]), strict=True)
    return nets

