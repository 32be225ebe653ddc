"""Planning costs: robot / world decomposed rewards on batched tensors.

Counterpart of `robot_aware_control_tpu/planning/cost.py` (reference:
src/prediction/losses.py:172-335, env-side reward types in
src/env/robotics/clutter_push.py:681-744). Conventions:

  * costs are *rewards* — negated distances; the planner maximizes.
  * images are float in [0,1]; distances are computed on a 255 scale.
  * the don't-care image cost zeroes the union of current and goal robot
    masks and normalizes by the world-pixel count.

Shapes: curr_img (N,H,W,C), goal_img (H,W,C) or (N,H,W,C); masks (...,1).
Returns (N,) float32 rewards.
"""

from __future__ import annotations

import functools

import torch

from robot_aware_control_tpu_torch.config import Config


def _bsum(x):
    """Sum over all but the leading batch axis."""
    return x.sum(dim=tuple(range(1, x.dim())))


def robot_l2_cost(curr_state, goal_state):
    """-||curr - goal||_2 over state vectors (reference: losses.py:183-207)."""
    d = (curr_state.float() - goal_state.float()) ** 2
    return -torch.sqrt(_bsum(d))


def img_l2_cost(cfg: Config, curr_img, goal_img):
    """-||255*(curr - goal)||_2 per batch element; optional threshold-count
    mode (reference: losses.py:210-238)."""
    c, g = curr_img.float(), goal_img.float()
    if cfg.img_cost_threshold is not None:
        diff = torch.abs(255.0 * (c - g))
        return -_bsum(diff > cfg.img_cost_threshold).float()
    return -torch.sqrt(_bsum((255.0 * (c - g)) ** 2))


def img_dontcare_cost(cfg: Config, curr_img, goal_img, curr_mask, goal_mask):
    """L2 over the union-masked world region, normalized by world pixels
    (reference: losses.py:240-288)."""
    c, g = curr_img.float(), goal_img.float()
    union = (curr_mask.float() > 0.5) | (goal_mask.float() > 0.5)
    keep = 1.0 - union.float()
    if cfg.img_cost_threshold is not None:
        diff = torch.abs(255.0 * (c - g)) * keep
        loss = _bsum(diff > cfg.img_cost_threshold).float()
    else:
        loss = torch.sqrt(_bsum(((255.0 * (c - g)) * keep) ** 2))
    if cfg.img_cost_world_norm:
        loss = loss / torch.clamp(_bsum(keep), min=1.0)
    return -loss


def _gaussian_kernel1d(sigma: float, radius: int):
    xs = torch.arange(-radius, radius + 1, dtype=torch.float32)
    k = torch.exp(-(xs ** 2) / (2.0 * sigma ** 2))
    return k / k.sum()


@functools.lru_cache(maxsize=None)
def _blur_matrix(n: int, sigma: float, radius: int, device: str):
    """The (n, n) float64 matrix M with (M @ x)[i] = sum_t k[t] x[i + t -
    radius] over the in-image taps: a "SAME" convolution with the float32
    kernel k of `radius`, its zero-padded taps left out."""
    k = _gaussian_kernel1d(sigma, radius).double()
    off = torch.arange(n)[None, :] - torch.arange(n)[:, None]
    m = torch.where(off.abs() <= radius, k[(off + radius).clamp(0, 2 * radius)],
                    torch.zeros((), dtype=torch.float64))
    return m.to(device)


def gaussian_blur(img, sigma: float, radius: int):
    """Separable depthwise gaussian blur of (N, H, W, C) images with a
    (2 radius + 1)-tap kernel, "SAME" (JAX `cost.py:gaussian_blur`); returns
    float32. Each pass is a product with a banded (H, H) or (W, W) matrix,
    not a convolution: at the default radius of 127 most of a 255-tap
    kernel lies on the padding of a 48x64 image. The products run in
    float64, which no TF32 setting touches: the inpaint-blur cost floors
    255 x the blur, so a sum off by TF32's 10-bit rounding would move
    pixels across 1/255 steps."""
    x = img.double()
    dev = str(x.device)
    x = torch.einsum("ij,njwc->niwc", _blur_matrix(x.shape[1], sigma, radius,
                                                   dev), x)
    x = torch.einsum("ij,nhjc->nhic", _blur_matrix(x.shape[2], sigma, radius,
                                                   dev), x)
    return x.float()


class InpaintBlurCost:
    """Gaussian-blurred image MSE cost of the inpaint-blur reward (JAX
    `cost.py:InpaintBlurCost`; reference: src/prediction/losses.py:109-154):
    blur with sigma = blur_sigma over the reference's window, floor to 1/255
    steps (the reference's (255 * gaussian(...)).astype(np.uint8)), then
    -MSE per image; an unblurred step costs -unblur_cost_scale * MSE.
    Returns (N,) float32."""

    def __init__(self, cfg: Config):
        self.sigma = cfg.blur_sigma
        self.unblur_cost_scale = cfg.unblur_cost_scale
        # radius from the reference's truncate math: (w-1)/2 - 0.5 pixels
        self.radius = max(int(((cfg.img_dim * 2 - 1) / 2 - 0.5)), 1)

    def __call__(self, img, goal, blur: bool = True):
        img, goal = img.float(), goal.float()
        if img.dim() == 3:
            img = img[None]
        if goal.dim() == 3:
            goal = goal[None]
        if not blur:
            return -self.unblur_cost_scale * ((img - goal) ** 2).mean((1, 2, 3))
        floor = lambda x: torch.floor(
            255.0 * gaussian_blur(x, self.sigma, self.radius)) / 255.0
        return -((floor(img) - floor(goal)) ** 2).mean((1, 2, 3))


def _mask2d(mask, like):
    """Broadcast a (...,H,W[,1]) mask against a (N,H,W,C) image batch."""
    m = torch.as_tensor(mask, dtype=torch.float32, device=like.device)
    if m.shape[-1] != 1:  # no channel axis: (H,W) / (N,H,W)
        m = m[..., None]
    return (m > 0.5).float().expand(like.shape[:-1] + (1,))


def img_weighted_cost(cfg: Config, curr_img, goal_img, curr_mask, goal_mask):
    """weighted reward: robot pixels down-weighted by robot_pixel_weight
    once per mask, so pixels in BOTH masks get weight^2 (reference:
    src/env/robotics/clutter_push.py:717-721)."""
    c = curr_img.float()
    g = goal_img.float().expand(c.shape)
    a = cfg.robot_pixel_weight
    w = torch.where(_mask2d(goal_mask, c) > 0, a, 1.0)
    w = w * torch.where(_mask2d(curr_mask, c) > 0, a, 1.0)
    return -torch.sqrt(_bsum((255.0 * (c - g) * w) ** 2))


def img_inpaint_cost(cfg: Config, curr_img, goal_img, curr_mask,
                     background=None):
    """inpaint reward: replace current robot pixels with the background
    image, then plain L2 (reference: clutter_push.py:689-717,524-528). With
    no background, robot pixels are zeroed (== blackrobot)."""
    c = curr_img.float()
    g = goal_img.float().expand(c.shape)
    m = _mask2d(curr_mask, c)
    bg = (torch.zeros_like(c) if background is None else
          torch.as_tensor(background, dtype=torch.float32,
                          device=c.device).expand(c.shape))
    c = c * (1.0 - m) + bg * m
    return -torch.sqrt(_bsum((255.0 * (c - g)) ** 2))


def img_blackrobot_cost(cfg: Config, curr_img, goal_img, curr_mask):
    """blackrobot reward: zero current robot pixels, plain L2 vs the
    (pre-blacked) goal (reference: clutter_push.py:722-728,530-532)."""
    c = curr_img.float()
    g = goal_img.float().expand(c.shape)
    c = c * (1.0 - _mask2d(curr_mask, c))
    return -torch.sqrt(_bsum((255.0 * (c - g)) ** 2))


def img_sparse_cost(cfg: Config, curr_img, goal_img):
    """sparse reward: -(||curr-goal|| > threshold) (reference:
    clutter_push.py:742-744); threshold = img_cost_threshold (default 0)."""
    d = -img_l2_cost(cfg.replace(img_cost_threshold=None), curr_img, goal_img)
    return -(d > (cfg.img_cost_threshold or 0.0)).float()


class RobotWorldCost:
    """robot_cost_weight * RobotL2 + world_cost_weight * WorldCost with the
    world cost dispatched per reward_type (reference: losses.py:290-335,
    clutter_push.py:681-744). eef_inpaint = robot-eef L2 + inpainted-image
    L2. Returns (N,) rewards."""

    def __init__(self, cfg: Config):
        self.cfg = cfg
        self.robot_w = cfg.robot_cost_weight
        self.world_w = cfg.world_cost_weight
        self.reward_type = cfg.reward_type
        self.blur = (InpaintBlurCost(cfg) if cfg.reward_type == "inpaint-blur"
                     else None)

    def world_cost(self, curr_img, goal_img, curr_mask=None, goal_mask=None,
                   background=None, blur: bool = True):
        """`blur` selects the inpaint-blur cost's blurred branch (the
        rollout unblurs its last `unblur_timestep` steps); other rewards
        ignore it."""
        rt, cfg = self.reward_type, self.cfg
        if rt == "dontcare":
            return img_dontcare_cost(cfg, curr_img, goal_img, curr_mask,
                                     goal_mask)
        if rt == "inpaint-blur":
            return self.blur(curr_img, goal_img, blur=blur)
        if rt in ("inpaint", "eef_inpaint"):
            return img_inpaint_cost(cfg, curr_img, goal_img, curr_mask,
                                    background)
        if rt == "blackrobot":
            return img_blackrobot_cost(cfg, curr_img, goal_img, curr_mask)
        if rt == "weighted":
            if curr_mask is None or goal_mask is None:
                return img_l2_cost(cfg, curr_img, goal_img)
            return img_weighted_cost(cfg, curr_img, goal_img, curr_mask,
                                     goal_mask)
        if rt == "sparse":
            return img_sparse_cost(cfg, curr_img, goal_img)
        # dense and anything else: plain image L2
        return img_l2_cost(cfg, curr_img, goal_img)

    def __call__(self, curr_img, goal_img, curr_mask=None, goal_mask=None,
                 curr_state=None, goal_state=None, background=None,
                 blur: bool = True):
        total = 0.0
        if self.robot_w != 0 and curr_state is not None and goal_state is not None:
            total = total + self.robot_w * robot_l2_cost(curr_state, goal_state)
        if self.world_w != 0:
            total = total + self.world_w * self.world_cost(
                curr_img, goal_img, curr_mask, goal_mask, background=background,
                blur=blur)
        return total
