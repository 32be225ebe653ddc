"""The port's CUDA kernels against their plain versions, on a GPU.

These tests skip without a CUDA device. They import neither JAX nor the
JAX package, so that they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.models import svg
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


def test_gpu_mask_kernel_equals_plain(cuda):
    rng = np.random.RandomState(0)
    a = rng.uniform(-10, 74, (37, 8, 2))
    b = a + rng.randn(37, 8, 2) * 15
    r = rng.uniform(0.5, 9.0, (37, 8, 2))
    segs = torch.tensor(np.concatenate([a, b, r], -1).astype(np.float32),
                        device=cuda)
    before = kernels.launches["capsule_mask_render"]
    got = kernels.capsule_mask_render(segs, 48, 64)
    assert kernels.launches["capsule_mask_render"] == before + 1
    assert torch.equal(got, kernels.capsule_mask_render_plain(segs, 48, 64))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
# channels in multiples of 8 take the bf16 kernel's 16-byte loads; 13/20 the
# element-wise loads, and C=20 leaves part of a 32-channel tile empty
@pytest.mark.parametrize("B,H,W,Cx,C,k", [(3, 5, 7, 24, 40, 5),
                                          (2, 6, 8, 13, 20, 3)])
def test_gpu_cell_kernel_matches_plain(cuda, monkeypatch, dtype, tol,
                                       B, H, W, Cx, C, k):
    """f32 to 1e-4 with TF32 off on the plain side; bf16 to one bf16
    rounding step (1e-2 absolute and relative)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    g = torch.Generator().manual_seed(0)
    x, h, c = (torch.randn(B, H, W, n, generator=g) for n in (Cx, C, C))
    w = torch.randn(k, k, Cx + C, 4 * C, generator=g) * 0.05
    b = torch.randn(4 * C, generator=g) * 0.1
    args = [t.to(cuda, dtype) for t in (x, h, c, w)] + [b.to(cuda)]
    before = kernels.launches["conv_lstm_cell"]
    got = kernels.conv_lstm_cell(*args)
    assert kernels.launches["conv_lstm_cell"] == before + 1
    want = kernels.conv_lstm_cell_plain(*args)
    for gv, wv in zip(got, want):
        assert gv.dtype == dtype
        torch.testing.assert_close(gv.float(), wv.float(), rtol=tol, atol=tol)


def test_gpu_cell_rejects_mixed_types(cuda):
    x = torch.zeros(1, 6, 8, 4, device=cuda)
    h = torch.zeros(1, 6, 8, 8, device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        kernels.conv_lstm_cell(x, h, h, torch.zeros(3, 3, 12, 32, device=cuda),
                               torch.zeros(32, device=cuda))


def test_gpu_small_plan_goes_through_both_kernels(cuda, monkeypatch):
    """A small float32 plan on the GPU launches 4 cells per model step and
    one mask render per iteration, and equals the CPU plan to 1e-4."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = Config(model="svg", g_dim=16, z_dim=4, action_dim=5, robot_dim=5,
                 model_use_mask=True, model_use_future_mask=True,
                 reconstruction_loss="dontcare_l1", reward_type="dontcare",
                 compute_dtype="float32", horizon=3, opt_iter=2,
                 action_candidates=6, topk=2, cem_init_std=0.015,
                 sample_mean=True)
    rng = np.random.RandomState(1)
    start = State(img=rng.rand(48, 64, 3).astype(np.float32),
                  state=np.array([0.3, 0.0, 0.15, 0, 0], np.float32),
                  qpos=np.zeros(5, np.float32))
    goal = DemoGoalState(imgs=[rng.rand(48, 64, 3).astype(np.float32)],
                         masks=[np.zeros((48, 64), np.float32)])
    noise = rng.randn(2, 6, 2, 2)
    plans = {}
    for dev in ("cpu", "cuda"):
        before = dict(kernels.launches)
        plans[dev] = CEMPolicy(cfg, svg.init(cfg, 0, dev), device=dev
                               ).get_action(start, goal, noise=noise)
        launched = {k: kernels.launches[k] - before[k] for k in before}
    assert launched == {"conv_lstm_cell": 16, "capsule_mask_render": 2}
    np.testing.assert_allclose(plans["cuda"], plans["cpu"], atol=1e-4)
