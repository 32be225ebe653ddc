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
from robot_aware_control_tpu_torch.training.step import make_eval_step
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State
from torch_mask_cases import MASK_CASES, mask_case
from torch_train_small import (
    EVAL_TOL,
    GRAD_TOL_DEVICES,
    TRAIN_SMALL,
    bench_batch,
    eval_kernel_vs_plain,
    train_step_parity,
)

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU: the kernels have no CPU mode")
    return torch.device("cuda")


# ----------------------------------------------------------- capsule masks
@pytest.mark.parametrize("case", list(MASK_CASES))
def test_gpu_mask_kernel_equals_plain(cuda, case):
    """Bit for bit, one launch (none for M = 0)."""
    segs, h, w = mask_case(case, cuda)
    before = kernels.launches["capsule_mask_render"]
    got = kernels.capsule_mask_render(segs, h, w)
    assert kernels.launches["capsule_mask_render"] == before + (len(segs) > 0)
    assert got.shape == (len(segs), h, w)
    assert torch.equal(got, kernels.capsule_mask_render_plain(segs, h, w))


def test_gpu_mask_kernel_past_the_default_shared_memory(cuda):
    """MASK_MAX_SEGMENTS capsules a mask take more than the 48 KB of shared
    memory a launch gets by default; the launch opts into more. Capsules at
    the ends of the shared array each mark their own patch of the image."""
    S = kernels.MASK_MAX_SEGMENTS
    segs = torch.tensor([-1000.0, -1000.0, -990.0, -1000.0, 3.0, 3.0]
                        ).repeat(2, S, 1)
    for i, s in enumerate([0, 1023, 1024, 2047, 2048, S - 1]):
        segs[i % 2, s] = torch.tensor([5.0 + 10 * i, 10.0 + 5 * i,
                                       8.0 + 10 * i, 30.0, 2.0, 3.0])
    segs = segs.to(cuda)
    got = kernels.capsule_mask_render(segs, 48, 64)
    want = kernels.capsule_mask_render_plain(segs, 48, 64)
    assert torch.equal(got, want)
    assert int(want[0].sum()) > 0 and int(want[1].sum()) > 0


def test_gpu_mask_rejects_more_capsules_than_shared_memory_holds(cuda):
    segs = torch.zeros(2, kernels.MASK_MAX_SEGMENTS + 1, 6, device=cuda)
    with pytest.raises(ValueError, match="capsules"):
        kernels.capsule_mask_render(segs, 48, 64)


def _cell_args(dev, dtype, B, H, W, Cx, C, k, seed=0):
    g = torch.Generator().manual_seed(seed)
    x, h, c = (torch.randn(B, H, W, n, generator=g) for n in (Cx, C, C))
    w = torch.randn(k, k, Cx + C, 4 * C, generator=g) * 0.05
    b = torch.randn(4 * C, generator=g) * 0.1
    return [t.to(dev, dtype) for t in (x, h, c, w)] + [b.to(dev)]


def _assert_cell_close(got, want, dtype, tol):
    for gv, wv in zip(got, want):
        assert gv.dtype == dtype
        torch.testing.assert_close(gv.float(), wv.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
# bf16 with channels in multiples of 8 takes the wgmma/TMA kernel; 13/20
# channels the WMMA kernel's element-wise loads, and C=20 leaves part of a
# 32-channel tile empty; float32 always the CUDA-core kernel
@pytest.mark.parametrize("B,H,W,Cx,C,k", [(3, 5, 7, 24, 40, 5),
                                          (2, 6, 8, 13, 20, 3)])
def test_gpu_cell_kernel_matches_plain(cuda, monkeypatch, dtype, tol,
                                       B, H, W, Cx, C, k):
    """f32 to 1e-4 with TF32 off on the plain side; bf16 to one bf16
    rounding step (1e-2 absolute and relative)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    args = _cell_args(cuda, dtype, B, H, W, Cx, C, k)
    before = dict(kernels.launches)
    got = kernels.conv_lstm_cell(*args)
    sm90 = dtype == torch.bfloat16 and Cx % 8 == 0 and C % 8 == 0
    assert kernels.launches["conv_lstm_cell"] == before["conv_lstm_cell"] + 1
    assert (kernels.launches["conv_lstm_cell_sm90"]
            == before["conv_lstm_cell_sm90"] + sm90)
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*args), dtype, tol)


# Cx != C catches misplaced B tiles; C = 40 a partial 64-channel tile; B = 3
# and 13 a batch run (16 entries) that TMA fills past the end; 5x7 maps a
# row narrower than the 8-column box; k = 5 on 5 or 6 rows skips row taps
# at the border; then the planner's cell0 (B = 100) and the trainer's eval
# cells (B = 16: 24 output tiles, another stream-K split)
@pytest.mark.parametrize("B,H,W,Cx,C,k", [
    (3, 6, 8, 64, 128, 5), (13, 5, 7, 64, 128, 3), (13, 6, 8, 40, 40, 3),
    (3, 5, 7, 24, 40, 5), (13, 5, 7, 128, 64, 5), (100, 6, 8, 256, 256, 5),
    (16, 6, 8, 256, 256, 5), (16, 6, 8, 256, 256, 3)])
def test_gpu_sm90_cell_matches_plain(cuda, B, H, W, Cx, C, k):
    """The wgmma/TMA kernel to one bf16 rounding step (1e-2 absolute and
    relative), launched once per call."""
    args = _cell_args(cuda, torch.bfloat16, B, H, W, Cx, C, k, seed=B + k)
    before = kernels.launches["conv_lstm_cell_sm90"]
    got = kernels.conv_lstm_cell(*args)
    assert kernels.launches["conv_lstm_cell_sm90"] == before + 1
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*args),
                       torch.bfloat16, 1e-2)


def test_gpu_wmma_cell_matches_plain_on_16_byte_rows(cuda):
    """The WMMA kernel's 16-byte loads, which the planner's shapes take
    when it is called by name."""
    args = _cell_args(cuda, torch.bfloat16, 3, 5, 7, 24, 40, 5)
    before = kernels.launches["conv_lstm_cell_sm90"]
    got = kernels.conv_lstm_cell_wmma(*args)
    assert kernels.launches["conv_lstm_cell_sm90"] == before
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*args),
                       torch.bfloat16, 1e-2)


def test_gpu_unaligned_bf16_cell_takes_wmma(cuda):
    """A tensor TMA cannot address (not 16-byte aligned) goes to the WMMA
    kernel, and the result still matches."""
    x, h, c, w, b = _cell_args(cuda, torch.bfloat16, 2, 6, 8, 16, 16, 3)
    x = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)[1:].view(
        x.shape).copy_(x)
    assert x.data_ptr() % 16 != 0
    before = kernels.launches["conv_lstm_cell_sm90"]
    got = kernels.conv_lstm_cell(x, h, c, w, b)
    assert kernels.launches["conv_lstm_cell_sm90"] == before
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(x, h, c, w, b),
                       torch.bfloat16, 1e-2)


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
    assert launched == {"conv_lstm_cell": 16, "conv_lstm_cell_sm90": 0,
                        "capsule_mask_render": 2}
    np.testing.assert_allclose(plans["cuda"], plans["cpu"], atol=1e-4)


# ---------------------------------------------------------------- training
def test_gpu_train_step_matches_cpu(cuda, monkeypatch):
    """One small float32 train step and one eval step, same weights,
    window and draws, GPU against CPU (torch_train_small.py): loss,
    metrics, BatchNorm statistics and eval outputs to 1e-4; gradients to
    GRAD_TOL_DEVICES of each leaf's norm; no kernel in the train step, the
    eval step's cells through the float32 kernel."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    errs, _ = train_step_parity(cuda)
    assert errs["grads_norm"] <= GRAD_TOL_DEVICES


def test_gpu_bf16_eval_step_takes_sm90(cuda):
    """A bf16 eval step from float32 training weights: every cell launch
    (6 a model step) through the wgmma/TMA kernel, finite metrics."""
    cfg = Config(**TRAIN_SMALL).replace(compute_dtype="bfloat16")
    model = svg.init(cfg, 3, cuda, train=True)
    before = dict(kernels.launches)
    per_step, preds = make_eval_step(cfg, model)(
        bench_batch(cfg.replace(n_future=cfg.n_eval - 1), 2, 2, cuda),
        torch.Generator(cuda).manual_seed(0))
    cells = 6 * (cfg.n_eval - 1)
    assert kernels.launches["conv_lstm_cell"] - before["conv_lstm_cell"] == cells
    assert (kernels.launches["conv_lstm_cell_sm90"]
            - before["conv_lstm_cell_sm90"] == cells)
    assert preds.shape == (3, 2, 48, 64, 3)
    assert all(bool(torch.isfinite(v).all()) for v in per_step.values())


def test_gpu_full_width_eval_step_kernel_matches_plain(cuda):
    """The trainer's eval step at full width (g_dim 256, B = 16, bf16),
    autoregressive and one-step: with the cell kernel, every launch
    through sm90, against the same step with its plain version, to
    EVAL_TOL of the predictions' and metrics' max."""
    result = eval_kernel_vs_plain(cuda)
    assert max(r["preds"] for r in result.values()) <= EVAL_TOL


def test_gpu_kernels_refuse_autograd(cuda):
    """Under autograd with an input that requires grad, the wrappers raise
    rather than return outputs with no gradient; under no_grad they run."""
    x, h, c, w, b = _cell_args(cuda, torch.float32, 1, 6, 8, 8, 8, 3)
    w.requires_grad_(True)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.conv_lstm_cell(x, h, c, w, b)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.conv_lstm_cell_wmma(x.bfloat16(), h.bfloat16(), c.bfloat16(),
                                    w.bfloat16(), b)
    segs, hh, ww = mask_case("planner_500", cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.capsule_mask_render(segs.requires_grad_(True), hh, ww)
    with torch.no_grad():
        kernels.conv_lstm_cell(x, h, c, w, b)
        kernels.capsule_mask_render(segs, hh, ww)
