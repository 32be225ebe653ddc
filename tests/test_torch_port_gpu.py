"""The port's CUDA kernels against their plain versions, on a GPU.

These tests skip without a CUDA device. They import neither JAX nor the
JAX package, so that they run where only PyTorch is installed:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_port_gpu.py
"""

import numpy as np
import pytest
import torch

from robot_aware_control_tpu_torch.config import Config
from robot_aware_control_tpu_torch.control.plan_server import PlanServer
from robot_aware_control_tpu_torch.data.loader import DataLoader
from robot_aware_control_tpu_torch.data.records import RecordDataset
from robot_aware_control_tpu_torch.data.robonet_hdf5 import RoboNetHDF5Dataset
from robot_aware_control_tpu_torch.models import svg
from robot_aware_control_tpu_torch.models.registry import get_model
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.planning.cem import CEMPolicy
from robot_aware_control_tpu_torch.envs.variants import make
from robot_aware_control_tpu_torch.planning.gt_rollout import GTPushCEMPolicy
from robot_aware_control_tpu_torch.planning.rollout import RolloutEngine, prepare_goals
from robot_aware_control_tpu_torch.training.step import make_eval_step
from robot_aware_control_tpu_torch.utils.state import DemoGoalState, State
from torch_chain_cases import (
    CHAIN_EXPERIMENTS,
    CHAIN_PLAN,
    chain_batched_diff,
    chain_geometry,
    chain_joints_parity,
    small_chain_plan_parity,
)
from torch_robot_cases import (
    FinetuneRecordTrainer,
    finetune_launches,
    record_renders,
    recorded_kernel_vs_plain,
    robot_step_parity,
)
from torch_data_cases import (
    RecordTrainer,
    eval_cells,
    prefetch_check,
    write_record_split,
)
from torch_experiment_cases import (
    CYCLEGAN_TOL,
    EMBED_TOL,
    I3D_TOL,
    cyclegan_card_vs_cpu,
    cyclegan_episode,
    i3d_card_vs_cpu,
    random_embed_card_vs_cpu,
    record_route,
    shards_close,
)
from torch_family_cases import (
    FAMILIES,
    family_fields,
    inverse_learns,
    inverse_step_parity,
)
from torch_family_cases import small_plan_parity as family_plan_parity
from torch_family_cases import train_step_parity as family_train_parity
from torch_mask_cases import MASK_CASES, mask_case
from torch_sim_cases import (
    GT_PLAN_TOL,
    GT_SMALL,
    IMG_TOL,
    POS_TOL,
    SIM_ENVS,
    bridge_plan_check,
    gt_mask_kernel_vs_plain,
    gt_plans,
    physics_card_vs_cpu,
    push_goal,
    small_gt_plan_parity,
)
from torch_raw_cases import (
    NATIVE_HW,
    RAW_LAYOUT,
    MaskLaunches,
    raw_card_vs_cpu,
    raw_trees,
)
from torch_serve_cases import (
    cell_invariance,
    plan_checks,
    serve_checks,
    small_cell_invariance,
)
from torch_train_small import (
    EVAL_TOL,
    GRAD_TOL_DEVICES,
    TRAIN,
    TRAIN_SMALL,
    bench_batch,
    eval_kernel_vs_plain,
    train_step_parity,
)
from torch_variant_cases import (
    CANONICAL,
    TRAIN_VARIANTS,
    VARIANTS,
    plan_launches,
    small_cost_parity,
    small_plan_parity,
    start_goal,
)

pytestmark = pytest.mark.gpu
# the bridge's small plan: svg cut to g_dim 16, float32
SMALL_SVG = dict(CANONICAL, g_dim=16, z_dim=4, compute_dtype="float32",
                 horizon=3, opt_iter=2, action_candidates=6, topk=2)


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


def _det_layout(x, h, c, w, b):
    """det's layout of a cell: x, h, c as views of buffers padded to a
    multiple of 8 channels with NaN in the pad lanes."""
    def padded(t):
        buf = torch.full((*t.shape[:3], kernels.round_up(t.shape[-1])),
                         float("nan"), dtype=t.dtype, device=t.device)
        return buf[..., :t.shape[-1]].copy_(t)

    return [padded(x), padded(h), padded(c), w, b]


def _assert_cell_close(got, want, dtype, tol):
    for gv, wv in zip(got, want):
        assert gv.dtype == dtype
        torch.testing.assert_close(gv.float(), wv.float(), rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4),
                                       (torch.bfloat16, 1e-2)])
# bf16 always takes the wgmma/TMA kernel: 24/40 read in place, 13/20
# (contiguous rows of 26 and 40 bytes) staged into padded views with the
# weights gate-packed; float32 always the float32 kernel (4-byte copies at
# 13/20 channels)
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
    sm90 = dtype == torch.bfloat16
    assert kernels.launches["conv_lstm_cell"] == before["conv_lstm_cell"] + 1
    assert (kernels.launches["conv_lstm_cell_sm90"]
            == before["conv_lstm_cell_sm90"] + sm90)
    assert (kernels.launches["conv_lstm_cell_f32"]
            == before["conv_lstm_cell_f32"] + (dtype == torch.float32))
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*args), dtype, tol)


# Cx != C catches misplaced B tiles; C = 40 a partial 64-channel tile; B = 3
# and 13 a batch run (16 entries) that TMA fills past the end; 5x7 maps a
# row narrower than the 8-column box; k = 5 on 5 or 6 rows skips row taps
# at the border; then the planner's cell0 (B = 100), the trainer's eval
# cells (B = 16: 24 output tiles, 48 pieces for 66 clusters) and the cells
# of 2 and 4 requests planned together (B = 200 and 400)
@pytest.mark.parametrize("B,H,W,Cx,C,k", [
    (3, 6, 8, 64, 128, 5), (13, 5, 7, 64, 128, 3), (13, 6, 8, 40, 40, 3),
    (3, 5, 7, 24, 40, 5), (13, 5, 7, 128, 64, 5), (100, 6, 8, 256, 256, 5),
    (16, 6, 8, 256, 256, 5), (16, 6, 8, 256, 256, 3),
    (200, 6, 8, 256, 256, 3), (400, 6, 8, 256, 256, 5)])
def test_gpu_sm90_cell_matches_plain(cuda, B, H, W, Cx, C, k):
    """The wgmma/TMA kernel to one bf16 rounding step (1e-2 absolute and
    relative), launched once per call."""
    args = _cell_args(cuda, torch.bfloat16, B, H, W, Cx, C, k, seed=B + k)
    before = kernels.launches["conv_lstm_cell_sm90"]
    got = kernels.conv_lstm_cell(*args)
    assert kernels.launches["conv_lstm_cell_sm90"] == before + 1
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*args),
                       torch.bfloat16, 1e-2)


def _assert_one_sm90(before):
    """One cell launch since `before` (kernels.launches), through the
    wgmma/TMA kernel, and no other kernel."""
    launched = {n: kernels.launches[n] - before[n] for n in before}
    assert launched == {"capsule_mask_render": 0, "conv_lstm_cell": 1,
                        "conv_lstm_cell_sm90": 1, "conv_lstm_cell_f32": 0}


def test_gpu_sm90_cell_matches_plain_on_16_byte_rows(cuda):
    """24/40 channels (48- and 80-byte rows, a partial channel tile), read
    in place: one sm90 launch, within one bf16 rounding step."""
    args = _cell_args(cuda, torch.bfloat16, 3, 5, 7, 24, 40, 5)
    before = dict(kernels.launches)
    got = kernels.conv_lstm_cell(*args)
    _assert_one_sm90(before)
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*args),
                       torch.bfloat16, 1e-2)


def test_gpu_unaligned_bf16_cell_takes_sm90(cuda):
    """A tensor TMA cannot address (not 16-byte aligned) is staged into an
    aligned padded view: one copy, one sm90 launch, and the result still
    matches."""
    x, h, c, w, b = _cell_args(cuda, torch.bfloat16, 2, 6, 8, 16, 16, 3)
    x = torch.empty(x.numel() + 1, device=cuda, dtype=x.dtype)[1:].view(
        x.shape).copy_(x)
    assert x.data_ptr() % 16 != 0
    before, staged = dict(kernels.launches), kernels.staged["inputs"]
    got = kernels.conv_lstm_cell(x, h, c, w, b)
    _assert_one_sm90(before)
    assert kernels.staged["inputs"] == staged + 1
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(x, h, c, w, b),
                       torch.bfloat16, 1e-2)


@pytest.mark.parametrize("padded", [False, True])
def test_gpu_sm90_cell_matches_plain_at_odd_channels(cuda, padded):
    """Odd Cx and C (13/21): contiguous, staged, or in padded views with
    NaN in every pad lane, read in place. The channels past Cx and C come
    from TMA's zero fill and the packed weights' zero columns, never from
    a pad lane: one sm90 launch, finite outputs within one bf16 rounding
    step."""
    raw = _cell_args(cuda, torch.bfloat16, 2, 6, 8, 13, 21, 3, seed=34)
    args = _det_layout(*raw) if padded else raw
    before, staged = dict(kernels.launches), kernels.staged["inputs"]
    got = kernels.conv_lstm_cell(*args)
    _assert_one_sm90(before)
    assert kernels.staged["inputs"] == staged + (0 if padded else 3)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*raw),
                       torch.bfloat16, 1e-2)


@pytest.mark.parametrize("C", [252, 100])
@pytest.mark.parametrize("k", [5, 3])
def test_gpu_staged_sm90_cell_at_model_widths(cuda, C, k):
    """A model of g_dim 252 or 100 as it steps its first cell at the
    planner's B = 100: x contiguous (a *_in convolution's output, staged),
    h and c the padded views of lstm.zero_state (NaN pad lanes, read in
    place); one copy, one sm90 launch, within one bf16 rounding step."""
    raw = _cell_args(cuda, torch.bfloat16, 100, 6, 8, C, C, k, seed=C + k)
    args = [raw[0]] + _det_layout(*raw)[1:]
    before, staged = dict(kernels.launches), kernels.staged["inputs"]
    got = kernels.conv_lstm_cell(*args)
    _assert_one_sm90(before)
    assert kernels.staged["inputs"] == staged + 1
    assert got[0].stride() == args[1].stride()
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*raw),
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
                        "conv_lstm_cell_f32": 16, "capsule_mask_render": 2}
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
        kernels.conv_lstm_cell(x.bfloat16(), h.bfloat16(), c.bfloat16(),
                               w.bfloat16(), b)
    segs, hh, ww = mask_case("planner_500", cuda)
    with pytest.raises(RuntimeError, match="no backward"):
        kernels.capsule_mask_render(segs.requires_grad_(True), hh, ww)
    with torch.no_grad():
        kernels.conv_lstm_cell(x, h, c, w, b)
        kernels.capsule_mask_render(segs, hh, ww)


# ----------------------------------------------------------------- serving
# a small bf16 planner whose cells (16 + 16 channels) take the wgmma/TMA
# kernel: batched plans run them at B = 6, 12 and 24
SERVE_SMALL = dict(model="svg", g_dim=16, z_dim=4, action_dim=5, robot_dim=5,
                   model_use_mask=True, model_use_robot_state=True,
                   reconstruction_loss="dontcare_l1", reward_type="dontcare",
                   compute_dtype="bfloat16", horizon=3, opt_iter=2,
                   action_candidates=6, topk=2, cem_init_std=0.015)


@pytest.mark.parametrize("channels", [256, 260])
@pytest.mark.parametrize("k", [5, 3])
def test_gpu_cell_result_depends_on_its_row_alone(cuda, k, channels):
    """The wgmma/TMA cell at the planner's widths and at det's (260: padded
    views with NaN pad lanes, the tail layout): 50 launches
    of identical inputs give identical bits at B = 16, 100, 200 and 400,
    and rows of a B = 100 launch equal the same rows at offsets 0 and 100
    of B = 200 launches, at 0, 100, 200 and 300 of B = 400 launches, and
    the first 16 a B = 16 launch."""
    cell_invariance(cuda, ks=(k,), channels=channels)


@pytest.mark.parametrize("k", [5, 3])
def test_gpu_f32_cell_result_depends_on_its_row_alone(cuda, k):
    """The same for the float32 kernel at the planner's widths (256
    channels, B = 16, 100, 200 and 400), every launch through it."""
    before = dict(kernels.launches)
    cell_invariance(cuda, ks=(k,), dtype=torch.float32)
    launched = {n: kernels.launches[n] - before[n] for n in before}
    assert launched["conv_lstm_cell_f32"] == launched["conv_lstm_cell"] > 0


def test_gpu_small_cell_kernels_depend_on_their_row_alone(cuda):
    """The same for the wgmma/TMA kernel at 13/20 channels (bf16; padded
    views with NaN pad lanes and contiguous tensors, staged) and the
    float32 kernel at small shapes."""
    assert len(small_cell_invariance(cuda)) == 6


def test_gpu_batched_plans_equal_single(cuda):
    """One request planned twice gives one plan; get_action_batched of
    R = 2, 3 (padded to 4) and 4 requests equals their single plans bit
    for bit, all cells through sm90."""
    cfg = Config(**SERVE_SMALL)
    before = kernels.launches["conv_lstm_cell_sm90"]
    plan_checks(CEMPolicy(cfg, svg.init(cfg, 0, cuda)), repeats=2)
    assert (kernels.launches["conv_lstm_cell_sm90"] - before
            == 4 * (cfg.horizon - 1) * cfg.opt_iter * (6 + 2))


def test_gpu_served_plans_equal_local(cuda):
    """A PlanServer on a thread: one client alone and 4 concurrent clients
    get their local plans, and a micro-batch is seen."""
    cfg = Config(**SERVE_SMALL)
    model = svg.init(cfg, 0, cuda)
    singles = plan_checks(CEMPolicy(cfg, model), repeats=1,
                          batch_sizes=(4,))["singles"]
    server = PlanServer(cfg, model)
    thread = server.start()
    try:
        serve_checks(server, singles, rounds=1)
    finally:
        server.close()
        thread.join(timeout=10)


# ---------------------------------------------------------------- variants
@pytest.mark.parametrize("B", [16, 100, 200, 400])
@pytest.mark.parametrize("k", [5, 3])
def test_gpu_sm90_cell_matches_plain_at_det_channels(cuda, k, B):
    """det's cells (6x8, Cx = C = 260; B = 100 a request, 200 and 400 for
    2 and 4 planned together, 16 the eval epoch's batch) in det's layout,
    NaN in the pad lanes of x, h and c, take the wgmma/TMA kernel, one
    launch, and equal its plain version to one bf16 rounding step with
    finite outputs, returned in h's padded layout."""
    raw = _cell_args(cuda, torch.bfloat16, B, 6, 8, 260, 260, k, seed=k)
    args = _det_layout(*raw)
    before = dict(kernels.launches)
    got = kernels.conv_lstm_cell(*args)
    assert kernels.launches["conv_lstm_cell"] == before["conv_lstm_cell"] + 1
    assert (kernels.launches["conv_lstm_cell_sm90"]
            == before["conv_lstm_cell_sm90"] + 1)
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert got[0].stride() == args[1].stride()
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*raw),
                       torch.bfloat16, 1e-2)


@pytest.mark.parametrize("k", [5, 3])
def test_gpu_staged_sm90_cell_matches_plain_at_det_channels(cuda, k):
    """det's channels (Cx = C = 260) on contiguous tensors (520-byte rows)
    and on a 262-channel pixel stride with NaN pad lanes: neither is read
    in place; each is staged into padded views and takes the wgmma/TMA
    kernel, one launch, within one bf16 rounding step."""
    args = _cell_args(cuda, torch.bfloat16, 100, 6, 8, 260, 260, k, seed=k)
    want = kernels.conv_lstm_cell_plain(*args)
    views = [torch.full((100, 6, 8, 262), float("nan"), dtype=torch.bfloat16,
                        device=cuda)[..., :260].copy_(t) for t in args[:3]]
    for ins in (args[:3], views):
        before, staged = dict(kernels.launches), kernels.staged["inputs"]
        got = kernels.conv_lstm_cell(*ins, *args[3:])
        _assert_one_sm90(before)
        assert kernels.staged["inputs"] == staged + 3
        assert kernels.pixel_stride(got[0]) == 264
        _assert_cell_close(got, want, torch.bfloat16, 1e-2)


@pytest.mark.parametrize("padded", [False, True])
@pytest.mark.parametrize("dtype,C,B,k", [
    (torch.float32, 20, 6, 3), (torch.float32, 260, 100, 5),
    (torch.float32, 260, 16, 3), (torch.bfloat16, 260, 100, 5),
    (torch.bfloat16, 258, 16, 3)])
def test_gpu_cell_kernels_match_plain_at_det_channels(cuda, monkeypatch,
                                                      dtype, C, B, k, padded):
    """det's channel counts (Cx = C: 20 at the small config, 260 at the
    canonical, 258 without state maps), contiguous or in det's layout
    (NaN pad lanes), on the parameters' (k, k, 2C, 4C) weights: float32
    through the float32 kernel to 1e-4 (TF32 off on the plain side), bf16
    contiguous (staged) and padded (read in place) through the wgmma/TMA
    kernel (on its packed copy) to one bf16 rounding step; finite outputs
    in the layout in which the kernel read h (contiguous bf16 h is staged
    into a padded view first)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    raw = _cell_args(cuda, dtype, B, 6, 8, C, C, k, seed=C + k)
    args = _det_layout(*raw) if padded else raw
    before = dict(kernels.launches)
    got = kernels.conv_lstm_cell(*args)
    sm90 = dtype == torch.bfloat16
    assert kernels.launches["conv_lstm_cell"] == before["conv_lstm_cell"] + 1
    assert (kernels.launches["conv_lstm_cell_sm90"]
            == before["conv_lstm_cell_sm90"] + sm90)
    assert (kernels.launches["conv_lstm_cell_f32"]
            == before["conv_lstm_cell_f32"] + (dtype == torch.float32))
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert got[0].stride() == kernels.stage_cell(*args[:4])[1].stride()
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*raw), dtype,
                       1e-4 if dtype == torch.float32 else 1e-2)


def _tf32_off(monkeypatch):
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)


@pytest.mark.parametrize("name", ["heatmap", "group_norm", "det"])
def test_gpu_variant_plan_matches_cpu(cuda, monkeypatch, name):
    """A small float32 plan of the variant equals the CPU's to 1e-4 and
    launches its cells (none for GroupNorm) and masks
    (torch_variant_cases.small_plan_parity)."""
    _tf32_off(monkeypatch)
    small_plan_parity(name, cuda)


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gpu_variant_costs_match_cpu(cuda, monkeypatch, name):
    """Small float32 rollout costs of fixed candidates equal the CPU's to
    1e-4, the blur cost's within one 1/255 step a pixel on another step,
    and the cells' states on the way to 1e-4 of their largest value."""
    _tf32_off(monkeypatch)
    small_cost_parity(name, cuda)


@pytest.mark.parametrize("name", sorted(TRAIN_VARIANTS))
def test_gpu_variant_train_step_matches_cpu(cuda, monkeypatch, name):
    """The small float32 train and eval step of GroupNorm + heatmaps and of
    det, GPU against CPU, to the limits of torch_train_small.py."""
    _tf32_off(monkeypatch)
    errs, _ = train_step_parity(cuda, **TRAIN_VARIANTS[name])
    assert errs["grads_norm"] <= GRAD_TOL_DEVICES


@pytest.mark.parametrize("name", sorted(VARIANTS))
def test_gpu_variant_batched_plans_equal_single(cuda, name):
    """Each variant at the canonical config (bf16; det's cells through the
    wgmma/TMA kernel at B = R x 100, GroupNorms over R x 100 rows, heatmaps
    rendered for them, blur costs per request): batched plans of 2 and 4
    requests equal their single plans bit for bit."""
    cfg = Config(**dict(CANONICAL, **VARIANTS[name]))
    model = get_model(cfg).init(cfg, 0, cuda)
    checks = plan_checks(CEMPolicy(cfg, model), repeats=2, batch_sizes=(2, 4))
    assert set(checks["batched"].values()) == {0.0}


# ------------------------------------------------------------ float32 cell
@pytest.mark.parametrize("channels", [256, 260])
@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("B", [16, 100, 200, 400])
def test_gpu_f32_cell_matches_plain(cuda, monkeypatch, B, k, channels):
    """The float32 kernel at the planner's cells (6x8, 256 channels; B = 16
    the eval batch, 100 a request, 200 and 400 two and four planned
    together) and det's (260 channels in padded views, NaN in the pad
    lanes): one launch through it, equal to the plain version to 1e-4
    with TF32 off, finite, in h's layout."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    raw = _cell_args(cuda, torch.float32, B, 6, 8, channels, channels, k,
                     seed=B + k)
    args = _det_layout(*raw) if channels % 8 else raw
    before = dict(kernels.launches)
    got = kernels.conv_lstm_cell(*args)
    assert kernels.launches["conv_lstm_cell_f32"] == before["conv_lstm_cell_f32"] + 1
    assert kernels.launches["conv_lstm_cell"] == before["conv_lstm_cell"] + 1
    assert all(bool(torch.isfinite(t).all()) for t in got)
    assert got[0].stride() == args[1].stride()
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*raw), torch.float32,
                       1e-4)


@pytest.mark.parametrize("B,Cx,C,padded", [
    (100, 258, 258, True),   # 258 channels on a 264 pixel stride: 8-byte copies
    (16, 258, 258, False),   # 258 contiguous: 8-byte copies
    (6, 13, 20, False),      # odd channels: 4-byte copies
    (6, 13, 20, True),
])
@pytest.mark.parametrize("k", [5, 3])
def test_gpu_f32_cell_narrow_copies_match_plain(cuda, monkeypatch, B, Cx, C,
                                                padded, k):
    """Channel counts that are not multiples of 4 take the kernel's 8- and
    4-byte copies: equal to the plain version to 1e-4 (TF32 off)."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    raw = _cell_args(cuda, torch.float32, B, 6, 8, Cx, C, k, seed=C)
    args = _det_layout(*raw) if padded else raw
    before = kernels.launches["conv_lstm_cell_f32"]
    got = kernels.conv_lstm_cell(*args)
    assert kernels.launches["conv_lstm_cell_f32"] == before + 1
    assert all(bool(torch.isfinite(t).all()) for t in got)
    _assert_cell_close(got, kernels.conv_lstm_cell_plain(*raw), torch.float32,
                       1e-4)


def _offset_copy(t, floats):
    """t's values in a tensor whose storage starts `floats` float32 values
    past an allocation's start: 16-byte aligned at 0, 8 at 2, 4 at 1."""
    buf = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    return buf[floats:floats + t.numel()].view(t.shape).copy_(t)


@pytest.mark.parametrize("k", [5, 3])
def test_gpu_f32_cell_bits_do_not_hang_on_the_copy_width(cuda, k):
    """One cell at 256 channels, its x, h and w 16-byte aligned (16-byte
    copies), 8-byte aligned (8-byte copies) and 4-byte aligned (4-byte
    copies): the same bits, and both of its tile shapes the same bits."""
    x, h, c, w, b = _cell_args(cuda, torch.float32, 100, 6, 8, 256, 256, k)
    want = kernels.conv_lstm_cell(x, h, c, w, b)
    for floats in (2, 1):
        moved = [_offset_copy(t, floats) for t in (x, h, w)]
        assert all(t.data_ptr() % 16 for t in moved)
        got = kernels.conv_lstm_cell(moved[0], moved[1], c, moved[2], b)
        assert all(torch.equal(g, v) for g, v in zip(got, want))
    dims = kernels._check_cell(x, h, c, w, b)
    for shape in (0, 1):
        got = kernels.launch_f32(dims, x, h, c, w, b, shape)
        assert all(torch.equal(g, v) for g, v in zip(got, want))


def test_gpu_full_width_f32_plan_takes_the_f32_kernel(cuda, monkeypatch):
    """The canonical planner (g_dim 256, N = 100, horizon 5, opt_iter 10)
    with compute_dtype float32: a finite (4, 2) plan whose 160 cells all
    launch the float32 kernel, none the wgmma/TMA one, and 10 masks."""
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    cfg = Config(**dict(CANONICAL, compute_dtype="float32"))
    policy = CEMPolicy(cfg, svg.init(cfg, 0, cuda))
    start, goal = start_goal(np.random.RandomState(0))
    before = dict(kernels.launches)
    plan = policy.get_action(start, goal, ep_num=1, step=0)
    launched = {n: kernels.launches[n] - before[n] for n in before}
    assert launched == plan_launches(cfg)
    assert launched["conv_lstm_cell_f32"] == 160
    assert plan.shape == (4, 2) and np.all(np.isfinite(plan))


# ------------------------------------------------------------------ data
def test_gpu_prefetched_batches_equal_host_batches(cuda, tmp_path):
    """device_prefetch on the GPU over an epoch of record shards (3 loader
    threads, 5 batches): every batch equal to its host batch bit for bit,
    each read after the consumer's stream slept while the side stream
    copied the next ones (tests/torch_data_cases.py:prefetch_check)."""
    cfg = Config(**dict(TRAIN_SMALL, video_length=12))
    write_record_split(str(tmp_path), 40, cfg, 0, episodes_per_shard=16)
    loader = DataLoader(RecordDataset(str(tmp_path)), 8, num_workers=3, seed=0)
    out = prefetch_check(loader, cuda)
    assert out == {"batches": 5, "mismatched": 0, "keys": [
        "actions", "images", "masks", "qpos", "states"]}


def test_gpu_records_trainer_eval_takes_sm90(cuda, tmp_path):
    """PredictionTrainer fed by record shards at the bf16 width of bench.py
    (g_dim 256, z_dim 64; batch 4, 12-frame videos): it trains an epoch,
    and its eval epoch (2 test batches of 16) and eval gif launch
    eval_cells cells, every one through sm90."""
    cfg = Config(**dict(TRAIN, batch_size=4, test_batch_size=16,
                        video_length=12, n_eval=6, niter=1, epoch_size=1,
                        eval_interval=1, checkpoint_interval=1, data_threads=2,
                        log_dir=str(tmp_path), jobname="records"))
    write_record_split(str(tmp_path / "train"), 8, cfg, 0)
    write_record_split(str(tmp_path / "test"), 32, cfg, 1)
    tr = RecordTrainer(cfg, str(tmp_path), cuda)
    kernels.reset_launches()
    tr.train()
    tr.logger.close()
    cells = eval_cells(cfg, 2)
    assert dict(kernels.launches) == {
        "conv_lstm_cell": cells, "conv_lstm_cell_sm90": cells,
        "conv_lstm_cell_f32": 0, "capsule_mask_render": 0}
    assert tr._step == 2


# ---------------------------------------------------------------- robots
CHAIN_KEYS = ["baxter", "baxter_right", "fetch", "franka", "kuka", "sawyer",
              "widowx", "wx250s"]


@pytest.mark.parametrize("key", CHAIN_KEYS)
def test_gpu_chain_geometry_matches_cpu(cuda, key):
    """FK to 1e-5 m, IK tips to FK-made targets within 1e-5 m of them
    where the CPU's are and of the CPU's distances, thin and thick masks
    of the same joints but within 1e-3 px of an edge
    (tests/torch_chain_cases.py:chain_geometry)."""
    chain_geometry(cuda, [key])


@pytest.mark.parametrize("experiment", CHAIN_EXPERIMENTS)
def test_gpu_chain_joints_match_cpu(cuda, experiment):
    """The canonical chain plan's warm-started IK at a rollout's shapes
    (100 candidates, 5 steps) on the card against the CPU's: tips within
    1e-5 m, the masks of its joints as the CPU env's but near an edge
    (tests/torch_chain_cases.py:chain_joints_parity)."""
    cfg = Config(**dict(CANONICAL, experiment=experiment))
    engine = RolloutEngine(cfg, device=cuda)
    N, T, A = cfg.action_candidates, cfg.horizon - 1, cfg.action_dim
    acts = (torch.randn(T, N, A, generator=torch.Generator().manual_seed(0))
            * 0.015).clamp(-0.05, 0.05).to(cuda)
    start_raw = torch.tensor([0.3, 0.0, 0.15, 0.0, 0.0], device=cuda).expand(N, 5)
    q0 = torch.zeros(N, engine.qpos_dim, device=cuda)
    chain_joints_parity(engine, start_raw, q0, acts)


@pytest.mark.parametrize("experiment", CHAIN_EXPERIMENTS)
def test_gpu_small_chain_plan_matches_cpu(cuda, monkeypatch, experiment):
    """A small float32 chain plan, injected noise, at the CPU's robot
    trajectory: the CPU's plan to 1e-4; the card's own plan clamped."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    small_chain_plan_parity(experiment, cuda)


@pytest.mark.parametrize("experiment", CHAIN_EXPERIMENTS)
def test_gpu_chain_batched_plans_equal_single(cuda, experiment):
    """get_action_batched of 2 small chain requests equals their single
    plans bit for bit on the card, and plans launch no mask kernel."""
    cfg = Config(**dict(CHAIN_PLAN, experiment=experiment))
    policy = CEMPolicy(cfg, svg.init(cfg, seed=0, device=cuda))
    kernels.reset_launches()
    assert chain_batched_diff(policy, experiment, 2) == 0.0
    assert kernels.launches["capsule_mask_render"] == 0


def test_gpu_robot_train_step_matches_cpu(cuda, monkeypatch, tmp_path):
    """One robot-trainer step (both MLPs, Adam) on the card against the
    CPU's: losses to 1e-5 relative, parameters as
    tests/torch_robot_cases.py:robot_step_parity allows."""
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    robot_step_parity(cuda, str(tmp_path))


def test_gpu_finetune_trainer_takes_the_kernels(cuda, tmp_path):
    """finetune_locobot at the bf16 width of bench.py (batch 4, 12-frame
    videos) fed by record shards with the locobot bounds: each train
    window and eval window renders its robot masks through the mask
    kernel, the eval epoch's cells (best of 3 in the autoregressive pass)
    all take sm90; the mask kernel equals its plain version bit for bit on
    the first train window's and eval window's joints."""
    cfg = Config(**dict(TRAIN, experiment="finetune_locobot", batch_size=4,
                        test_batch_size=16, video_length=12, n_eval=6, niter=1,
                        epoch_size=1, eval_interval=1, checkpoint_interval=1,
                        data_threads=2, log_dir=str(tmp_path), jobname="ft"))
    write_record_split(str(tmp_path / "train"), 8, cfg, 0)
    write_record_split(str(tmp_path / "test"), 32, cfg, 1)
    tr = FinetuneRecordTrainer(cfg, str(tmp_path), cuda)
    rendered = record_renders(tr)
    kernels.reset_launches()
    tr.train()
    tr.logger.close()
    assert dict(kernels.launches) == finetune_launches(cfg, 1, 2)
    recorded_kernel_vs_plain(rendered)


# ------------------------------------------------------- model families
@pytest.mark.parametrize("name", FAMILIES)
def test_gpu_family_plan_matches_cpu(cuda, monkeypatch, name):
    """A small float32 plan of each family equals the CPU's to 1e-4 and
    launches its cells (CDNA's 2 a model step through the float32 kernel;
    none in the vector models) and masks (torch_family_cases)."""
    _tf32_off(monkeypatch)
    family_plan_parity(name, cuda)


@pytest.mark.parametrize("name", ["cdna_det", "cdna_robonet"])
def test_gpu_cdna_plan_cells_take_sm90(cuda, name):
    """A canonical bf16 CDNA plan (g_dim 256, N 100, horizon 5, opt_iter
    10): 80 cell launches (40 k = 5, 40 k = 3), every one through the
    wgmma/TMA kernel, and 10 mask launches; the plan finite and clamped."""
    cfg = Config(**dict(CANONICAL, **family_fields(name, small=False)))
    policy = CEMPolicy(cfg, get_model(cfg).init(cfg, 0, cuda))
    start, goal = start_goal(np.random.RandomState(0))
    before = dict(kernels.launches)
    plan = policy.get_action(start, goal)
    got = {k: kernels.launches[k] - before[k] for k in before}
    assert got == plan_launches(cfg)
    assert got["conv_lstm_cell_sm90"] == 80
    assert plan.shape == (4, 2) and np.all(np.isfinite(plan))
    assert np.abs(plan).max() <= 0.05


@pytest.mark.parametrize("name", ["cdna_det", "svg_vec"])
def test_gpu_family_batched_plans_equal_single(cuda, name):
    """At the canonical config (bf16, the JAX defaults' fc-LSTM stacks):
    batched plans of 2 and 4 requests equal their single plans bit for bit
    (the vector models' Linears and CDNA's kernel einsum at R x 100 rows)."""
    cfg = Config(**dict(CANONICAL, **family_fields(name, small=False)))
    model = get_model(cfg).init(cfg, 0, cuda)
    checks = plan_checks(CEMPolicy(cfg, model), repeats=2, batch_sizes=(2, 4))
    assert set(checks["batched"].values()) == {0.0}


def test_gpu_cdna_eval_step_kernel_matches_plain(cuda):
    """The trainer's eval step of cdna_det at full width (g_dim 256, B =
    16, bf16): with the cell kernel, 2 sm90 launches a model step, against
    the same step with its plain version, to EVAL_TOL."""
    result = eval_kernel_vs_plain(cuda, model="cdna_det")
    assert max(r["preds"] for r in result.values()) <= EVAL_TOL


@pytest.mark.parametrize("name", FAMILIES)
def test_gpu_family_train_step_matches_cpu(cuda, monkeypatch, name):
    """The small float32 train and eval step of each family (the vector
    models with channel dropout, the same keep masks on both devices), GPU
    against CPU, to the limits of torch_train_small.py."""
    _tf32_off(monkeypatch)
    errs, _ = family_train_parity(name, cuda)
    assert errs["grads_norm"] <= GRAD_TOL_DEVICES


@pytest.mark.parametrize("discretized", [False, True])
def test_gpu_inverse_step_matches_cpu(cuda, monkeypatch, discretized):
    """One Adam step of the inverse model, GPU against CPU; 20 steps at
    batch 128 lower its loss."""
    _tf32_off(monkeypatch)
    inverse_step_parity(cuda, discretized=discretized)
    if not discretized:
        inverse_learns(cuda)


# ---------------------------------------------------------------- simulation
@pytest.mark.parametrize("name", SIM_ENVS)
def test_gpu_physics_and_render_match_cpu(cuda, name):
    """20 scripted steps (contact; grab, carry, release, drop; a chain of
    three blocks) on the card against the CPU: positions and joints within
    POS_TOL, images within IMG_TOL, masks bit-equal."""
    r = physics_card_vs_cpu(name, cuda)
    assert r["pos_err"] <= POS_TOL and r["img_err"] <= IMG_TOL, r
    assert r["mask_differ"] == 0, r


def test_gpu_mask_kernel_matches_plain_at_gt_shape(cuda):
    """The mask kernel at one GT CEM iteration's launch (100 candidates x 4
    steps of thin capsules) and at one observation's, bit for bit."""
    r = gt_mask_kernel_vs_plain(cuda)
    assert (r["gt"]["M"], r["obs"]["M"]) == (400, 1)
    assert r["gt"]["differ"] == r["obs"]["differ"] == 0, r


def test_gpu_small_gt_plan_matches_cpu(cuda):
    """A small GT plan in LocobotPush with injected noise, card vs CPU."""
    assert small_gt_plan_parity(cuda) <= GT_PLAN_TOL


def test_gpu_gt_plan_launches_the_mask_kernel_per_iteration(cuda):
    """A canonical GT plan launches the mask kernel opt_iter times (all
    N x T scenes of an iteration in one launch) and the cell never."""
    gt = gt_plans(cuda, n_timed=1)
    assert gt["launches"]["capsule_mask_render"] == 10


def test_gpu_gt_plan_loop_makes_no_host_sync(cuda):
    """The GT CEM loop (physics, render, costs, top-k, refit) runs without
    a host sync: with PyTorch's sync debug mode at "error" a synchronizing
    op raises (a host value copied to the card per call, as the IK's
    constants would be, is one)."""
    cfg = Config(**GT_SMALL)
    env = make("LocobotPush", cfg, seed=1, device=cuda)
    goal = push_goal(env)
    policy = GTPushCEMPolicy(cfg, env)
    goal_imgs, goal_masks, goal_states = (
        torch.as_tensor(a, device=cuda) for a in prepare_goals(
            goal, cfg.horizon - 1))
    mean, std = policy.init_mean_std(cfg.horizon)
    gen = policy._generator(0, 0)
    policy._plan_gt(env.state, goal_imgs, goal_masks, goal_states, gen,
                    mean, std)  # warm: builds the kernel
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        plan = policy._plan_gt(env.state, goal_imgs, goal_masks, goal_states,
                               gen, mean, std)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert torch.isfinite(plan).all()


def test_gpu_bridged_plan_equals_converted_plan(cuda):
    """A reference-layout state dict through torch_import plans on the card
    as the same weights through convert.py, bit for bit."""
    assert bridge_plan_check(cuda, fields=SMALL_SVG)["equal"]



# ------------------------------------------------------------ experiments
@pytest.fixture
def no_tf32():
    """Full float32 convolutions and matmuls on the card for the card ==
    CPU checks; restored after."""
    old = (torch.backends.cudnn.allow_tf32,
           torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    yield
    torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = old


def test_gpu_i3d_matches_cpu(cuda, no_tf32):
    """The seed-42 I3D's logits of 2 videos of 8 frames at 48x64 on the
    card within 1e-4 of the CPU's largest |logit|."""
    r = i3d_card_vs_cpu(cuda)
    assert r["finite"] and r["shape"] == [2, 400]
    assert r["rel_err"] <= I3D_TOL, r


def test_gpu_random_embedder_matches_cpu(cuda, no_tf32):
    r = random_embed_card_vs_cpu(cuda)
    assert r["shape"] == [2, 400] and r["rel_err"] <= EMBED_TOL, r


def test_gpu_cyclegan_matches_cpu(cuda, no_tf32):
    """The runner's default CycleGAN translates as on the CPU (1e-4); one
    train_step on the card is finite."""
    r = cyclegan_card_vs_cpu(cuda)
    assert r["finite"] and r["max_diff"] <= CYCLEGAN_TOL, r


def test_gpu_record_route_shards_match_cpu(cuda, tmp_path):
    """The record route's shards of 4 LocobotPick episodes collected on
    the card and on the CPU: the same episodes, file paths and split,
    images and masks equal, states, actions and joints within the envs'
    1e-5."""
    root = str(tmp_path / "data_pick")
    card = record_route(root, cuda, n=4, record_dir=str(tmp_path / "card"))
    cpu = record_route(root, "cpu", n=4, record_dir=str(tmp_path / "cpu"))
    assert (card["train"], card["test"]) == (cpu["train"], cpu["test"])
    r = shards_close(card["record_dir"], cpu["record_dir"], POS_TOL)
    assert r["ok"], r


def test_gpu_cyclegan_push_episode(cuda, tmp_path):
    """A 2-step PushEpisodeRunner episode with --cyclegan (GT dynamics) on
    the card, following a demo made in memory: each observation goes
    through the translator, the stats are finite."""
    kernels.reset_launches()
    r = cyclegan_episode(cuda, str(tmp_path))
    assert r["finite"] and len(r["actions"]) == 2 and r["translated"] == 2, r
    assert kernels.launches["capsule_mask_render"] > 0


# ------------------------------------------------------ raw RoboNet route
RAW_CFG = Config(video_length=31, n_past=1, n_future=9, action_dim=5,
                 robot_dim=5, robot_joint_dim=7, seed=0, data_threads=1,
                 experiment="train_sawyer_multiview")


def test_gpu_mask_kernel_equals_plain_on_raw_locobot_capsules(cuda):
    """The raw route's locobot masks at 64x85 (85 % 4 != 0: 4-byte stores):
    every launch of reading two 31-frame trajectories is one of M = 31
    masks and equals the plain version bit for bit."""
    trees = raw_trees("/data", layout=(RAW_LAYOUT[3],))
    ds = RoboNetHDF5Dataset([p for p, _, _ in trees], ["locobot_c0"] * 2,
                            RAW_CFG, episodes=[t for _, _, t in trees],
                            device=cuda)
    kernels.reset_launches()
    with MaskLaunches() as rec:
        for i in range(2):
            assert ds._load_file(i)["masks"].any()
    assert kernels.launches["capsule_mask_render"] == 2
    checked = rec.check()
    assert [c[:4] for c in checked] == [(31, 8, *NATIVE_HW)] * 2, checked


def test_gpu_raw_items_match_cpu(cuda):
    """Each trajectory of the raw layout (sawyer train views, the held-out
    view, locobot) read on the card equals the CPU's: frames, states,
    actions, joints and bounds; locobot's masks bit for bit, the chain's
    but within 1e-3 px of an edge."""
    r = raw_card_vs_cpu(cuda, raw_trees("/data", T=12), RAW_CFG.replace(
        video_length=12))
    assert r["trajectories"] == 8 and r["locobot_differ"] == 0, r


def test_gpu_raw_shards_match_cpu(cuda, tmp_path):
    """Record shards of the locobot raw trees written through the reader
    on the card equal the CPU's, bit for bit (their masks through the
    kernel and through its plain version)."""
    from robot_aware_control_tpu_torch.data.collect import write_training_records
    from torch_experiment_cases import shards_equal

    trees = raw_trees("/data", layout=(RAW_LAYOUT[3],), seed=5)
    for dev, d in ((cuda, "card"), ("cpu", "cpu")):
        write_training_records([(p, t) for p, _, t in trees],
                               str(tmp_path / d), RAW_CFG,
                               viewpoint="locobot_c0", device=dev)
    assert shards_equal(str(tmp_path / "card"), str(tmp_path / "cpu"))


def test_gpu_profiling_reads_the_card(cuda, tmp_path):
    """device_memory_stats reads the card's allocated bytes (now and at
    peak); a trace of a card matmul holds its kernel; the step timer waits
    for the card before it reads the clock."""
    import json

    from robot_aware_control_tpu_torch.utils import profiling

    x = torch.ones(1024, 1024, device=cuda)
    stats = profiling.device_memory_stats()["0"]
    assert stats["peak_bytes_in_use"] >= stats["bytes_in_use"] >= x.numel() * 4
    with profiling.trace(str(tmp_path)) as path:
        y = x @ x
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("cat") == "kernel" for e in events)
    timer = profiling.StepTimer()
    with timer:
        torch.cuda._sleep(100_000_000)
    assert timer.ema_s > 0.01 and float(y[0, 0]) == 1024.0


# ------------------------------------------------------------- int8, mesh
@pytest.mark.parametrize("shape", [(2, 6, 8, 24, 32, 5, 1),
                                   (1, 3, 4, 5, 7, 3, 1),
                                   (2, 7, 9, 6, 16, 3, 2)])
def test_gpu_int8_gemm_route_equals_plain(cuda, shape):
    """The card's int8 product (im2col + torch._int_mm) gives the CPU's
    float64 int32 sums, K and N not multiples of 8, M under 16 rows."""
    from robot_aware_control_tpu_torch.ops import quant

    B, H, W, C, O, k, stride = shape
    g = torch.Generator().manual_seed(B * 100 + C)
    x_q = torch.randint(-127, 128, (B, H, W, C), generator=g, dtype=torch.int8)
    w_q = torch.randint(-127, 128, (O, C, k, k), generator=g, dtype=torch.int8)
    pads = quant._pads(x_q.shape, (k, k), stride, "same")
    got = quant.conv_int8_mm(x_q.to(cuda), quant.gemm_weight(w_q.to(cuda)), O,
                             (k, k), stride, pads).cpu()
    assert torch.equal(got, quant.conv_int8_plain(x_q, w_q, stride, pads))


def test_gpu_int8_plan_runs_no_cell_and_matches_cpu(cuda):
    """A small int8 plan on the card launches the mask kernel and int8
    GEMMs, never a cell kernel, and its Int8Conv2d outputs equal the
    CPU's; the plan itself is finite and clamped."""
    from robot_aware_control_tpu_torch.ops import quant

    cfg = Config(**dict(SMALL_SVG, plan_quantize="int8"))
    policy = CEMPolicy(cfg, svg.init(cfg, seed=3, device="cuda"))
    start, goal = start_goal(np.random.RandomState(0))
    kernels.reset_launches()
    mm = quant.launches["int8_mm"]
    plan = policy.get_action(start, goal)
    assert kernels.launches["conv_lstm_cell"] == 0
    assert kernels.launches["capsule_mask_render"] == cfg.opt_iter
    assert quant.launches["int8_mm"] > mm
    assert np.all(np.isfinite(plan)) and np.abs(plan).max() <= 0.05
    conv = quant.Int8Conv2d(torch.randn(16, 8, 3, 3), torch.randn(16))
    x = torch.randn(4, 6, 8, 8)
    assert torch.equal(conv.to(cuda)(x.to(cuda)).cpu(), conv.cpu()(x))


def test_gpu_layouts_on_an_nccl_world_of_one(cuda, tmp_path):
    """DDP, FSDP2 and the model-axis layout on one card take the plain
    step's two steps; a mesh plan equals the unsharded plan."""
    import torch.distributed as dist

    import torch_mesh_cases as cases
    from robot_aware_control_tpu_torch import convert
    from robot_aware_control_tpu_torch.parallel import mesh as pmesh

    store = dist.FileStore(str(tmp_path / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        cfg = Config(**cases.TINY)
        params, bn = convert.jax_flat_trees(
            svg.init(cfg, seed=0, device="cpu", train=True))
        plain = cases.train_steps(cfg, params, bn, device="cuda")
        for kind in ("replicated", "data", "model"):
            c = cases.layout_config(kind)
            got = cases.train_steps(c, params, bn, pmesh.Layout(c),
                                    device="cuda")
            errs = cases.step_errors(got, plain, c.lr)
            assert errs["step1"] <= 1 and errs["step2"] <= 1, (kind, errs)
            assert errs["params_lr"] <= 5, (kind, errs)
        pcfg = Config(**SMALL_SVG)
        model = svg.init(pcfg, seed=3, device="cuda")
        start, goal = start_goal(np.random.RandomState(0))
        want = CEMPolicy(pcfg, model).get_action(start, goal)
        meshed = CEMPolicy(pcfg, model, mesh=pmesh.get_mesh(axis="data"))
        np.testing.assert_array_equal(meshed.get_action(start, goal), want)
    finally:
        dist.destroy_process_group()
