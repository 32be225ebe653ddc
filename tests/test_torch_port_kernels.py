"""The port's two kernels, held against the JAX package's Pallas kernels on
the CPU through their plain versions (the CUDA kernels themselves are held
against the plain versions in tests/test_torch_port_gpu.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from robot_aware_control_tpu.ops import lstm as jlstm
from robot_aware_control_tpu.ops.pallas_kernels import (
    capsule_mask_render as jax_capsule_mask_render,
    fused_conv_lstm_cell,
)
from robot_aware_control_tpu.robot.mask_renderer import (
    CapsuleMaskRenderer as JRenderer,
)
from robot_aware_control_tpu_torch.ops import kernels
from robot_aware_control_tpu_torch.robot.mask_renderer import CapsuleMaskRenderer
from torch_mask_cases import (BOX_EDGE_TILES, MASK_CASES, PLANNER_POSES,
                              mask_case)


# ----------------------------------------------------------- capsule masks
@pytest.mark.parametrize("thick", [False, True])
def test_mask_render_equals_jax_exactly(rng, thick):
    """qpos -> masks through the port (FK, projection, plain mask path)
    equals the JAX jnp render and its Pallas kernel in interpret mode bit
    for bit; M = 21 is not a multiple of the Pallas block of 16."""
    q = rng.uniform(-0.5, 0.5, (3, 7, 5)).astype(np.float32)
    jr = JRenderer((48, 64), thick=thick)
    want = np.asarray(jr.render(jnp.asarray(q)))
    want_pallas = np.asarray(jr.render_pallas(jnp.asarray(q), interpret=True))
    got = CapsuleMaskRenderer((48, 64), thick=thick,
                              device="cpu").render(torch.tensor(q))
    assert got.shape == (3, 7, 48, 64, 1) and got.dtype == torch.float32
    assert 0 < want.mean() < 1
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), want_pallas)


def test_segment_params_match_jax(rng):
    """FK + projection to pixel-space capsules, to 1e-5 relative."""
    q = rng.uniform(-0.5, 0.5, (11, 5)).astype(np.float32)
    want = np.asarray(JRenderer((48, 64)).segment_params(jnp.asarray(q)))
    got = CapsuleMaskRenderer((48, 64), device="cpu").segment_params(torch.tensor(q))
    assert got.shape == (11, 8, 6)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_mask_plain_equals_pallas_on_same_segments(rng):
    """The kernel-level contract: the same (M, S, 6) segments give the same
    masks as the Pallas kernel, bit for bit, with M = 21 (not a multiple of
    16) and capsules that cross the image border."""
    a = rng.uniform(-10, 74, (21, 8, 2))
    b = a + rng.randn(21, 8, 2) * 15
    r = rng.uniform(0.5, 9.0, (21, 8, 2))
    segs = np.concatenate([a, b, r], -1).astype(np.float32)
    want = np.asarray(jax_capsule_mask_render(jnp.asarray(segs), 48, 64,
                                              interpret=True))
    got = kernels.capsule_mask_render(torch.tensor(segs), 48, 64)
    np.testing.assert_array_equal(got.numpy(), want)


def test_mask_wrapper_rejects_bad_segments():
    with pytest.raises(ValueError):
        kernels.capsule_mask_render(torch.zeros(4, 8, 5), 48, 64)


@pytest.mark.parametrize("case", [c for c in MASK_CASES if c != "empty"])
def test_mask_skip_rule_drops_no_hit(case):
    """Every capsule alone, through the Pallas kernel (interpret mode) and
    the plain version, bit for bit: no pixel-capsule pair that the CUDA
    kernel's skip rule (tile shape and margin from ops/kernels.py) leaves
    out is a hit. The CUDA kernel is held to the plain version on the same
    cases in tests/test_torch_port_gpu.py."""
    segs, h, w = mask_case(case, "cpu")
    M, S = segs.shape[:2]
    one = segs.reshape(M * S, 1, 6)
    hits = np.asarray(jax_capsule_mask_render(jnp.asarray(one.numpy()), h, w,
                                              interpret=True))
    hits = hits.reshape(M, S, h, w) > 0
    plain = kernels.capsule_mask_render_plain(one, h, w).numpy()
    np.testing.assert_array_equal(plain.reshape(M, S, h, w) > 0, hits)
    kept = kernels.capsule_mask_tests_kept(segs, h, w).numpy()
    assert not (hits & ~kept).any()


def test_mask_skip_rule_on_planner_poses():
    """On 500 planner poses the rule keeps under a quarter of the tests,
    and the masks of the kept tests alone equal JAX `render`."""
    segs, h, w = mask_case("planner_500", "cpu")
    M, S = segs.shape[:2]
    kept = kernels.capsule_mask_tests_kept(segs, h, w)
    hits = kernels.capsule_mask_render_plain(segs.reshape(M * S, 1, 6), h, w)
    got = (hits.reshape(M, S, h, w).bool() & kept).any(1).float()
    want = JRenderer((h, w), thick=True).render(
        jnp.asarray(PLANNER_POSES, jnp.float32))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[..., 0])
    assert float(kept.float().mean()) < 0.25


def test_mask_skip_rule_cases_mean_what_they_say():
    """Off-image capsules miss everywhere and the whole-image ones hit
    everywhere; a tile whose outer pixel centre lies exactly on a box edge
    is tested, one float32 step short of it is skipped; capsules with a
    non-finite parameter or a magnitude past the limit are never skipped."""
    assert not kernels.capsule_mask_render(*mask_case("off_image", "cpu")).any()
    assert kernels.capsule_mask_render(*mask_case("whole_image", "cpu")).all()
    segs, h, w = mask_case("box_edge", "cpu")
    kept = kernels.capsule_mask_tests_kept(segs, h, w)
    rows, cols = kernels.MASK_TILE
    for s, (ty, tx) in enumerate(BOX_EDGE_TILES):
        tile = (slice(ty * rows, (ty + 1) * rows),
                slice(tx * cols, (tx + 1) * cols))
        assert kept[0, s][tile].all() and not kept[1, s][tile].any()
    segs, h, w = mask_case("nonfinite", "cpu")
    wild = (~segs.isfinite().all(-1)
            | (segs.abs().sum(-1) >= kernels.MASK_MAX_MAGNITUDE))
    assert int(wild.sum()) == 6
    assert kernels.capsule_mask_tests_kept(segs, h, w)[wild].all()


# ----------------------------------------------------------- ConvLSTM cell
def _cell_inputs(rng, batch, hw, cin, ch, ksize, seed):
    params = jlstm.conv_lstm_cell_init(jax.random.PRNGKey(seed), cin, ch, ksize)
    params["gates"]["b"] = jnp.asarray(
        rng.randn(4 * ch).astype(np.float32) * 0.1)
    x = rng.randn(batch, *hw, cin).astype(np.float32)
    h = rng.randn(batch, *hw, ch).astype(np.float32)
    c = rng.randn(batch, *hw, ch).astype(np.float32)
    return params, x, h, c


def _port_cell(params, x, h, c, dtype):
    w = torch.tensor(np.asarray(params["gates"]["w"])).to(dtype)
    b = torch.tensor(np.asarray(params["gates"]["b"]))
    return kernels.conv_lstm_cell(torch.tensor(x).to(dtype),
                                  torch.tensor(h).to(dtype),
                                  torch.tensor(c).to(dtype), w, b)


@pytest.mark.parametrize("ksize,hw,cin,ch,batch", [
    (5, (6, 8), 16, 8, 3),    # cell0-like: x and h widths differ, odd batch
    (3, (6, 8), 8, 8, 4),     # cell1-like
    (3, (4, 4), 8, 256, 2),   # C = 256: the Pallas channel-tile grid
])
def test_cell_f32_matches_pallas(rng, ksize, hw, cin, ch, batch):
    """Plain cell vs the JAX fused Pallas cell (interpret mode), float32,
    to 1e-5: the same float32 sums in another order."""
    params, x, h, c = _cell_inputs(rng, batch, hw, cin, ch, ksize, 0)
    _, (h_want, c_want) = fused_conv_lstm_cell(
        params, (jnp.asarray(h), jnp.asarray(c)), jnp.asarray(x),
        interpret=True)
    h_got, c_got = _port_cell(params, x, h, c, torch.float32)
    assert h_got.shape == (batch, *hw, ch) and h_got.dtype == torch.float32
    np.testing.assert_allclose(h_got.numpy(), np.asarray(h_want),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(c_got.numpy(), np.asarray(c_want),
                               rtol=1e-5, atol=1e-5)


def test_cell_bf16_matches_pallas(rng):
    """bf16 inputs and weights, gates in float32, outputs in bf16: within
    0.05 of the Pallas cell, the bound tests/test_pallas.py uses."""
    params, x, h, c = _cell_inputs(rng, 2, (6, 8), 8, 8, 3, 1)
    bf = jnp.bfloat16
    _, (h_want, c_want) = fused_conv_lstm_cell(
        params, (jnp.asarray(h, bf), jnp.asarray(c, bf)), jnp.asarray(x, bf),
        interpret=True)
    h_got, c_got = _port_cell(params, x, h, c, torch.bfloat16)
    assert h_got.dtype == torch.bfloat16
    for got, want in ((h_got, h_want), (c_got, c_want)):
        np.testing.assert_allclose(got.float().numpy(),
                                   np.asarray(want, np.float32),
                                   rtol=0.05, atol=0.05)


def test_cell_wrapper_rejects_bad_weights():
    x = torch.zeros(1, 6, 8, 4)
    h = torch.zeros(1, 6, 8, 8)
    with pytest.raises(ValueError):  # in-channels must be Cx + C
        kernels.conv_lstm_cell(x, h, h, torch.zeros(3, 3, 8, 32),
                               torch.zeros(32))
    with pytest.raises(ValueError):  # even kernel size
        kernels.conv_lstm_cell(x, h, h, torch.zeros(2, 2, 12, 32),
                               torch.zeros(32))


@pytest.mark.parametrize("dtype,cx,ch,offset,want", [
    (torch.bfloat16, 256, 256, 0, True),   # the planner's cells
    (torch.bfloat16, 24, 40, 0, True),     # a partial 64-channel tile
    (torch.bfloat16, 13, 20, 0, False),    # rows not a multiple of 16 bytes
    (torch.bfloat16, 16, 16, 1, False),    # x not 16-byte aligned
    (torch.float32, 256, 256, 0, False),   # float32 keeps the CUDA-core kernel
])
def test_cell_kernel_choice(dtype, cx, ch, offset, want):
    """Which CUDA kernel a cell takes depends only on dtype, channel counts
    and alignment. The rule is plain Python, so it is checked here on CPU
    tensors; the launches are checked on the card."""
    x = torch.zeros(2 * 6 * 8 * cx + offset, dtype=dtype)[offset:].view(
        2, 6, 8, cx)
    h = torch.zeros(2, 6, 8, ch, dtype=dtype)
    w = torch.zeros(3, 3, cx + ch, 4 * ch, dtype=dtype)
    assert kernels.takes_sm90(x, h, h, w) is want
