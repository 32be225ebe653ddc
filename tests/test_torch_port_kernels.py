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
    # the wgmma/TMA kernel's gate-packed copy is the wrapper's to make
    # (kernels.sm90_weights); every path takes (k, k, Cx + C, 4C)
    x = torch.zeros(1, 6, 8, 260)
    with pytest.raises(ValueError):
        kernels.conv_lstm_cell(
            x, x, x, kernels.pack_gate_weights(torch.zeros(3, 3, 520, 1040), 260),
            torch.zeros(1040))


@pytest.mark.parametrize("dtype,cx,ch,offset,staged,ld", [
    (torch.bfloat16, 256, 256, 0, "", None),    # the planner's cells
    (torch.bfloat16, 24, 40, 0, "", None),      # a partial 64-channel tile
    (torch.bfloat16, 13, 20, 0, "xhcw", None),  # rows not a multiple of 16 bytes
    (torch.bfloat16, 16, 16, 1, "xhc", None),   # x, h, c not 16-byte aligned
    (torch.float32, 256, 256, 0, "", None),     # float32: the float32 kernel
    (torch.bfloat16, 260, 260, 0, "w", 264),    # det: padded views
    (torch.bfloat16, 258, 258, 0, "w", 264),    # det without robot state
    (torch.bfloat16, 260, 260, 0, "xhcw", None),  # contiguous 260: 520-byte rows
    (torch.float32, 260, 260, 0, "", 264),      # float32 det: the float32 kernel
    (torch.bfloat16, 13, 13, 0, "w", 16),       # an odd channel count
    (torch.bfloat16, 260, 260, 0, "xhcw", 262),  # a pixel stride of 262
])
def test_cell_kernel_choice(dtype, cx, ch, offset, staged, ld):
    """Every CUDA cell of a type takes one kernel (bf16 the wgmma/TMA
    kernel, float32 the float32 kernel); which inputs the wrapper copies
    first (`stage_cell`) depends only on dtype, channel counts, strides and
    alignment: x, h and c contiguous or views of buffers of `ld` channels
    a pixel, w gate-packed where C is not a multiple of 8. The rule is
    plain Python, so it is checked here on CPU tensors; the launches are
    checked on the card."""
    def make(n):
        if ld is None:
            return torch.zeros(2 * 6 * 8 * n + offset, dtype=dtype)[
                offset:].view(2, 6, 8, n)
        return torch.zeros(2, 6, 8, ld, dtype=dtype)[..., :n]

    x, h, c = make(cx), make(ch), make(ch)
    w = torch.zeros(3, 3, cx + ch, 4 * ch, dtype=dtype)
    out = kernels.stage_cell(x, h, c, w)
    assert "".join(n for n, a, b in zip("xhcw", (x, h, c, w), out)
                   if a is not b) == staged
    if dtype == torch.bfloat16:
        assert all(kernels.tma_ready(t) for t in out[:3])


@pytest.mark.parametrize("C,ld", [(260, 264), (258, 264), (20, 24)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_cell_plain_ignores_pad_lanes(C, ld, dtype):
    """The cell on views of padded buffers whose pad lanes hold NaN equals
    the cell on contiguous copies bit for bit, and returns h' and c' in h's
    padded layout. One
    torch thread: with several, the first float32 convolution of a shape
    on the CPU now and then sums in another order (3e-5 apart)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        _plain_ignores_pad_lanes(C, ld, dtype)
    finally:
        torch.set_num_threads(threads)


def _plain_ignores_pad_lanes(C, ld, dtype):
    g = torch.Generator().manual_seed(C)
    x, h, c = (torch.randn(2, 6, 8, C, generator=g).to(dtype)
               for _ in range(3))
    w = (torch.randn(3, 3, 2 * C, 4 * C, generator=g) * 0.05).to(dtype)
    b = torch.randn(4 * C, generator=g) * 0.1

    def padded(t):
        return torch.full((2, 6, 8, ld), float("nan"), dtype=dtype)[
            ..., :C].copy_(t)

    got = kernels.conv_lstm_cell(padded(x), padded(h), padded(c), w, b)
    want = kernels.conv_lstm_cell(x, h, c, w, b)
    for gv, wv in zip(got, want):
        assert kernels.pixel_stride(gv) == ld
        assert torch.equal(gv, wv)


def test_pack_gate_weights_round_trip():
    """Packed weights: each gate's columns on a multiple of 64, zeros past
    C, then the narrow tail's block (channels 256-263 of each gate, zeros
    past 260). 256 channels stay as they are."""
    w = torch.randn(3, 3, 520, 1040)
    p = kernels.pack_gate_weights(w, 260)
    assert p.shape == (3, 3, 520, 4 * 320 + kernels.TAIL_COLUMNS)
    gates = w.reshape(3, 3, 520, 4, 260)
    for q in range(4):
        assert torch.equal(p[..., q * 320:q * 320 + 260], gates[..., q, :])
        assert not p[..., q * 320 + 260:(q + 1) * 320].any()
        tail = p[..., 1280 + 8 * q:1280 + 8 * q + 8]
        assert torch.equal(tail[..., :4], gates[..., q, 256:260])
        assert not tail[..., 4:].any()
    w256 = torch.randn(3, 3, 512, 1024)
    assert kernels.pack_gate_weights(w256, 256) is w256


def test_sm90_weights_follow_the_parameter():
    """The wgmma/TMA kernel's gate-packed copy of a cell's weights (20
    hidden channels) is made once per version of the parameter: the same
    tensor while it is unchanged, also under inference_mode (and then not
    an inference tensor), a new one after an in-place update (an optimizer
    step, load_state_dict); no copy for 16 channels, and none in the
    module's state."""
    from robot_aware_control_tpu_torch.ops.lstm import ConvLSTMCell

    cell = ConvLSTMCell(8, 20, 3)
    torch.nn.init.normal_(cell.weight)
    with torch.inference_mode():
        packed, cw = kernels.sm90_weights(cell.weight, 20)
    assert not packed.is_inference()
    assert cw == 64 and packed.shape == (3, 3, 28, 4 * 64 + kernels.TAIL_COLUMNS)
    assert kernels.sm90_weights(cell.weight, 20)[0] is packed
    assert torch.equal(packed, kernels.pack_gate_weights(cell.weight, 20))
    with torch.no_grad():
        cell.weight.mul_(2.0)
    again = kernels.sm90_weights(cell.weight, 20)[0]
    assert again is not packed
    assert torch.equal(again, kernels.pack_gate_weights(cell.weight, 20))
    assert set(cell.state_dict()) == {"weight", "bias"}
    plain = ConvLSTMCell(8, 16, 3)
    w, cw = kernels.sm90_weights(plain.weight, 16)
    assert w is plain.weight and cw == 16
