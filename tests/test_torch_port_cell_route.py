"""The bf16 ConvLSTM cell's one CUDA route, checked on the CPU.

Every bf16 CUDA cell takes the wgmma/TMA kernel of
csrc/conv_lstm_cell_sm90.cu. What that kernel cannot read in place, the
wrapper stages first (`ops/kernels.py:stage_cell`): x, h or c whose pixel
stride is not a multiple of 8 elements, or whose pointer is not 16-byte
aligned, into a `padded_nhwc` view; weights whose C is not a multiple of 8
into the gate-packed copy (`sm90_weights`). Staging is plain PyTorch, so
its contract is checked here on CPU tensors, at the widths that took the
retired WMMA kernel before (any g_dim not a multiple of 8, odd ones, det's 258
and 260 on contiguous tensors, a 262-channel stride, a misaligned view):

  * the staged inputs satisfy the kernel's layout contract, and staging
    them again changes nothing;
  * the packed weights hold each gate's columns at a 16-byte aligned gate
    stride, zeros past C, and the narrow tail's block;
  * with NaN in every pad lane of the staged inputs, the plain cell gives
    the bits it gives on the originals.

The kernel itself runs on the card (tests/test_torch_port_gpu.py,
chip_smoke.py). No JAX here.
"""

import pytest
import torch

from robot_aware_control_tpu_torch.ops import kernels

# (Cx, C): multiples of 8, g_dims that are not (12, 100, 252), odd ones,
# det's widths (258, 260) and a mixed cell
WIDTHS = [(8, 8), (12, 12), (13, 20), (100, 100), (252, 252), (255, 255),
          (258, 258), (260, 260)]
# the same cell held in a view of a 262-channel buffer, or at an offset of
# one element from a 16-byte boundary
VIEWS = ["ld262", "misaligned"]


@pytest.fixture(autouse=True)
def one_thread():
    """One torch thread: with several, the first float32 convolution of a
    shape on the CPU now and then sums in another order."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _cell(case, k=3, B=2, H=5, W=7):
    """A bf16 cell of Cx/C channels (or 260/260 in a view), seed from the
    widths; returns (x, h, c, w, b)."""
    Cx, C = (260, 260) if case in VIEWS else case
    g = torch.Generator().manual_seed(Cx * 1000 + C)
    x, h, c = (torch.randn(B, H, W, n, generator=g).bfloat16()
               for n in (Cx, C, C))
    w = (torch.randn(k, k, Cx + C, 4 * C, generator=g) * 0.05).bfloat16()
    b = torch.randn(4 * C, generator=g) * 0.1
    if case == "ld262":
        x, h, c = (torch.full((B, H, W, 262), float("nan"),
                              dtype=torch.bfloat16)[..., :t.shape[-1]].copy_(t)
                   for t in (x, h, c))
    elif case == "misaligned":
        def shifted(t):
            buf = torch.empty(t.numel() + 8, dtype=t.dtype)
            off = 1 if buf.data_ptr() % 16 == 0 else 0
            return buf[off:off + t.numel()].view(t.shape).copy_(t)

        x, h, c = shifted(x), shifted(h), shifted(c)
        w = shifted(w)
        assert all(t.data_ptr() % 16 for t in (x, h, c, w))
    return x, h, c, w, b


def _pad_lanes(t):
    """The lanes between t's channels and its pixel stride, as a view."""
    B, H, W, C = t.shape
    ld = kernels.pixel_stride(t)
    return t.as_strided((B, H, W, ld - C), t.stride(), t.storage_offset() + C)


def _unpack(wk, cw, C):
    """The (k, k, Cin, 4C) weights that packed weights of gate stride cw
    hold."""
    k, _, cin, _ = wk.shape
    return wk[..., :4 * cw].reshape(k, k, cin, 4, cw)[..., :C].reshape(
        k, k, cin, 4 * C)


@pytest.mark.parametrize("case", WIDTHS + VIEWS, ids=str)
def test_staged_inputs_meet_the_kernel_contract(case):
    """x, h and c come back NHWC at a pixel stride that is a multiple of 8
    and at or above their channels, 16-byte aligned, equal to the inputs;
    the weights contiguous and aligned at a gate stride that is a multiple
    of 8, C itself where C is one. Staged inputs are staged no further."""
    x, h, c, w, b = _cell(case)
    C = h.shape[-1]
    xs, hs, cs, wk, cw = kernels.stage_cell(x, h, c, w)
    for orig, t in zip((x, h, c), (xs, hs, cs)):
        ld = kernels.pixel_stride(t)
        assert ld is not None and ld % 8 == 0 and ld >= t.shape[-1]
        assert t.data_ptr() % 16 == 0 and kernels.tma_ready(t)
        assert t.shape == orig.shape and t.dtype == torch.bfloat16
        assert torch.equal(t, orig)
        # read in place where it could be, else a padded copy
        assert (t is orig) == (kernels.pixel_stride(orig) % 8 == 0
                               and orig.data_ptr() % 16 == 0)
    assert wk.is_contiguous() and wk.data_ptr() % 16 == 0
    assert cw % 8 == 0 and cw >= C and (cw == C) == (C % 8 == 0)
    assert wk.shape[-1] == 4 * cw + (kernels.TAIL_COLUMNS if cw != C else 0)
    again = kernels.stage_cell(xs, hs, cs, wk if cw == C else w)
    assert all(a is b for a, b in zip(again[:3], (xs, hs, cs)))


@pytest.mark.parametrize("case", WIDTHS + VIEWS, ids=str)
def test_packed_weights_hold_the_gates(case):
    """Gate q's C columns at q cw, zeros up to (q + 1) cw, then (cw > C)
    the narrow tail's block: the 8 channels from C rounded down to 64 of
    each gate, zeros past C."""
    x, h, c, w, b = _cell(case)
    C = h.shape[-1]
    _, _, _, wk, cw = kernels.stage_cell(x, h, c, w)
    assert torch.equal(_unpack(wk, cw, C), w)
    k, _, cin, _ = w.shape
    gates = wk[..., :4 * cw].reshape(k, k, cin, 4, cw)
    assert not gates[..., C:].any()
    if cw != C:
        t0 = C // 64 * 64
        tail = wk[..., 4 * cw:].reshape(k, k, cin, 4, 8)
        want = w.reshape(k, k, cin, 4, C)[..., t0:t0 + 8]
        assert torch.equal(tail[..., :want.shape[-1]], want)
        assert not tail[..., want.shape[-1]:].any()


@pytest.mark.parametrize("k", [5, 3])
@pytest.mark.parametrize("case", WIDTHS + VIEWS, ids=str)
def test_plain_cell_on_staged_inputs_keeps_its_bits(case, k):
    """NaN in every pad lane of the staged x, h and c: the plain cell on
    them, with the weights the packed copy holds, gives the bits it gives
    on the original inputs, finite."""
    x, h, c, w, b = _cell(case, k=k)
    C = h.shape[-1]
    xs, hs, cs, wk, cw = kernels.stage_cell(x, h, c, w)
    for t in (xs, hs, cs):
        if kernels.pixel_stride(t) > t.shape[-1]:
            _pad_lanes(t).fill_(float("nan"))
    want = kernels.conv_lstm_cell_plain(x, h, c, w, b)
    got = kernels.conv_lstm_cell_plain(xs, hs, cs, _unpack(wk, cw, C), b)
    for g, wv in zip(got, want):
        assert torch.equal(g, wv) and bool(torch.isfinite(g).all())


def test_staging_leaves_the_inputs_alone():
    """Staging copies: the caller's tensors are not written, and only CUDA
    copies are counted."""
    x, h, c, w, b = _cell((13, 20))
    before = [t.clone() for t in (x, h, c, w)]
    count = kernels.staged["inputs"]
    for t in kernels.stage_cell(x, h, c, w)[:3]:
        _pad_lanes(t).fill_(float("nan"))
    assert all(torch.equal(a, b) for a, b in zip(before, (x, h, c, w)))
    assert kernels.staged["inputs"] == count


def test_staging_under_inference_mode():
    """Weights made under inference_mode (an inference tensor has no
    version counter to key the kept packed copy by) are packed per call,
    the same values as a parameter's kept copy."""
    x, h, c, w, b = _cell((13, 20))
    kept = kernels.stage_cell(x, h, c, w)
    with torch.inference_mode():
        wi = w.clone()
        got = kernels.stage_cell(x, h, c, wi)
    assert wi.is_inference()
    assert got[4] == kept[4] and torch.equal(got[3], kept[3])
    assert all(torch.equal(a, b) for a, b in zip(got[:3], kept[:3]))
