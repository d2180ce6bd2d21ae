"""K1-1pass and K1-3pass on the tensor cores (``csrc/melspec_mma.cu``): the
host layout of their constants and the function that layout computes. No
kernel runs here (``tests/test_torch_cuda.py`` runs them on the card): these
tests hold the bf16 planes ``melspec_cuda._device_consts`` feeds the kernels
to the float32 kernel's constants, and multiply them out in float64 the way
the kernel pairs them (cos and -sin of a bin in the two halves of each 16-row
tile), against the plain versions."""

import math

import numpy as np
import pytest
import torch

from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import melspec, melspec_cuda
from openwakeword_tpu_torch.ops.bf16 import round_bf16, split_bf16
from openwakeword_tpu_torch.utils import cuda_build

MEL_TOL_DB = 2e-3
# one bf16 rounding of the power flipped by a float32 sum in another order
# (tests/test_torch_cuda.py)
MEL_1PASS_TOL_DB = MEL_TOL_DB + 10 * math.log10(1 + 2 ** -7)

CPU = torch.device("cpu")


def _planes(arith):
    basis, melw = melspec_cuda._device_consts(CPU, "direct", arith)
    return basis.double(), melw.double()


@pytest.mark.parametrize("arith, tol", [("1pass", 2 ** -8), ("3pass", 2 ** -16)])
def test_mma_basis_pairs_cos_and_sin_of_the_same_bins(arith, tol):
    """Row 16 G + i of the (N, K) basis is the cos column of live bin 8 G + i
    and row 16 G + 8 + i its -sin column (``stft_power_basis``), to the
    planes' precision: an n8 tile of re and one of im for the same bins."""
    first, count, _ = melspec_cuda.live_bins()
    basis, _ = _planes(arith)
    value = basis.sum(0).numpy()                               # hi (+ lo)
    ref = melspec.stft_power_basis()                           # (512, 514): cos, -sin per bin
    for b in range(count):
        cos_row, sin_row = 16 * (b // 8) + b % 8, 16 * (b // 8) + 8 + b % 8
        np.testing.assert_allclose(value[cos_row], ref[:, 2 * (first + b)], rtol=0, atol=tol)
        np.testing.assert_allclose(value[sin_row], ref[:, 2 * (first + b) + 1], rtol=0, atol=tol)


@pytest.mark.parametrize("arith", ["1pass", "3pass"])
def test_mma_padded_bins_are_zero(arith):
    """Bins past the live range, up to whole 32-bin warp tiles, are zero in
    every plane of the basis (both rows of a bin) and of the mel weights."""
    _, count, _ = melspec_cuda.live_bins()
    basis, melw = melspec_cuda._device_consts(CPU, "direct", arith)
    bins = melspec_cuda.mma_bins()
    assert bins % melspec_cuda.MMA_BIN_TILE == 0 and bins >= count
    assert basis.is_contiguous() and melw.is_contiguous()
    rows = np.arange(2 * bins)
    bin_of_row = 8 * (rows // 16) + rows % 8
    assert not basis[:, bin_of_row >= count].any() and basis[:, bin_of_row < count].any(dim=-1).all()
    assert not melw[..., count:].any() and melw[0, :, :count].any()


def _layout_mel(x: torch.Tensor, arith: str) -> torch.Tensor:
    """What the kernel computes from its constants, in float64 where it sums
    in float32: the frames rounded or split, the (N, K) basis rows paired per
    16-row tile into re and im, the power rounded or split, the mel weights
    as (mels, bins)."""
    basis, melw = _planes(arith)
    frames = melspec.frame_signal(x)                                 # (S, 8, 512) float32
    if arith == "1pass":
        spec = round_bf16(frames).double() @ basis[0].t()
    else:
        hi, lo = split_bf16(frames)
        spec = hi.double() @ (basis[0] + basis[1]).t() + lo.double() @ basis[0].t()
    spec = spec.reshape(*spec.shape[:-1], -1, 2, 8)                  # (S, 8, group, re/im, 8)
    power = (spec[..., 0, :] ** 2 + spec[..., 1, :] ** 2).flatten(-2).float()
    if arith == "1pass":
        mel = round_bf16(power).double() @ melw[0].t()
    else:
        hi, lo = split_bf16(power)
        mel = hi.double() @ (melw[0] + melw[1]).t() + lo.double() @ melw[0].t()
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10)).float()


@pytest.mark.parametrize("arith", ["1pass", "3pass"])
@pytest.mark.parametrize("n_streams", [1, 5, 17])
def test_mma_layout_computes_the_plain_function(rng, arith, n_streams):
    """The constants, paired as the kernel pairs them, give the plain
    version's dB with a silent stream: within 2e-3 dB at 3-pass; at 1-pass
    within one flipped power rounding, and beyond 2e-3 dB in at most 1% of
    the values (the checks the card holds the kernel to)."""
    w = (rng.uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[n_streams // 2] = 0.0
    x = torch.from_numpy(w)
    got = _layout_mel(x, arith)
    want = melspec_cuda.melspectrogram_frames_plain(x, "direct", arith)
    assert got.shape == want.shape == (n_streams, 8, 32)
    err = (got - want).abs()
    if arith == "3pass":
        assert float(err.max()) <= MEL_TOL_DB
    else:
        assert float(err.max()) <= MEL_1PASS_TOL_DB
        assert float((err > MEL_TOL_DB).float().mean()) <= 0.01
    np.testing.assert_allclose(got[n_streams // 2].numpy(), -100.0, atol=1e-4)


def test_mma_layout_other_live_range(monkeypatch):
    """At FMAX = 7000 (222 live bins, padded to 224, whole 32-bin tiles):
    the planes keep the layout, un-permute to the float32 kernel's constants
    and are zero in the padded bins."""
    monkeypatch.setattr(config, "FMAX", 7000.0)
    first, count, padded = melspec_cuda.live_bins()
    bins = melspec_cuda.mma_bins()
    assert (first, count, padded, bins) == (2, 222, 224, 224)
    basis, melw = melspec_cuda._mma_consts("3pass")
    assert basis.shape == (2, 2 * bins, 512) and melw.shape == (2, 32, bins)
    want = split_bf16(melspec.f32_const(melspec_cuda._kernel_basis("direct"), "cpu"))
    cols = torch.from_numpy(melspec_cuda.mma_columns())
    for plane in range(2):
        got = torch.zeros((512, 2 * bins))
        got[:, cols] = basis[plane].t()
        assert torch.equal(got[:, :2 * padded], want[plane])
    assert not melw[..., count:].any()


@pytest.mark.parametrize("arith", ["1pass", "3pass"])
def test_wrapper_rejects_as_before(arith):
    """The bf16 variants' wrapper rejects what it rejected before: other
    devices, an unknown DFT or arithmetic."""
    with pytest.raises(ValueError, match="CPU or CUDA"):
        melspec_cuda.melspectrogram_frames(torch.empty((2, 1760), device="meta"), "direct", arith)
    with pytest.raises(ValueError, match="unknown dft"):
        melspec_cuda.melspectrogram_frames(torch.zeros((2, 1760)), "fft", arith)
    with pytest.raises(ValueError, match="unknown arithmetic"):
        melspec_cuda.melspectrogram_frames(torch.zeros((2, 1760)), "direct", arith.upper())
    with pytest.raises(ValueError, match="unknown arithmetic"):
        melspec_cuda._device_consts(CPU, "direct", arith + "es")


def test_tensor_core_entries_live_in_their_own_unit():
    """K1-1pass and K1-3pass build from ``csrc/melspec_mma.cu``, K2-1pass
    and K2-3pass from ``csrc/melspec_factored_mma.cu``; both take their
    geometry, live range and warp tiles only from ``mel_program.h`` and their
    tensor-core helpers from ``mma_bf16.cuh``. ``melspec.cu`` keeps the fp32
    kernels 1 and 2 only."""
    text = cuda_build.generated_headers()["mel_program.h"]
    assert f"constexpr int kMmaBinTile = {melspec_cuda.MMA_BIN_TILE};" in text
    assert f"constexpr int kFactoredChunk = {melspec_cuda.FACTORED_CHUNK};" in text
    mma = (cuda_build.CSRC / "melspec_mma.cu").read_text()
    factored = (cuda_build.CSRC / "melspec_factored_mma.cu").read_text()
    fp32 = (cuda_build.CSRC / "melspec.cu").read_text()
    helpers = (cuda_build.CSRC / "mma_bf16.cuh").read_text()
    assert "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32" in helpers
    for unit, entries in ((mma, ("owwt_melspec_frames_1pass", "owwt_melspec_frames_3pass")),
                          (factored, ("owwt_melspec_frames_factored_1pass", "owwt_melspec_frames_factored_3pass"))):
        assert '#include "mel_program.h"' in unit and '#include "mma_bf16.cuh"' in unit
        assert "constexpr int kLiveBin" not in unit and "constexpr int kFactoredCol" not in unit
        assert "asm" not in unit
        for entry in entries:
            assert f'extern "C" int {entry}(' in unit and f'extern "C" int {entry}(' not in fp32
    for entry in ("owwt_melspec_frames", "owwt_melspec_frames_factored"):
        assert f'extern "C" int {entry}(' in fp32
    assert "_1pass(" not in fp32 and "_3pass(" not in fp32 and "ARITH" not in fp32


@pytest.fixture()
def fresh_consts():
    """The device constants are cached per device: drop them before and
    after a test that changes the live range."""
    melspec_cuda._device_consts.cache_clear()
    yield
    melspec_cuda._device_consts.cache_clear()


@pytest.mark.parametrize("arith", ["1pass", "3pass"])
@pytest.mark.parametrize("fmax, count", [(8000.0, 254), (9000.0, 255)])
def test_mma_layout_full_band(rng, monkeypatch, fresh_consts, fmax, count, arith):
    """At the full band (FMAX = 8000: bins 2..255) and above it (9000: bin
    256 live too) the live range pads to 256 bins, 8 whole 32-bin warp
    tiles: the (planes, 512, 512) basis and (planes, 32, 256) mel weights
    keep the layout, un-permute to the float32 kernel's constants, are zero
    past the live bins, and, paired as the kernel pairs them, compute the
    plain version over that range's filterbank (the plain version follows
    ``config``), with a silent stream at -100 dB."""
    monkeypatch.setattr(config, "FMAX", fmax)
    assert melspec_cuda.live_bins() == (2, count, 256) and melspec_cuda.mma_bins() == 256
    planes = 1 if arith == "1pass" else 2
    basis, melw = melspec_cuda._device_consts(CPU, "direct", arith)
    assert basis.shape == (planes, 512, 512) and melw.shape == (planes, 32, 256)
    f32 = melspec.f32_const(melspec_cuda._kernel_basis("direct"), "cpu")
    want = (round_bf16(f32),) if arith == "1pass" else split_bf16(f32)
    cols = torch.from_numpy(melspec_cuda.mma_columns())
    for plane in range(planes):
        got = torch.zeros((512, 512))
        got[:, cols] = basis[plane].float().t()
        assert torch.equal(got, want[plane])
    assert not melw[..., count:].any() and melw[0, :, count - 1].any()
    fb32 = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    assert torch.equal(melw[0].float().t()[:count], (round_bf16(fb32) if arith == "1pass"
                                                     else split_bf16(fb32)[0])[2:2 + count])
    w = (rng.uniform(-1, 1, (9, 1760)) * 25000).astype(np.float32)
    w[4] = 0.0
    x = torch.from_numpy(w)
    got = _layout_mel(x, arith)
    err = (got - melspec_cuda.melspectrogram_frames_plain(x, "direct", arith)).abs()
    assert float(err.max()) <= (MEL_TOL_DB if arith == "3pass" else MEL_1PASS_TOL_DB)
    assert float((err > MEL_TOL_DB).float().mean()) <= 0.01
    np.testing.assert_allclose(got[4].numpy(), -100.0, atol=1e-4)
