"""Kernel 2 in fp32 (``csrc/melspec.cu::melspec_frames_factored_kernel``): the
host layout of its constants and the function that layout computes. No kernel
runs here (``tests/test_torch_cuda.py`` runs it on the card): these tests hold
the float32 basis and mel weights ``melspec_cuda._device_consts`` feeds the
kernel to the stage-1 bases and the filterbank, and multiply them out the way
the kernel pairs them (branch by branch over the live stage-1 columns, the
butterfly E = Z0 + Z2, O = Z1 + Z3, D = Z0 - Z2, F = Z1 - Z3, the power of each
half against its mel rows, bin 256's power against its row), against the plain
version and JAX's ``_make_factored_kernel`` at ``precision=HIGHEST``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.ops import melspec_pallas as jax_mel
from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import melspec, melspec_cuda
from openwakeword_tpu_torch.utils import cuda_build

MEL_TOL_DB = 2e-3
SUB = config.N_FFT // melspec.RADIX
CPU = torch.device("cpu")


def _consts():
    """(basis (4, 128, 2 * padded), mel weights (halves, padded, 32), bin
    256's row (32,)) as the float32 device tensors hold them, split by
    branch and by half."""
    basis, melw = melspec_cuda._device_consts(CPU, "factored")
    padded, half1 = melspec_cuda.factored_padded(), melspec_cuda.factored_columns()[3]
    halves = 2 if half1 else 1
    assert basis.dtype == melw.dtype == torch.float32 and basis.is_contiguous() and melw.is_contiguous()
    assert basis.shape == (config.N_FFT, 2 * padded) and melw.shape == (halves * padded + 1, config.N_MELS)
    return basis.view(melspec.RADIX, SUB, 2 * padded), melw[:-1].view(halves, padded, config.N_MELS), melw[-1]


def test_factored_constants_are_the_live_columns():
    """The basis, branch by branch, is the float32 stage-1 bases' live
    columns (Re, Im of columns first .. first + count - 1) bit for bit,
    zero past count; the mel weights are the float32 filterbank's rows of
    bins first + i, zero past count; bin 256's row follows (zero at the
    default range). The columns are padded to the fp32 kernel's own warp
    tiles, not to the tensor-core variants' passes: 120 stay 120."""
    first, count, _, half1, nyquist = melspec_cuda.factored_columns()
    assert (first, count, half1, nyquist) == (2, 120, False, False)
    assert melspec_cuda.factored_padded() == 120 and 120 % melspec_cuda.FACTORED_COL_TILE == 0
    basis, melw, w256 = _consts()
    bases32 = melspec.f32_const(melspec.factored_dft_bases(), "cpu")
    assert torch.equal(basis[:, :, :2 * count], bases32[:, :, 2 * first:2 * (first + count)])
    assert not basis[:, :, 2 * count:].any()
    fb32 = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    assert torch.equal(melw[0, :count], fb32[first:first + count]) and not melw[0, count:].any()
    assert torch.equal(w256, fb32[2 * SUB]) and not w256.any()


def test_generated_header_carries_the_column_tile():
    """``mel_program.h`` carries the fp32 kernel's column tile beside the
    live stage-1 columns; the kernel takes both from there only."""
    text = cuda_build.generated_headers()["mel_program.h"]
    assert f"constexpr int kFactoredColTile = {melspec_cuda.FACTORED_COL_TILE};" in text
    assert "constexpr int kFactoredCols = 120;" in text and "constexpr int kFactoredCol0 = 2;" in text
    source = (cuda_build.CSRC / "melspec.cu").read_text()
    assert "constexpr int kFactoredColTile" not in source and "kFactoredColTile" in source


def _layout_mel(x: torch.Tensor) -> torch.Tensor:
    """What the kernel computes from its constants, in float64 where it sums
    in float32: each branch's product with its K range of the basis, the
    butterfly, the power of each half against its mel rows, bin 256's power
    against its row where it is live."""
    basis, melw, w256 = (c.double() for c in _consts())
    _, _, _, half1, nyquist = melspec_cuda.factored_columns()
    branches = melspec.deinterleave_branches(melspec.frame_signal(x)).double()    # (S, 8, 4, 128)
    z = [branches[..., b, :] @ basis[b] for b in range(melspec.RADIX)]             # (S, 8, 2 * padded)
    e, o, d, f = z[0] + z[2], z[1] + z[3], z[0] - z[2], z[1] - z[3]
    x0 = e + o
    p0 = x0[..., 0::2] ** 2 + x0[..., 1::2] ** 2
    mel = p0 @ melw[0]
    if half1:
        p1 = (d[..., 0::2] + f[..., 1::2]) ** 2 + (d[..., 1::2] - f[..., 0::2]) ** 2
        mel = mel + p1 @ melw[1]
    if nyquist:
        x2 = (e - o)[..., :2]                                                      # column 0
        mel = mel + (x2[..., :1] ** 2 + x2[..., 1:] ** 2) * w256
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10)).float()


def _windows(rng, n_streams, silent):
    w = (rng.uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    w[silent] = 0.0
    return w


def _cases(rng, n_streams):
    """The windows with one silent stream: stream S // 2, and at S = 1 both a
    sounding and a silent window."""
    if n_streams == 1:
        return [(_windows(rng, 1, []), None), (_windows(rng, 1, [0]), 0)]
    return [(_windows(rng, n_streams, [n_streams // 2]), n_streams // 2)]


@pytest.mark.parametrize("n_streams", [1, 5, 17, 33])
def test_factored_layout_computes_the_plain_function(rng, n_streams):
    """The constants, multiplied out as the kernel pairs them, give the plain
    version's dB within 2e-3 dB (the limit the card holds the kernel to),
    and -100 dB on a silent stream."""
    for w, silent in _cases(rng, n_streams):
        x = torch.from_numpy(w)
        got = _layout_mel(x)
        want = melspec_cuda.melspectrogram_frames_plain(x, "factored")
        assert got.shape == want.shape == (n_streams, 8, 32)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=MEL_TOL_DB)
        if silent is not None:
            np.testing.assert_allclose(got[silent].numpy(), -100.0, atol=1e-4)


@pytest.mark.parametrize("n_streams", [1, 5, 17, 33])
def test_factored_layout_matches_jax(rng, n_streams):
    """The same function against JAX's ``melspectrogram_pallas(dft=
    "factored", precision=HIGHEST)`` in interpret mode, within 2e-3 dB."""
    for w, silent in _cases(rng, n_streams):
        got = _layout_mel(torch.from_numpy(w)).numpy()
        want = np.asarray(jax_mel.melspectrogram_pallas(jnp.asarray(w), tile_s=8, interpret=True, dft="factored",
                                                        precision=jax.lax.Precision.HIGHEST))
        assert got.shape == want.shape == (n_streams, 8, 32)
        np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL_DB)
        if silent is not None:
            np.testing.assert_allclose(got[silent], -100.0, atol=1e-4)


def _plain_over(x):
    """The plain factored function in float32 over the filterbank as
    ``config`` now sets it, written out in the kernel's order (the plain
    version follows ``config`` too)."""
    z = torch.einsum("...ba,bad->...bd", melspec.deinterleave_branches(melspec.frame_signal(x)),
                     melspec.f32_const(melspec.factored_dft_bases(), "cpu"))
    p0, p1, p2 = melspec._factored_power_parts(z)
    fb = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    return melspec.power_to_db(p0 @ fb[:SUB] + p1 @ fb[SUB:2 * SUB] + p2 * fb[2 * SUB:], top_db=None)


@pytest.fixture()
def fresh_consts():
    """The device constants are cached per device: drop them before and
    after a test that changes the live range."""
    melspec_cuda._device_consts.cache_clear()
    yield
    melspec_cuda._device_consts.cache_clear()


@pytest.mark.parametrize("fmax, columns", [(7000.0, (0, 128, 128, True, False)), (9000.0, (0, 128, 128, True, True))])
def test_factored_layout_other_live_range(rng, monkeypatch, fresh_consts, fmax, columns):
    """At FMAX = 7000 (bins 2..223) every stage-1 column is computed and the
    c = 1 half is live: a second half of mel rows, non-zero; above half the
    sample rate (9000) bin 256 is live too, its row non-zero. The layout
    keeps its form and, multiplied out as the kernel pairs it, computes the
    plain function over that range's filterbank."""
    monkeypatch.setattr(config, "FMAX", fmax)
    assert melspec_cuda.factored_columns() == columns and melspec_cuda.factored_padded() == 128
    basis, melw, w256 = _consts()
    fb32 = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    assert torch.equal(basis, melspec.f32_const(melspec.factored_dft_bases(), "cpu"))
    assert melw.shape == (2, 128, 32) and melw[1].any()
    assert torch.equal(melw[0], fb32[:SUB]) and torch.equal(melw[1], fb32[SUB:2 * SUB])
    assert bool(w256.any()) == columns[4] and torch.equal(w256, fb32[2 * SUB])
    w = _windows(rng, 9, [4])
    x = torch.from_numpy(w)
    got = _layout_mel(x)
    np.testing.assert_allclose(got.numpy(), _plain_over(x).numpy(), rtol=0, atol=MEL_TOL_DB)
    np.testing.assert_allclose(got[4].numpy(), -100.0, atol=1e-4)
