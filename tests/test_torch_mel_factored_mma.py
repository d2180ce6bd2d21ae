"""K2-1pass and K2-3pass on the tensor cores (``csrc/melspec_factored_mma.cu``):
the host layout of their constants and the function that layout computes. No
kernel runs here (``tests/test_torch_cuda.py`` runs them on the card): these
tests hold the bf16 planes ``melspec_cuda._device_consts`` feeds the kernels
to the float32 stage-1 bases and filterbank, and multiply them out in float64
the way the kernel pairs them (branch by branch, each 16-row tile an Re and an
Im half, then the butterfly), against the plain versions and JAX's
``_make_factored_kernel`` arithmetic."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.ops import melspec_pallas as jax_mel
from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import melspec, melspec_cuda
from openwakeword_tpu_torch.ops.bf16 import round_bf16, split_bf16
from test_torch_tiers import jax_mel_1pass

MEL_TOL_DB = 2e-3
# one bf16 rounding of the power flipped by a sum in another order
# (tests/test_torch_cuda.py)
MEL_1PASS_TOL_DB = MEL_TOL_DB + 10 * math.log10(1 + 2 ** -7)
MEL_1PASS_SHARE = 0.01
SUB = config.N_FFT // melspec.RADIX

CPU = torch.device("cpu")


def _consts(arith):
    """(basis (planes, N, 512), mel weights (planes, halves, 32, padded),
    bin 256's row (32,)) as float64, split out of the kernel's two device
    tensors."""
    basis, flat = melspec_cuda._device_consts(CPU, "factored", arith)
    _, _, padded, half1, _ = melspec_cuda.factored_columns()
    planes = basis.shape[0]
    melw = flat[:-64].view(planes, 2 if half1 else 1, config.N_MELS, padded)
    return basis.double(), melw.double(), flat[-64:].view(torch.float32).double()


def _unpermuted(plane):
    """One (N, 512) basis plane back in ``factored_dft_bases``' (4, 128,
    256) layout over the computed columns, and the rows past ``count``."""
    first, count, _, _, _ = melspec_cuda.factored_columns()
    cols = torch.from_numpy(melspec_cuda.factored_mma_columns())
    live = cols >= 0
    got = torch.zeros((melspec.RADIX, SUB, 2 * SUB), dtype=plane.dtype)
    got[:, :, cols[live]] = plane[live].reshape(-1, melspec.RADIX, SUB).permute(1, 2, 0)
    return got[:, :, 2 * first:2 * (first + count)], plane[~live]


@pytest.mark.parametrize("arith", ["1pass", "3pass"])
def test_factored_planes_are_the_bases_live_columns(arith):
    """The basis planes, un-permuted, are ``round_bf16`` (1-pass) or
    ``split_bf16`` (3-pass) of the float32 stage-1 bases' live columns, bit
    for bit, and the padded rows are zero; the mel planes are the rounded or
    split float32 filterbank rows of bins ``first + i``, zero past ``count``;
    bin 256's row follows as float32 (zero at the default range)."""
    first, count, padded, half1, nyquist = melspec_cuda.factored_columns()
    assert (first, count, padded, half1, nyquist) == (2, 120, 128, False, False)
    basis, flat = melspec_cuda._device_consts(CPU, "factored", arith)
    planes = 1 if arith == "1pass" else 2
    assert basis.dtype == flat.dtype == torch.bfloat16 and basis.is_contiguous()
    assert basis.shape == (planes, 2 * padded, config.N_FFT) and flat.shape == (planes * 32 * padded + 64,)
    bases32 = melspec.f32_const(melspec.factored_dft_bases(), "cpu")[:, :, 2 * first:2 * (first + count)]
    want = (round_bf16(bases32),) if arith == "1pass" else split_bf16(bases32)
    _, melw, w256 = _consts(arith)
    fb32 = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    want_melw = (round_bf16(fb32),) if arith == "1pass" else split_bf16(fb32)
    for p in range(planes):
        got, padding = _unpermuted(basis[p].float())
        assert torch.equal(got, want[p]) and not padding.any()
        assert torch.equal(melw[p, 0, :, :count].float().t(), want_melw[p][first:first + count])
        assert not melw[p, 0, :, count:].any()
    assert not w256.any()


def _layout_mel(x: torch.Tensor, arith: str) -> torch.Tensor:
    """What the kernel computes from its constants, in float64 where it sums
    in float32: the branch operands rounded or split, each branch's product
    with its K range of the (N, K) basis, the butterfly E = Z0 + Z2, O = Z1 +
    Z3, D = Z0 - Z2, F = Z1 - Z3, each 16-row tile paired into Re and Im, the
    power of both halves rounded or split against its mel planes, bin 256's
    power in float64 against its float32 row."""
    basis, melw, w256 = _consts(arith)
    branches = melspec.deinterleave_branches(melspec.frame_signal(x))     # (S, 8, 4, 128) float32
    z = []
    for b in range(melspec.RADIX):
        k = slice(SUB * b, SUB * (b + 1))
        if arith == "1pass":
            zb = round_bf16(branches[..., b, :]).double() @ basis[0, :, k].t()
        else:
            hi, lo = split_bf16(branches[..., b, :])
            zb = hi.double() @ (basis[0, :, k] + basis[1, :, k]).t() + lo.double() @ basis[0, :, k].t()
        z.append(zb.reshape(*zb.shape[:-1], -1, 2, 8))                     # (S, 8, group, re/im, 8)
    e, o, d, f = z[0] + z[2], z[1] + z[3], z[0] - z[2], z[1] - z[3]
    p0 = ((e + o)[..., 0, :] ** 2 + (e + o)[..., 1, :] ** 2).flatten(-2).float()
    p1 = ((d[..., 0, :] + f[..., 1, :]) ** 2 + (d[..., 1, :] - f[..., 0, :]) ** 2).flatten(-2).float()
    mel = 0.0
    for half, p in enumerate((p0, p1)[:melw.shape[1]]):
        if arith == "1pass":
            mel = mel + round_bf16(p).double() @ melw[0, half].t()
        else:
            hi, lo = split_bf16(p)
            mel = mel + hi.double() @ (melw[0, half] + melw[1, half]).t() + lo.double() @ melw[0, half].t()
    if melspec_cuda.factored_columns()[4]:
        x0 = (e - o)[..., 0, :, 0]                                          # column 0: (S, 8, re/im)
        mel = mel + (x0[..., :1] ** 2 + x0[..., 1:] ** 2) * w256
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10)).float()


def _check(got, want, arith, silent):
    err = (got - want).abs()
    if arith == "3pass":
        assert float(err.max()) <= MEL_TOL_DB
    else:
        assert float(err.max()) <= MEL_1PASS_TOL_DB
        assert float((err > MEL_TOL_DB).float().mean()) <= MEL_1PASS_SHARE
    if silent is not None:
        np.testing.assert_allclose(got[silent].numpy(), -100.0, atol=1e-4)


def _windows(rng, n_streams):
    w = (rng.uniform(-1, 1, (n_streams, 1760)) * 25000).astype(np.float32)
    silent = n_streams // 2 if n_streams > 1 else None
    if silent is not None:
        w[silent] = 0.0
    return w, silent


@pytest.mark.parametrize("arith", ["1pass", "3pass"])
@pytest.mark.parametrize("n_streams", [1, 5, 17])
def test_factored_layout_computes_the_plain_function(rng, arith, n_streams):
    """The constants, paired as the kernel pairs them, give the plain
    version's dB with a silent stream: within 2e-3 dB at 3-pass; at 1-pass
    within one flipped power rounding, and beyond 2e-3 dB in at most 1% of
    the values (the checks the card holds the kernel to)."""
    w, silent = _windows(rng, n_streams)
    x = torch.from_numpy(w)
    got = _layout_mel(x, arith)
    want = melspec_cuda.melspectrogram_frames_plain(x, "factored", arith)
    assert got.shape == want.shape == (n_streams, 8, 32)
    _check(got, want, arith, silent)


@pytest.mark.parametrize("arith", ["1pass", "3pass"])
@pytest.mark.parametrize("n_streams", [1, 5, 17])
def test_factored_layout_matches_jax(rng, arith, n_streams):
    """The same function against JAX's ``_make_factored_kernel`` arithmetic
    within 2e-3 dB, with a silent stream: at 3-pass its Pallas kernel at
    ``Precision.HIGH`` in interpret mode; at 1-pass its body with the TPU's
    rounding points written out (``test_torch_tiers.jax_mel_1pass``)."""
    w, silent = _windows(rng, n_streams)
    got = _layout_mel(torch.from_numpy(w), arith).numpy()
    if arith == "1pass":
        want = jax_mel_1pass(w, "factored")
    else:
        want = np.asarray(jax_mel.melspectrogram_pallas(jnp.asarray(w), tile_s=8, interpret=True, dft="factored",
                                                        precision=jax.lax.Precision.HIGH))
    assert got.shape == want.shape == (n_streams, 8, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL_DB)
    if silent is not None:
        np.testing.assert_allclose(got[silent], -100.0, atol=1e-4)


def _plain_over(x, arith):
    """The plain factored function in ``arith`` over the filterbank as
    ``config`` now sets it, written out in the kernel's order (the plain
    version follows ``config`` too)."""
    from openwakeword_tpu_torch.ops import bf16
    product = bf16.product_1pass if arith == "1pass" else bf16.product_3pass
    z = product(lambda a, b: torch.einsum("...ba,bad->...bd", a, b),
                melspec.deinterleave_branches(melspec.frame_signal(x)),
                melspec.f32_const(melspec.factored_dft_bases(), "cpu"))
    p0, p1, p2 = melspec._factored_power_parts(z)
    fb = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    mel = product(torch.matmul, p0, fb[:SUB]) + product(torch.matmul, p1, fb[SUB:2 * SUB]) + p2 * fb[2 * SUB:]
    return melspec.power_to_db(mel, top_db=None)


@pytest.fixture()
def fresh_consts():
    """The device constants are cached per device: drop them before and
    after a test that changes the live range."""
    melspec_cuda._device_consts.cache_clear()
    yield
    melspec_cuda._device_consts.cache_clear()


@pytest.mark.parametrize("fmax, columns", [(7000.0, (0, 128, 128, True, False)), (9000.0, (0, 128, 128, True, True))])
@pytest.mark.parametrize("arith", ["1pass", "3pass"])
def test_factored_layout_other_live_range(rng, monkeypatch, fresh_consts, fmax, columns, arith):
    """At FMAX = 7000 (bins 2..223) every stage-1 column is computed and the
    c = 1 half is live: a second mel half, non-zero; above half the sample
    rate (9000) bin 256 is live too, its float32 row non-zero. The planes
    keep the layout, and paired as the kernel pairs them compute the plain
    function over that range's filterbank."""
    monkeypatch.setattr(config, "FMAX", fmax)
    assert melspec_cuda.factored_columns() == columns
    basis, melw, w256 = _consts(arith)
    assert basis.shape[1:] == (256, 512) and melw.shape[1:] == (2, 32, 128)
    first, count, _ = melspec_cuda.live_bins()
    fb32 = melspec.f32_const(melspec.mel_filterbank(), "cpu")
    assert melw[0, 1].any() and torch.equal(melw[0, 1].float().t(), round_bf16(fb32[SUB:2 * SUB])
                                            if arith == "1pass" else split_bf16(fb32[SUB:2 * SUB])[0])
    assert bool(w256.any()) == columns[4] and torch.equal(w256.float(), fb32[2 * SUB])
    got, padding = _unpermuted(basis[0].float())
    bases32 = melspec.f32_const(melspec.factored_dft_bases(), "cpu")
    assert padding.numel() == 0 and torch.equal(got, round_bf16(bases32) if arith == "1pass"
                                                 else split_bf16(bases32)[0])
    w, silent = _windows(rng, 9)
    x = torch.from_numpy(w)
    _check(_layout_mel(x, arith), _plain_over(x, arith), arith, silent)
