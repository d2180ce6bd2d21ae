"""Mel frontend of the PyTorch port against the JAX package: the constant
factories, the plain ``melspectrogram`` (direct and factored DFT) and the
plain versions of kernels 1 and 2 (``ops.melspec_cuda``) against
``melspectrogram_pallas`` in interpret mode, and kernel 1's live-bin
constants and generated header."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.ops import melspec as jax_melspec
from openwakeword_tpu.ops.melspec_pallas import melspectrogram_pallas
from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import melspec, melspec_cuda
from openwakeword_tpu_torch.utils import cuda_build

MEL_ATOL_DB = 2e-3    # the JAX package's own kernel tolerance (tests/test_pallas.py)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _windows(rng, n, n_samples=1760):
    return (rng.uniform(-1, 1, (n, n_samples)) * 25000).astype(np.float32)


@pytest.mark.parametrize("name", ["hann_window", "mel_filterbank", "stft_power_basis", "factored_dft_bases"])
def test_constant_factories_bit_equal(name):
    want, got = getattr(jax_melspec, name)(), getattr(melspec, name)()
    assert got.dtype == want.dtype == np.float64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(melspec.f32_const(got, "cpu").numpy(), np.asarray(jax_melspec._f32(want)))


@pytest.mark.parametrize("n_samples", [512, 1760, 16000])
def test_frame_signal_matches_jax(rng, n_samples):
    x = _windows(rng, 2, n_samples)
    got = melspec.frame_signal(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_melspec.frame_signal(jnp.asarray(x))))
    assert melspec.num_frames(n_samples) == jax_melspec.num_frames(n_samples) == got.shape[1]


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("apply_transform", [True, False])
def test_melspectrogram_matches_jax(rng, apply_transform, dft):
    x = _windows(rng, 3, 16000)
    x[1, :4000] = 0.0                       # quiet stretch: the top_db clamp engages
    want = np.asarray(jax_melspec.melspectrogram(jnp.asarray(x), apply_transform=apply_transform, dft=dft))
    got = melspec.melspectrogram(torch.from_numpy(x), apply_transform=apply_transform, dft=dft).numpy()
    assert got.shape == want.shape == (3, 97, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_ATOL_DB)


@pytest.mark.parametrize("dft", ["direct", "factored"])
def test_frames_plain_matches_pallas_and_reference_op(rng, dft):
    windows = _windows(rng, 5)
    got = melspec_cuda.melspectrogram_frames_plain(torch.from_numpy(windows), dft).numpy()
    pallas = np.asarray(melspectrogram_pallas(jnp.asarray(windows), tile_s=4, interpret=True,
                                              precision=jax.lax.Precision.HIGHEST, dft=dft))
    reference = np.asarray(jax_melspec.melspectrogram(jnp.asarray(windows), apply_transform=False,
                                                      top_db=None, dft=dft))
    assert got.shape == pallas.shape == (5, 8, 32)
    np.testing.assert_allclose(got, pallas, rtol=0, atol=MEL_ATOL_DB)
    np.testing.assert_allclose(got, reference, rtol=0, atol=MEL_ATOL_DB)


def test_factored_stages_match_jax(rng):
    frames = _windows(rng, 6, 512).reshape(2, 3, 512)
    got = melspec.deinterleave_branches(torch.from_numpy(frames))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jax_melspec.deinterleave_branches(jnp.asarray(frames))))
    z = rng.standard_normal((2, 3, 4, 256)).astype(np.float32) * 1e3
    np.testing.assert_allclose(melspec._factored_power(torch.from_numpy(z)).numpy(),
                               np.asarray(jax_melspec._factored_power(jnp.asarray(z))), rtol=1e-6, atol=0)


@pytest.mark.parametrize("dft", ["direct", "factored"])
def test_silence_gives_amin_floor(dft):
    got = melspec_cuda.melspectrogram_frames_plain(torch.zeros((3, 1760)), dft).numpy()
    np.testing.assert_allclose(got, -100.0, atol=1e-4)


def test_unknown_dft_raises(rng):
    x = torch.from_numpy(_windows(rng, 2))
    with pytest.raises(ValueError, match="dft"):
        melspec.melspectrogram(x, dft="fft")
    with pytest.raises(ValueError, match="dft"):
        melspec_cuda.melspectrogram_frames(x, dft="fft")


@pytest.mark.parametrize("dft", ["direct", "factored"])
def test_wrapper_takes_plain_path_for_cpu_tensors(rng, dft):
    x = torch.from_numpy(_windows(rng, 4))
    got = melspec_cuda.melspectrogram_frames(x, dft)
    torch.testing.assert_close(got, melspec_cuda.melspectrogram_frames_plain(x, dft), rtol=0, atol=0)
    assert not any(melspec_cuda.melspectrogram_frames.launches.values())


def test_wrapper_rejects_other_devices():
    with pytest.raises(ValueError, match="CPU or CUDA"):
        melspec_cuda.melspectrogram_frames(torch.empty((2, 1760), device="meta"))


# ---------------------------------------------------------------------------
# Kernel 1 computes only the live DFT bins (no kernel runs here: these test
# the constants the kernel is built and fed with)


def test_live_bins_come_from_the_filterbank():
    first, count, padded = melspec_cuda.live_bins()
    assert (first, count, padded) == (2, 120, 128)
    fb = melspec.mel_filterbank().astype(np.float32)
    live = (fb != 0).any(axis=1)
    assert live[first] and live[first + count - 1]
    assert not fb[:first].any() and not fb[first + count:].any()
    assert padded % melspec_cuda.BIN_TILE == 0 and padded - count < melspec_cuda.BIN_TILE


@pytest.mark.parametrize("n_streams", [1, 5, 17])
def test_pruned_constants_reproduce_the_unpruned_plain_version(rng, n_streams):
    """Kernel 1's basis and mel weights, multiplied out in plain torch (the
    kernel's arithmetic in another order), equal the 257-bin plain version."""
    first, count, padded = melspec_cuda.live_bins()
    basis = melspec_cuda._kernel_basis("direct")
    melw = melspec_cuda._kernel_melw("direct")
    assert basis.shape == (512, 2 * padded) and melw.shape == (padded, 32)
    assert not basis[:, 2 * count:].any() and not melw[count:].any()
    np.testing.assert_array_equal(basis[:, :2 * count], melspec.stft_power_basis()[:, 2 * first:2 * (first + count)])
    x = _windows(rng, n_streams)
    x[n_streams // 2] = 0.0
    windows = torch.from_numpy(x)
    spec = melspec.frame_signal(windows) @ melspec.f32_const(basis, "cpu")      # (S, 8, 2 * padded)
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    db = 10.0 * torch.log10(torch.clamp_min(power @ melspec.f32_const(melw, "cpu"), 1e-10))
    want = melspec_cuda.melspectrogram_frames_plain(windows, "direct")
    assert db.shape == want.shape == (n_streams, 8, 32)
    np.testing.assert_allclose(db.numpy(), want.numpy(), rtol=0, atol=1e-4)


def test_generated_mel_header_carries_the_live_range(monkeypatch):
    """The live range reaches csrc/melspec.cu only through mel_program.h,
    which is part of the build key: a new FMAX changes both."""
    text = cuda_build.generated_headers()["mel_program.h"]
    for name, value in [("kLiveBin0", 2), ("kLiveBins", 120), ("kLiveBinsPad", 128), ("kNfft", 512),
                        ("kHop", 160), ("kMels", 32), ("kFrames", 8), ("kWindow", 1760),
                        ("kBinTile", melspec_cuda.BIN_TILE)]:
        assert f"constexpr int {name} = {value};" in text
    source = (cuda_build.CSRC / "melspec.cu").read_text()
    assert '#include "mel_program.h"' in source and "constexpr int kLiveBin" not in source
    digest = cuda_build._digest(cuda_build.generated_headers())
    monkeypatch.setattr(config, "FMAX", 7000.0)
    first, count, padded = melspec_cuda.live_bins()
    assert first == 2 and count > 120
    text = cuda_build.generated_headers()["mel_program.h"]
    assert f"constexpr int kLiveBins = {count};" in text and f"constexpr int kLiveBinsPad = {padded};" in text
    assert cuda_build._digest(cuda_build.generated_headers()) != digest


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("fmax", [8000.0, 9000.0])
def test_filterbank_follows_config(rng, monkeypatch, fmax, dft):
    """``mel_filterbank()`` resolves ``config.FMIN`` / ``FMAX`` at the call,
    as the kernels do when they are built: at FMAX 8000 and 9000 it is JAX's
    ``mel_filterbank(fmax=...)`` (the same float64 code, so equal after
    rounding to float32), and the plain versions compute the 257-bin DFT
    projected onto it. At the defaults it is the default filterbank."""
    default = melspec.mel_filterbank()
    np.testing.assert_array_equal(default, jax_melspec.mel_filterbank())
    monkeypatch.setattr(config, "FMAX", fmax)
    fb = melspec.mel_filterbank()
    np.testing.assert_array_equal(fb.astype(np.float32), jax_melspec.mel_filterbank(fmax=fmax).astype(np.float32))
    assert fb.shape == default.shape and not np.array_equal(fb, default)
    windows = torch.from_numpy(_windows(rng, 5))
    spec = melspec.frame_signal(windows.double()) @ torch.from_numpy(jax_melspec.stft_power_basis())
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    want = 10.0 * torch.log10(torch.clamp_min(power @ torch.from_numpy(jax_melspec.mel_filterbank(fmax=fmax)),
                                              1e-10))
    for arith in ("fp32", "3pass"):
        got = melspec_cuda.melspectrogram_frames_plain(windows, dft, arith)
        np.testing.assert_allclose(got.double().numpy(), want.numpy(), rtol=0, atol=2e-3, err_msg=arith)
    monkeypatch.setattr(config, "FMIN", 100.0)
    np.testing.assert_array_equal(melspec.mel_filterbank(), jax_melspec.mel_filterbank(fmin=100.0, fmax=fmax))
