"""The port's augmentation ops (``openwakeword_tpu_torch.ops.filters``,
``ops.augment``) against the JAX package on the CPU, on the same audio and
the same parameters.

Each random op of the port splits into a draw from a ``torch.Generator`` and
a deterministic function of the audio and the drawn parameters; the tests
feed that function the parameters the JAX op draws from its key, and hold
the outputs to max |diff| <= 1e-5 of the output's peak. The data pipeline
that drives these ops is tested in ``test_torch_data.py``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.ops import augment as JA
from openwakeword_tpu.ops import filters as JF
from openwakeword_tpu_torch import testing
from openwakeword_tpu_torch.ops import augment as TA
from openwakeword_tpu_torch.ops import filters as TF

PEAK_TOL = 1e-5            # max |diff| over the output's peak
VOCODER_TOL = 1e-4         # relative RMS of the vocoder given JAX's analysis
PITCH_SHARE = 0.25         # port-vs-JAX over JAX-vs-exact, end to end
PITCH_MAX = 1e-3           # relative RMS, end to end
B, N = 4, 32000
SEMITONES = (-3.0, 0.7, 3.0)
PITCH_N = 16000


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def audio():
    """Four 2 s speech-like clips (synthetic vowels) with a little noise."""
    rng = np.random.default_rng(31)
    x = np.stack([testing.vowel(N, rng) for _ in range(B)]) * 0.5
    return (x + rng.normal(0, 0.01, x.shape)).astype(np.float32)


def _close(got, want, tol=PEAK_TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    err = float(np.abs(got - want).max())
    assert err <= tol * float(np.abs(want).max()), err


def _rel_rms(got, want) -> float:
    return float(np.sqrt(np.mean((np.asarray(got, np.float64) - want) ** 2)) / np.sqrt(np.mean(np.square(want))))


def test_filters_match_jax(audio):
    rng = np.random.default_rng(1)
    gains = rng.uniform(-6, 6, (B, 7)).astype(np.float32)
    centers = np.asarray(TA.EQ_CENTERS_HZ, np.float32)
    bt, at = TF.peaking_coeffs(centers[None, :], 1.0, gains)
    bj, aj = JF.peaking_coeffs(jnp.asarray(centers)[None, :], 1.0, jnp.asarray(gains))
    _close(bt, bj)
    _close(at, aj)
    f0 = rng.uniform(200, 4000, B).astype(np.float32)
    q = rng.uniform(0.5, 2.0, B).astype(np.float32)
    for t, j in zip(TF.notch_coeffs(f0, q), JF.notch_coeffs(jnp.asarray(f0), jnp.asarray(q))):
        _close(t, j)
    h_t = TF.cascade_response(bt, at, 4096).numpy()
    h_j = np.asarray(JF.cascade_response(bj, aj, 4096))
    assert h_t.dtype == np.complex64
    _close(h_t, h_j)
    _close(TF.apply_cascade(torch.from_numpy(audio), bt, at), JF.apply_cascade(jnp.asarray(audio), bj, aj))


def _jax_params(op, key, x):
    """The parameters the JAX op draws from ``key``, drawn the same way."""
    batch, n = x.shape
    if op == "gain":
        return jax.random.uniform(key, (batch, 1), minval=-18.0, maxval=0.0)
    if op == "tanh_distortion":
        return jax.random.uniform(key, (batch, 1), minval=0.0001, maxval=0.10)
    if op == "seven_band_eq":
        return jax.random.uniform(key, (batch, 7), minval=-6.0, maxval=6.0)
    if op == "band_stop":
        k1, k2 = jax.random.split(key)
        return (jnp.exp(jax.random.uniform(k1, (batch,), minval=jnp.log(200.0), maxval=jnp.log(4000.0))),
                jax.random.uniform(k2, (batch,), minval=0.5, maxval=1.99))
    if op == "colored_noise":
        return jax.random.normal(jax.random.split(key)[0], (batch, n // 2 + 1), dtype=jnp.complex64)
    return jax.random.uniform(key, (batch, 1), minval=10.0, maxval=30.0)          # add_noise_at_snr


@pytest.mark.parametrize("op", ["gain", "tanh_distortion", "seven_band_eq", "band_stop", "colored_noise",
                                "colored_noise_scalar_decay", "add_noise_at_snr"])
def test_deterministic_halves_match_jax(audio, op):
    key = jax.random.PRNGKey(7)
    x, xj = torch.from_numpy(audio), jnp.asarray(audio)
    p = _jax_params(op.replace("_scalar_decay", ""), key, audio)
    if op == "gain":
        got, want = TA.apply_gain(x, np.asarray(p)), JA.gain(key, xj)
    elif op == "tanh_distortion":
        got, want = TA.apply_tanh_distortion(x, np.asarray(p)), JA.tanh_distortion(key, xj)
    elif op == "seven_band_eq":
        got, want = TA.apply_seven_band_eq(x, np.asarray(p)), JA.seven_band_eq(key, xj, -6, 6)
    elif op == "band_stop":
        got, want = TA.apply_band_stop(x, np.asarray(p[0]), np.asarray(p[1])), JA.band_stop(key, xj)
    elif op.startswith("colored_noise"):
        decay = 1.0 if op.endswith("scalar_decay") else np.array([-1.0, 0.0, 1.0, 2.0], np.float32)
        got = TA.apply_colored_noise(torch.from_numpy(np.asarray(p)), N, decay)
        want = JA.colored_noise(key, (B, N), decay if np.isscalar(decay) else jnp.asarray(decay))
    else:
        noise = np.random.default_rng(2).normal(0, 1, audio.shape).astype(np.float32)
        got = TA.apply_noise_at_snr(x, torch.from_numpy(noise), np.asarray(p))
        want = JA.add_noise_at_snr(key, xj, jnp.asarray(noise), 10, 30)
    _close(got, want)


def test_mix_and_reverberate_match_jax(audio):
    rng = np.random.default_rng(3)
    bg = rng.normal(0, 0.1, audio.shape).astype(np.float32)
    snr = rng.uniform(-5, 15, B)
    _close(TA.mix_at_snr(torch.from_numpy(bg), torch.from_numpy(audio), snr), JA.mix_at_snr(bg, audio, snr))
    decay = np.exp(-np.arange(4000) / 600.0)
    for rir in ((rng.normal(0, 1, 4000) * decay).astype(np.float32),
                (rng.normal(0, 1, (B, 4000)) * decay).astype(np.float32)):
        _close(TA.reverberate(torch.from_numpy(audio), rir), JA.reverberate(jnp.asarray(audio), jnp.asarray(rir)))
    # the direct path is the FIRST absolute maximum: two equal peaks
    tied = np.zeros(300, np.float32)
    tied[[40, 90]] = 1.0
    _close(TA.reverberate(torch.from_numpy(audio), tied), JA.reverberate(jnp.asarray(audio), jnp.asarray(tied)))


@pytest.mark.parametrize("n", [1, 5, 16, 17, 137, 300])
def test_cumsum_order_is_jax_cpu_order(n):
    """``cumsum_f32`` adds in the order of ``jnp.cumsum`` on the CPU (blocks
    of 16): bit-equal."""
    v = np.random.default_rng(n).uniform(-800, 800, (3, n, 5)).astype(np.float32)
    got = TA.cumsum_f32(torch.from_numpy(v), dim=-2).numpy()
    np.testing.assert_array_equal(got, np.asarray(jnp.cumsum(jnp.asarray(v), axis=-2)))


def _jax_analysis(x, n_fft=1024, hop=256):
    window = jnp.asarray(np.hanning(n_fft).astype(np.float32))
    t_in = (x.shape[-1] - n_fft) // hop + 1
    idx = np.arange(t_in)[:, None] * hop + np.arange(n_fft)[None, :]
    spec = jnp.fft.rfft(jnp.asarray(x)[..., idx] * window, axis=-1)
    return torch.from_numpy(np.asarray(jnp.abs(spec))), torch.from_numpy(np.asarray(jnp.angle(spec)))


@pytest.mark.parametrize("semis", SEMITONES)
def test_pitch_shift_vocoder_matches_jax(audio, semis):
    """Given JAX's analysis (the frames' magnitudes and phases), the port's
    vocoder and resampler agree with JAX's ``pitch_shift`` at fixed
    semitones within relative RMS 1e-4."""
    x = audio[:2, :PITCH_N]
    want = np.asarray(JA.pitch_shift(jax.random.PRNGKey(0), jnp.asarray(x), semis, semis))
    mag, phase = _jax_analysis(x)
    got = TA.vocode(mag, phase, PITCH_N, semis, semis, semis).numpy()
    assert _rel_rms(got, want) <= VOCODER_TOL


@pytest.mark.parametrize("semis", SEMITONES)
def test_pitch_shift_matches_jax_within_its_float32_error(audio, semis):
    """End to end the port and JAX differ in the last bits of their FFTs and
    of atan2, and the vocoder accumulates phase to ~1e5 rad, where a float32
    step is ~0.008 rad: a flipped rounding shows. JAX's own float32 result is
    ~1e-3 (relative RMS) from the same computation in float64; the port
    must sit at most a quarter of that from JAX, and within 1e-3."""
    x = audio[:2, :PITCH_N]
    want = np.asarray(JA.pitch_shift(jax.random.PRNGKey(0), jnp.asarray(x), semis, semis))
    got = TA.apply_pitch_shift(torch.from_numpy(x), semis, semis, semis).numpy()
    exact = TA.apply_pitch_shift(torch.from_numpy(x).double(), semis, semis, semis).numpy()
    err, jax_err = _rel_rms(got, want), _rel_rms(want, exact)
    assert err <= PITCH_SHARE * jax_err and err <= PITCH_MAX, (err, jax_err)


def test_draws_shapes_ranges_and_seeds():
    gen = torch.Generator().manual_seed(5)
    g = TA.draw_gain(gen, 64, -18, 0)
    assert g.shape == (64, 1) and g.min() >= -18 and g.max() < 0 and g.std() > 1
    d = TA.draw_tanh_distortion(gen, 64)
    assert d.shape == (64, 1) and d.min() >= 1e-4 and d.max() < 0.1
    eq = TA.draw_seven_band_eq(gen, 64)
    assert eq.shape == (64, 7) and eq.abs().max() <= 6
    center, frac = TA.draw_band_stop(gen, 64)
    assert center.shape == frac.shape == (64,)
    assert center.min() >= 200 * (1 - 1e-6) and center.max() <= 4000 * (1 + 1e-6)
    assert frac.min() >= 0.5 and frac.max() < 1.99
    s = TA.draw_pitch_shift(gen, -3, 3)
    assert s.shape == () and -3 <= float(s) < 3               # one shift per batch
    spec = TA.draw_colored_noise(gen, (64, 2000))
    assert spec.shape == (64, 1001) and spec.dtype == torch.complex64
    assert abs(float(spec.real.var()) - 0.5) < 0.02 and abs(float(spec.imag.var()) - 0.5) < 0.02
    snr = TA.draw_snr(gen, 64, 10, 30)
    assert snr.shape == (64, 1) and snr.min() >= 10 and snr.max() < 30
    one, two, other = (TA.draw_gain(torch.Generator().manual_seed(k), 8) for k in (9, 9, 10))
    assert torch.equal(one, two) and not torch.equal(one, other)
