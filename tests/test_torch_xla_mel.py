"""The port's plain mel at the bf16 modes against JAX's XLA mel arithmetic
(``openwakeword_tpu.ops.melspec.melspectrogram(compute_dtype, precision)``,
the JAX engine's ``use_pallas_melspec=False`` path).

JAX on the CPU runs no bf16 dot the way the TPU does (``Precision.DEFAULT``
is exact float32 here), so the reference is built from JAX's own functions
(``frame_signal``, ``stft_power_basis`` / ``factored_dft_bases`` with
``deinterleave_branches``, ``_factored_power``, ``mel_filterbank``,
``power_to_db``) in numpy float64, with the DFT's operands rounded to bf16
as the TPU rounds them at ``DEFAULT`` and for bf16 operands (1-pass: 'fast',
'bf16') or split into bf16 hi and lo (``melspec_pallas._bf16_split``) with
lo * lo dropped (3-pass, ``HIGH``: 'high'), and the mel product in float32
(``HIGHEST``), as JAX takes it at every tier. The port's engine with
``use_pallas_melspec=False`` and ``ops.melspec.melspectrogram(arith=...)``
are held to it within 2e-3 dB (``tests/test_pallas.py``'s mel tolerance).
The bf16 kernels' arithmetic, which also rounds or splits the mel product,
sits up to ~0.02 dB away at 1-pass.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.ops import melspec as jax_melspec
from openwakeword_tpu.ops.melspec_pallas import _bf16_split
from openwakeword_tpu_torch import config
from openwakeword_tpu_torch.ops import bf16, melspec
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

MEL_TOL_DB = 2e-3
TIERS = [("fast", "1pass"), ("bf16", "1pass"), ("high", "3pass")]
S = 3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _f64(x) -> np.ndarray:
    return np.asarray(jnp.asarray(x).astype(jnp.float32), np.float64)


def _product(a: np.ndarray, b: np.ndarray, arith: str, op) -> np.ndarray:
    """``op(a, b)`` in float64 on float32 operands rounded to bf16 (1-pass)
    or split into bf16 hi + lo, lo * lo dropped (3-pass)."""
    if arith == "1pass":
        return op(_f64(jnp.asarray(a, jnp.float32).astype(jnp.bfloat16)),
                  _f64(jnp.asarray(b, jnp.float32).astype(jnp.bfloat16)))
    a_hi, a_lo = map(_f64, _bf16_split(jnp.asarray(a, jnp.float32)))
    b_hi, b_lo = map(_f64, _bf16_split(jnp.asarray(b, jnp.float32)))
    return op(a_hi, b_hi) + op(a_hi, b_lo) + op(a_lo, b_hi)


def xla_mel(x: np.ndarray, dft: str, arith: str) -> np.ndarray:
    """(..., N) raw PCM -> (..., T, 32) raw dB (no top_db, no affine) in
    JAX's XLA mel arithmetic at ``arith``, on the TPU's rounding points."""
    frames = np.asarray(jax_melspec.frame_signal(jnp.asarray(x, jnp.float32)))        # float32
    if dft == "factored":
        branches = np.asarray(jax_melspec.deinterleave_branches(jnp.asarray(frames)))
        bases = jax_melspec.factored_dft_bases().astype(np.float32)
        z = _product(branches, bases, arith, lambda a, b: np.einsum("...ba,bad->...bd", a, b))
        power = _f64(jax_melspec._factored_power(jnp.asarray(z, jnp.float32)))
    else:
        spec = _product(frames, jax_melspec.stft_power_basis().astype(np.float32), arith, np.matmul)
        power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    mel = power @ jax_melspec.mel_filterbank().astype(np.float32).astype(np.float64)
    return np.asarray(jax_melspec.power_to_db(jnp.asarray(mel, jnp.float32), top_db=None))


def _windows(seed: int, n: int) -> np.ndarray:
    """Seeded noise at three loudnesses, with quiet windows (a few LSBs)."""
    rng = np.random.default_rng(seed)
    amp = np.array([3.0, 400.0, 20000.0])[np.arange(n) % 3, None]
    return np.round((rng.random((n, config.CHUNK_SAMPLES + config.MEL_LOOKBACK_SAMPLES)) * 2 - 1) * amp
                    ).astype(np.float32)


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("tier, arith", TIERS)
def test_melspectrogram_computes_jax_xla_mel(dft, tier, arith):
    """``ops.melspec.melspectrogram(arith=...)``: the DFT product in the
    tier's arithmetic, the mel product in float32."""
    x = _windows(11, 6)
    got = melspec.melspectrogram(torch.from_numpy(x), apply_transform=False, top_db=None, dft=dft,
                                 arith=arith).numpy()
    want = xla_mel(x, dft, arith)
    assert got.shape == want.shape == (6, 8, 32)
    np.testing.assert_allclose(got, want, rtol=0, atol=MEL_TOL_DB)


@pytest.mark.parametrize("dft", ["direct", "factored"])
@pytest.mark.parametrize("tier, arith", TIERS)
def test_engine_plain_mel_path_computes_jax_xla_mel(dft, tier, arith):
    """The engine with ``use_pallas_melspec=False`` at 'fast', 'bf16' and
    'high': every mel window it computes in a run of predict calls (the
    first primes) is JAX's XLA mel of that window in the tier's
    arithmetic."""
    engine = MultiStreamEngine(n_streams=S, precision=tier, mel_dft=dft, use_pallas_melspec=False, device="cpu")
    seen = []
    mel_frames = engine._mel_frames

    def recorder(windows, dft_, arith_):
        out = mel_frames(windows, dft_, arith_)
        seen.append((windows.float().numpy().copy(), out.numpy().copy(), dft_, arith_))
        return out
    engine._mel_frames = recorder
    pcm = _windows(12, 3 * S)[:, :config.CHUNK_SAMPLES].reshape(3, S, -1).astype(np.int16)
    for frame in pcm:
        engine.predict(frame)
    assert len(seen) == 3 and {(d, a) for _, _, d, a in seen} == {(dft, arith)}
    for windows, out, _, _ in seen:
        np.testing.assert_allclose(out, xla_mel(windows, dft, arith), rtol=0, atol=MEL_TOL_DB)


@pytest.mark.parametrize("dft", ["direct", "factored"])
def test_bf16_frames_round_as_one_pass(dft):
    """At 'bf16' JAX's XLA path casts the frames to bf16 before the DFT
    (``mel_dtype``) and takes the product on bf16 operands. The port's
    1-pass product rounds the frames the same way (bit for bit as JAX's
    cast), so audio rounded to bf16 beforehand gives the same dB bit for
    bit."""
    x = _windows(13, 3)
    frames = jax_melspec.frame_signal(jnp.asarray(x))
    np.testing.assert_array_equal(np.asarray(frames.astype(jnp.bfloat16).astype(jnp.float32)),
                                  bf16.round_bf16(melspec.frame_signal(torch.from_numpy(x))).numpy())
    got = melspec.melspectrogram(torch.from_numpy(x), apply_transform=False, top_db=None, dft=dft, arith="1pass")
    rounded = melspec.melspectrogram(bf16.round_bf16(torch.from_numpy(x)), apply_transform=False, top_db=None,
                                     dft=dft, arith="1pass")
    assert torch.equal(got, rounded)
