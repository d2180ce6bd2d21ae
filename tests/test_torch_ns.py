"""The port's noise suppressors on the CPU against the JAX package:
``ops.ns_torch`` against ``ops.ns_jax`` for both profiles, and the
single-stream ``ns.TorchNoiseSuppression`` / ``ns.NoiseSuppression``
against the JAX package's classes.

Outputs are rounded to the int16 grid after a float32 sum: a sum in another
order can land on the other side of .5, so outputs agree within 1 LSB. The
state takes the input frame, not the rounded output, so its leaves agree to
float32 rounding: rtol 1e-5 plus 1e-5 of the leaf's largest value (the
overlap tail crosses zero).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.ops import ns_jax
from openwakeword_tpu_torch.ops import ns_torch

PROFILES = ("spectral", "mmse")
AMPS = np.array([0.0, 100.0, 1000.0, 5000.0, 20000.0, 32000.0])


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _audio(rng, n_frames):
    return np.round((rng.random((AMPS.size, n_frames * ns_torch.FRAME)) * 2 - 1) * AMPS[:, None]).astype(np.float32)


def _assert_states_close(ts, js):
    assert set(ts) == set(js)
    for k, v in js.items():
        want, got = np.asarray(v), ts[k].numpy()
        assert got.dtype == want.dtype, k
        if want.dtype == np.int32:
            np.testing.assert_array_equal(got, want, err_msg=k)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * float(np.abs(want).max()), err_msg=k)


def test_tables_match_jax():
    np.testing.assert_array_equal(ns_torch._WINDOW, ns_jax._WINDOW)
    np.testing.assert_array_equal(ns_torch._COS_TAB, ns_jax._COS_TAB)
    np.testing.assert_array_equal(ns_torch._SIN_TAB, ns_jax._SIN_TAB)


@pytest.mark.parametrize("profile", PROFILES)
def test_init_state_matches_jax(profile):
    js, ts = ns_jax.init_state(4, profile), ns_torch.init_state(4, profile)
    _assert_states_close(ts, js)


@pytest.mark.parametrize("profile", PROFILES)
def test_step_matches_jax(rng, profile):
    """Frame by frame, 30 frames: the warm-up (20 frames) and after."""
    x = _audio(rng, 30)
    js, ts = ns_jax.init_state(AMPS.size, profile), ns_torch.init_state(AMPS.size, profile)
    for f in range(30):
        frame = x[:, f * 160:(f + 1) * 160]
        js, jo = ns_jax.step(js, jnp.asarray(frame), profile=profile)
        ts, to = ns_torch.step(ts, torch.from_numpy(frame), profile)
        assert np.abs(to.numpy() - np.asarray(jo)).max() <= 1.0, f
        _assert_states_close(ts, js)
    assert int(ts["frames_seen"][0]) == ns_torch.WARMUP_FRAMES + 1


@pytest.mark.parametrize("profile", PROFILES)
def test_process_chunk_long_stream_matches_jax(rng, profile):
    """Eight 1280-sample chunks (64 frames), well past the warm-up."""
    js, ts = ns_jax.init_state(AMPS.size, profile), ns_torch.init_state(AMPS.size, profile)
    x = _audio(rng, 64)
    n_flipped = 0
    for i in range(8):
        chunk = x[:, i * 1280:(i + 1) * 1280]
        js, jo = ns_jax.process_chunk(js, jnp.asarray(chunk), profile=profile)
        ts, to = ns_torch.process_chunk(ts, torch.from_numpy(chunk), profile)
        diff = np.abs(to.numpy() - np.asarray(jo))
        assert diff.max() <= 1.0
        n_flipped += int((diff > 0).sum())
    _assert_states_close(ts, js)
    assert n_flipped <= 1e-3 * x.size
    # silence in, silence out; loud input stays in the int16 range
    out = to.numpy()
    assert (out[0] == 0).all() and out.min() >= -32768 and out.max() <= 32767


@pytest.mark.parametrize("profile", PROFILES)
def test_clamped_frame_counter_matches_jax(rng, profile):
    """A long-lived stream's counter sits at WARMUP_FRAMES + 1 and stays
    there (no wrap, no return to the warm-up)."""
    js, ts = ns_jax.init_state(AMPS.size, profile), ns_torch.init_state(AMPS.size, profile)
    seen = np.full(AMPS.size, ns_torch.WARMUP_FRAMES + 1, np.int32)
    js["frames_seen"], ts["frames_seen"] = jnp.asarray(seen), torch.from_numpy(seen.copy())
    x = _audio(rng, 8)
    js, jo = ns_jax.process_chunk(js, jnp.asarray(x), profile=profile)
    ts, to = ns_torch.process_chunk(ts, torch.from_numpy(x), profile)
    assert np.abs(to.numpy() - np.asarray(jo)).max() <= 1.0
    _assert_states_close(ts, js)
    np.testing.assert_array_equal(ts["frames_seen"].numpy(), seen)


def test_bad_inputs_raise():
    with pytest.raises(ValueError, match="not a multiple"):
        ns_torch.process_chunk(ns_torch.init_state(1), torch.zeros((1, 100)))
    with pytest.raises(ValueError, match="unknown NS profile"):
        ns_torch.init_state(1, "wiener")


@pytest.mark.parametrize("profile", PROFILES)
def test_torch_suppressor_matches_jax_class(rng, profile):
    """TorchNoiseSuppression against JaxNoiseSuppression over odd-sized
    buffers: every whole frame suppressed, the tail passed through."""
    from openwakeword_tpu.ns import JaxNoiseSuppression
    from openwakeword_tpu_torch.ns import TorchNoiseSuppression
    jn, tn = JaxNoiseSuppression(algorithm=profile), TorchNoiseSuppression(algorithm=profile, device="cpu")
    for n in (1280, 500, 2000, 160, 77, 3333):
        x = np.round((rng.random(n) * 2 - 1) * 6000).astype(np.int16)
        want, got = jn.process_frames(x), tn.process_frames(x)
        assert got.dtype == np.int16 and got.shape == x.shape
        assert np.abs(got.astype(np.int32) - want.astype(np.int32)).max() <= 1
        tail = n % 160
        if tail:
            np.testing.assert_array_equal(got[-tail:], x[-tail:])


def test_native_suppressor_builds_and_matches_jax_class(rng):
    """The port's build of native/ns.cpp against the JAX package's: the same
    source, so the same samples; and within 1 LSB of the PyTorch one."""
    from openwakeword_tpu.ns import NoiseSuppression as JaxNative
    from openwakeword_tpu_torch.ns import NoiseSuppression, TorchNoiseSuppression
    ours, theirs, torch_ns = NoiseSuppression(), JaxNative(), TorchNoiseSuppression(device="cpu")
    for n in (1280, 2000, 4000, 90):
        x = np.round((rng.random(n) * 2 - 1) * 8000).astype(np.int16)
        got = ours.process_frames(x)
        np.testing.assert_array_equal(got, theirs.process_frames(x))
        assert np.abs(got.astype(np.int32) - torch_ns.process_frames(x).astype(np.int32)).max() <= 1


def test_model_falls_back_when_native_is_unavailable(monkeypatch):
    """'spectral' without a native library runs TorchNoiseSuppression, with
    the JAX package's warning."""
    from openwakeword_tpu_torch import Model, ns
    from openwakeword_tpu_torch.models import embedding

    def no_library():
        raise ImportError("no g++")
    monkeypatch.setattr(ns, "_load_lib", no_library)
    from openwakeword_tpu_torch import convert
    emb = convert.embedding_from_jax(embedding.init_params(np.random.default_rng(1)))
    m = Model(wakeword_models=["alexa"], device="cpu", embedding_params=emb, enable_speex_noise_suppression=True)
    assert isinstance(m.speex_ns, ns.TorchNoiseSuppression) and m.speex_ns.algorithm == "spectral"
    m2 = Model(wakeword_models=["alexa"], device="cpu", embedding_params=emb, enable_speex_noise_suppression=True,
               noise_suppression_algorithm="mmse")
    assert isinstance(m2.speex_ns, ns.TorchNoiseSuppression) and m2.speex_ns.algorithm == "mmse"
    with pytest.raises(ValueError, match="noise_suppression_algorithm"):
        Model(wakeword_models=["alexa"], device="cpu", embedding_params=emb, noise_suppression_algorithm="x")
