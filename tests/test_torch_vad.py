"""The port's VAD on the CPU against the JAX package: ``models.vad_net.apply``
on the bundled weights and on seeded ones, the single-stream ``VAD`` class
and ``gating.vad_gate``. Both run float32 products (HIGHEST in JAX), so
scores and state agree within 1e-5."""

import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu import gating as jax_gating
from openwakeword_tpu.models import vad_net as jax_vad_net
from openwakeword_tpu.vad import VAD as JaxVAD
from openwakeword_tpu_torch import VAD, convert, gating, registry, testing
from openwakeword_tpu_torch.io import loaders
from openwakeword_tpu_torch.models import vad_net
from openwakeword_tpu_torch.vad import load_vad_apply

ATOL = 1e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)
    logging.disable(logging.WARNING)
    yield
    logging.disable(logging.NOTSET)
    # the JAX VAD's jax.jit(vad_net.apply) shares one compilation cache with
    # every other wrapper of that function in the process: leave it empty
    # for later test files on this worker (tests/test_input_robustness.py
    # counts its entries)
    jax.clear_caches()


@pytest.fixture(scope="module")
def bundled():
    params, meta = loaders.load_vad(registry.VAD_MODELS["silero_vad"]["model_path"])
    assert meta["kind"] == "vad"
    return params


def _apply_both(params, x, h, c):
    want = jax_vad_net.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), jnp.asarray(h), jnp.asarray(c))
    got = vad_net.apply(vad_net.product_params(convert.vad_from_jax(params)), torch.from_numpy(x),
                        torch.from_numpy(h), torch.from_numpy(c))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def test_frontend_constants_match_jax():
    jb, jm = jax_vad_net._frontend_consts()
    tb, tm = vad_net._frontend_consts_np()
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tm, jm)


@pytest.mark.parametrize("n", [256, 480, 640, 1000, 1279])
@pytest.mark.parametrize("weights", ["bundled", "seeded"])
def test_apply_matches_jax(rng, bundled, n, weights):
    params = bundled if weights == "bundled" else vad_net.init_params(np.random.default_rng(3))
    voice = testing.vowel(3 * n, np.random.default_rng(n)).reshape(3, n)
    x = np.concatenate([0.4 * voice, (rng.random((2, n)) * 2 - 1) * 0.2]).astype(np.float32)
    h = (0.3 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    c = (0.6 * rng.standard_normal((2, 5, 64))).astype(np.float32)
    want, got = _apply_both(params, x, h, c)
    assert got[0].shape == (5,) and got[1].shape == got[2].shape == (2, 5, 64)
    for w, g in zip(want, got):
        np.testing.assert_allclose(g, w, rtol=0, atol=ATOL)
    if weights == "bundled":
        assert got[0][:3].min() > 0.5 and got[0][3:].max() < 0.5          # the vowels, and noise


def test_sub_hop_tail_is_unseen(bundled):
    """A 640-sample chunk takes 4 STFT steps: samples 592.. change nothing."""
    p = vad_net.product_params(convert.vad_from_jax(bundled))
    x = (np.random.default_rng(1).random((1, 640)) * 0.4 - 0.2).astype(np.float32)
    h = torch.zeros((2, 1, 64))
    y = x.copy()
    y[:, 592:] = 0.9
    a, b = vad_net.apply(p, torch.from_numpy(x), h, h), vad_net.apply(p, torch.from_numpy(y), h, h)
    for u, v in zip(a, b):
        torch.testing.assert_close(u, v, rtol=0, atol=0)


def test_vad_predict_matches_jax_class():
    """Chunked scoring with state across calls: 480-sample frames (the
    default), 640-sample calls, short and ragged buffers, an empty one."""
    jv, tv = JaxVAD(), VAD(device="cpu")
    packets = testing.gating_packets()[10:40]
    for i, p in enumerate(packets):
        frame_size = 480 if i % 2 else 640
        assert tv.predict(p, frame_size) == pytest.approx(jv.predict(p, frame_size), abs=ATOL)
    for p in packets[:8]:
        jv(p)
        tv(p)
    np.testing.assert_allclose(np.array(tv.prediction_buffer), np.array(jv.prediction_buffer), rtol=0, atol=ATOL)
    assert tv.predict(np.zeros(0, np.int16)) == 0.0 and tv.predict(np.zeros(100, np.int16)) >= 0.0
    tv.reset_states()
    assert float(tv._h.abs().max()) == 0.0
    with pytest.raises(ValueError, match="batch_size must be 1"):
        tv.reset_states(batch_size=2)


def test_load_vad_apply_without_checkpoint_is_seeded(tmp_path):
    apply_fn, params, min_samples = load_vad_apply(str(tmp_path / "missing.npz"))
    again = load_vad_apply(str(tmp_path / "missing.npz"))[1]
    assert apply_fn is vad_net.apply and min_samples == 256
    np.testing.assert_array_equal(params["lstm0"]["w_ih"], again["lstm0"]["w_ih"])
    assert params["proj"]["w"].shape == (32, 64) and params["out"]["w"].shape == (64, 1)


def test_onnx_program_checkpoint_raises(tmp_path):
    """An ``onnx_program`` checkpoint loads as a Silero program since slice
    E1 (tests/test_torch_onnx.py runs real ones); a program with an op the
    executor lacks raises naming the op when it runs."""
    from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
    spec = {"nodes": [{"op_type": "NonMaxSuppression", "name": "nms", "input": ["input", "h", "c"],
                       "output": ["output", "hn", "cn"], "attributes": {}}],
            "input_names": ["input", "h", "c"], "output_names": ["output", "hn", "cn"],
            "param_key": {}, "static_inputs": {}, "inits_static": {}}
    path = str(tmp_path / "silero.npz")
    save_checkpoint(path, "vad", {}, meta={"format": "onnx_program", "spec": spec})
    apply, params, min_samples = load_vad_apply(path)
    assert min_samples == 256
    h = torch.zeros(2, 1, 64)
    with pytest.raises(NotImplementedError, match="NonMaxSuppression"):
        apply(params, torch.zeros(1, 640), h, h)


def test_cuda_device_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        VAD()


@pytest.mark.parametrize("threshold", [0.0, 0.3, 0.5, 0.95])
def test_vad_gate_matches_numpy(rng, threshold):
    scores = rng.random((6, 4)).astype(np.float32)
    gate = rng.random((6, 3)).astype(np.float32)
    gate[0] = -1.0                                      # an unfilled ring reads 0
    gate[1, :2] = -1.0
    want = jax_gating.vad_gate(np, scores, gate, threshold)
    got = gating.vad_gate(torch.from_numpy(scores), torch.from_numpy(gate), threshold).numpy()
    np.testing.assert_array_equal(got, want)
    one = gating.vad_gate(torch.from_numpy(scores[0]), torch.tensor([-1.0]), threshold).numpy()
    np.testing.assert_array_equal(one, jax_gating.vad_gate(np, scores[0], np.array([-1.0], np.float32), threshold))
