"""Embedding CNN of the PyTorch port against the JAX package: BN folding,
the full-window forward, the streaming caches and steps."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.models import embedding as jax_embedding
from openwakeword_tpu.models import embedding_stream as jax_stream
from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch.models import embedding, embedding_stream

ATOL = 1e-4   # the JAX CNN kernel tests' own tolerance (tests/test_cnn_pallas.py)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    """Checkpoint-layout weights with non-trivial BatchNorm statistics,
    scaled so embeddings are O(10) like those of the identity-BN init."""
    rng = np.random.default_rng(11)
    p = embedding.init_params(rng)
    for k in [k for k in p if k.startswith("bn_")]:
        c = p[k]["gamma"].shape[0]
        p[k] = {"gamma": (0.7 + 0.5 * rng.random(c)).astype(np.float32),
                "beta": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "mean": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "var": (0.8 + 0.4 * rng.random(c)).astype(np.float32)}
    return p


@pytest.fixture(scope="module")
def folded(params):
    return (jax_embedding.fold_batchnorm(jax.tree.map(jnp.asarray, params)),
            embedding.fold_batchnorm(convert.embedding_from_jax(params)))


def _mel(rng, *shape):
    return rng.uniform(-2.0, 8.0, shape).astype(np.float32)


def test_fold_batchnorm_matches_jax(folded):
    want, got = folded
    assert sorted(got) == sorted(want)
    for k in want:
        for leaf, v in want[k].items():
            v = np.asarray(v)
            if leaf == "w":
                v = np.transpose(v, (3, 2, 0, 1))
            np.testing.assert_allclose(got[k][leaf].numpy(), v, rtol=1e-6, atol=1e-7)
    assert embedding.is_folded(got) and not embedding.is_folded(convert.embedding_from_jax(
        embedding.init_params(np.random.default_rng(0))))


def test_apply_folded_matches_jax(params, folded, rng):
    x = _mel(rng, 3, 76, 32)
    want = np.asarray(jax_embedding.apply_folded(folded[0], jnp.asarray(x)))
    unfolded = np.asarray(jax_embedding.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x)))
    got = embedding.apply_folded(folded[1], torch.from_numpy(x)).numpy()
    assert got.shape == (3, 96)
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL)
    np.testing.assert_allclose(got, unfolded, rtol=0, atol=ATOL)


@pytest.mark.parametrize("width", [7, 8])
@pytest.mark.parametrize("window", [(1, 2), (2, 2)])
@pytest.mark.parametrize("padding", ["SAME", "VALID"])
def test_pool_matches_reduce_window(rng, width, window, padding):
    x = rng.standard_normal((2, 6, width, 3)).astype(np.float32)            # NHWC
    want = np.asarray(jax_embedding._pool(jnp.asarray(x), window, window, padding))
    got = embedding.pool(torch.from_numpy(x).permute(0, 3, 1, 2), window, window, padding)
    np.testing.assert_array_equal(got.permute(0, 2, 3, 1).numpy(), want)


def test_cache_spec_and_shapes_match_jax(folded):
    assert embedding_stream.cache_spec() == jax_stream.cache_spec()
    caches, _ = jax_stream.init_caches(folded[0], jnp.ones((1, 76, 32)))
    assert {k: tuple(v.shape[1:]) for k, v in caches.items()} == embedding_stream.cache_shapes()


def test_init_caches_and_step_match_jax(folded, rng):
    ring, new = _mel(rng, 3, 76, 32), _mel(rng, 3, 8, 32)
    j_caches, j_emb = jax_stream.init_caches(folded[0], jnp.asarray(ring))
    t_caches, t_emb = embedding_stream.init_caches(folded[1], torch.from_numpy(ring))
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=ATOL)
    assert sorted(t_caches) == sorted(j_caches)
    for k in j_caches:
        assert t_caches[k].is_contiguous()
        np.testing.assert_allclose(t_caches[k].numpy(), np.asarray(j_caches[k]), rtol=0, atol=ATOL)

    j_caches, j_emb = jax_stream.step(folded[0], j_caches, jnp.asarray(new))
    t_caches, t_emb = embedding_stream.step(folded[1], t_caches, torch.from_numpy(new))
    assert t_emb.shape == (3, 96)
    np.testing.assert_allclose(t_emb.numpy(), np.asarray(j_emb), rtol=0, atol=ATOL)
    for k in j_caches:
        np.testing.assert_allclose(t_caches[k].numpy(), np.asarray(j_caches[k]), rtol=0, atol=ATOL)
    # the stream step equals re-running the full window over the shifted ring
    full = embedding.apply_folded(folded[1], torch.from_numpy(np.concatenate([ring[:, 8:], new], 1)))
    np.testing.assert_allclose(t_emb.numpy(), full.numpy(), rtol=0, atol=ATOL)


def test_multi_frame_step_equals_sequential(folded, rng):
    ring, new = _mel(rng, 3, 76, 32), _mel(rng, 3, 16, 32)
    caches, _ = embedding_stream.init_caches(folded[1], torch.from_numpy(ring))
    c16, e16 = embedding_stream.step(folded[1], caches, torch.from_numpy(new))
    c8, e8a = embedding_stream.step(folded[1], caches, torch.from_numpy(new[:, :8]))
    c8, e8b = embedding_stream.step(folded[1], c8, torch.from_numpy(new[:, 8:]))
    assert e16.shape == (3, 2, 96)
    np.testing.assert_allclose(e16.numpy(), torch.stack([e8a, e8b], 1).numpy(), rtol=0, atol=ATOL)
    for k in c16:
        np.testing.assert_allclose(c16[k].numpy(), c8[k].numpy(), rtol=0, atol=ATOL)


def test_from_jax_params_converts_both_sides(params):
    from openwakeword_tpu_torch.models import heads
    head = heads.init_params(np.random.default_rng(3))
    emb, converted = convert.from_jax_params(params, {"alexa": head})
    assert emb["conv_0"]["w"].shape == (24, 1, 3, 3)                        # HWIO -> OIHW
    np.testing.assert_array_equal(emb["conv_0"]["w"].numpy(), np.transpose(params["conv_0"]["w"], (3, 2, 0, 1)))
    np.testing.assert_array_equal(emb["bn_3"]["var"].numpy(), params["bn_3"]["var"])
    assert converted["alexa"]["__meta__"] == head["__meta__"]
    np.testing.assert_array_equal(converted["alexa"]["layer1"]["w"].numpy(), head["layer1"]["w"])
    assert convert.from_jax_params() == (None, None)
