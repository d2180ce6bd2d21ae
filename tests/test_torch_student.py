"""The student embedding of the port (``models.embedding_student``, the
engine's and ``AudioFeatures``' ``embedding="student"``) on the CPU against
the JAX package.

Weights come from ``testing.student_params`` (seeded numpy) and go to both
packages. At fp32 ('highest' and the default) the port agrees with JAX to
1e-5 per tensor and the engine's scores to 1e-4. On the CPU JAX's
``Precision.DEFAULT`` is exact float32, so the port's 1-pass products
('fast') are held to a reference that rounds the operands to bf16 by hand.

``tests/fixtures/torch_student_golden.npz`` holds the JAX engine's scores
(precision 'highest', student embedding, the bench heads) over
``testing.student_inputs()``; ``chip_smoke.py`` phase 15a holds the card to
it. Regenerate it from the repo root with
``JAX_PLATFORMS=cpu python -m tests.test_torch_student``.
"""

import logging
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu_torch import convert, testing
from openwakeword_tpu_torch.features import AudioFeatures
from openwakeword_tpu_torch.io import loaders
from openwakeword_tpu_torch.models import embedding_student as S
from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine

ATOL = 1e-5
SCORE_ATOL = 1e-4
# features through the mel frontend: both packages' float32 DFT sums in
# their own order move the embeddings (|e| up to ~3) by up to ~2e-5
FEATURE_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def params():
    return testing.student_params(np.random.default_rng(3))


def _jax(p):
    return jax.tree.map(jnp.asarray, p)


def _mel(rng, *shape):
    return (rng.random(shape) * 4.0 - 1.0).astype(np.float32)


def test_is_student_and_published_widths(params):
    assert S.is_student(params) and S.is_student(convert.student_from_jax(params))
    from openwakeword_tpu.models import embedding_student as JS
    for name in ("BLOCK_IN", "BLOCK_DIM", "N_BLOCKS", "HIDDEN", "OUTPUT_DIM", "HOP_BLOCKS"):
        assert getattr(S, name) == getattr(JS, name), name
    assert (S.BLOCK_IN, S.BLOCK_DIM, S.N_BLOCKS, S.HIDDEN, S.OUTPUT_DIM) == (128, 256, 19, 512, 96)
    assert {k: v["w"].shape for k, v in params.items() if "w" in v} == {
        "block1": (128, 256), "mix1": (4864, 512), "mix2": (512, 512), "out": (512, 96)}


@pytest.mark.parametrize("k", [1, 3])
def test_apply_init_caches_step_match_jax(params, k):
    from openwakeword_tpu.models import embedding_student as JS
    rng = np.random.default_rng(10 + k)
    window, new = _mel(rng, 3, 76, 32), _mel(rng, 3, 8 * k, 32)
    pt, pj = convert.student_from_jax(params), _jax(params)
    np.testing.assert_allclose(S.apply(pt, torch.from_numpy(window[..., None])).numpy(),
                               np.asarray(JS.apply(pj, jnp.asarray(window[..., None]))), atol=ATOL)
    ct, et = S.init_caches(pt, torch.from_numpy(window))
    cj, ej = JS.init_caches(pj, jnp.asarray(window))
    np.testing.assert_allclose(et.numpy(), np.asarray(ej), atol=ATOL)
    np.testing.assert_allclose(ct["blocks"].numpy(), np.asarray(cj["blocks"]), atol=ATOL)
    ct2, st = S.step(pt, ct, torch.from_numpy(new))
    cj2, sj = JS.step(pj, cj, jnp.asarray(new))
    assert st.shape == ((3, 96) if k == 1 else (3, k, 96))
    np.testing.assert_allclose(st.numpy(), np.asarray(sj), atol=ATOL)
    np.testing.assert_allclose(ct2["blocks"].numpy(), np.asarray(cj2["blocks"]), atol=ATOL)


def test_stream_equals_full_window(params):
    """Each streamed embedding equals ``apply`` on its implicit window, hop
    by hop and with several hops at once."""
    pt = convert.student_from_jax(params)
    rows = torch.from_numpy(_mel(np.random.default_rng(4), 2, 76 + 8 * 6, 32))
    caches, _ = S.init_caches(pt, rows[:, :76])
    one = []
    c = caches
    for j in range(6):
        c, e = S.step(pt, c, rows[:, 76 + 8 * j:84 + 8 * j])
        one.append(e)
    _, many = S.step(pt, caches, rows[:, 76:])
    full = torch.stack([S.apply(pt, rows[:, 8 * (j + 1):8 * (j + 1) + 76]) for j in range(6)], dim=1)
    np.testing.assert_allclose(torch.stack(one, dim=1).numpy(), full.numpy(), atol=ATOL)
    np.testing.assert_allclose(many.numpy(), full.numpy(), atol=ATOL)


def _jax_one_pass_apply(p, x):
    """JAX student forward with each product's operands rounded to bf16 by
    hand and float32 sums: the TPU's 1-pass arithmetic, which the CPU's
    ``Precision.DEFAULT`` does not round."""
    def r(a):
        return a.astype(jnp.bfloat16).astype(jnp.float32)

    def lin(q, z):
        return jnp.matmul(r(z), r(q["w"]), precision=jax.lax.Precision.HIGHEST) + q["b"]

    gelu = jax.nn.gelu
    z = x.reshape(x.shape[0], 19, 128)
    mu = z.mean(-1, keepdims=True)
    var = ((z - mu) ** 2).mean(-1, keepdims=True)
    z = (z - mu) * jax.lax.rsqrt(var + 1e-5) * p["block_ln"]["gamma"] + p["block_ln"]["beta"]
    blocks = gelu(lin(p["block1"], z))
    h = gelu(lin(p["mix1"], blocks.reshape(x.shape[0], -1)))
    return lin(p["out"], gelu(lin(p["mix2"], h)))


def test_fast_runs_one_pass_products(params):
    """'fast' rounds both operands of every product to bf16 and sums in
    float32: one product agrees with the hand-rounded reference on the same
    inputs at 1e-5; the whole network within 2 E, E its distance from fp32
    (a flipped rounding feeds the later products)."""
    pt, pj = convert.student_from_jax(params), _jax(params)
    x = _mel(np.random.default_rng(6), 5, 76, 32)
    fast = S.product_params(pt, "fast")
    z = torch.from_numpy(np.random.default_rng(7).standard_normal((5, 4864)).astype(np.float32))
    ref = (np.asarray(jnp.asarray(z.numpy()).astype(jnp.bfloat16).astype(jnp.float32))
           @ np.asarray(pj["mix1"]["w"].astype(jnp.bfloat16).astype(jnp.float32)).astype(np.float64))
    np.testing.assert_allclose(S._linear(fast["mix1"], z, "fast").numpy(),
                               ref + params["mix1"]["b"], atol=ATOL, rtol=1e-6)
    got = S.apply(fast, torch.from_numpy(x), "fast").numpy()
    exact = S.apply(pt, torch.from_numpy(x)).numpy()
    ref = np.asarray(jax.jit(_jax_one_pass_apply)(pj, jnp.asarray(x)))
    e = np.abs(ref - exact).max()
    assert e > 1e-4                                  # 1-pass really rounds
    assert np.abs(got - ref).max() <= 2 * e


@pytest.fixture(scope="module")
def heads_dir(tmp_path_factory):
    inputs = testing.student_inputs()
    return testing.write_head_checkpoints(inputs["heads"], str(tmp_path_factory.mktemp("student_heads")))


def _engines(params, paths, n_streams, precision="highest", **kw):
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    port = MultiStreamEngine(wakeword_models=paths, n_streams=n_streams, precision=precision, device="cpu",
                             embedding_params=convert.student_from_jax(params), **kw)
    jx = JaxEngine(wakeword_models=paths, n_streams=n_streams, precision=precision,
                   embedding_params=_jax(params), **kw)
    return port, jx


def test_engine_student_matches_jax(params, heads_dir):
    """S=8 over 20 frames at 'highest': every entry point of the golden
    sequence (predict, predict_masked, predict_frames) within 1e-4."""
    port, jx = _engines(params, heads_dir, 8)
    assert port.embedding == jx.embedding == "student"
    assert tuple(port.state["conv_caches"]["blocks"].shape) == (8, 19, 256)
    pcm = testing.student_inputs()["pcm"]
    mask = np.random.default_rng(8).random((6, 8)) < 0.6
    out_p = [port.predict(pcm[t]) for t in range(7)] + [port.predict_masked(pcm[7 + t], mask[t]) for t in range(6)]
    out_j = [jx.predict(pcm[t]) for t in range(7)] + [jx.predict_masked(pcm[7 + t], mask[t]) for t in range(6)]
    out_p = np.concatenate([np.stack(out_p), port.predict_frames(pcm[13:])])
    out_j = np.concatenate([np.stack(out_j), np.asarray(jx.predict_frames(pcm[13:]))])
    assert np.abs(out_p).max() > 0.05
    np.testing.assert_allclose(out_p, out_j, atol=SCORE_ATOL)


def test_engine_student_fast_and_bf16_drift(params, heads_dir):
    """'fast' and 'bf16' (bf16 weights and block ring) run 1-pass products:
    they move the scores, within the JAX package's 1-pass bound against
    the port's own 'highest'."""
    pcm = testing.student_inputs()["pcm"][:12]
    ref = MultiStreamEngine(wakeword_models=heads_dir, n_streams=8, precision="highest", device="cpu",
                            embedding_params=convert.student_from_jax(params)).predict_frames(pcm)
    for tier in ("fast", "bf16"):
        e = MultiStreamEngine(wakeword_models=heads_dir, n_streams=8, precision=tier, device="cpu",
                              embedding="student", embedding_params=convert.student_from_jax(params))
        if tier == "bf16":
            assert e.state["conv_caches"]["blocks"].dtype == torch.bfloat16
            assert e.params["embedding"]["mix1"]["w"].dtype == torch.bfloat16
        d = np.abs(e.predict_frames(pcm) - ref).max()
        assert 0 < d <= 0.02, (tier, d)


def test_engine_loads_student_without_params(heads_dir, caplog):
    """embedding='student' with no params and no checkpoint: a seeded init,
    with a warning."""
    with caplog.at_level(logging.WARNING):
        e = MultiStreamEngine(wakeword_models=heads_dir[:1], n_streams=2, device="cpu", embedding="student")
    assert e.embedding == "student" and S.is_student(e.params["embedding"])
    assert any("student-embedding checkpoint" in r.message for r in caplog.records)
    p = loaders.load_embedding_params(embedding="student")
    assert S.is_student(p) and p["mix1"]["w"].dtype == np.float32


def test_golden_fixture(params, heads_dir):
    """The port's CPU engine reproduces the JAX engine's committed scores."""
    with np.load(testing.STUDENT_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.student_inputs(int(fixture["seed"]))
    assert inputs["sha256"] == str(fixture["inputs_sha256"])
    e = MultiStreamEngine(wakeword_models=heads_dir, n_streams=testing.STUDENT_STREAMS, precision="highest",
                          device="cpu", embedding_params=convert.student_from_jax(inputs["embedding"]))
    np.testing.assert_allclose(e.predict_frames(inputs["pcm"]), fixture["scores"], atol=SCORE_ATOL)


@pytest.mark.parametrize("case", ["mixed", "per_conv_list", "faithful_params"])
def test_refusals_match_jax(params, heads_dir, case):
    """'mixed' and per-conv lists are refused for the student, and
    embedding='student' with faithful-CNN params, as JAX refuses them."""
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    from openwakeword_tpu.models import embedding as JE
    kw = dict(wakeword_models=heads_dir[:1], n_streams=2, embedding="student")
    if case == "mixed":
        port_kw, jax_kw = dict(kw, precision="mixed"), dict(kw, precision="mixed")
    elif case == "per_conv_list":
        modes = ["high"] * 20
        port_kw, jax_kw = dict(kw, precision={"cnn": modes}), dict(kw, precision={"cnn": modes})
    else:
        cnn = testing.golden_inputs()["embedding"]
        port_kw = dict(kw, embedding_params=convert.embedding_from_jax(cnn))
        jax_kw = dict(kw, embedding_params=jax.tree.map(jnp.asarray, cnn))
    with pytest.raises(ValueError) as jerr:
        JaxEngine(**jax_kw)
    with pytest.raises(ValueError) as perr:
        MultiStreamEngine(device="cpu", **port_kw)
    assert str(perr.value) == str(jerr.value)
    if case == "faithful_params":
        from openwakeword_tpu.features import AudioFeatures as JaxFeatures
        with pytest.raises(ValueError, match="faithful-CNN"):
            JaxFeatures(embedding="student", embedding_params=jax_kw["embedding_params"])
        with pytest.raises(ValueError, match="faithful-CNN"):
            AudioFeatures(embedding="student", embedding_params=port_kw["embedding_params"], device="cpu")
    assert JE.n_convs() == 20


def test_audio_features_student_matches_jax(params):
    """Streaming features and the batch path of AudioFeatures(embedding=
    'student') against the JAX package's."""
    from openwakeword_tpu.features import AudioFeatures as JaxFeatures
    port = AudioFeatures(embedding="student", embedding_params=convert.student_from_jax(params), device="cpu")
    jx = JaxFeatures(embedding="student", embedding_params=_jax(params))
    assert port.embedding == jx.embedding == "student"
    rng = np.random.default_rng(9)
    clip = np.round((rng.random(16000 * 2) * 2 - 1) * 8000).astype(np.int16)
    for a, b in ((0, 4000), (4000, 5280), (5280, 17000), (17000, 32000)):
        assert port(clip[a:b]) == jx(clip[a:b])
    np.testing.assert_allclose(port.get_features(40), jx.get_features(40), atol=FEATURE_ATOL)
    batch = clip[None, :16000].repeat(2, axis=0)
    np.testing.assert_allclose(port.embed_clips(batch), np.asarray(jx.embed_clips(batch)), atol=FEATURE_ATOL)


def test_state_round_trip_in_jax_layout(params, heads_dir, tmp_path):
    """save_state writes the block ring under the JAX engine's key
    ('conv_caches/blocks'); a JAX snapshot loads into the port and the
    port's into JAX, and stepping on agrees."""
    port, jx = _engines(params, heads_dir[:2], 3)
    pcm = testing.student_inputs()["pcm"][:, :3]
    for t in range(4):
        port.predict(pcm[t])
        jx.predict(pcm[t])
    pp, jp = str(tmp_path / "port.npz"), str(tmp_path / "jax.npz")
    port.save_state(pp)
    jx.save_state(jp)
    with np.load(pp) as a, np.load(jp) as b:
        assert sorted(a.files) == sorted(b.files)
        assert a["conv_caches/blocks"].shape == (3, 19, 256)
        for k in a.files:
            np.testing.assert_allclose(a[k], b[k], atol=FEATURE_ATOL, err_msg=k)
    fresh_p, fresh_j = _engines(params, heads_dir[:2], 3)
    fresh_p.load_state(jp)
    fresh_j.load_state(pp)
    np.testing.assert_allclose(fresh_p.predict_frames(pcm[4:8]), np.asarray(jx.predict_frames(pcm[4:8])),
                               atol=SCORE_ATOL)
    np.testing.assert_allclose(port.predict_frames(pcm[4:8]), np.asarray(fresh_j.predict_frames(pcm[4:8])),
                               atol=SCORE_ATOL)


def test_bf16_state_round_trip(params, heads_dir, tmp_path):
    """At 'bf16' the block ring is stored in bf16 and snapshotted as float32
    under 'bf16:conv_caches/blocks', the JAX engine's key (JAX cannot run
    bf16 products on the CPU, so the port holds itself): a reload steps on
    bit for bit."""
    kw = dict(wakeword_models=heads_dir[:2], n_streams=3, precision="bf16", device="cpu",
              embedding_params=convert.student_from_jax(params))
    port = MultiStreamEngine(**kw)
    pcm = testing.student_inputs()["pcm"][:, :3]
    port.predict_frames(pcm[:4])
    path = str(tmp_path / "bf16.npz")
    port.save_state(path)
    with np.load(path) as z:
        assert "bf16:conv_caches/blocks" in z.files and "conv_caches/blocks" not in z.files
        assert z["bf16:conv_caches/blocks"].dtype == np.float32
    fresh = MultiStreamEngine(**kw)
    fresh.load_state(path)
    assert fresh.state["conv_caches"]["blocks"].dtype == torch.bfloat16
    np.testing.assert_array_equal(fresh.predict_frames(pcm[4:8]), port.predict_frames(pcm[4:8]))


def _write_fixture():
    import tempfile
    from openwakeword_tpu.parallel.engine import MultiStreamEngine as JaxEngine
    inputs = testing.student_inputs()
    paths = testing.write_head_checkpoints(inputs["heads"], tempfile.mkdtemp())
    engine = JaxEngine(wakeword_models=paths, n_streams=testing.STUDENT_STREAMS, precision="highest",
                       embedding_params=_jax(inputs["embedding"]))
    assert engine.embedding == "student"
    scores = np.asarray(engine.predict_frames(inputs["pcm"]), np.float32)
    np.savez(testing.STUDENT_FIXTURE, scores=scores, seed=np.int64(testing.STUDENT_SEED),
             inputs_sha256=np.array(inputs["sha256"]), labels=np.array(engine.labels))
    print(f"wrote {testing.STUDENT_FIXTURE}: scores {scores.shape}, max {scores.max():.4f}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    logging.disable(logging.WARNING)
    _write_fixture()
