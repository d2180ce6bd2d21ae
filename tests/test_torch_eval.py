"""The port's evaluation (``openwakeword_tpu_torch.eval``) against the JAX
package's on the CPU.

The metric functions are numpy and must give the JAX package's values bit
for bit on the same score arrays. ``evaluate_model`` scores synthetic WAVs
through each package's own engine with the same ``.npz`` head and the same
embedding weights (converted for the port): per-frame scores within 1e-3
(the port's score budget, BASELINE.json), and equal false-accept and
false-reject counts at every swept threshold that no score lies within
2e-3 of (1e-3 from either package's scores).
"""

import numpy as np
import pytest
import torch

from openwakeword_tpu import eval as JE
from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch import eval as TE
from openwakeword_tpu_torch import testing
from openwakeword_tpu_torch.data import write_audio
from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
from openwakeword_tpu_torch.models import heads

SCORE_TOL = 1e-3


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def test_metric_functions_bit_equal():
    rng = np.random.default_rng(0)
    neg = [rng.random(n) ** 3 for n in (700, 0, 1300)]
    pos = [np.clip(rng.random(n) + 0.3, 0, 1) for n in (5, 20, 0, 9)]
    for t in (0.05, 0.5, 0.93):
        assert TE.false_accepts_per_hour(neg, t) == JE.false_accepts_per_hour(neg, t)
        assert TE.false_accepts_per_hour(neg[0], t, grouping_window=7) == JE.false_accepts_per_hour(
            neg[0], t, grouping_window=7)
        assert TE.false_reject_rate(pos, t) == JE.false_reject_rate(pos, t)
    assert np.isnan(TE.false_reject_rate([], 0.5)) and TE.false_accepts_per_hour(np.zeros(0), 0.5) == 0.0
    got, want = TE.far_tar_curve(neg, pos), JE.far_tar_curve(neg, pos)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    result = {"threshold": 0.5, "far_per_hour": 1.25, "frr": 0.2, "negative_hours": 0.3, "n_positive_clips": 4,
              "rejected_clips": [], "curve": want}
    assert TE.render_model_page("m", result) == JE.render_model_page("m", result)
    multi = dict(result, per_label={"a": result, "b": result})
    assert TE.render_model_page("m", multi, curve_points=5) == JE.render_model_page("m", multi, curve_points=5)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    d = tmp_path_factory.mktemp("eval")
    rng = np.random.default_rng(3)
    neg, pos = [], []
    for i, n in enumerate((32000, 24000, 40000)):
        neg.append(str(d / f"neg_{i}.wav"))
        write_audio(neg[-1], rng.integers(-800, 800, n).astype(np.int16))
    for i in range(3):
        pos.append(str(d / f"pos_{i}.wav"))
        voice = testing.vowel(16000, rng) * 9000.0
        write_audio(pos[-1], np.clip(np.round(voice + rng.integers(-300, 300, 16000)), -32768, 32767)
                    .astype(np.int16))
    head = str(d / "tiny.npz")
    save_checkpoint(head, "head", heads.init_params(np.random.default_rng(4), "dnn", layer_dim=32))
    return neg, pos, head


def test_evaluate_model_matches_jax(corpus):
    import jax
    import jax.numpy as jnp
    neg, pos, head = corpus
    emb = testing.golden_inputs()["embedding"]
    want_scores, want_labels = JE.score_files_multi(neg + pos, [head], padding=1,
                                                    embedding_params=jax.tree.map(jnp.asarray, emb))
    got_scores, got_labels = TE.score_files_multi(neg + pos, [head], padding=1, device="cpu",
                                                  embedding_params=convert.embedding_from_jax(emb))
    assert got_labels == want_labels == ["tiny"]
    spread = []
    for p in neg + pos:
        assert got_scores[p].shape == want_scores[p].shape and got_scores[p].shape[0] > 0
        assert np.abs(got_scores[p] - want_scores[p]).max() < SCORE_TOL
        spread.append(want_scores[p][:, 0])
    spread = np.concatenate(spread)
    assert spread.max() - spread.min() > 0.05               # the scores are not all alike

    thresholds = np.linspace(0.01, 0.99, 50)
    kw = dict(threshold=0.5, thresholds=thresholds, segment_seconds=3.0)
    want = JE.evaluate_model(head, neg, pos, embedding_params=jax.tree.map(jnp.asarray, emb), **kw)
    got = TE.evaluate_model(head, neg, pos, device="cpu", embedding_params=convert.embedding_from_jax(emb), **kw)
    assert got["n_positive_clips"] == want["n_positive_clips"] == 3
    assert got["negative_hours"] == want["negative_hours"]
    # counts equal wherever no score of either package lies within the
    # score budget of the threshold (evaluate_model scores the negatives
    # unpadded: the port's scores of those stand within 1e-3 of JAX's)
    unpadded, _ = TE.score_files_multi(neg, [head], padding=0, segment_seconds=3.0, device="cpu",
                                       embedding_params=convert.embedding_from_jax(emb))
    spread = np.concatenate([spread] + [unpadded[p][:, 0] for p in neg])
    clear = np.array([np.abs(spread - t).min() > 2 * SCORE_TOL for t in thresholds])
    assert clear.sum() >= 25
    for k in ("far_per_hour", "frr"):
        np.testing.assert_array_equal(got["curve"][k][clear], want["curve"][k][clear])
    if np.abs(spread - 0.5).min() > 2 * SCORE_TOL:
        assert got["far_per_hour"] == want["far_per_hour"] and got["frr"] == want["frr"]
        assert got["rejected_clips"] == want["rejected_clips"]


def test_score_files_paths(corpus):
    """Label selection, and the streaming path against the one-shot path."""
    neg, pos, head = corpus
    emb = convert.embedding_from_jax(testing.golden_inputs()["embedding"])
    one_shot = TE.score_files(neg, [head], label="tiny", device="cpu", embedding_params=emb)
    streamed = TE.score_files(neg, [head], label="tiny", segment_seconds=0.4, device="cpu", embedding_params=emb)
    for p in neg:
        assert one_shot[p].ndim == 1 and one_shot[p].shape == streamed[p].shape
        np.testing.assert_allclose(streamed[p], one_shot[p], rtol=0, atol=1e-5)
    with pytest.raises(KeyError):
        TE.score_files(neg[:1], [head], label="nope", device="cpu", embedding_params=emb)
