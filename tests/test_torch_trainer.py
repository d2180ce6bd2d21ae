"""The port's head trainer (``openwakeword_tpu_torch.training.trainer``)
against the JAX package's ``HeadTrainer`` on the CPU.

Both start from the JAX trainer's init (``convert.trainer_from_jax``) and
take the same numpy batches for 40 steps: the update gate (``updated``) and
the survivor counts must be equal step for step, the losses within 1e-4
relative, and predictions on held-out windows within 1e-4 after training.
Adam turns a tiny gradient difference into a step of up to lr, so the
params themselves are not compared leaf by leaf.
"""

import logging
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from openwakeword_tpu.training import trainer as JT
from openwakeword_tpu_torch import convert
from openwakeword_tpu_torch.training import trainer as TT

LOSS_RTOL = 1e-4
PRED_ATOL = 1e-4
STEPS = 40
CASES = {"dnn": dict(model_type="dnn"), "mlp": dict(model_type="mlp"), "rnn": dict(model_type="rnn"),
         "multiclass": dict(model_type="dnn", n_classes=3), "true_accumulation": dict(model_type="dnn")}


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


def _batches(seed, n, bs, n_classes=1, sep=0.3):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        y = rng.integers(0, max(2, n_classes), bs)
        x = rng.normal(0, 1, (bs, 16, 96)).astype(np.float32) + (y[:, None, None] * sep).astype(np.float32)
        out.append((x, y))
    return out


def _train(module, trainer, data, monkeypatch, **kw):
    """Train for len(data) steps, returning each step's (updated,
    n_survivors, loss) as read from the step function."""
    stats = []
    step = module._train_step

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        stats.append(out[3])
        return out
    monkeypatch.setattr(module, "_train_step", recording)
    trainer.train_model(iter(data), max_steps=len(data), warmup_steps=5, hold_steps=5, lr=1e-3,
                        negative_weight_schedule=list(np.linspace(1, 5, len(data))), **kw)
    monkeypatch.setattr(module, "_train_step", step)
    return (np.array([bool(s["updated"]) for s in stats]), np.array([int(s["n_survivors"]) for s in stats]),
            np.array([float(s["loss"]) for s in stats]))


def _port_from(jax_trainer, **kw):
    t = TT.HeadTrainer(device="cpu", **kw)
    t.params, t.opt_state = convert.trainer_from_jax(jax_trainer.params, jax_trainer.opt_state)
    return t


_JAX_RUNS = {}


def _jax_run(case, monkeypatch):
    """The JAX trainer's 40 steps for ``case`` (run once per module), per
    step: its chunked feed runs the same step in one scan."""
    if case not in _JAX_RUNS:
        spec = dict(CASES[case], layer_dim=32, seed=0)
        data = _batches(1, STEPS, 48, spec.get("n_classes", 1))
        jt = JT.HeadTrainer(**spec)
        init = (jt.params, jt.opt_state)
        stats = _train(JT, jt, data, monkeypatch, feed_chunk=1, true_accumulation=case == "true_accumulation")
        held_out = _batches(2, 1, 64, spec.get("n_classes", 1))[0][0]
        _JAX_RUNS[case] = (spec, data, init, stats, held_out, jt.forward(held_out))
    return _JAX_RUNS[case]


@pytest.mark.parametrize("feed_chunk", [1, 8])
@pytest.mark.parametrize("case", list(CASES))
def test_steps_match_jax(case, feed_chunk, monkeypatch):
    spec, data, (params, opt_state), want, held_out, want_pred = _jax_run(case, monkeypatch)
    t = TT.HeadTrainer(device="cpu", **spec)
    t.params, t.opt_state = convert.trainer_from_jax(params, opt_state)
    got = _train(TT, t, data, monkeypatch, feed_chunk=feed_chunk, true_accumulation=case == "true_accumulation")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert 0 < want[0].sum() < STEPS                        # the gate both fires and holds
    np.testing.assert_allclose(got[2], want[2], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(t.forward(held_out), want_pred, rtol=0, atol=PRED_ATOL)
    assert t.history["loss"] == pytest.approx([l for u, l in zip(want[0], want[2]) if u], rel=LOSS_RTOL)


@pytest.mark.parametrize("feed_chunk", [1, 8])
def test_bf16_feed_matches_jax(feed_chunk, monkeypatch):
    """A bf16 transfer rounds the inputs as JAX's does; the math stays
    float32, so the runs agree as the float32 ones do. (The JAX trainer's
    chunked feed is its per-step path in one scan, so JAX runs per step.)"""
    data = _batches(3, 16, 48)
    jt = JT.HeadTrainer(layer_dim=32, seed=1)
    t = _port_from(jt, layer_dim=32)
    want = _train(JT, jt, data, monkeypatch, feed_chunk=1, feed_dtype=jnp.bfloat16)
    got = _train(TT, t, data, monkeypatch, feed_chunk=feed_chunk, feed_dtype=torch.bfloat16)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=LOSS_RTOL, atol=0)
    x = data[0][0]
    np.testing.assert_allclose(t.forward(x), jt.forward(x), rtol=0, atol=PRED_ATOL)


def test_adam_state_carries_across(monkeypatch):
    """A JAX trainer's mid-run params and optax state (count, mu, nu) move
    into the port, and both continue alike."""
    data = _batches(4, 30, 48)
    jt = JT.HeadTrainer(layer_dim=32, seed=2)
    _train(JT, jt, data[:15], monkeypatch)
    adam = jt.opt_state[0]
    t = _port_from(jt, layer_dim=32)
    assert int(t.opt_state["count"]) == int(adam.count) > 0
    np.testing.assert_array_equal(t.opt_state["nu"]["layer1"]["w"].numpy(), np.asarray(adam.nu["layer1"]["w"]))
    want = _train(JT, jt, data[15:], monkeypatch)
    got = _train(TT, t, data[15:], monkeypatch)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[2], want[2], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(t.forward(data[0][0]), jt.forward(data[0][0]), rtol=0, atol=PRED_ATOL)


def test_schedule_init_and_device():
    for s in range(0, 100, 7):
        kw = dict(warmup_steps=10, hold=20, total_steps=100, target_lr=1e-3)
        assert TT.lr_warmup_cosine_decay(s, **kw) == JT.lr_warmup_cosine_decay(s, **kw)
    t = TT.HeadTrainer(layer_dim=16, seed=3, device="cpu")
    assert t.lr_warmup_cosine_decay(5, warmup_steps=10, total_steps=50) == TT.lr_warmup_cosine_decay(
        5, warmup_steps=10, total_steps=50)
    # numpy init, as models.heads.init_params: seeds reproduce, torch's RNG is untouched
    state = torch.random.get_rng_state()
    again = TT.HeadTrainer(layer_dim=16, seed=3, device="cpu")
    assert torch.equal(state, torch.random.get_rng_state())
    np.testing.assert_array_equal(t.params["layer1"]["w"], again.params["layer1"]["w"])
    assert t.summary() == sum(v.size for p in t._leaf(t.params).values() for v in p.values())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            TT.HeadTrainer()


def test_auto_train_doubles_negative_weight():
    t = TT.HeadTrainer(layer_dim=16, seed=0, device="cpu")
    xv, yv = _batches(6, 1, 64)[0]
    t.auto_train(X_train=iter(_batches(7, 400, 64)), X_val=[(xv, yv)], false_positive_val_data=[(xv, yv)],
                 steps=30, max_negative_weight=5, target_fp_per_hour=-1.0, lr=1e-3, val_set_hrs=0.01)
    assert t.history["max_negative_weight"] == [5, 10, 20]
    assert len(t.best_models) >= 1


def test_average_select_predict_and_state(tmp_path):
    t = TT.HeadTrainer(layer_dim=32, seed=0, device="cpu")
    xv, yv = _batches(8, 1, 128, sep=1.5)[0]
    t.train_model(iter(_batches(9, 100, 64, sep=1.5)), max_steps=100, warmup_steps=20, hold_steps=30, lr=1e-3,
                  X_val=[(xv, yv)], val_steps=[50, 75, 99])
    assert t.accuracy(t.forward(xv), yv) > 0.9 and len(t.best_models) >= 1
    # the average is numpy's, leaf for leaf
    jt = JT.HeadTrainer(layer_dim=32, seed=0)
    want = jt.average_models(t.best_models)
    got = t.average_models()
    for k in ("layer1", "out"):
        np.testing.assert_array_equal(got[k]["w"], np.asarray(want[k]["w"]))
    assert t._select_best_model([(xv, yv)], val_set_hrs=1.0, max_fp_per_hour=1e9, min_recall=0.0) is not None
    # sliding windows, the last one included, as the JAX trainer's
    clips = np.random.default_rng(10).normal(0, 1, (2, 30, 96)).astype(np.float32)
    jt.params = {"__meta__": t.meta, **{k: v for k, v in t.params.items() if k != "__meta__"}}
    preds = t.predict_on_features(clips)
    assert preds.shape[:2] == (2, 30 - 16 + 1)
    np.testing.assert_allclose(preds, jt.predict_on_features(clips), rtol=0, atol=1e-5)
    path = str(tmp_path / "state.pkl")
    t.save_state(path)
    t2 = TT.HeadTrainer(layer_dim=32, seed=1, device="cpu")
    t2.load_state(path)
    np.testing.assert_array_equal(t2.forward(xv), t.forward(xv))
    assert t2.history["val_accuracy"] == t.history["val_accuracy"]
    assert len(t2.best_models) == len(t.best_models)
    assert int(t2.opt_state["count"]) == int(t.opt_state["count"]) > 0
    t2.train_model(iter(_batches(11, 10, 64)), max_steps=10, warmup_steps=2, hold_steps=2, lr=1e-4)


def test_checkpoints_and_refusals(tmp_path, caplog):
    """The saved ``.npz`` loads in the JAX package with the same scores; the
    exports (``export_model``'s ``.onnx``, ``export_to_onnx``,
    ``train.convert_onnx_to_tflite``) load in the JAX package with the same
    scores too."""
    from openwakeword_tpu.io.loaders import load_model_file
    from openwakeword_tpu.models import heads as jax_heads
    t = TT.HeadTrainer(layer_dim=16, seed=4, device="cpu")
    x = _batches(12, 1, 8)[0][0]
    with caplog.at_level(logging.WARNING):
        t.export_model(None, "head", str(tmp_path))
    assert not any("ONNX export unavailable" in r.message for r in caplog.records)
    for name in ("head.npz", "head.onnx"):
        kind, params, _ = load_model_file(str(tmp_path / name))
        assert kind == "head"
        np.testing.assert_allclose(np.asarray(jax_heads.apply(params, jnp.asarray(x))), t.forward(x), atol=1e-6)
    t.save_model(str(tmp_path / "tagged.npz"), meta={"embedding": "student"})
    assert load_model_file(str(tmp_path / "tagged.npz"))[2]["embedding"] == "student"
    assert os.path.exists(str(tmp_path / "tagged.npz"))
    t.export_to_onnx(str(tmp_path / "named.onnx"), class_mapping="wake")
    from openwakeword_tpu.io import onnx_proto
    assert onnx_proto.load_onnx(str(tmp_path / "named.onnx"))["graph"]["outputs"][0]["name"] == "wake"
    from openwakeword_tpu_torch import train
    assert train.Model is TT.HeadTrainer and train.lr_warmup_cosine_decay is TT.lr_warmup_cosine_decay
    train.convert_onnx_to_tflite(str(tmp_path / "head.onnx"), str(tmp_path / "head.tflite"))
    kind, params, _ = load_model_file(str(tmp_path / "head.tflite"))
    assert kind == "head"
    np.testing.assert_allclose(np.asarray(jax_heads.apply(params, jnp.asarray(x))), t.forward(x), atol=1e-6)
