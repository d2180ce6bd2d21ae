"""The port's training CLI (``openwakeword_tpu_torch.train_cli``) and its
feature pre-compute (``features.compute_features_from_generator``) on the CPU.

The CLI runs end to end on synthetic WAVs with ``device: cpu``, as
``tests/test_train_cli.py`` runs the JAX package's. Against the JAX package:
the port's features of the training golden's clips on the golden embedding
weights must agree with the JAX package's within 1e-4 (the embedding
tolerance of ``tests/test_cnn_pallas.py``), and the port's trainer, started
from the golden's JAX init at full width, must reproduce the JAX trainer's
40 steps. The fixture ``tests/fixtures/torch_train_golden.npz`` holds the
JAX package's side; regenerate it with
``JAX_PLATFORMS=cpu python -m tests.test_torch_train_cli``.
"""

import logging
import os

import numpy as np
import pytest
import torch
import yaml

from openwakeword_tpu_torch import convert, testing
from openwakeword_tpu_torch import data as TD
from openwakeword_tpu_torch.features import compute_features_from_generator
from openwakeword_tpu_torch.training import trainer as TT

EMB_ATOL = 1e-4
LOSS_RTOL = 1e-4
PRED_ATOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    torch.set_num_threads(2)


@pytest.fixture(scope="module")
def golden():
    return testing.load_train_golden()


@pytest.fixture(scope="module")
def inputs():
    return testing.train_inputs(testing.TRAIN_SEED)


def _record_steps(module, sink):
    step = module._train_step

    def recording(*args, **kwargs):
        out = step(*args, **kwargs)
        sink.append(out[3])
        return out
    return step, recording


def test_golden_inputs_regenerate(golden, inputs):
    assert str(golden["inputs_sha256"]) == inputs["sha256"]
    assert golden["features"].shape == (testing.TRAIN_CLIPS, 16, 96)


def test_features_match_jax(golden, inputs, tmp_path):
    """``compute_features_from_generator`` on the port's CPU path against the
    JAX package's on the same clips and converted embedding weights."""
    clips = inputs["clips"]
    out = str(tmp_path / "features.npy")
    emb = convert.embedding_from_jax(testing.golden_inputs()["embedding"])
    compute_features_from_generator(iter([clips[:10], clips[10:]]), n_total=len(clips),
                                    clip_duration=testing.TRAIN_CLIP_SAMPLES, output_file=out,
                                    device="cpu", embedding_params=emb)
    got = np.load(out)
    assert got.shape == golden["features"].shape
    np.testing.assert_allclose(got, golden["features"], rtol=0, atol=EMB_ATOL)


def test_trainer_matches_jax_golden(golden, inputs, monkeypatch):
    """40 steps at full width from the golden's JAX init: the update gate
    and the survivor counts equal step for step, losses within 1e-4
    relative, held-out predictions within 1e-4."""
    t = TT.HeadTrainer(layer_dim=testing.TRAIN_WIDTH, device="cpu")
    t.params = convert.head_from_jax(golden["init"])
    stats = []
    step, recording = _record_steps(TT, stats)
    monkeypatch.setattr(TT, "_train_step", recording)
    t.train_model(iter(inputs["batches"]), feed_chunk=8, **testing.train_schedule())
    np.testing.assert_array_equal([bool(s["updated"]) for s in stats], golden["updated"])
    np.testing.assert_array_equal([int(s["n_survivors"]) for s in stats], golden["n_survivors"])
    np.testing.assert_allclose([float(s["loss"]) for s in stats], golden["loss"], rtol=LOSS_RTOL, atol=0)
    np.testing.assert_allclose(t.forward(inputs["held_out"]), golden["held_out_pred"], rtol=0, atol=PRED_ATOL)


@pytest.fixture()
def training_setup(tmp_path):
    """Synthetic clip directories and a config, as tests/test_train_cli.py."""
    rng = np.random.default_rng(0)
    model_dir = tmp_path / "out" / "tiny_model"
    for split in ("positive_train", "positive_test", "negative_train", "negative_test"):
        d = model_dir / split
        d.mkdir(parents=True)
        for i in range(8):
            n = 16000
            if "positive" in split:
                t = np.arange(n) / 16000
                sig = 0.4 * np.sin(2 * np.pi * (300 + 50 * i) * t) * np.hanning(n)
            else:
                sig = rng.uniform(-0.3, 0.3, n)
            TD.write_audio(str(d / f"clip{i}.wav"), sig.astype(np.float32))
    cfg = {
        "model_name": "tiny_model", "target_phrase": ["hey tiny"], "custom_negative_phrases": [],
        "output_dir": str(tmp_path / "out"), "piper_sample_generator_path": "./nonexistent",
        "n_samples": 8, "n_samples_val": 8, "tts_batch_size": 4, "augmentation_batch_size": 8,
        "augmentation_rounds": 1, "rir_paths": [], "background_paths": [],
        "background_paths_duplication_rate": [], "feature_data_files": {}, "batch_n_per_class": {},
        "false_positive_validation_data_path": "", "model_type": "dnn", "layer_size": 16, "steps": 30,
        "max_negative_weight": 5, "target_false_positives_per_hour": -1.0, "seed": 3, "device": "cpu",
    }
    path = str(tmp_path / "cfg.yml")
    with open(path, "w") as f:
        yaml.safe_dump(cfg, f)
    return path, cfg


def test_augment_and_train(training_setup, caplog):
    from openwakeword_tpu_torch import Model
    from openwakeword_tpu_torch.train_cli import main
    cfg_path, cfg = training_setup
    with caplog.at_level(logging.INFO):
        main(["--training_config", cfg_path, "--augment_clips", "--train_model"])
    # the miniature run misses its FP/hr target, so the weight doubles
    assert any("Increasing weight on negative examples" in r.message for r in caplog.records)
    out = cfg["output_dir"]
    feats = np.load(os.path.join(out, "tiny_model", "positive_features_train.npy"))
    assert feats.shape == (8, 16, 96)
    npz = os.path.join(out, "tiny_model.npz")
    m = Model(wakeword_models=[npz], device="cpu")
    preds = m.predict(np.random.default_rng(0).integers(-1000, 1000, 1280).astype(np.int16))
    assert "tiny_model" in preds
    # resumable: a second run skips the finished features
    with caplog.at_level(logging.WARNING):
        caplog.clear()
        main(["--training_config", cfg_path, "--augment_clips"])
    assert any("Features already exist" in r.message for r in caplog.records)


@pytest.mark.parametrize("flag", ["--export_onnx", "--convert_to_tflite", "--distill_student"])
def test_f2_stages_fail_before_any_stage(training_setup, flag, caplog):
    """The stages the port once refused now run: the exports write the
    trained head beside its ``.npz`` (the same scores in ``Model``), and
    ``--distill_student`` writes the student checkpoint at
    ``student_checkpoint_path`` and skips it on a second run."""
    from openwakeword_tpu_torch import Model
    from openwakeword_tpu_torch.io.loaders import load_model_file
    from openwakeword_tpu_torch.train_cli import main
    cfg_path, cfg = training_setup
    if flag == "--distill_student":
        student = os.path.join(cfg["output_dir"], "student.npz")
        cfg.update(student_checkpoint_path=student, distill_steps=2, distill_batch_size=8)
        with open(cfg_path, "w") as f:
            yaml.safe_dump(cfg, f)
        main(["--training_config", cfg_path, flag])
        kind, params, meta = load_model_file(student)
        assert kind == "embedding_student" and meta["distilled"] and "served_score_drift" in meta["drift"]
        with caplog.at_level(logging.WARNING):
            main(["--training_config", cfg_path, flag])
        assert any("Student checkpoint already exists" in r.message for r in caplog.records)
        return
    main(["--training_config", cfg_path, "--augment_clips", "--train_model", flag])
    base = os.path.join(cfg["output_dir"], "tiny_model")
    ext = ".onnx" if flag == "--export_onnx" else ".tflite"
    assert os.path.exists(base + ext) and not os.path.exists(base + (".tflite" if ext == ".onnx" else ".onnx"))
    pcm = np.random.default_rng(0).integers(-1000, 1000, 1280 * 6).astype(np.int16)
    want = [p["tiny_model"] for p in Model(wakeword_models=[base + ".npz"], device="cpu").predict_clip(pcm)]
    got = [p["tiny_model"] for p in Model(wakeword_models=[base + ext], device="cpu").predict_clip(pcm)]
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


def test_generate_clips_needs_the_external_generator(training_setup):
    from openwakeword_tpu_torch.train_cli import main
    cfg_path, _ = training_setup
    with pytest.raises(ImportError, match="piper-sample-generator"):
        main(["--training_config", cfg_path, "--generate_clips"])


def test_default_device_is_the_card(training_setup):
    """Without a ``device`` key the stages run on "cuda", and raise where
    there is none: no stage carries on on the CPU."""
    from openwakeword_tpu_torch import train_cli
    _, cfg = training_setup
    cfg = {k: v for k, v in cfg.items() if k != "device"}
    paths = train_cli.prepare(cfg)
    train_cli.auto_size(cfg, paths)
    assert cfg["device"] == "cuda" and cfg["total_length"] == 32000
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            train_cli.augment_stage(cfg, paths)


def make_golden(path: str = testing.TRAIN_FIXTURE):
    """Write the training golden from the JAX package (CPU)."""
    import tempfile

    import jax
    import jax.numpy as jnp
    from openwakeword_tpu import features as jax_features
    from openwakeword_tpu.training import trainer as JT

    inputs = testing.train_inputs(testing.TRAIN_SEED)
    clips = inputs["clips"]
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "features.npy")
        emb = jax.tree.map(jnp.asarray, testing.golden_inputs()["embedding"])
        jax_features.compute_features_from_generator(iter([clips[:10], clips[10:]]), n_total=len(clips),
                                                     clip_duration=testing.TRAIN_CLIP_SAMPLES, output_file=out,
                                                     embedding_params=emb)
        features = np.load(out)
    jt = JT.HeadTrainer(layer_dim=testing.TRAIN_WIDTH, seed=testing.TRAIN_SEED)
    init = {f"init/{k}/{leaf}": np.asarray(v) for k, p in jt.params.items() if k != "__meta__"
            for leaf, v in p.items()}
    stats = []
    step, recording = _record_steps(JT, stats)
    JT._train_step = recording
    try:
        jt.train_model(iter(inputs["batches"]), feed_chunk=1, **testing.train_schedule())
    finally:
        JT._train_step = step
    np.savez_compressed(
        path, seed=testing.TRAIN_SEED, inputs_sha256=inputs["sha256"], features=features,
        updated=np.array([bool(s["updated"]) for s in stats]),
        n_survivors=np.array([int(s["n_survivors"]) for s in stats], np.int32),
        loss=np.array([float(s["loss"]) for s in stats], np.float32),
        held_out_pred=jt.forward(inputs["held_out"]), **init)
    print(f"wrote {path}: features {features.shape}, {int(np.sum([bool(s['updated']) for s in stats]))} updates "
          f"in {len(stats)} steps")


if __name__ == "__main__":
    jax_cfg = __import__("jax").config
    jax_cfg.update("jax_platforms", "cpu")
    make_golden()
