"""End-to-end training pipeline CLI of the PyTorch port (counterpart of
``openwakeword_tpu.train_cli``).

Mirrors the reference's ``python train.py --training_config cfg.yml`` flow
(reference train.py:596-910): synthetic TTS clip generation (through the
external piper-sample-generator), student distillation, augmentation ->
feature memmaps, the auto-trained classifier head, written as a native
``.npz``, and its export as ``.onnx`` and ``.tflite``. Every stage is
resumable: clip generation skips when >= 95% of the target count exists;
distillation skips when the student checkpoint exists and features are only
recomputed with --overwrite.

The config key ``device`` (default "cuda") places distillation, the
augmentation, the feature pre-compute and the trainer; "cuda" raises
without CUDA.

Usage:
    python -m openwakeword_tpu_torch.train_cli --training_config my_model.yml \\
        --augment_clips --train_model --export_onnx

The stages are also functions (``prepare``, ``generate_clips``,
``distill_stage``, ``augment_stage``, ``train_stage``, ``export_stage``)
that take the config as a dict, for hosts without pyyaml.
"""

import argparse
import logging
import os
import random
import sys
import uuid
import wave
from pathlib import Path

import numpy as np

from openwakeword_tpu_torch.data import augment_clips, generate_adversarial_texts, mmap_batch_generator
from openwakeword_tpu_torch.features import compute_features_from_generator
from openwakeword_tpu_torch.training.trainer import HeadTrainer

def _load_config(path):
    import yaml
    with open(path, "r") as f:
        return yaml.safe_load(f.read())


def _generate_clip_set(generate_samples, texts, n_target, output_dir, batch_size,
                       noise_scales, length_scales=(0.75, 1.0, 1.25)):
    os.makedirs(output_dir, exist_ok=True)
    n_current = len(os.listdir(output_dir))
    if n_current > 0.95 * n_target:
        logging.warning("Skipping clip generation for %s: ~%d already exist",
                        output_dir, n_target)
        return
    generate_samples(
        text=texts, max_samples=n_target - n_current, batch_size=batch_size,
        noise_scales=list(noise_scales), noise_scale_ws=list(noise_scales),
        length_scales=list(length_scales), output_dir=output_dir,
        auto_reduce_batch_size=True,
        file_names=[uuid.uuid4().hex + ".wav" for _ in range(n_target)])


def prepare(config: dict) -> dict:
    """Resolve the config in place (output dir, seed, embedding frontend,
    device, the auto-sized ``total_length``) and return the paths the stages
    use. Seeds numpy's and Python's global streams when ``seed`` is set."""
    config["output_dir"] = os.path.abspath(config["output_dir"])
    # `embedding: student` trains the head on the student frontend's
    # features, kept in *.student.npy files
    embedding = config.get("embedding", "default")
    if embedding not in ("default", "student"):
        raise ValueError(f"config key 'embedding' must be 'default' or "
                         f"'student', got {embedding!r}")
    config.setdefault("device", "cuda")
    seed = config.get("seed")
    if seed is not None:
        seed = int(seed)
        np.random.seed(seed)
        random.seed(seed)
    model_dir = os.path.join(config["output_dir"], config["model_name"])
    os.makedirs(model_dir, exist_ok=True)
    paths = {"model_dir": model_dir, "seed": seed, "embedding": embedding,
             "feat_suffix": ".student.npy" if embedding == "student" else ".npy"}
    for split in ("positive_train", "positive_test", "negative_train", "negative_test"):
        paths[split] = os.path.join(model_dir, split)

    paths["rir"] = [i.path for j in config.get("rir_paths", []) for i in os.scandir(j)]
    background_paths = []
    dup_rates = config.get("background_paths_duplication_rate", [])
    bg_dirs = config.get("background_paths", [])
    if len(dup_rates) != len(bg_dirs):
        dup_rates = [1] * len(bg_dirs)
    for background_path, duplication_rate in zip(bg_dirs, dup_rates):
        background_paths.extend([i.path for i in os.scandir(background_path)] * duplication_rate)
    paths["background"] = background_paths

    from openwakeword_tpu_torch import registry
    paths["student"] = (config.get("student_checkpoint_path")
                        or registry.FEATURE_MODELS["embedding_student"]["model_path"])
    return paths


def distill_stage(config: dict, paths: dict, overwrite: bool = False) -> None:
    """Distill the student embedding against the installed teacher into
    ``paths["student"]`` (config key ``student_checkpoint_path``, else the
    registry's path), with the generated positive clips mixed into its
    data; skipped when that checkpoint exists unless ``overwrite``."""
    student_path = paths["student"]
    if os.path.exists(student_path) and not overwrite:
        logging.warning("Student checkpoint already exists at %s; skipping "
                        "distillation (use --overwrite to redo)", student_path)
        return
    from openwakeword_tpu_torch.training.distill import distill_default_student
    # the deployment's own speech in the distillation data
    speech_wavs = [str(i) for i in Path(paths["positive_train"]).glob("*.wav")][:256]
    _, report = distill_default_student(
        student_path, speech_wavs=speech_wavs or None,
        steps=int(config.get("distill_steps", 3000)),
        batch_size=int(config.get("distill_batch_size", 256)),
        seed=paths["seed"] if paths["seed"] is not None else 0,
        device=config["device"])
    logging.info("Student distilled (drift report: %s)", report)


def auto_size(config: dict, paths: dict) -> None:
    """Size the training window: median positive duration + 750 ms, at
    least and snapped to 32000 samples (reference train.py:745-758)."""
    positive_clips = [str(i) for i in Path(paths["positive_test"]).glob("*.wav")]
    if positive_clips:
        durations = []
        for _ in range(min(50, len(positive_clips))):
            p = positive_clips[np.random.randint(0, len(positive_clips))]
            with wave.open(p, "rb") as f:
                durations.append(f.getnframes())
        config["total_length"] = int(round(np.median(durations) / 1000) * 1000) + 12000
        if config["total_length"] < 32000 or abs(config["total_length"] - 32000) <= 4000:
            config["total_length"] = 32000
    else:
        config.setdefault("total_length", 32000)


def generate_clips(config: dict, paths: dict) -> None:
    """Synthetic positive and adversarial clips through the external
    piper-sample-generator (config key 'piper_sample_generator_path')."""
    sys.path.insert(0, os.path.abspath(config["piper_sample_generator_path"]))
    try:
        from generate_samples import generate_samples
    except ImportError as e:
        raise ImportError(
            "Synthetic clip generation requires the external piper-sample-generator "
            "repo (config key 'piper_sample_generator_path'). "
            f"Import failed: {e}") from e

    logging.info("Generating positive clips (train/test)...")
    _generate_clip_set(generate_samples, config["target_phrase"], config["n_samples"],
                       paths["positive_train"], config["tts_batch_size"], [0.98])
    _generate_clip_set(generate_samples, config["target_phrase"], config["n_samples_val"],
                       paths["positive_test"], config["tts_batch_size"], [1.0])

    logging.info("Generating adversarial negative clips (train/test)...")
    for out_dir, n_target, noise in ((paths["negative_train"], config["n_samples"], [0.98]),
                                     (paths["negative_test"], config["n_samples_val"], [1.0])):
        adversarial_texts = list(config.get("custom_negative_phrases", []))
        for target_phrase in config["target_phrase"]:
            adversarial_texts.extend(generate_adversarial_texts(
                input_text=target_phrase,
                N=n_target // len(config["target_phrase"]),
                include_partial_phrase=1.0,
                include_input_words=0.2))
        _generate_clip_set(generate_samples, adversarial_texts, n_target, out_dir,
                           max(1, config["tts_batch_size"] // 7), noise)


def augment_stage(config: dict, paths: dict, overwrite: bool = False) -> None:
    """Augment each split's clips and pre-compute their features into
    ``<split>_features_{train,test}.npy`` under the model directory."""
    suffix, seed, feature_save_dir = paths["feat_suffix"], paths["seed"], paths["model_dir"]
    split_outputs = ((paths["positive_train"], "positive_features_train" + suffix),
                     (paths["negative_train"], "negative_features_train" + suffix),
                     (paths["positive_test"], "positive_features_test" + suffix),
                     (paths["negative_test"], "negative_features_test" + suffix))
    # features are computed into a .tmp name and renamed when complete, and
    # the skip needs every split: a crash never leaves a partial file that a
    # later run takes for finished features
    all_done = all(os.path.exists(os.path.join(feature_save_dir, name)) for _, name in split_outputs)
    if all_done and not overwrite:
        logging.warning("Features already exist; skipping augmentation "
                        "(use --overwrite to recompute)")
        return
    logging.info("Augmenting clips and computing features...")
    for si, (split_dir, out_name) in enumerate(split_outputs):
        final_path = os.path.join(feature_save_dir, out_name)
        if os.path.exists(final_path) and not overwrite:
            continue
        clips = [str(i) for i in Path(split_dir).glob("*.wav")] * config.get("augmentation_rounds", 1)
        gen = augment_clips(clips, total_length=config["total_length"],
                            batch_size=config.get("augmentation_batch_size", 128),
                            background_clip_paths=paths["background"],
                            RIR_paths=paths["rir"],
                            seed=(seed + si + 1) if seed is not None else 0,
                            device=config["device"])
        tmp_path = final_path + ".tmp.npy"
        compute_features_from_generator(
            gen, n_total=len(clips), clip_duration=config["total_length"],
            output_file=tmp_path, device=config["device"], embedding=paths["embedding"],
            embedding_model_path=(paths["student"] if paths["embedding"] == "student" else ""))
        os.replace(tmp_path, final_path)


def train_stage(config: dict, paths: dict) -> str:
    """Auto-train the head on the pre-computed features; writes
    ``<output_dir>/<model_name>.npz`` and returns its path."""
    suffix, seed, feature_save_dir = paths["feat_suffix"], paths["seed"], paths["model_dir"]
    embedding = paths["embedding"]
    input_shape = np.load(os.path.join(feature_save_dir, "positive_features_test" + suffix),
                          mmap_mode="r").shape[1:]
    trainer = HeadTrainer(n_classes=1, input_shape=input_shape,
                          model_type=config.get("model_type", "dnn"),
                          layer_dim=config.get("layer_size", 128),
                          seconds_per_example=1280 * input_shape[0] / 16000,
                          seed=seed if seed is not None else 0,
                          device=config["device"])

    def reshape_negative(x, n=input_shape[0]):
        """Re-window negative feature arrays whose clip length differs
        from the model's input frames (reference train.py:829-836)."""
        if n != x.shape[1]:
            x = np.vstack(x)
            return np.array([x[i:i + n, :] for i in range(0, x.shape[0] - n, n)])
        return x

    feature_data_files = dict(config.get("feature_data_files", {}))
    if embedding == "student" and (feature_data_files or config.get("false_positive_validation_data_path")):
        logging.warning(
            "embedding: student — the pre-computed feature sets in "
            "'feature_data_files' / 'false_positive_validation_data_path' "
            "must themselves have been computed with the student frontend "
            "(compute_features_from_generator(embedding='student')); "
            "teacher-frontend features would poison training/validation")
    data_transforms = {key: reshape_negative for key in feature_data_files.keys()}
    label_transforms = {}
    for key in ["positive"] + list(feature_data_files.keys()) + ["adversarial_negative"]:
        label_transforms[key] = (lambda x: [1 for _ in x]) if key == "positive" \
            else (lambda x: [0 for _ in x])

    feature_data_files["positive"] = os.path.join(feature_save_dir, "positive_features_train" + suffix)
    feature_data_files["adversarial_negative"] = os.path.join(feature_save_dir, "negative_features_train" + suffix)

    batch_generator = mmap_batch_generator(
        feature_data_files,
        n_per_class=config.get("batch_n_per_class", {}),
        data_transform_funcs=data_transforms,
        label_transform_funcs=label_transforms)

    # validation sets; the FP/hr denominator is the duration of the set
    # supplied (one 80 ms frame per feature row)
    X_val_fp = None
    val_set_hrs = 11.3
    fp_path = config.get("false_positive_validation_data_path")
    if fp_path and os.path.exists(fp_path):
        fp_feats = np.load(fp_path)
        if fp_feats.ndim != 2:
            raise ValueError(
                f"false_positive_validation_data_path must hold a 2-D "
                f"(frames, 96) feature array, got shape {fp_feats.shape}")
        if fp_feats.shape[0] > input_shape[0]:
            # zero-copy stride-1 windows in bounded chunks
            windows = np.lib.stride_tricks.sliding_window_view(
                fp_feats, input_shape[0], axis=0)[:-1].transpose(0, 2, 1)
            chunk = 8192
            X_val_fp = [(windows[i:i + chunk],
                         np.zeros(min(chunk, windows.shape[0] - i), np.float32))
                        for i in range(0, windows.shape[0], chunk)]
            val_set_hrs = fp_feats.shape[0] * 0.08 / 3600.0
        else:
            logging.warning(
                "false-positive validation features are shorter than one "
                "model window (%d <= %d rows); skipping FP validation",
                fp_feats.shape[0], input_shape[0])

    X_val_pos = np.load(os.path.join(feature_save_dir, "positive_features_test" + suffix))
    X_val_neg = np.load(os.path.join(feature_save_dir, "negative_features_test" + suffix))
    labels = np.hstack((np.ones(X_val_pos.shape[0]), np.zeros(X_val_neg.shape[0]))).astype(np.float32)
    X_val = [(np.vstack((X_val_pos, X_val_neg)), labels)]
    if X_val_fp is None:
        # the balanced val set stands in: its duration, not 11.3 h
        val_set_hrs = labels.shape[0] * input_shape[0] * 0.08 / 3600.0

    best_model = trainer.auto_train(
        X_train=batch_generator,
        X_val=X_val,
        false_positive_val_data=X_val_fp or X_val,
        steps=config["steps"],
        max_negative_weight=config.get("max_negative_weight", 1000),
        target_fp_per_hour=config.get("target_false_positives_per_hour", 0.2),
        val_set_hrs=val_set_hrs)

    out = os.path.join(config["output_dir"], config["model_name"] + ".npz")
    trainer.save_model(out, model=best_model, meta={"embedding": embedding})
    logging.info("Training complete; model saved to %s", out)
    return out


def export_stage(config: dict, onnx: bool = True, tflite: bool = False) -> None:
    """Write the trained ``<output_dir>/<model_name>.npz`` head as
    ``.onnx`` and / or ``.tflite`` beside it, its output named after the
    model."""
    from openwakeword_tpu_torch.io.checkpoints import load_checkpoint
    base = os.path.join(config["output_dir"], config["model_name"])
    _, params, _ = load_checkpoint(base + ".npz")
    if onnx:
        from openwakeword_tpu_torch.io.onnx_export import export_head_onnx
        export_head_onnx(params, base + ".onnx", output_name=config["model_name"])
    if tflite:
        # every trainable family exports (dnn/mlp FC chains, rnn through
        # UNIDIRECTIONAL_SEQUENCE_LSTM), as the reference converts any head
        from openwakeword_tpu_torch.io.tflite_export import export_head_tflite
        export_head_tflite(params, base + ".tflite", output_name=config["model_name"])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("--training_config", type=str, required=True,
                        help="Path to the YAML training config (see examples/custom_model.yml)")
    parser.add_argument("--generate_clips", action="store_true",
                        help="Run synthetic TTS data generation (requires piper-sample-generator)")
    parser.add_argument("--augment_clips", action="store_true",
                        help="Run augmentation + feature pre-compute")
    parser.add_argument("--overwrite", action="store_true",
                        help="Recompute features even if they exist")
    parser.add_argument("--distill_student", action="store_true",
                        help="Distill the student embedding against the installed teacher and "
                             "save it to the student checkpoint path (skipped if it exists "
                             "unless --overwrite)")
    parser.add_argument("--train_model", action="store_true",
                        help="Train the classifier head (auto-train schedule)")
    parser.add_argument("--export_onnx", action="store_true",
                        help="Also export the trained model as ONNX")
    parser.add_argument("--convert_to_tflite", action="store_true",
                        help="Also export the trained model as TFLite")
    args = parser.parse_args(argv)

    config = _load_config(args.training_config)
    paths = prepare(config)
    if args.generate_clips:
        generate_clips(config, paths)
    if args.distill_student:
        distill_stage(config, paths, overwrite=args.overwrite)
    auto_size(config, paths)
    if args.augment_clips:
        augment_stage(config, paths, overwrite=args.overwrite)
    if args.train_model:
        train_stage(config, paths)
        if args.export_onnx or args.convert_to_tflite:
            export_stage(config, onnx=args.export_onnx, tflite=args.convert_to_tflite)


if __name__ == "__main__":
    logging.basicConfig(level=logging.INFO)
    main()
