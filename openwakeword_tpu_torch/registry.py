"""Model registry of the PyTorch port (counterpart of ``openwakeword_tpu.registry``).

The pretrained names, their published head architectures and the timer's
class mapping are copied from the JAX package. Checkpoint paths point into
the JAX package's ``resources/models`` directory, which the port reads; its
one writer there is ``utils.download.convert_local_models``, whose default
target is that directory.
"""

import os
import pathlib

_RES = os.path.join(pathlib.Path(__file__).resolve().parent.parent,
                    "openwakeword_tpu", "resources", "models")

FEATURE_MODELS = {
    "embedding": {"model_path": os.path.join(_RES, "embedding_model.npz")},
    # the student embedding (models.embedding_student); made by distillation,
    # no upstream artifact
    "embedding_student": {"model_path": os.path.join(_RES, "embedding_student.npz")},
}

# the bundled VAD is a native vad_net checkpoint, not the released Silero graph
VAD_MODELS = {
    "silero_vad": {"model_path": os.path.join(_RES, "silero_vad.npz")},
}

MODELS = {
    "alexa": {"model_path": os.path.join(_RES, "alexa_v0.1.npz")},
    "hey_mycroft": {"model_path": os.path.join(_RES, "hey_mycroft_v0.1.npz")},
    "hey_jarvis": {"model_path": os.path.join(_RES, "hey_jarvis_v0.1.npz")},
    "hey_rhasspy": {"model_path": os.path.join(_RES, "hey_rhasspy_v0.1.npz")},
    "timer": {"model_path": os.path.join(_RES, "timer_v0.1.npz")},
    "weather": {"model_path": os.path.join(_RES, "weather_v0.1.npz")},
}

model_class_mappings = {
    "timer": {
        "1": "1_minute_timer",
        "2": "5_minute_timer",
        "3": "10_minute_timer",
        "4": "20_minute_timer",
        "5": "30_minute_timer",
        "6": "1_hour_timer",
    }
}

# Architecture metadata for the published heads, used when instantiating a
# named model without its weight artifact.
PRETRAINED_HEAD_SPECS = {
    "alexa_v0.1": {"model_type": "dnn", "input_frames": 16, "n_classes": 1, "layer_dim": 64, "n_blocks": 1},
    "hey_mycroft_v0.1": {"model_type": "dnn", "input_frames": 16, "n_classes": 1, "layer_dim": 64, "n_blocks": 1},
    "hey_jarvis_v0.1": {"model_type": "dnn", "input_frames": 16, "n_classes": 1, "layer_dim": 64, "n_blocks": 1},
    "hey_rhasspy_v0.1": {"model_type": "dnn", "input_frames": 16, "n_classes": 1, "layer_dim": 64, "n_blocks": 1},
    "timer_v0.1": {"model_type": "mlp", "input_frames": 34, "n_classes": 7, "layer_dim": 128},
    "weather_v0.1": {"model_type": "dnn", "input_frames": 16, "n_classes": 1, "layer_dim": 64, "n_blocks": 1},
}


def get_pretrained_model_paths(inference_framework: str = "torch"):
    """Paths of all pretrained wakeword checkpoints."""
    return [m["model_path"] for m in MODELS.values()]


def resolve_wakeword_models(wakeword_models):
    """Resolve model specs (file paths or pretrained names, spaces allowed)
    to (paths, names); empty input selects every pretrained model. Same
    contract as ``openwakeword_tpu.registry.resolve_wakeword_models``."""
    pretrained = get_pretrained_model_paths()
    if not wakeword_models:
        return list(pretrained), list(MODELS.keys())
    paths, names = [], []
    for i in wakeword_models:
        if os.path.exists(i):
            paths.append(i)
            names.append(os.path.splitext(os.path.basename(i))[0])
        else:
            matching = [j for j in pretrained
                        if i.replace(" ", "_") in j.split(os.path.sep)[-1]]
            if not matching:
                raise ValueError(f"Could not find pretrained model for model name '{i}'")
            if len(matching) > 1:
                opts = ", ".join(os.path.basename(m) for m in sorted(matching))
                raise ValueError(f"Model name '{i}' is ambiguous: matches {opts}")
            paths.append(matching[0])
            names.append(i)
    return paths, names
