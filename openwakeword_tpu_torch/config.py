"""Global constants of the PyTorch port: a copy of ``openwakeword_tpu.config``.

The port imports nothing from the JAX package (whose ``__init__`` pulls in
jax), so the framework-free constants are duplicated here verbatim. They
mirror the fixed DSP/model geometry of the reference pipeline (reference
openwakeword/utils.py:163-170 and the conversion notebook). The precision
parser at the end follows the JAX engine's.
"""

from typing import Dict, NamedTuple, Tuple, Union

# Audio
SAMPLE_RATE = 16000          # Hz; the entire pipeline is 16 kHz 16-bit PCM
CHUNK_SAMPLES = 1280         # 80 ms @ 16 kHz -- the atomic streaming frame
# STFT / mel frontend (reference melspectrogram.onnx; torchlibrosa export:
# notebooks/converting_google_speech_embedding_model.ipynb cell 15)
N_FFT = 512
WIN_LENGTH = 400             # 25 ms
HOP_LENGTH = 160             # 10 ms
N_MELS = 32
FMIN = 60.0
FMAX = 3800.0
MEL_AMIN = 1e-10
MEL_REF = 1.0
MEL_TOP_DB = 80.0
# Downstream affine applied to the raw log-mel (reference utils.py:180)
MEL_TRANSFORM_SCALE = 0.1    # spec/10
MEL_TRANSFORM_SHIFT = 2.0    # + 2

# Streaming geometry (reference utils.py:163-170, 387-452)
MEL_LOOKBACK_SAMPLES = 480       # 160*3 STFT look-back for streaming melspec
MELS_PER_CHUNK = CHUNK_SAMPLES // HOP_LENGTH   # 8 new mel frames per 80 ms
EMB_WINDOW_FRAMES = 76           # mel frames per embedding window (775 ms)
EMB_STEP_FRAMES = 8              # embedding window hop (one per 80 ms)
EMB_DIM = 96                     # speech_embedding output dimension
MEL_BUFFER_MAX_FRAMES = 970      # reference melspectrogram_max_len (10*97)
FEATURE_BUFFER_MAX = 120         # reference feature_buffer_max_len (~10 s)
FEATURE_SEED_SECONDS = 4         # feature buffer seeded with 4 s of noise
PREDICTION_BUFFER_MAX = 30       # per-label score history (reference model.py:198)

# Stream-block size for the engine's conv-cache prime branch: the full-window
# CNN's stem activation is (S, 74, 32, 24) f32 — unchunked it needs ~10.6 GB
# of HBM temps at 50k streams (cond branches are allocated up front). 4096
# streams/block keeps the prime's temps under ~1 GB at any pool size.
PRIME_BLOCK_STREAMS = 4096
WARMUP_FRAMES = 5                # scores zeroed for first 5 predictions

# VAD (reference vad.py)
VAD_FRAME_SAMPLES = 480          # 30 ms silero frame
VAD_CALL_FRAME_SAMPLES = 640     # frame size used by VAD.__call__
VAD_BUFFER_MAX = 125             # ~10 s of VAD score history
VAD_STATE_LAYERS = 2
VAD_STATE_DIM = 64
# VAD gate looks at scores 0.4-0.56 s back: buffer[-7:-4] (reference model.py:377)
VAD_GATE_LO = -7
VAD_GATE_HI = -4

# Default head geometry (reference docs/models/alexa.md:11-36)
DEFAULT_HEAD_INPUT_FRAMES = 16   # 1.28 s of embeddings
DEFAULT_HEAD_WIDTH = 64

# Precision tiers (JAX engine :227-298). The port follows the arithmetic the
# tiers run on the TPU. Each TPU kernel's body (the mel kernels, the CNN step
# kernel) takes one of three arithmetics, named by ``kernel_arith``: 'highest'
# is float32 ('fp32'); 'high' is the 3-pass bf16 split ('3pass': each operand
# split into bf16 hi + lo, round-to-nearest-even, the product hi*hi + hi*lo +
# lo*hi with float32 sums, dropping lo*lo); 'fast' and 'bf16' are 1-pass
# ('1pass': each operand rounded to bf16, the products exact, the sums
# float32). So the mel stage at 'high' runs the 3-pass mel kernels. The
# stages that are XLA ops in JAX, not Pallas bodies (the engine's eager CNN
# and the heads), run float32 at 'highest' and 'high' (FFMA, TF32 off) and
# 1-pass at 'fast' and 'bf16'. 'bf16' also stores the >= 2-D float weights
# and the mel ring, feature ring and conv caches in bf16; 'mixed' runs the
# convs of MIXED_FAST_CONVS at 1-pass and every other stage at 'high'; a
# dict {'mel', 'cnn', 'heads'} sets each stage.
MODES = ("highest", "high", "fast", "bf16")
ONE_PASS_MODES = ("fast", "bf16")
THREE_PASS_MODES = ("high",)
ARITHS = ("fp32", "1pass", "3pass")


class Precision(NamedTuple):
    """A parsed ``precision``: ``name`` is the tier's storage behaviour
    ('bf16' stores weights and activation rings in bf16; dicts and 'mixed'
    store as 'high', as in the JAX engine), ``stages`` the mode of 'mel',
    'cnn' and 'heads' (the 'cnn' mode may be a per-conv tuple)."""
    name: str
    stages: Dict[str, Union[str, Tuple[str, ...]]]


def check_precision(precision, embedding: str = "default") -> Precision:
    """Parse the engine's ``precision`` exactly as the JAX engine does,
    accepting and rejecting the same values with the same errors."""
    from openwakeword_tpu_torch.models import embedding as embedding_model   # it imports this module

    def valid_cnn_mode(v):
        # 'cnn' also takes a per-conv sequence of modes, default embedding only
        if isinstance(v, (list, tuple)):
            return (embedding == "default" and len(v) == embedding_model.n_convs()
                    and all(m in MODES[:3] for m in v))
        return v in MODES[:3]

    if isinstance(precision, str) and precision == "mixed":
        if embedding != "default":
            raise ValueError(
                "precision='mixed' is the measured per-conv assignment "
                "for the default embedding CNN; with "
                f"embedding={embedding!r} use 'fast' (recommended "
                "student tier) or a per-stage dict")
        precision = {"cnn": embedding_model.mixed_precision()}
    if isinstance(precision, dict):
        bad = set(precision) - {"mel", "cnn", "heads"}
        if (bad
                or not all(v in MODES[:3] for k, v in precision.items() if k != "cnn")
                or not valid_cnn_mode(precision.get("cnn", "high"))):
            raise ValueError("per-stage precision takes keys mel/cnn/heads "
                             f"with values {MODES[:3]} ('cnn' also takes "
                             "a per-conv sequence of those modes, default "
                             f"embedding only), got {precision!r}")
        stages = {k: precision.get(k, "high") for k in ("mel", "cnn", "heads")}
        if isinstance(stages["cnn"], list):
            stages["cnn"] = tuple(stages["cnn"])
        return Precision("high", stages)
    if isinstance(precision, str) and precision in MODES:
        return Precision(precision, dict.fromkeys(("mel", "cnn", "heads"), precision))
    raise ValueError("precision must be 'highest', 'high', 'mixed', "
                     f"'fast', 'bf16', or a per-stage dict; got "
                     f"{precision!r}")


def one_pass(mode) -> bool:
    """True for the modes whose products are 1-pass bf16."""
    return isinstance(mode, str) and mode in ONE_PASS_MODES


def three_pass(mode) -> bool:
    """True for the modes whose TPU kernel bodies run 3-pass bf16 products."""
    return isinstance(mode, str) and mode in THREE_PASS_MODES


def kernel_arith(mode) -> str:
    """The arithmetic (one of ``ARITHS``) of a TPU kernel body in ``mode``,
    as ``melspec_pallas`` and ``cnn_pallas._dot`` select it."""
    return "1pass" if one_pass(mode) else "3pass" if three_pass(mode) else "fp32"
