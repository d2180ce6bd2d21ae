"""Global constants of the PyTorch port: a copy of ``openwakeword_tpu.config``.

The port imports nothing from the JAX package (whose ``__init__`` pulls in
jax), so the framework-free constants are duplicated here verbatim. They
mirror the fixed DSP/model geometry of the reference pipeline (reference
openwakeword/utils.py:163-170 and the conversion notebook). The precision
check at the end is the port's own.
"""

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

# Precision tiers (port only). The port runs every stage in full float32:
# both tiers the JAX engine keeps inside the 1e-3 score budget map here.
# 'high' is a 3-pass bf16 approximation of float32 in JAX, so float32 is at
# least as close to 'highest'. The lower tiers wait for their port.
SUPPORTED_PRECISIONS = ("highest", "high")


def check_precision(precision) -> str:
    """``precision`` if the port runs it, else NotImplementedError."""
    if not isinstance(precision, str) or precision not in SUPPORTED_PRECISIONS:
        raise NotImplementedError(
            f"precision {precision!r} is not ported yet: the port runs 'highest' and 'high' "
            "as float32 (ROADMAP.md, queue 1, slice A: precision tiers)")
    return precision
