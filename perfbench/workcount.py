"""The yardstick's arithmetic: the published peaks of the card and the work
of one stream-frame (one stream advanced by 80 ms), by stage, counted from
the model's shapes and not from any implementation. ``counts()`` recomputes
the numbers that the configuration files freeze; a test holds the files to
it.

Peaks: NVIDIA H100 SXM data sheet, dense, at 700 W. A stage's arithmetic
at the tier ``"high"``: the mel DFT and projection as 3-pass bf16 products
(three tensor-core passes), every other stage float32 outside the tensor
cores.
"""

from typing import Dict

import numpy as np

from perfbench.reference import dsp, pipeline

FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
PEAKS = {"fp32": FP32_FLOPS, "bf16": BF16_FLOPS, "bf16x3": BF16_FLOPS / 3}

FRAMES = 8            # mel frames per step
WINDOW_SAMPLES = 1760  # look-back + chunk a step reads


def mel() -> Dict[str, int]:
    """Per stream-frame: the DFT's multiply-adds (cos and sin over 512
    samples) at the bins any mel filter weighs, the power of those bins and
    the filterbank's non-zero weights, for 8 frames; bytes: the window's
    samples a step's frames read ((8 - 1) * 160 + 512) and the 8 x 32 dB
    values written, float32."""
    melw = dsp.mel_filterbank(pipeline.SR, pipeline.N_FFT, pipeline.N_MELS, pipeline.FMIN, pipeline.FMAX)
    live = int(np.count_nonzero(melw.any(axis=1)))
    nonzero = int(np.count_nonzero(melw.astype(np.float32)))
    per_frame = 2 * 2 * pipeline.N_FFT * live + 3 * live + 2 * nonzero
    samples = (FRAMES - 1) * pipeline.HOP + pipeline.N_FFT
    return {"flops": FRAMES * per_frame, "bytes": 4 * (samples + FRAMES * pipeline.N_MELS),
            "const_values": 2 * pipeline.N_FFT * live + nonzero}


def _cnn_rows(rows_in: int, cached: bool):
    """(rows, width, flops) through the layer program for ``rows_in`` mel
    rows: with ``cached`` a time conv also reads its input's 2 cached rows
    and outputs one row per new row; without, a full valid window."""
    rows, width, cin, flops = rows_in, pipeline.N_MELS, 1, 0
    for op in pipeline.CNN:
        if op[0] == "padw":
            width += 2 * op[1]
        elif op[0] == "conv":
            _, cout, (kh, kw), padding, _ = op
            out_rows = rows if (cached or kh == 1) else rows - kh + 1
            out_w = width if padding == "same" else width - kw + 1
            flops += 2 * out_rows * out_w * cout * kh * kw * cin
            rows, width, cin = out_rows, out_w, cout
        elif op[0] == "pool":
            rows, width = rows // op[1][0], -(-width // op[1][1])
    return rows, width, flops


def cnn() -> Dict[str, int]:
    """Per stream-frame: the incremental step over 8 new mel rows (each time
    conv reads 2 cached rows), and the full 76-row window that a prime
    computes."""
    return {"step_flops": _cnn_rows(FRAMES, True)[2], "window_flops": _cnn_rows(pipeline.RING, False)[2]}


def heads(specs) -> Dict[str, int]:
    """Per stream-frame: every head's linears, 2 operations a weight."""
    total = 0
    for s in specs:
        n_in, w = s["input_frames"] * pipeline.EMB_DIM, s["layer_dim"]
        hidden = s.get("n_blocks", 1) if s["model_type"] == "dnn" else 1
        total += 2 * (n_in * w + hidden * w * w + w * s["n_classes"])
    return {"flops": total}


def noise_suppression() -> Dict[str, int]:
    """Per stream-frame: 8 frames of 160, each two (320 x 161) analysis and
    two (161 x 320) synthesis products."""
    return {"flops": FRAMES * 4 * 2 * 320 * 161}


def vad() -> Dict[str, int]:
    """Per stream-frame: two calls of 4 STFT frames of 256, each frame its
    (256 x 258) DFT, the (129 x 32) filterbank, the (32 x 64) projection and
    two LSTM(64) layers (input and recurrent (64 x 256) products)."""
    per_frame = 2 * (256 * 258 + 129 * 32 + 32 * 64 + 2 * 2 * 64 * 256)
    return {"flops": 2 * 4 * per_frame + 2 * 2 * 64}


def counts(config: Dict) -> Dict[str, Dict[str, int]]:
    """The ``work`` block a configuration file freezes."""
    out = {"mel": mel(), "cnn": cnn(), "heads": heads(config["heads"])}
    if config["engine"].get("enable_noise_suppression"):
        out["noise_suppression"] = noise_suppression()
    if config["engine"].get("vad_threshold", 0) > 0:
        out["vad"] = vad()
    return out


def step_least_seconds(work: Dict, n_streams: int) -> float:
    """The least time of one step of ``n_streams`` streams at the peaks:
    the mel stage at three bf16 passes, the rest at the float32 rate, each
    stage's operations over its peak, summed."""
    t = n_streams * work["mel"]["flops"] / PEAKS["bf16x3"]
    t += n_streams * work["cnn"]["step_flops"] / FP32_FLOPS
    for stage in ("heads", "noise_suppression", "vad"):
        if stage in work:
            t += n_streams * work[stage]["flops"] / FP32_FLOPS
    return t


def mel_launch_least_seconds(work: Dict, n_streams: int) -> float:
    """The least time of one launch of the 3-pass mel kernel over
    ``n_streams`` windows: the larger of three bf16 passes over its
    operations and its bytes (the windows read, the dB written, the hi and
    lo bf16 planes of its constants read once) at the HBM rate."""
    m = work["mel"]
    nbytes = n_streams * m["bytes"] + 4 * m["const_values"]
    return max(n_streams * m["flops"] / PEAKS["bf16x3"], nbytes / HBM_BYTES_PER_S)
