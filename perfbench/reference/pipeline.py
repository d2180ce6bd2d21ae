"""Plain reference of the openWakeWord streaming pipeline, in float32 PyTorch.

It scores whole streams from their raw PCM, with no incremental state: for
each 80 ms step t of a stream the mel ring is rebuilt from every frame up to
that step and the speech-embedding CNN runs over the full 76-row window, the
feature ring over all embeddings so far; the heads, the warm-up zeroing and,
where configured, the spectral noise suppressor and the VAD gate follow the
published streaming contract (openWakeWord v0.6.0 ``utils.AudioFeatures`` and
``Model.predict``):

* each step reads 480 samples of look-back (zeros before the stream starts)
  and its 1280 new samples: 8 STFT frames of 512 at hop 160, power, the
  Slaney mel filterbank (60-3800 Hz), 10 log10(max(mel, 1e-10)), the top_db
  floor of 80 dB under the step's peak, then x / 10 + 2. A stream's first
  step keeps only its frames 3..7 (the first three read the zero look-back);
* the mel ring starts as 76 rows of ones, the feature ring as the last 34
  embeddings of 4 s of uniform noise in [-1000, 1000) drawn by
  ``numpy.random.default_rng(ring_seed)`` (upstream seeds it the same way);
* scores of a stream's first 5 steps read 0;
* noise suppression (when on) runs on the PCM before the mel frontend,
  frame by 160-sample frame; the VAD hears the raw PCM, two 640-sample calls
  a step, and zeroes every score unless its score 0.4-0.56 s back (steps
  t-6 .. t-4) reaches the threshold.

Weights come in the checkpoint layout (HWIO convs with explicit BatchNorm,
(n_in, n_out) linears) and are applied as they stand: nothing is folded.
Every product is float32 with TF32 off. This module imports nothing of the
program.
"""

from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from perfbench.reference import dsp

SR = 16000
CHUNK = 1280
LOOKBACK = 480
N_FFT, WIN, HOP = 512, 400, 160
N_MELS, FMIN, FMAX = 32, 60.0, 3800.0
TOP_DB = 80.0
RING = 76
EMB_DIM = 96
FEATURE_FRAMES = 34          # the longest head's window
WARMUP_STEPS = 5
BN_EPS = 1e-3
LN_EPS = 1e-5
SEED_NOISE_SAMPLES = 64000   # max(4 s, (76 + 8 * 33 + 4) * 160)

# the speech_embedding layer program: ("conv", out, (kh, kw), padding, relu)
# then ("bn",) = BatchNorm + max(max(0.2 x, x), -0.4); ("pool", window, padding)
CNN = ([("padw", 1), ("conv", 24, (3, 3), "valid", True), ("bn",),
        ("conv", 24, (1, 3), "same", False), ("bn",), ("conv", 24, (3, 1), "valid", False), ("bn",),
        ("pool", (2, 2), "valid")]
       + [("conv", 48, (1, 3), "same", False), ("bn",), ("conv", 48, (3, 1), "valid", False), ("bn",)] * 2
       + [("pool", (1, 2), "same")]
       + [("conv", 72, (1, 3), "same", False), ("bn",), ("conv", 72, (3, 1), "valid", False), ("bn",)] * 2
       + [("pool", (2, 2), "valid")]
       + [("conv", 96, (1, 3), "same", False), ("bn",), ("conv", 96, (3, 1), "valid", False), ("bn",)] * 2
       + [("pool", (1, 2), "valid")]
       + [("conv", 96, (1, 3), "same", False), ("bn",), ("conv", 96, (3, 1), "valid", False), ("bn",)] * 2
       + [("pool", (2, 2), "valid"), ("conv", 96, (3, 1), "valid", False)])


def _f32(a, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(a, dtype=np.float32), device=device)


class _Fp32:
    """Full float32 products while inside (TF32 off), restored after."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self.saved


# ---------------------------------------------------------------- frontend

def mel_db(x: torch.Tensor) -> torch.Tensor:
    """(B, N) raw int16-range audio -> (B, frames, 32) dB, no floor."""
    dev = x.device
    frames = x.unfold(-1, N_FFT, HOP)
    spec = frames @ _f32(dsp.dft_basis(N_FFT, WIN), dev)
    power = spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2
    mel = power @ _f32(dsp.mel_filterbank(SR, N_FFT, N_MELS, FMIN, FMAX), dev)
    return 10.0 * torch.log10(torch.clamp_min(mel, 1e-10))


def stream_windows(pcm: torch.Tensor) -> torch.Tensor:
    """(B, T * 1280) PCM -> (B, T, 76, 32) mel windows, one per step."""
    b, n = pcm.shape
    t = n // CHUNK
    db = mel_db(F.pad(pcm, (LOOKBACK, 0))).reshape(b, t, 8, N_MELS)
    valid = torch.ones(t, 8, dtype=torch.bool, device=pcm.device)
    valid[0, :3] = False
    peak = torch.where(valid[None, :, :, None], db, torch.full_like(db, -float("inf"))).amax(dim=(2, 3))
    rows = torch.maximum(db, peak[:, :, None, None] - TOP_DB) / 10.0 + 2.0
    rows = torch.cat([torch.ones(b, RING, N_MELS, device=pcm.device), rows[:, 0, 3:],
                      rows[:, 1:].reshape(b, -1, N_MELS)], dim=1)
    return rows[:, 5:].unfold(1, RING, 8).permute(0, 1, 3, 2)[:, :t]


def clip_windows(x: torch.Tensor) -> torch.Tensor:
    """(N,) audio -> every 76-row window at hop 8 of its mel features, the
    top_db floor taken over the whole clip."""
    db = mel_db(x[None])[0]
    rows = torch.maximum(db, db.max() - TOP_DB) / 10.0 + 2.0
    return rows.unfold(0, RING, 8).permute(0, 2, 1)


# ----------------------------------------------------------- embedding CNN

def embed(params: Dict, windows: torch.Tensor, block: int = 2048) -> torch.Tensor:
    """(N, 76, 32) windows -> (N, 96) embeddings, in blocks of ``block``."""
    dev = windows.device
    convs, bns = [], []
    for i in range(sum(1 for op in CNN if op[0] == "conv")):
        convs.append(_f32(np.transpose(params[f"conv_{i}"]["w"], (3, 2, 0, 1)), dev))      # HWIO -> OIHW
    for i in range(sum(1 for op in CNN if op[0] == "bn")):
        bns.append({k: _f32(v, dev) for k, v in params[f"bn_{i}"].items()})
    out = []
    for s in range(0, windows.shape[0], block):
        x = windows[s:s + block, None]
        ci = bi = 0
        for op in CNN:
            if op[0] == "padw":
                x = F.pad(x, (op[1], op[1]))
            elif op[0] == "conv":
                x = F.conv2d(x, convs[ci], padding=op[3])
                if op[4]:
                    x = torch.relu(x)
                ci += 1
            elif op[0] == "bn":
                bn = bns[bi]
                x = ((x - bn["mean"][:, None, None]) / torch.sqrt(bn["var"][:, None, None] + BN_EPS)
                     * bn["gamma"][:, None, None] + bn["beta"][:, None, None])
                x = torch.clamp_min(torch.maximum(0.2 * x, x), -0.4)
                bi += 1
            else:
                window, padding = op[1], op[2]
                if padding == "same" and x.shape[3] % window[1]:
                    x = F.pad(x, (0, window[1] - x.shape[3] % window[1]), value=-float("inf"))
                x = F.max_pool2d(x, window, window)
        out.append(x.reshape(x.shape[0], EMB_DIM))
    return torch.cat(out)


# ------------------------------------------------------------------ heads

def _layer_norm(x, p, dev):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + LN_EPS) * _f32(p["gamma"], dev) + _f32(p["beta"], dev)


def head_scores(head: Dict, x: torch.Tensor) -> torch.Tensor:
    """One head on (N, frames * 96) features -> (N, labels): sigmoid of a
    binary head, the softmax of a multiclass head's ReLU'd logits at the
    classes its mapping names, in key order."""
    dev, p, meta = x.device, head["params"], head["meta"]

    def linear(q, z):
        return z @ _f32(q["w"], dev) + _f32(q["b"], dev)

    if meta["model_type"] == "dnn":
        h = torch.relu(_layer_norm(linear(p["layer1"], x), p["ln1"], dev))
        for i in range(meta["n_blocks"]):
            h = torch.relu(_layer_norm(linear(p[f"block{i}_fc"], h), p[f"block{i}_ln"], dev))
    elif meta["model_type"] == "mlp":
        h = torch.relu(linear(p["layer2"], torch.relu(linear(p["layer1"], x))))
    else:
        raise ValueError(f"no reference for head type {meta['model_type']!r}")
    logits = linear(p["out"], h)
    if meta["n_classes"] == 1:
        return torch.sigmoid(logits)
    probs = torch.softmax(torch.relu(logits), dim=-1)
    return probs[:, [int(k) for k in sorted(head["class_mapping"], key=int)]]


def head_labels(heads: Sequence[Dict]) -> List[str]:
    labels = []
    for h in heads:
        if h["meta"]["n_classes"] == 1:
            labels.append(h["name"])
        else:
            labels += [h["class_mapping"][k] for k in sorted(h["class_mapping"], key=int)]
    return labels


# ------------------------------------------------------- gating add-ons

def noise_suppress(pcm: torch.Tensor) -> torch.Tensor:
    """Spectral noise suppression of (B, N) PCM, N a multiple of 160: 50%
    overlap sqrt-Hann analysis and synthesis over 320 samples, smoothed
    power (0.82), a noise floor that tracks down at once and rises by 1.002
    a frame after 20 warm-up frames (0.7 / 0.3 blend, never above the power,
    during them), the gain (P - 1.4 N) / P clamped to [0.18, 1], overlap-add,
    rounded half to even and clipped to int16."""
    frame, win = 160, 320
    n = np.arange(win)
    window = torch.as_tensor(np.sqrt(0.5 - 0.5 * np.cos(2.0 * np.pi * n / win)), dtype=torch.float32)
    ang = 2.0 * np.pi * np.outer(n, np.arange(frame + 1)) / win
    cos, sin = (torch.as_tensor(f(ang), dtype=torch.float32) for f in (np.cos, np.sin))
    cos_t, sin_t = cos.t().contiguous(), sin.t().contiguous()
    wk = torch.full((frame + 1,), 2.0)
    wk[0] = wk[-1] = 1.0
    b = pcm.shape[0]
    prev = torch.zeros(b, frame)
    overlap = torch.zeros(b, frame)
    psd = torch.zeros(b, frame + 1)
    noise = torch.full((b, frame + 1), 1e6)
    out = torch.empty_like(pcm)
    for i in range(pcm.shape[1] // frame):
        x = pcm[:, i * frame:(i + 1) * frame]
        buf = torch.cat([prev * window[:frame], x * window[frame:]], dim=1)
        re, im = buf @ cos, -(buf @ sin)
        p = re * re + im * im
        psd = 0.82 * psd + 0.18 * p
        if i < 20:
            noise = torch.minimum(0.7 * noise + 0.3 * psd, psd)
        else:
            noise = torch.where(psd < noise, psd, noise * 1.002)
        g = torch.where(psd > 1e-12, (psd - 1.4 * noise) / psd, torch.zeros_like(psd)).clamp(0.18, 1.0)
        synth = ((re * g * wk) @ cos_t - (im * g * wk) @ sin_t) * (window / win)
        out[:, i * frame:(i + 1) * frame] = torch.clamp(torch.round(synth[:, :frame] + overlap), -32768.0, 32767.0)
        overlap, prev = synth[:, frame:], x
    return out


def vad_scores(params: Dict, pcm: torch.Tensor) -> torch.Tensor:
    """(B, T * 1280) raw PCM -> (B, T) VAD score of each step: the mean of
    two calls on its 640-sample halves / 32767, each over the STFT frames of
    256 at hop 112 it holds (log of the 60-7800 Hz mel power + 1e-6, a ReLU
    projection, one step of a 2-layer LSTM(64) a frame, the carry kept across
    calls), scored by a sigmoid of the last hidden state."""
    basis = torch.as_tensor(dsp.dft_basis(256, 256), dtype=torch.float32)
    melw = torch.as_tensor(dsp.mel_filterbank(SR, 256, 32, 60.0, 7800.0), dtype=torch.float32)
    p = {k: {n: torch.as_tensor(np.asarray(v, dtype=np.float32)) for n, v in d.items()} for k, d in params.items()}
    b, t = pcm.shape[0], pcm.shape[1] // CHUNK
    h = [torch.zeros(b, 64), torch.zeros(b, 64)]
    c = [torch.zeros(b, 64), torch.zeros(b, 64)]
    out = torch.empty(b, t)
    for step in range(t):
        scores = []
        for half in range(2):
            x = pcm[:, step * CHUNK + 640 * half:step * CHUNK + 640 * (half + 1)] / 32767.0
            spec = x.unfold(-1, 256, 112) @ basis
            feats = torch.log((spec[..., 0::2] ** 2 + spec[..., 1::2] ** 2) @ melw + 1e-6)
            z_seq = torch.relu(feats @ p["proj"]["w"] + p["proj"]["b"])
            for f in range(z_seq.shape[1]):
                z = z_seq[:, f]
                for layer in range(2):
                    q = p[f"lstm{layer}"]
                    gates = z @ q["w_ih"] + q["b_ih"] + h[layer] @ q["w_hh"] + q["b_hh"]
                    i, fg, g, o = gates.chunk(4, dim=-1)
                    c[layer] = torch.sigmoid(fg) * c[layer] + torch.sigmoid(i) * torch.tanh(g)
                    h[layer] = torch.sigmoid(o) * torch.tanh(c[layer])
                    z = h[layer]
            scores.append(torch.sigmoid(h[1] @ p["out"]["w"] + p["out"]["b"])[:, 0])
        out[:, step] = (scores[0] + scores[1]) / 2.0
    return out


def gate_readings(vad: torch.Tensor) -> torch.Tensor:
    """(B, T) VAD scores -> (B, T) the largest of steps t-6 .. t-4 (0 where
    none exists), which the gate holds against the threshold."""
    padded = F.pad(vad, (6, 0))
    return torch.stack([padded[:, k:k + vad.shape[1]] for k in range(3)]).amax(dim=0)


# ---------------------------------------------------------------- pipeline

def score_streams(pcm: np.ndarray, embedding: Dict, heads: Sequence[Dict], ring_seed: int,
                  noise_suppression: bool = False, vad: Optional[Dict] = None,
                  device="cpu") -> Dict[str, np.ndarray]:
    """Score B streams from their first sample.

    Args:
        pcm: (B, T * 1280) int16 PCM, each row a stream from its start.
        embedding: the CNN's weights, checkpoint layout.
        heads: [{"name", "meta", "params", "class_mapping"}] in label order.
        ring_seed: the seed of the feature ring's noise clip.
        noise_suppression: run the spectral suppressor before the mel frontend.
        vad: {"params", "threshold"} to gate the scores, or None.
    Returns:
        {"scores": (B, T, L) float32, "ungated": (B, T, L) float32 (the scores
        before the VAD gate), "gate": (B, T) gate readings or None}.
    """
    dev = torch.device(device)
    with torch.no_grad(), _Fp32():
        raw = torch.as_tensor(np.asarray(pcm, dtype=np.float32))
        b, t = raw.shape[0], raw.shape[1] // CHUNK
        audio = noise_suppress(raw) if noise_suppression else raw
        windows = stream_windows(audio.to(dev))                                  # (B, T, 76, 32)
        emb = embed(embedding, windows.reshape(-1, RING, N_MELS)).reshape(b, t, EMB_DIM)
        noise = np.random.default_rng(ring_seed).integers(-1000, 1000, SEED_NOISE_SAMPLES).astype(np.float32)
        seed_ring = embed(embedding, clip_windows(torch.as_tensor(noise, device=dev)))[-FEATURE_FRAMES:]
        feats = torch.cat([seed_ring[None].expand(b, -1, -1), emb], dim=1)      # (B, 34 + T, 96)
        cols = []
        for head in heads:
            f = int(head["meta"]["input_frames"])
            win = feats[:, FEATURE_FRAMES + 1 - f:].unfold(1, f, 1)[:, :t]       # (B, T, 96, f)
            x = win.permute(0, 1, 3, 2).reshape(b * t, f * EMB_DIM)
            cols.append(head_scores(head, x).reshape(b, t, -1))
        scores = torch.cat(cols, dim=-1)
        scores[:, :WARMUP_STEPS] = 0.0
        ungated = scores.cpu().numpy()
        gate = None
        if vad is not None:
            gate = gate_readings(vad_scores(vad["params"], raw))
            scores = torch.where((gate >= vad["threshold"]).to(dev)[:, :, None], scores, torch.zeros_like(scores))
            gate = gate.numpy()
    return {"scores": scores.cpu().numpy(), "ungated": ungated, "gate": gate}
