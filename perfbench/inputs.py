"""What a run feeds both sides, made from ``--seed``: the weights at the
configuration's shapes and the audio.

Weights are numpy arrays in the checkpoint layout (HWIO convs with their
BatchNorms, (n_in, n_out) linears), small enough to draw on the host. Audio
is drawn on the run's device by a seeded ``torch.Generator`` and copied to
the host once, before any window. The sizes never depend on the seed; only
the values and the order do.
"""

import json
import os
from typing import Dict, List

import numpy as np
import torch

CHUNK = 1280
SR = 16000
OUT_OFFSET = 2.0      # logits by which a head's output favours its negative class

# speech_embedding: (kh, kw, cin, cout) per conv, and the channels of the
# BatchNorm after each conv but the last
CONVS = ([(3, 3, 1, 24), (1, 3, 24, 24), (3, 1, 24, 24), (1, 3, 24, 48), (3, 1, 48, 48), (1, 3, 48, 48),
          (3, 1, 48, 48), (1, 3, 48, 72), (3, 1, 72, 72), (1, 3, 72, 72), (3, 1, 72, 72), (1, 3, 72, 96)]
         + [(3, 1, 96, 96), (1, 3, 96, 96)] * 3 + [(3, 1, 96, 96), (3, 1, 96, 96)])


def seed_rng(seed: int, stream: int) -> np.random.Generator:
    """An independent numpy generator per (seed, purpose)."""
    return np.random.default_rng([int(seed) & 0xFFFFFFFF, int(seed) >> 32, stream])


def embedding_weights(seed: int) -> Dict:
    """He-normal convs and BatchNorms with random statistics, so that folding
    them into the convs is real work."""
    rng = seed_rng(seed, 1)
    out: Dict = {}
    for i, (kh, kw, cin, cout) in enumerate(CONVS):
        out[f"conv_{i}"] = {"w": (rng.standard_normal((kh, kw, cin, cout)) * np.sqrt(2.0 / (kh * kw * cin)))
                            .astype(np.float32)}
        if i < len(CONVS) - 1:
            out[f"bn_{i}"] = {"gamma": rng.uniform(0.8, 1.2, cout).astype(np.float32),
                              "beta": rng.normal(0.0, 0.05, cout).astype(np.float32),
                              "mean": rng.normal(0.0, 0.05, cout).astype(np.float32),
                              "var": rng.uniform(0.8, 1.2, cout).astype(np.float32)}
    return out


def _linear(rng, n_in, n_out, gain=1.0):
    bound = gain / np.sqrt(n_in)
    return {"w": rng.uniform(-bound, bound, (n_in, n_out)).astype(np.float32),
            "b": rng.uniform(-bound, bound, n_out).astype(np.float32)}


def _norm(rng, width):
    return {"gamma": rng.uniform(0.8, 1.2, width).astype(np.float32),
            "beta": rng.normal(0.0, 0.05, width).astype(np.float32)}


def head_weights(seed: int, specs: List[Dict]) -> List[Dict]:
    """[{"name", "meta", "params", "class_mapping"}] per head of the
    configuration, in its order.

    The output layer favours the negative class by ``OUT_OFFSET`` logits (a
    binary head's bias lowered, a multiclass head's class 0 raised), so that
    the scores sit low on this audio, as trained heads' do on audio without
    their wake word, and the server's default threshold sees few activations
    or none. An ``mlp`` head has no normalisation, so its logits scale with
    the embedding's: its output layer is drawn at a quarter of the gain."""
    out = []
    for k, spec in enumerate(specs):
        rng = seed_rng(seed, 100 + k)
        meta = {key: spec[key] for key in ("model_type", "input_frames", "n_classes", "layer_dim", "n_blocks")
                if key in spec}
        meta.setdefault("n_blocks", 1)
        n_in, width = spec["input_frames"] * 96, spec["layer_dim"]
        p = {"layer1": _linear(rng, n_in, width)}
        if spec["model_type"] == "dnn":
            p["ln1"] = _norm(rng, width)
            for i in range(meta["n_blocks"]):
                p[f"block{i}_fc"] = _linear(rng, width, width)
                p[f"block{i}_ln"] = _norm(rng, width)
        else:
            p["layer2"] = _linear(rng, width, width)
        p["out"] = _linear(rng, width, spec["n_classes"], gain=1.0 if spec["model_type"] == "dnn" else 0.25)
        if spec["n_classes"] == 1:
            p["out"]["b"] -= OUT_OFFSET
        else:
            p["out"]["b"][0] += OUT_OFFSET
        out.append({"name": spec["name"], "meta": meta, "params": p,
                    "class_mapping": spec.get("class_mapping")})
    return out


def vad_weights(path: str) -> Dict:
    """The VAD network's arrays from its checkpoint file (``p/<layer>/<leaf>``)."""
    out: Dict = {}
    with np.load(path) as z:
        for key in z.files:
            if key.startswith("p/"):
                _, layer, leaf = key.split("/")
                out.setdefault(layer, {})[leaf] = z[key].astype(np.float32)
    return out


def write_head_files(heads: List[Dict], directory: str) -> List[str]:
    """Each head as a ``<name>.npz`` checkpoint the program loads (flat
    ``p/<path>`` arrays and a JSON ``__meta__``); returns the paths in order."""
    paths = []
    for h in heads:
        arrays = {f"p/{layer}/{leaf}": v for layer, leaves in h["params"].items() for leaf, v in leaves.items()}
        meta = {"kind": "head", "model": h["meta"]}
        if h["class_mapping"]:
            meta["class_mapping"] = h["class_mapping"]
        arrays["__meta__"] = np.array(json.dumps(meta))
        path = os.path.join(directory, f"{h['name']}.npz")
        with open(path, "wb") as f:
            np.savez(f, **arrays)
        paths.append(path)
    return paths


def audio(seed: int, n_streams: int, n_frames: int, device, mix: Dict, salt: int = 0) -> np.ndarray:
    """(n_frames, n_streams, 1280) int16 PCM: each 80 ms frame of each stream
    is silence, low noise or a loud voiced burst (a harmonic tone at the
    stream's pitch over noise), drawn from ``mix``'s shares; bursts last
    ``burst_frames`` frames on average."""
    gen = torch.Generator(device=device)
    gen.manual_seed((int(seed) * 1000003 + salt) % (2 ** 63))
    kinds = torch.tensor([mix["silence"], mix["noise"], mix["burst"]], device=device)
    # a two-state run-length walk: a frame continues its predecessor's kind
    # with probability 1 - 1 / burst_frames, otherwise it draws afresh
    fresh = torch.multinomial(kinds, n_frames * n_streams, replacement=True, generator=gen)
    fresh = fresh.reshape(n_frames, n_streams)
    keep = torch.rand((n_frames, n_streams), generator=gen, device=device) < 1.0 - 1.0 / mix["burst_frames"]
    kind = fresh.clone()
    for t in range(1, n_frames):
        kind[t] = torch.where(keep[t], kind[t - 1], fresh[t])
    level = torch.tensor([0.0, mix["noise_rms"], mix["burst_noise_rms"]], device=device)[kind]
    tone = torch.tensor([0.0, 0.0, 1.0], device=device)[kind] * mix["burst_amplitude"]
    f0 = mix["pitch_hz"][0] + (mix["pitch_hz"][1] - mix["pitch_hz"][0]) * torch.rand(
        n_streams, generator=gen, device=device)
    t_s = torch.arange(n_frames * CHUNK, device=device, dtype=torch.float32).reshape(n_frames, 1, CHUNK) / SR
    out = torch.empty((n_frames, n_streams, CHUNK), dtype=torch.int16, device=device)
    for t in range(n_frames):
        phase = 2.0 * np.pi * f0[:, None] * t_s[t]
        voiced = sum(torch.sin(h * phase) / h for h in range(1, 6))
        noise = torch.randn((n_streams, CHUNK), generator=gen, device=device)
        x = noise * level[t][:, None] + voiced * tone[t][:, None]
        out[t] = torch.clamp(torch.round(x), -32768, 32767).to(torch.int16)
    return out.cpu().numpy()
