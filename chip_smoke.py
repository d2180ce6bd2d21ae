#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``openwakeword_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles ``openwakeword_tpu_torch/csrc/*.cu`` with nvcc for sm_90a;
3. kernel vs plain: the mel kernel against its plain PyTorch version on the
   card, S in {1, 5, 1000, 4096}, max |dB diff| <= 2e-3, plus silence
   (-100 dB); times both at S=4096 with CUDA events;
4. golden: the port's engine on the card against the JAX engine's committed
   scores (tests/fixtures/torch_port_golden.npz), max |dscore| < 1e-3;
5. scale: the bench configuration (all six published heads, default CNN,
   seeded random weights) at 4096 streams, ``predict_frames`` over 50 frames
   twice (the first warms up); scores must be finite, in [0, 1], shaped
   (50, 4096, 11), and the mel kernel must have launched during the timed run.

Then it prints one JSON line describing each kernel and, last, the result
line ``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

MEL_TOL_DB = 2e-3          # the JAX package's own mel tolerance (tests/test_pallas.py)
SCORE_TOL = 1e-3           # the port's score budget against JAX 'highest' (BASELINE.json)
SCALE_STREAMS = 4096
SCALE_FRAMES = 50


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def cuda_ms(fn, n_iter: int = 50, n_warm: int = 5) -> float:
    import torch
    for _ in range(n_warm):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(n_iter):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n_iter


def main():
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from openwakeword_tpu_torch import convert, testing
        from openwakeword_tpu_torch.ops import melspec_cuda
        from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
        from openwakeword_tpu_torch.utils import cuda_build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the root of a checkout")
    if "jax" in sys.modules:
        fail("the port imported jax")

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    # 2. build
    built = cuda_build.load_library()
    print(f"build: {built.path} in {built.build_seconds:.2f} s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    # 3. kernel vs plain on the card
    dev = torch.device("cuda", 0)
    mel, plain = melspec_cuda.melspectrogram_frames, melspec_cuda.melspectrogram_frames_plain
    max_err = 0.0
    for n in (1, 5, 1000, SCALE_STREAMS):
        w = (np.random.default_rng(n).uniform(-1, 1, (n, melspec_cuda.WINDOW)) * 25000).astype(np.float32)
        w[n // 2] = 0.0                                       # one silent stream
        x = torch.from_numpy(w).to(dev)
        got, want = mel(x), plain(x)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        print(f"mel kernel vs plain, S={n}: max |diff| {err:.3e} dB")
        if not err <= MEL_TOL_DB:
            fail(f"mel kernel disagrees with the plain version at S={n}: {err} dB > {MEL_TOL_DB}")
        max_err = max(max_err, err)
    silence = mel(torch.zeros((7, melspec_cuda.WINDOW), device=dev))
    if float((silence + 100.0).abs().max()) > 1e-4:
        fail("silence does not give -100 dB")
    x = torch.from_numpy((np.random.default_rng(0).uniform(-1, 1, (SCALE_STREAMS, melspec_cuda.WINDOW))
                          * 25000).astype(np.float32)).to(dev)
    ms_plain_1 = cuda_ms(lambda: plain(x))
    ms_kernel_1 = cuda_ms(lambda: mel(x))
    ms_kernel_2 = cuda_ms(lambda: mel(x))
    ms_plain_2 = cuda_ms(lambda: plain(x))
    ms_kernel, ms_plain = min(ms_kernel_1, ms_kernel_2), min(ms_plain_1, ms_plain_2)
    print(f"mel at S={SCALE_STREAMS}: kernel {ms_kernel_1:.4f} / {ms_kernel_2:.4f} ms, "
          f"plain {ms_plain_1:.4f} / {ms_plain_2:.4f} ms (plain, kernel, kernel, plain)")

    # 4. golden against the JAX engine's committed scores
    with np.load(testing.FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.golden_inputs(int(fixture["seed"]))
    if inputs["sha256"] != str(fixture["inputs_sha256"]):
        fail("golden inputs do not regenerate bit-exactly with this numpy")
    with tempfile.TemporaryDirectory() as d:
        engine = MultiStreamEngine(wakeword_models=testing.write_head_checkpoints(inputs["heads"], d),
                                   n_streams=testing.GOLDEN_STREAMS, precision="highest", device=dev,
                                   embedding_params=convert.embedding_from_jax(inputs["embedding"]))
    if engine.labels != list(fixture["labels"]):
        fail(f"labels {engine.labels} != golden {list(fixture['labels'])}")
    golden_err = float(np.abs(testing.run_golden(engine, inputs) - fixture["scores"]).max())
    print(f"golden: max |dscore| vs the JAX engine ('highest') = {golden_err:.3e} over "
          f"{fixture['scores'].shape}")
    if not golden_err < SCORE_TOL:
        fail(f"golden scores off by {golden_err} >= {SCORE_TOL}")
    del engine

    # 5. scale: the bench configuration at 4096 streams
    t0 = time.perf_counter()
    engine = MultiStreamEngine(n_streams=SCALE_STREAMS, precision="high", device=dev)
    torch.cuda.synchronize()
    print(f"scale: engine with {len(engine.labels)} labels built in {time.perf_counter() - t0:.2f} s")
    frames = np.random.default_rng(1).integers(-2000, 2000, (SCALE_FRAMES, SCALE_STREAMS, 1280),
                                               dtype=np.int16)
    t0 = time.perf_counter()
    engine.predict_frames(frames)                            # warm-up, includes the prime
    warm_s = time.perf_counter() - t0
    mel.launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    scores = engine.predict_frames(frames)
    wall = time.perf_counter() - t0
    launches = mel.launches
    if scores.shape != (SCALE_FRAMES, SCALE_STREAMS, 11):
        fail(f"scale scores have shape {scores.shape}")
    if not (np.isfinite(scores).all() and scores.min() >= 0.0 and scores.max() <= 1.0):
        fail("scale scores are not finite values in [0, 1]")
    if launches < SCALE_FRAMES:
        fail(f"the mel kernel launched {launches} times in {SCALE_FRAMES} steps")
    rt = SCALE_STREAMS * SCALE_FRAMES * 0.08 / wall
    print(f"scale: {SCALE_FRAMES} frames x {SCALE_STREAMS} streams in {wall:.4f} s "
          f"({wall / SCALE_FRAMES * 1e3:.3f} ms per step; warm-up run {warm_s:.2f} s), "
          f"{rt:.0f} streams in real time, on {card}")

    print(json.dumps({"kernels": [{
        "name": "melspec_frames", "route": "cuda",
        "source": "openwakeword_tpu_torch/csrc/melspec.cu",
        "replaces": "openwakeword_tpu/ops/melspec_pallas.py:73",
        "launches": launches, "max_abs_err": max_err,
        "ms": ms_kernel, "plain_ms": ms_plain}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
