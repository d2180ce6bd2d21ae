#!/usr/bin/env python3
"""GPU smoke run of the PyTorch port (``openwakeword_tpu_torch``) on one card.

    python3 chip_smoke.py

Phases, each of which exits nonzero on failure:

1. device: needs ``torch.cuda.is_available()``; prints the card's name and
   power limit as nvidia-smi reports them;
2. build: compiles ``openwakeword_tpu_torch/csrc/*.cu`` with nvcc for sm_90a,
   one nvcc per source, all at once, and ``native/ingest.cpp`` with g++ into
   ``build/`` (the serving ingest copies);
3. mel kernels vs plain: kernels 1 (direct DFT over the filterbank's live
   bins) and 2 (factored DFT) against their plain PyTorch versions on the
   card (the unpruned 257-bin path), S in {1, 5, 17, 63, 64, 65, 1000, 4095,
   4096} with one silent stream each where S > 1, max |dB diff| <= 2e-3, plus silence
   (-100 dB); times each pair at S=4096 with CUDA events (plain, kernel,
   kernel, plain), kernels 1 and 2 also at S=1, and prints their TFLOP/s
   and share of their one bound (the function's operations and bytes,
   counted once for both), kernel 2's ptxas register and spill lines and one
   fp32 ``torch.matmul`` of its DFT's product shape, (8 S, 512) x (512, 2 x
   the live stage-1 columns), as a yardstick (not the same function: no
   library time); the bf16 variants, which run on the
   tensor cores (K1-1pass and K1-3pass in ``csrc/melspec_mma.cu``, K2-1pass
   and K2-3pass in ``csrc/melspec_factored_mma.cu``), also at S=1, with
   their TFLOP/s, share of the bound and ptxas register and spill lines,
   beside one bf16 ``torch.matmul`` of their DFT's product shape, (8 S, 512)
   x (512, 256), as a yardstick (not the same function: no library time);
4. golden: the port's engine on the card against the JAX engine's committed
   scores (tests/fixtures/torch_port_golden.npz), max |dscore| < 1e-3, with
   ``mel_dft="direct"`` and with ``mel_dft="factored"`` (kernel 2 must
   launch);
5. scale: the bench configuration (all six published heads, default CNN,
   seeded random weights, the default tier 'high') at 4096 streams,
   ``predict_frames`` over 50 frames twice (the first warms up); scores must
   be finite, in [0, 1], shaped (50, 4096, 11), and K1-3pass must have
   launched once per step of the timed run; over both runs K4-high must
   have launched once per prime block of the first step and K3-high once on
   each of the other 99 (the engine's CNN stage at 'high'), and every frame
   of both runs must have gone through the engine's pinned frame ring
   (``staged_frames``; ``feed_waits`` reported on the ``kernels`` line as
   ``engine_feed``). Then the same with
   ``mel_dft="factored"`` (K2-3pass must launch), whose scores must agree
   with the direct run's within 1e-3;
6. CNN kernels vs plain: kernel 4 (prime) and kernel 3 (step) of
   ``ops.cnn_step`` against their plain versions, S in {1, 5, 100, 130,
   4096} (100 and 4096 run the 16-byte-copy variant, 100 with a ragged last
   stream tile; 1, 5 and 130 the 4-byte one), a prime and 4 steps, max |diff|
   <= 1e-4 on embeddings and all 11 caches; at S=5 also against the engine's
   NHWC ``embedding_stream`` step;
7. CNN path at scale: ``CnnStepKernel("highest").prime`` (kernel 4) and 50
   ``CnnStepKernel.step`` calls at S=4096, held against the plain versions;
8. CNN timing at S=4096: kernel 3 vs its plain version vs the engine's NHWC
   eager step, kernel 4 vs its plain version; then one call of each under
   ``torch.profiler`` (two calls per trace, a whole one kept), printed as
   each conv's ms and TFLOP/s; the same for the 1-pass and 3-pass variants
   (K3-bf16 and K4-bf16, K3-high and K4-high, ``csrc/cnn_step_mma.cuh`` on
   the tensor cores), their TFLOP/s counting one pass;
9. Model golden: the port's single-stream ``Model`` on the card with the
   golden weights over ``testing.model_packets()``, against the JAX
   ``Model``'s committed scores (tests/fixtures/torch_serving_golden.npz),
   max |dscore| < 1e-3; kernel 1 must launch once per call that completes a
   steady-state block; times ``Model.predict``;
10. server golden: ``StreamServer(capacity=8)`` with the golden weights
   through ``testing.run_server_golden``'s schedule under ``step()`` and
   under ``step_async()`` + ``drain()``, against the JAX server's committed
   score matrices (max |dscore| < 1e-3) and activation lists (scores within
   1e-3 of the threshold left out), at 'highest'; kernel 1 once per tick;
11. serving at scale: two ``StreamServer(capacity=4096)`` in the bench
   configuration fed the same 25 ticks of ``push_block`` over all slots with
   1% churn per tick, one driven by ``step()``, one by ``step_async()``; the
   score matrices must agree within 1e-6, every score finite in [0, 1],
   K1-3pass (the default tier 'high') once per tick and no other mel
   variant. Prints host ms per tick (ingest + dispatch), wall
   ms per tick for each mode, with and without churn, and
   ``engine.measure_realtime()``;
12. bulk: eight synthetic WAVs of different lengths; ``bulk_predict`` and
   ``bulk_predict_streaming`` must equal ``engine.predict_clips`` on the same
   audio within 1e-5;
13. precision tiers: the bench configuration at 4096 streams x 50 frames at
   'highest' (with each mel DFT), then 'high', 'fast', 'bf16' (with each mel
   DFT) and 'mixed' (twice, printing whether the two runs' scores are
   bit-equal) on the same weights and audio: ms per step, streams in real
   time and max |dscore| against the port's own 'highest' run (direct), which
   must lie in [0, 1e-3] at 'highest' with ``mel_dft="factored"``, in (0,
   1e-3] at 'high' (the score budget) and in (0, 0.02] at the others; scores
   finite in [0, 1]; each run's mel variant (K1 and K2 at 'highest', K1-3pass
   at 'high' and 'mixed', K1-1pass at 'fast' and 'bf16', K2-1pass at 'bf16'
   with ``mel_dft="factored"``) must launch once per step, and no other;
14. gating add-ons (noise suppression, the VAD gate, folded verifiers):
   a. golden: the engine at 'highest' on ``testing.gating_inputs()`` with
      the bundled VAD and two folded verifiers, suppression 'spectral' and
      'mmse', against the JAX engine's committed scores
      (tests/fixtures/torch_gating_golden.npz), max |dscore| < 1e-3; K1 once
      per step; prints the share of rows the gate closed and of verifier
      entries replaced (from runs without the VAD and without both);
   b. Model golden: the ``Model`` with 'mmse' suppression and the VAD over
      ``testing.gating_packets()`` against the JAX ``Model``'s committed
      scores, < 1e-3; the native suppressor (native/ns.cpp) must build and
      agree with the PyTorch one on the card within 1 LSB;
   c. the loaded step at full width: the bench configuration at 'high',
      S=4096, with 'spectral' suppression, the VAD at 0.5 and seeded
      ``(w, b)`` verifiers on two models, over ``testing.voiced_frames``
      (a quarter of the streams carry vowels), 8 warm-up and 50 timed
      frames: exactly 50 K1-3pass launches, scores finite in [0, 1], streams
      0-7 against a ``device="cpu"`` engine (the plain 3-pass mel) within
      1e-3, leaving out entries within 1e-3 of the verifier threshold;
      prints its ms and device operations per step beside the bare bench
      step's and those of each add-on alone, timed in turns (bare, loaded,
      NS, VAD, verifiers, loaded, bare), with each step's five costliest
      device operations; then the bench
      configuration plus an ``rnn`` head, 6 frames, its scores against the
      CPU on streams 0-7 within 1e-3;
15. the student embedding and the ONNX import:
   a. golden: the engine with ``embedding="student"`` at 'highest' (the
      bench heads, S=8) against the JAX engine's committed scores
      (tests/fixtures/torch_student_golden.npz), < 1e-4, K1 once per step;
      then the bench heads on the student at S=4096, 8 warm-up and 50 timed
      frames at 'highest', 'high' and 'fast': exactly one K1, K1-3pass or
      K1-1pass launch per step, scores finite in [0, 1], drift against the
      student's 'highest' in (0, 1e-3] at 'high' and (0, 0.02] at 'fast',
      streams 0-7 against a ``device="cpu"`` engine within 1e-3 (at 'fast'
      within 2 E, E the CPU's own 'fast' distance from its 'highest': two
      1-pass runs flip roundings in other places); prints ms and device
      operations per step;
   b. the committed graphs (tests/fixtures/torch_onnx/) through
      ``io.loaders`` on the card against the JAX package's outputs, < 1e-5:
      a dnn head, a conv graph head and its QDQ twin on seeded windows, the
      Silero-shaped program over 5 calls with its state threaded; the
      ``Model`` with those three ``.onnx`` heads against the JAX ``Model``'s
      committed scores, < 1e-3; ``Model.predict`` timed with the six ``.npz``
      bench heads and with seven ``.onnx`` heads (five copies of the dnn
      head, the two graph heads); the bench step at S=4096 with the Silero
      program as its VAD gate, timed in turns with the bare step (K1-3pass
      once per step each), streams 0-7 against the CPU engine within 1e-3
      (rows whose gate window holds a VAD score within 1e-5 of the
      threshold left out), with ms and device operations per step;
16. the TFLite import:
   a. golden: the committed graphs (tests/fixtures/torch_tflite/) through
      ``io.loaders`` on the card against the JAX package's outputs on
      ``testing.tflite_inputs()``: a bench-width dnn head, an rnn head, a
      depthwise-CNN graph head pinned at batch 1 and its int8 twin in float
      emulation within 1e-5, the int8 twin under ``quantized="exact"`` bit
      for bit (the largest difference printed in output LSBs), the embedding
      within 1e-4; ``testing.int8_programs()`` under ``"exact"`` on the card
      bit-equal to the CPU; the ``Model`` with the four ``.tflite`` heads
      against the JAX ``Model``'s committed scores, < 1e-3, and with the int8
      head under ``"exact"`` within one output LSB + 1e-3;
   b. the bench configuration at 'high', S=4096, with the int8 graph head
      added, under ``quantized_execution="exact"`` and ``"dequant"``, timed
      in turns with the bare step (bare, exact, dequant, dequant, exact,
      bare), 8 warm-up and 50 timed frames each: exactly one K1-3pass launch
      per step, scores finite in [0, 1], streams 0-7 against a
      ``device="cpu"`` engine within 1e-3 (the int8 head's column within one
      output LSB + 1e-3: the embeddings differ by float rounding before they
      are quantized), with ms and device operations per step;
17. training (the slice from WAV clips to a trained and evaluated head), at
   full width (``examples/custom_model.yml``: 2 s clips, augmentation batch
   128, a ``dnn`` head of width 128 on (16, 96) windows):
   a. augmentation: each op of ``ops.augment`` on the card against the port
      on the CPU on the same drawn parameters (16 clips; max |diff| <= 1e-5
      of the peak, pitch shift relative RMS <= 1e-3), then ``data.augment_clips``
      over 128 synthetic utterances with background and RIR files at the
      default probabilities, twice on the card and once on the CPU (the
      draws come from host generators, so the runs agree within relative RMS
      1e-3); prints clips/s;
   b. ``compute_features_from_generator`` on the card over
      ``testing.train_inputs()``' clips with the golden embedding weights
      against the JAX package's features (tests/fixtures/torch_train_golden.npz),
      max |diff| <= 1e-4; then over the augmented clips, timed;
   c. ``HeadTrainer`` on the card from the golden's JAX init over its 40
      batches: the update gate and survivor counts equal to JAX's step for
      step, losses within 1e-4 relative, held-out predictions within 1e-4;
      then 1000 ``train_model`` steps at batch 1024 with ``feed_chunk`` 1
      and 32 (the two heads' predictions within 1e-4, held-out accuracy
      above 0.9); prints steps/s;
   d. ``eval.evaluate_model`` with the trained ``.npz`` head over 16
      synthetic 10 s WAVs (8 negative, 8 positive) through the engine at
      'high': K1-3pass (and no other mel variant) on every engine step;
      prints the real-time factor;
   e. the same files scored with ``use_pallas_melspec=False``: no mel kernel
      launches, scores within 1e-3 of the kernel path's;
18. slice F2 (the exporters, distillation, VAD training, verifier mining):
   a. every artifact of ``testing.export_params()`` exported from card
      tensors on this host, which has no ``onnx`` and no ``flatbuffers``
      package: the twelve ``.onnx`` files must hash as the JAX exporter's
      (tests/fixtures/torch_export_sha256.json); the seven heads, the
      embedding and the mel frontend as ``.tflite`` must read back to their
      source arrays; each export timed; then the bench configuration at
      'high', S=4096, 10 frames, with the ``.npz``, the ``.onnx`` and the
      ``.tflite`` heads: scores within 1e-6 of the ``.npz`` run, one K1-3pass
      launch per step;
   b. distillation at batch 256 against the golden CNN teacher: 3 steps on
      the card and on the CPU from the same init (losses within 1e-4
      relative), then 60 steps (cut from 3000) with ``measure_drift`` over
      8 x 256 windows (steps/s, the drift report, the loss must fall) and
      ``measure_served_score_drift`` with the six bench heads over 20 s of
      noise (K1 launches only);
   c. VAD training at the JAX package's defaults (batch 64, 20-frame
      sequences, 2048 sequences, 600 steps) on 16 synthetic vowels: 3 steps
      on the card and the CPU (losses within 1e-4 relative), steps/s, the
      loss must fall, ``evaluate_vad`` FAR / FRR at 0.5;
   d. verifier mining (``get_reference_clip_features``) through the
      ``Model`` on the card against the CPU, windows within 1e-4, K1
      launches only; the scikit-learn fit is tested on the CPU (tier-1) where
      this host lacks scikit-learn, which ``train_verifier_model`` names;
19. slice G (stream sharding over a ``parallel.mesh.Mesh``, data-parallel
   training) on a 4-entry mesh: cuda:0..3 when the host has four cards,
   else 4 x cuda:0 (the shards share one card; printed):
   a. the bench configuration at 'high', S=4096 (1024 per shard), 10
      frames through ``predict`` and 10 through ``predict_frames``: scores
      within 1e-5 of the unsharded engine on the same weights, finite in
      [0, 1]; K1-3pass launches 4 per step (once per shard) and no other
      variant; every state leaf of each shard holds 1024 rows on its entry's
      device; ``save_state`` from the mesh, ``load_state`` into the
      unsharded engine, one more step: within 1e-5; then the step ms of
      both engines, timed in turns;
   b. two ``StreamServer(capacity=4096)``, on the mesh and not, 50 ticks of
      ``push_block`` with 1% churn, the first 25 through ``step()``, the
      rest through ``step_async()``: scores within 1e-5, equal valid masks
      and activations (scores within 1e-5 of the threshold left out), 4
      K1-3pass launches per tick on the mesh; ms per tick of both;
   c. ``HeadTrainer`` on a 2-entry mesh against one device, batch 1024,
      40 steps: params within 5e-5, the update gate and survivor counts
      equal; steps/s of both, the better of two runs in turns;
   d. ``parallel.multichip.dryrun_multichip(4, "cuda")``: one
      data-parallel step, the sharded step with the VAD gate, the packet
      path, the structural shard check, scores within 1e-5 of the
      unsharded engine, and the weak-scaling walls (the efficiency asserted
      only with one card per entry).
20. the full band: the library rebuilt at ``config.FMAX = 8000`` (254 live
   DFT bins; K1-3pass loads its mel weights after its K loop there), its
   build seconds and K1-1pass/K1-3pass's ptxas lines; all six mel kernels
   held to their plain versions over that range at phase 3's limits at
   S=4096 and S=1 and timed against them at S=4096 beside their bounds at
   that range; the bench step at 'highest' and 'high', S=4096, with each mel
   DFT, the 'high' scores within 1e-3 of 'highest' (its launches join the
   kernels line); then the default library restored.

The 1-pass bf16 variants of the four kernels run beside their fp32 ones.
Phase 3 holds K1-1pass and K2-1pass against their plain versions within
2e-3 dB + 10 log10(1 + 2^-7) (one flipped bf16 rounding of the power), with
at most 1% of the values beyond 2e-3 dB (a skipped rounding point moves most
of them), more than 2e-3 dB from the fp32 kernel, and bit for bit the same
on windows rounded to bf16 beforehand. Phase 6b holds K3-bf16 and K4-bf16
(the tensor-core kernels of ``csrc/cnn_step_mma.cuh`` in 1-pass), each call
fed the plain version's caches, within 2 E + 1e-4, E the plain bf16
version's distance from the plain fp32 one on the same inputs (the kernel
sums its k16 steps in another order, and flipped roundings feed every later
conv), with conv 1's output (the second cache) ONE_PASS_CLOSER times nearer
the plain bf16 version than the plain fp32 one (mean |diff|), and bit for
bit the same on inputs (mel rows and caches) rounded beforehand; phase 7b
runs ``CnnStepKernel(precision="bf16")`` at scale, phase 8 times the
variants.

The 3-pass bf16 variants (``Precision.HIGH``, the default tier 'high') run
beside them too. Phase 3 holds K1-3pass and K2-3pass against their plain
versions within 2e-3 dB, and each must sit at least THREE_PASS_CLOSER times
nearer its plain 3-pass version than the plain fp32 one (mean |diff| over
the frames); phase 6c holds K4-high and K3-high (``CnnStepKernel``'s
default precision), each call fed the plain version's caches, within 1e-4
of each tensor's scale (max |value|) of the plain 3-pass version, with conv
1's output (the second cache) nearer it than the plain fp32 version's by
the same margin; phase 7c runs ``CnnStepKernel(precision="high")`` at
scale, phase 8 times the variants. The 3-pass bound is three times the
1-pass operations at the dense bf16 rate. K3-high and K4-high are also the
engine's CNN stage at 'high' on CUDA: phase 5 counts them in its two engine
runs (a warm-up and a timed run of 50 frames each), and fails unless each
run made ceil(4096 / PRIME_BLOCK_STREAMS) K4-high launches on its one
priming step and one K3-high launch on each of the 99 other steps.

Then it prints one JSON line describing each kernel (its launches on the
main path: phase 5's for K3-high and K4-high, those of the phases that run
the others, its error against its plain version, its time, its plain
version's time and its bound: the larger of the operations over the fp32
peak, or the dense bf16 tensor-core peak for a 1-pass variant (three times
the operations for a 3-pass one), and the bytes over the memory rate, both
counted from this run's inputs), the
card's name and power limit, and last the result line
``{"ok": true, "device": {...}}``. It imports nothing of JAX.
"""

import json
import math
import os
import subprocess
import sys
import tempfile
import time
import wave

import numpy as np

MEL_TOL_DB = 2e-3          # the JAX package's own mel tolerance (tests/test_pallas.py)
SCORE_TOL = 1e-3           # the port's score budget against JAX 'highest' (BASELINE.json)
CNN_TOL = 1e-4             # the JAX CNN kernel tests' tolerance (tests/test_cnn_pallas.py)
SCALE_STREAMS = 4096
SCALE_FRAMES = 50
SYNC_ASYNC_TOL = 1e-6      # step() vs step_async() on one card: the same kernels on the same inputs
BULK_TOL = 1e-5
EMB_BYTES = 96 * 4         # one stream's float32 embedding
SCALE_THRESHOLD = 0.7
MEL_CHECK_STREAMS = (1, 5, 17, 63, 64, 65, 1000, 4095, 4096)
# a 1-pass variant rounds the mel power after a float32 sum: one flipped bf16
# rounding moves a band by at most 2^-7 of itself
MEL_1PASS_TOL_DB = MEL_TOL_DB + 10 * math.log10(1 + 2 ** -7)
# the share of a 1-pass mel variant's dB values allowed beyond MEL_TOL_DB of
# its plain version: both round at the same points, so a value moves that far
# only where a float32 sum in another order lands across a bf16 rounding
# (about 1e-4 of the values with the plain version's sums in float64, on a
# CPU); a variant that skipped the power's rounding would move about 60%
MEL_1PASS_SHARE = 0.01
# a 1-pass tier's max |dscore| against the port's own 'highest': the JAX
# package's bound on 'bf16' scores (tests/test_bf16.py::test_score_drift_bound)
TIER_DRIFT_TOL = 0.02
CNN_CHECK_STREAMS = (1, 5, 100, 130, SCALE_STREAMS)
# a 3-pass variant and its plain version take the same exact products and sum
# them in other orders; the 3-pass and fp32 functions differ by the dropped
# lo * lo terms and lo's rounding, which stand above float32 summation noise
# on the mel frames and on conv 1's output: a 3-pass kernel must sit this many
# times nearer its plain 3-pass version than the plain fp32 one there (mean
# |diff|; see PERF.md for the ratios measured on the card; an fp32 kernel
# would sit nearer the plain fp32 version, a ratio below 1)
THREE_PASS_CLOSER = 1.25
# a 1-pass CNN kernel and its plain version round the same operands and sum
# the exact products in other orders; the 1-pass and fp32 functions differ by
# every operand's rounding (about 2^-9 of it): on conv 1's output, before
# flipped roundings pile up, a 1-pass kernel must sit this many times nearer
# its plain 1-pass version than the plain fp32 one (mean |diff|)
ONE_PASS_CLOSER = 10
TIERS = ("fast", "bf16", "mixed")   # phase 13 runs each after 'highest' and 'high'
# published H100 SXM peaks at 700 W (NVIDIA data sheet): fp32 outside the tensor
# cores, dense bf16 on the tensor cores, and HBM3
FP32_FLOPS = 67e12
BF16_FLOPS = 989e12
HBM_BYTES_PER_S = 3.35e12
# phase 17, training (examples/custom_model.yml: augmentation_batch_size 128, 2 s clips, dnn width 128)
TRAIN_AUG_CLIPS = 128
AUG_CHECK_ROWS = 16        # rows of the per-op card-vs-CPU check
AUG_PEAK_TOL = 1e-5        # max |diff| over the peak, as the CPU tests hold the ops to JAX
PITCH_RMS_TOL = 1e-3       # relative RMS: the vocoder's phase sums (~1e5 rad) amplify FFT and atan2 ulps
TRAIN_LOSS_RTOL = 1e-4
TRAIN_PRED_TOL = 1e-4
TRAIN_SCALE_STEPS = 1000
TRAIN_SCALE_BATCH = 1024
TRAIN_POOL = 32            # distinct batches, cycled
TRAIN_PROFILE_STEPS = 200
EVAL_FILES = 16
EVAL_SECONDS = 10
# phase 18, slice F2 (the exporters, distillation, VAD training, verifier mining)
EXPORT_FRAMES = 10
EXPORT_SCORE_TOL = 1e-6
DISTILL_BATCH = 256        # training/distill.py's default
DISTILL_STEPS = 60         # cut from its 3000 to ~30 s on this host
DISTILL_DRIFT_BATCHES = 8
CHECK_STEPS = 3            # steps run on the card and on the CPU from the same start
CHECK_LOSS_RTOL = 1e-4
VAD_CLIPS = 16
VAD_STEPS = 600            # training/vad.py's default (batch 64, 20 frames, 2048 sequences)
# phase 19, slice G (stream sharding, data-parallel training)
MESH_ENTRIES = 4
SHARD_FRAMES = 10
SHARD_TOL = 1e-5           # streams are independent: a shard scores each row as the whole engine does
SHARD_TICKS = 50
SHARD_THRESHOLD = 0.66     # random heads score noise up to ~0.68: a few activations per tick
DP_ENTRIES = 2
DP_BATCH = 1024
DP_STEPS = 40
DP_PARAM_TOL = 5e-5        # the JAX mesh trainer test's tolerance (tests/test_trainer.py)
# phase 20, the full band: the filterbank up to half the sample rate (254 live DFT bins)
FULL_BAND_FMAX = 8000.0
FULL_BAND_STREAMS = (SCALE_STREAMS, 1)


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


def sandwich(name: str, kernel, plain, n_iter: int = 50):
    """(kernel ms, plain ms): the better of two runs each, timed in the order
    plain, kernel, kernel, plain."""
    p1 = cuda_ms(plain, n_iter)
    k1 = cuda_ms(kernel, n_iter)
    k2 = cuda_ms(kernel, n_iter)
    p2 = cuda_ms(plain, n_iter)
    print(f"{name} at S={SCALE_STREAMS}: kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms "
          f"(plain, kernel, kernel, plain)")
    return min(k1, k2), min(p1, p2)


def max_diff(got, want) -> float:
    return float((got - want).abs().max())


def n_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(flops: float, nbytes: int, peak: float = FP32_FLOPS):
    """(bound ms, what sets it): the least time the card could take for
    ``flops`` operations at ``peak`` per second that read and write
    ``nbytes`` once."""
    t_ops, t_bytes = flops / peak, nbytes / HBM_BYTES_PER_S
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def mel_work(n_streams: int, const_bytes: int = 4, dft: str = "direct"):
    """(fp32 operations, bytes) of the mel frontend's function on
    ``n_streams`` windows by ``dft``: per frame the DFT's multiply-adds over
    its columns, Re and Im over K = 512 (the direct DFT's live bins, cos and
    sin over 512 samples; the factored DFT's live stage-1 columns,
    ``factored_columns()``, over 4 branches x 128 taps, which feed the live
    bins of both power halves and bin 256), the power of the live bins and
    the mel projection's non-zero filterbank weights (the factored
    butterfly's adds, at most 6 per live bin, are left out); of each window
    the samples its 8 frames read, (8 - 1) * 160 + 512, read once, each dB
    value written once, and the DFT's coefficients over those columns and
    the non-zero weights read once at ``const_bytes`` each (4 for fp32 or a
    bf16 hi and lo, 2 for one rounded bf16 plane). At the default range both
    DFTs have 120 columns; at the full band the direct DFT has 254, the
    factored one 128."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec_cuda
    _, bins, _ = melspec_cuda.live_bins()
    cols = melspec_cuda.factored_columns()[1] if dft == "factored" else bins
    nonzero = int(np.count_nonzero(melspec_cuda._kernel_melw("direct").astype(np.float32)))
    per_frame = 2 * 2 * config.N_FFT * cols + 3 * bins + 2 * nonzero
    samples = (melspec_cuda.FRAMES - 1) * config.HOP_LENGTH + config.N_FFT
    io = 4 * n_streams * (samples + melspec_cuda.FRAMES * melspec_cuda.N_MELS)
    return melspec_cuda.FRAMES * n_streams * per_frame, io + const_bytes * (2 * config.N_FFT * cols + nonzero)


# per arithmetic: the passes of the DFT's product and the bytes of each constant
MEL_PASSES = {"fp32": (1, 4), "1pass": (1, 2), "3pass": (3, 4)}


def mel_bounds(n_streams: int) -> dict:
    """Each mel variant's ``bound`` on ``n_streams`` windows, by name: its
    DFT's ``mel_work`` at the fp32 rate, or at the dense bf16 tensor-core
    rate once (1-pass, one rounded constant plane) or three times (3-pass,
    hi and lo planes)."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec_cuda
    out = {}
    for dft in melspec_cuda.DFTS:
        for arith in config.ARITHS:
            passes, const_bytes = MEL_PASSES[arith]
            flops, nbytes = mel_work(n_streams, const_bytes, dft)
            out[melspec_cuda.variant(dft, arith)] = bound(passes * flops, nbytes,
                                                          FP32_FLOPS if arith == "fp32" else BF16_FLOPS)
    return out


def mma_flops(n_streams: int, dft: str = "direct") -> float:
    """Operations of one tensor-core pass of a mel kernel's bf16 variant as
    it runs, on 8 S rows: K1-1pass / K1-3pass, the DFT over the padded bins
    and the mel projection; K2-1pass / K2-3pass, the four branch products
    over the padded stage-1 columns (K = 4 x 128) and the mel projection of
    each power half they form."""
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec_cuda
    if dft == "factored":
        _, _, cols, half1, _ = melspec_cuda.factored_columns()
        per_row = cols * (2 * config.N_FFT + (2 if half1 else 1) * config.N_MELS)
    else:
        per_row = melspec_cuda.mma_bins() * (2 * config.N_FFT + config.N_MELS)
    return 2.0 * melspec_cuda.FRAMES * n_streams * per_row


def ptxas_lines(log: str, kernel: str):
    """ptxas's lines for each entry function whose name holds ``kernel``: the
    entry, then its spill and register lines."""
    lines, keep = [], False
    for line in log.splitlines():
        if "Compiling entry" in line:
            keep = kernel in line
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            lines.append(line.strip())
    return lines


def plain_flops(fn, *args) -> float:
    """Operations of the matrix products ``fn`` runs on ``args``."""
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as counter:
        fn(*args)
    return float(counter.get_total_flops())


def conv_profile(card: str, step, prime, n_streams: int, kernel: str = "conv_layer_kernel",
                 label: str = "") -> None:
    """Each conv's device time in one kernel 3 call (``step``) and one
    kernel 4 call (``prime``) under torch.profiler, printed as one JSON line
    per call with each conv's ms and TFLOP/s. The i-th launch of a call of a
    kernel whose name holds ``kernel`` (the FFMA kernels' template, or
    ``conv_mma_kernel``, the tensor-core one) is conv i: launch order is the key,
    since a template's instantiations may share a name. The operations of
    conv i are its products, 2 * Cout * kh * kw * Cin per output position
    and stream (one pass)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from openwakeword_tpu_torch.ops import cnn_step
    table = cnn_step.conv_table()
    def one_session():
        """The conv launches of each of two calls traced in one session,
        split at the pause between the calls. A trace now and then lacks
        one launch at its start or end, so a filler kernel runs first and
        last, and a call whose trace is whole is kept."""
        filler = torch.zeros(1, device="cuda")
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            filler.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                time.sleep(0.005)
            filler.add_(1.0)
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events()
                           if e.device_type == DeviceType.CUDA and kernel in e.name),
                          key=lambda e: e.time_range.start)
        calls, current = [], []
        for e in launches:
            if current and e.time_range.start - current[-1].time_range.end > 2000:     # us: the pause
                calls.append(current)
                current = []
            current.append(e)
        return calls + [current] if current else calls

    for what, fn, rows in (("step", step, 8), ("prime", prime, 76)):
        fn()
        torch.cuda.synchronize()
        for attempt in range(3):
            calls = one_session()
            whole = [c for c in calls if len(c) == len(table)]
            if whole:
                launches = whole[0]
                break
            print(f"the profiler saw {[len(c) for c in calls]} conv launches in two CNN {what} calls, expected "
                  f"{len(table)} in one (trace {attempt + 1} of 3)")
        else:
            fail(f"the profiler saw no whole CNN {what} call of {len(table)} conv launches in three traces")
        tx, wx, convs = rows, 32, []
        for (kh, kw, cin, cout, ph, pw, _), e in zip(table, launches):
            t_out = tx + (2 if kh > 1 and what == "step" else 0) - kh + 1
            ms = (e.time_range.end - e.time_range.start) / 1e3
            flops = 2 * cout * kh * kw * cin * t_out * wx * n_streams
            convs.append({"ms": round(ms, 5), "tflops": round(flops / ms / 1e9, 2)})
            tx, wx = t_out // ph, wx // pw
        total = sum(c["ms"] for c in convs)
        print(f"CNN {what}{label} per conv at S={n_streams} ({total:.4f} ms of kernels), on {card}: "
              + json.dumps({"call": what + label, "convs": convs}))


def nearer(what: str, got, want, want32, arith: str = "3pass") -> float:
    """mean |got - want32| / mean |got - want| of a bf16 kernel's output
    ``got``, its plain version ``want`` in the same arithmetic ``arith`` and
    the plain fp32 one ``want32`` on the same inputs; fails below
    THREE_PASS_CLOSER (3-pass) or ONE_PASS_CLOSER (1-pass)."""
    closer = ONE_PASS_CLOSER if arith == "1pass" else THREE_PASS_CLOSER
    d = float((got.double() - want.double()).abs().mean())
    d32 = float((got.double() - want32.double()).abs().mean())
    ratio = d32 / d if d > 0 else math.inf
    if not (d32 > 0 and ratio >= closer):
        fail(f"{what}: mean |diff| {d} from the plain {arith} version, {d32} from the plain fp32 one "
             f"(ratio {ratio}, need {closer}): it does not compute the {arith} function")
    return ratio


def mel_check(dft: str, arith: str, n: int, where: str = "") -> tuple:
    """Phase 3's check of one mel variant on ``n`` seeded windows, stream
    n // 2 silent where n > 1: within MEL_TOL_DB of its plain version (MEL_1PASS_TOL_DB
    at 1-pass); a 3-pass variant THREE_PASS_CLOSER times nearer its plain
    3-pass version than the plain fp32 one over the sounding streams; a
    1-pass variant beyond MEL_TOL_DB in at most MEL_1PASS_SHARE of the
    values, more than MEL_TOL_DB from the fp32 kernel and bit for bit the
    same on windows rounded to bf16 beforehand. Fails otherwise; returns
    (max |diff|, the 3-pass ratio or nan)."""
    import torch
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.ops.bf16 import round_bf16
    mel, mel_plain = melspec_cuda.melspectrogram_frames, melspec_cuda.melspectrogram_frames_plain
    name, tol = melspec_cuda.variant(dft, arith), (MEL_1PASS_TOL_DB if arith == "1pass" else MEL_TOL_DB)
    w = (np.random.default_rng(n).uniform(-1, 1, (n, melspec_cuda.WINDOW)) * 25000).astype(np.float32)
    silent = n // 2 if n > 1 else None            # one silent stream beside sounding ones
    if silent is not None:
        w[silent] = 0.0
    x = torch.from_numpy(w).to(torch.device("cuda", 0))
    got, want = mel(x, dft, arith), mel_plain(x, dft, arith)
    torch.cuda.synchronize()
    err, ratio = max_diff(got, want), math.nan
    if arith == "fp32":
        print(f"mel kernel ({name}) vs plain{where}, S={n}: max |diff| {err:.3e} dB (limit {tol:.1e})")
    elif arith == "3pass":
        # it computes the 3-pass function: nearer its plain version than the fp32
        # one, over the sounding streams (a silent one gives -100 dB in each)
        sounding = [i for i in range(n) if i != silent]
        if silent is not None:
            ratio = nearer(f"mel kernel ({name}){where} at S={n}", got[sounding], want[sounding],
                                 mel_plain(x, dft)[sounding])
        print(f"mel kernel ({name}) vs plain{where}, S={n}: max |diff| {err:.3e} dB (limit {tol:.1e}), "
              f"mean |diff| over the sounding streams to the plain fp32 version {ratio:.2f}x that "
              f"to the plain 3-pass one (need {THREE_PASS_CLOSER})")
    else:
        # it rounds at the plain version's points (the share), it is not
        # the fp32 kernel (the gap), and it rounds the windows it stages
        # (the same result on windows rounded beforehand, bit for bit)
        share = float(((got - want).abs() > MEL_TOL_DB).float().mean())
        gap = max_diff(got, mel(x, dft))
        same = bool(torch.equal(mel(round_bf16(x), dft, "1pass"), got))
        print(f"mel kernel ({name}) vs plain{where}, S={n}: max |diff| {err:.3e} dB (limit {tol:.3e}), "
              f"share over {MEL_TOL_DB:.0e} dB {share:.2e} (limit {MEL_1PASS_SHARE}), "
              f"the fp32 kernel's gap {gap:.3e} dB (must exceed {MEL_TOL_DB:.0e}), "
              f"same on rounded windows: {same}")
        if not share <= MEL_1PASS_SHARE:
            fail(f"mel kernel ({name}){where} moves {share:.2%} of the values at S={n} over {MEL_TOL_DB} dB "
                 f"from its plain version: it does not round where the plain version does")
        if n > 1 and not gap > MEL_TOL_DB:
            fail(f"mel kernel ({name}){where} is within {gap} dB of the fp32 kernel at S={n}")
        if not same:
            fail(f"mel kernel ({name}){where} changes when its windows come rounded to bf16 at S={n}: "
                 f"it does not round the samples it stages")
    if not err <= tol:
        fail(f"mel kernel ({name}){where} disagrees with the plain version at S={n}: {err} dB > {tol}")
    return err, ratio


def scaled_err(got, want) -> float:
    """max |got - want| over max |want|, the CNN's 3-pass check (1e-4)."""
    return max_diff(got, want) / max(float(want.abs().max()), 1e-30)


def one_pass_err(got, want, ref32):
    """(|got - want|, E, limit) of a 1-pass CNN variant, E = max |want -
    ref32|, the plain bf16 version's distance from the plain fp32 one on the
    same inputs. Fails unless ``got`` is within 1e-4 + 2 E of the plain bf16
    version (the kernel sums its k16 steps in another order, and flipped
    roundings feed every later conv); and unless, where E > 1e-4, ``got`` is
    at least E / 2 from the fp32 result."""
    err, e = max_diff(got, want), max_diff(want, ref32)
    limit = CNN_TOL + 2 * e
    if not err <= limit:
        fail(f"a 1-pass CNN kernel is {err} from its plain version, over {limit} (E = {e})")
    if e > CNN_TOL and not max_diff(got, ref32) >= e / 2:
        fail(f"a 1-pass CNN kernel's output is the fp32 one ({max_diff(got, ref32)} from it, E = {e})")
    return err, e, limit


def one_pass_checks(what: str, got, want, ref32):
    """``one_pass_err`` over a CNN call's (embedding, caches), each from the
    kernel, the plain bf16 version and the plain fp32 one, and ``nearer`` on
    conv 1's output (the second cache): (max error, max E, largest limit,
    the nearness ratio)."""
    out = [one_pass_err(a, b, c)
           for a, b, c in zip([got[0], *got[1]], [want[0], *want[1]], [ref32[0], *ref32[1]])]
    ratio = nearer(f"{what}, conv 1's output", got[1][1], want[1][1], ref32[1][1], "1pass")
    return tuple(max(o[i] for o in out) for i in range(3)) + (ratio,)


def rounding_invariant(what: str, got, run, inputs) -> None:
    """Fail unless a 1-pass CNN kernel rounds every input it is given: run
    on ``inputs`` rounded to bf16, it must return ``got``'s embedding bit
    for bit, and its caches bit for bit after rounding both (a cache may
    hold an input row as given). The inputs must not be bf16 values already."""
    import torch
    from openwakeword_tpu_torch.ops.bf16 import round_bf16
    if all(torch.equal(t, round_bf16(t)) for t in inputs):
        fail(f"{what}: the rounding check's inputs are bf16 values already")
    emb, caches = run(*[round_bf16(t) for t in inputs])
    if not torch.equal(emb, got[0]):
        fail(f"{what}: the embedding changes when the inputs come rounded to bf16 "
             f"({max_diff(emb, got[0])}): the kernel does not round every input")
    if not all(torch.equal(round_bf16(a), round_bf16(b)) for a, b in zip(caches, got[1])):
        fail(f"{what}: the caches change when the inputs come rounded to bf16")


def cnn_weights():
    """Folded port params from seeded He-normal convs and non-trivial
    BatchNorm statistics."""
    from openwakeword_tpu_torch import convert
    from openwakeword_tpu_torch.models import embedding
    rng = np.random.default_rng(11)
    p = embedding.init_params(rng)
    for k in [k for k in p if k.startswith("bn_")]:
        c = p[k]["gamma"].shape[0]
        p[k] = {"gamma": (0.7 + 0.5 * rng.random(c)).astype(np.float32),
                "beta": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "mean": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "var": (0.8 + 0.4 * rng.random(c)).astype(np.float32)}
    return embedding.fold_batchnorm(convert.embedding_from_jax(p))


def serving(card: str) -> int:
    """Phases 9-12, the serving slice; returns K1-3pass's launches in phase
    11's two runs at 4096 slots (this slice's main path, at the default tier
    'high')."""
    import torch
    from openwakeword_tpu_torch import Model, convert, testing
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.parallel import MultiStreamEngine, StreamServer, bulk_predict
    from openwakeword_tpu_torch.parallel.bulk import bulk_predict_streaming
    dev = torch.device("cuda", 0)
    launches = melspec_cuda.melspectrogram_frames.launches
    with np.load(testing.SERVING_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.golden_inputs(int(fixture["seed"]))
    if inputs["sha256"] != str(fixture["inputs_sha256"]):
        fail("serving golden inputs do not regenerate bit-exactly with this numpy")
    emb = convert.embedding_from_jax(inputs["embedding"])
    head_dir = tempfile.mkdtemp()
    head_paths = testing.write_head_checkpoints(inputs["heads"], head_dir)

    t_serving = time.perf_counter()
    # 9. Model golden
    model = Model(wakeword_models=head_paths, device=dev, embedding_params=emb)
    packets = testing.model_packets()
    launches["direct"] = 0
    t0 = time.perf_counter()
    scores = testing.run_model_golden(model, packets)
    model_s = time.perf_counter() - t0
    k1 = launches["direct"]
    err = float(np.abs(scores - fixture["model_scores"]).max())
    expect = testing.steady_block_calls(packets)
    print(f"model golden: max |dscore| vs the JAX Model {err:.3e} over {scores.shape}, {k1} mel launches "
          f"for {expect} calls with steady-state blocks")
    if not err < SCORE_TOL:
        fail(f"Model golden scores off by {err} >= {SCORE_TOL}")
    if k1 != expect:
        fail(f"the mel kernel launched {k1} times in the Model golden run, expected {expect}")
    frame = np.zeros(1280, np.int16)
    for _ in range(5):
        model.predict(frame)
    t0 = time.perf_counter()
    for _ in range(50):
        model.predict(frame)
    per_call = (time.perf_counter() - t0) / 50
    print(f"model: Model.predict {per_call * 1e3:.3f} ms per 1280-sample call (6 heads, 11 labels; "
          f"golden run {model_s * 1e3 / len(packets):.3f} ms per call over mixed packets), on {card}")
    del model

    # 10. server golden, step() and step_async()
    want = {k[len("server_"):]: v for k, v in fixture.items() if k.startswith("server_")}

    def clear(a):
        return a[np.abs(a[:, 3] - testing.SERVER_THRESHOLD) > SCORE_TOL]
    for mode in ("sync", "async"):
        server = StreamServer(wakeword_models=head_paths, capacity=testing.SERVER_CAPACITY,
                              threshold=testing.SERVER_THRESHOLD, queue_frames=testing.SERVER_QUEUE_FRAMES,
                              precision="highest", device=dev, embedding_params=emb)
        launches["direct"] = 0
        run = testing.run_server_golden(server, mode)
        k1 = launches["direct"]
        err = float(np.abs(run["scores"] - want["scores"]).max())
        g, w = clear(run["activations"]), clear(want["activations"])
        print(f"server golden ({mode}): max |dscore| vs the JAX server {err:.3e} over {run['scores'].shape}, "
              f"{len(run['activations'])} activations (JAX {len(want['activations'])}), {k1} mel launches")
        if not (err < SCORE_TOL and np.array_equal(run["valid"], want["valid"])):
            fail(f"server golden ({mode}) scores off by {err} or valid masks differ")
        if not np.array_equal(g[:, :3], w[:, :3]):
            fail(f"server golden ({mode}) activation lists differ")
        if k1 != testing.SERVER_TICKS:
            fail(f"the mel kernel launched {k1} times in {testing.SERVER_TICKS} server ticks ({mode})")
        del server

    # 11. serving at scale: 4096 slots, step() vs step_async(); the churn runs
    # take TC ticks (each re-primes the whole pool, ~60 ms a tick)
    S, T, TC = SCALE_STREAMS, SCALE_FRAMES, SCALE_FRAMES // 2
    rng = np.random.default_rng(3)
    pcm = rng.integers(-2000, 2000, (T, S, 1280), dtype=np.int16)
    churn = [rng.choice(S, S // 100, replace=False) for _ in range(T)]
    # random heads score noise up to ~0.68; a threshold above that keeps activations sparse, as
    # wake words are in real traffic (the goldens above exercise activation-heavy ticks)
    servers = {m: StreamServer(capacity=S, threshold=SCALE_THRESHOLD, device=dev, warm_compile=True)
               for m in ("sync", "async")}
    for srv in servers.values():
        for _ in range(S):
            srv.add_stream()
    sids = np.arange(S)

    def drive(mode, ticks, with_churn):
        srv = servers[mode]
        tick = srv.step if mode == "sync" else srv.step_async
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for t in ticks:
            if with_churn:
                for sid in churn[t]:
                    srv.remove_stream(int(sid))
                    srv.add_stream()
            srv.push_block(sids, pcm[t])
            tick()
        srv.drain()
        return time.perf_counter() - t0

    results, walls = {}, {}
    for mode in ("sync", "async"):
        with testing.recording(servers[mode]) as recorded:
            for k in launches:
                launches[k] = 0
            walls[mode, "churn"] = drive(mode, range(TC), True)
            used = {k: v for k, v in launches.items() if v}
            if used != {"direct_3pass": TC}:
                fail(f"the servers at the default tier made mel launches {used} in {TC} ticks ({mode}), "
                     f"expected {TC} of direct_3pass")
        results[mode] = np.stack([recorded[f][0] for f in sorted(recorded)])
    k1_scale = 2 * TC
    sa_err = float(np.abs(results["sync"] - results["async"]).max())
    r = results["sync"]
    print(f"serving at scale: step() vs step_async() max |dscore| {sa_err:.3e} over {r.shape}, "
          f"{int((r >= SCALE_THRESHOLD).sum())} activations")
    if r.shape != (TC, S, 11) or not (np.isfinite(r).all() and r.min() >= 0.0 and r.max() <= 1.0):
        fail(f"serving scores at scale are not finite values in [0, 1] of shape {(TC, S, 11)}: {r.shape}")
    if not sa_err <= SYNC_ASYNC_TOL:
        fail(f"step() and step_async() disagree at scale: {sa_err} > {SYNC_ASYNC_TOL}")
    del results, r
    # without churn, in turns sync, async, async, sync
    for i, mode in enumerate(("sync", "async", "async", "sync")):
        walls[mode, i] = drive(mode, range(T), False)
    # host cost of a tick: ingest + dispatch from an idle card
    srv, host, ingest_s = servers["async"], [], []
    for t in range(20):
        srv.drain()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        srv.push_block(sids, pcm[t % T])
        t1 = time.perf_counter()
        srv.step_async()
        host.append(time.perf_counter() - t0)
        ingest_s.append(t1 - t0)
    srv.drain()
    host_ms = 1e3 * float(np.median(host))
    for label, key, ticks in (("with 1% churn", "churn", TC), ("no churn", None, T)):
        for mode in ("sync", "async"):
            wall = walls[mode, key] if key else min(walls[mode, i] for i in range(4) if (mode, i) in walls)
            print(f"serving at scale ({label}, {mode}): {wall / ticks * 1e3:.3f} ms per tick over {ticks} ticks x "
                  f"{S} slots, {S * 0.08 * ticks / wall:.0f} streams in real time, on {card}")
    print(f"serving at scale: host ms per tick (push_block + step_async dispatch from an idle card) "
          f"median {host_ms:.3f} (min {1e3 * min(host):.3f}, max {1e3 * max(host):.3f}; push_block alone "
          f"median {1e3 * float(np.median(ingest_s)):.3f}) over 20 ticks, on {card}")
    m = servers["sync"].engine.measure_realtime()
    print(f"serving at scale: engine.measure_realtime(): {m['per_frame_s'] * 1e3:.3f} ms per frame, "
          f"rt_streams {m['rt_streams']:.0f}, realtime {m['realtime']}, on {card}")
    del servers, pcm

    # 12. bulk against predict_clips
    lengths = [16000, 23456, 8000, 40000, 1300, 31111, 12800, 20000]
    wav_dir = tempfile.mkdtemp()
    wavs, clips = [], []
    for i, n in enumerate(lengths):
        clips.append(np.random.default_rng(50 + i).integers(-6000, 6000, n).astype(np.int16))
        wavs.append(os.path.join(wav_dir, f"clip{i}.wav"))
        with wave.open(wavs[-1], "wb") as f:
            f.setnchannels(1)
            f.setsampwidth(2)
            f.setframerate(16000)
            f.writeframes(clips[-1].tobytes())
    batch = np.zeros((len(clips), max(lengths)), np.int16)
    for i, c in enumerate(clips):
        batch[i, :len(c)] = c
    engine = MultiStreamEngine(n_streams=len(clips), device=dev)
    want = engine.predict_clips(batch)                                 # (T, 8, 11)
    for k in launches:
        launches[k] = 0
    one_shot = bulk_predict(wavs, [], batch_size=len(wavs), device=dev)
    streamed, labels = bulk_predict_streaming(wavs, [], batch_size=len(wavs), segment_seconds=1.0, device=dev)
    used = {k: v for k, v in launches.items() if v}
    if labels != engine.labels or set(used) != {"direct_3pass"}:
        fail(f"bulk labels {labels} or mel launches {used} (expected direct_3pass at the default tier)")
    bulk_err = 0.0
    for i, (w, n) in enumerate(zip(wavs, lengths)):
        t_i = -(-(n + 32000 - 1280) // 1280)
        got = np.array([list(d.values()) for d in one_shot[w]], np.float32)
        if got.shape != (t_i, 11) or streamed[w].shape != (t_i, 11):
            fail(f"bulk output for {w} has shapes {got.shape} / {streamed[w].shape}, expected {(t_i, 11)}")
        bulk_err = max(bulk_err, float(np.abs(got - want[:t_i, i]).max()),
                       float(np.abs(streamed[w] - want[:t_i, i]).max()))
    print(f"bulk: bulk_predict and bulk_predict_streaming vs engine.predict_clips over {len(wavs)} WAVs: "
          f"max |dscore| {bulk_err:.3e}")
    if not bulk_err <= BULK_TOL:
        fail(f"bulk scoring disagrees with predict_clips: {bulk_err} > {BULK_TOL}")
    print(f"serving phases 9-12 took {time.perf_counter() - t_serving:.1f} s")
    return k1_scale


def tiers(card: str) -> dict:
    """Phase 13, the precision tiers at scale; returns the mel kernels'
    launches in the runs that put them on the main path: K1 and K2 at
    'highest', K1-1pass and K2-1pass at 'bf16' (with each mel DFT)."""
    import torch
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    dev = torch.device("cuda", 0)
    launches = melspec_cuda.melspectrogram_frames.launches
    frames = np.random.default_rng(13).integers(-2000, 2000, (SCALE_FRAMES, SCALE_STREAMS, 1280), dtype=np.int16)
    reference, out, mixed = None, {}, []
    runs = [("highest", "direct"), ("highest", "factored"), ("high", "direct")] + [
        (t, "direct") for t in TIERS] + [("mixed", "direct"), ("bf16", "factored")]
    for precision, dft in runs:
        engine = MultiStreamEngine(n_streams=SCALE_STREAMS, precision=precision, mel_dft=dft, device=dev)
        engine.predict_frames(frames[:8])                    # warm-up, includes the prime
        for k in launches:
            launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = engine.predict_frames(frames)
        wall = time.perf_counter() - t0
        used = {k: v for k, v in launches.items() if v}
        want = melspec_cuda.variant(dft, config.kernel_arith(engine._stage_modes["mel"]))
        if used != {want: SCALE_FRAMES}:
            fail(f"tier {precision} ({dft}): mel launches {used}, expected {SCALE_FRAMES} of {want}")
        if scores.shape != (SCALE_FRAMES, SCALE_STREAMS, 11) or not (
                np.isfinite(scores).all() and scores.min() >= 0.0 and scores.max() <= 1.0):
            fail(f"tier {precision} ({dft}): scores are not finite values in [0, 1] of the expected shape")
        limit = SCORE_TOL if precision in ("high", "highest") else TIER_DRIFT_TOL
        if reference is None:
            reference = scores
            drift = 0.0
        elif precision == "highest":
            # the factored DFT in fp32: the same function in another fp32 order
            drift = float(np.abs(scores - reference).max())
            if not drift <= limit:
                fail(f"tier {precision} ({dft}): max |dscore| vs the port's 'highest' (direct) is {drift}, "
                     f"above {limit}")
        else:
            # every tier here runs some stage 1-pass or 3-pass, so it must move the
            # scores: 'high' no further than the score budget, the 1-pass tiers no
            # further than the JAX package's own bound on 'bf16'
            drift = float(np.abs(scores - reference).max())
            if not 0.0 < drift <= limit:
                fail(f"tier {precision} ({dft}): max |dscore| vs the port's 'highest' is {drift}, "
                     f"outside (0, {limit}]")
        if precision in ("highest", "bf16"):
            out[want] = launches[want]
        if precision == "mixed":
            mixed.append(scores)
        print(f"tier {precision} (mel_dft={dft}): {wall / SCALE_FRAMES * 1e3:.3f} ms per step over {SCALE_FRAMES} "
              f"frames x {SCALE_STREAMS} streams, {SCALE_STREAMS * SCALE_FRAMES * 0.08 / wall:.0f} streams in "
              f"real time, {want} launches {launches[want]}, max |dscore| vs the port's 'highest' {drift:.3e} "
              f"(limit {limit}), state {str(engine.state['mel_ring'].dtype).replace('torch.', '')}, on {card}")
        del engine, scores
    # the same tier twice on the same weights and audio, two engines in one process
    print(f"tier mixed: two runs bit-equal: {bool(np.array_equal(mixed[0], mixed[1]))} "
          f"(max |dscore| between them {float(np.abs(mixed[0] - mixed[1]).max()):.3e})")
    return out


def device_ops_per_step(step, n_steps: int = 3, n_top: int = 5) -> tuple:
    """(device operations, their summed ms, the ``n_top`` costliest by name as
    (name, count, ms)) of one call of ``step``: every kernel and copy the
    card ran for it, under torch.profiler. The profiler now and then drops
    some of a trace's events, never adds one, so ``n_steps`` calls are
    traced, split at the pauses between them, and the call with the most
    operations is taken."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
            torch.cuda.synchronize()
            time.sleep(0.02)
    ops = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA), key=lambda e: e.time_range.start)
    calls, last_end = [], None
    for e in ops:
        if last_end is None or e.time_range.start - last_end > 10000:       # us: the pause between calls
            calls.append([])
        calls[-1].append(e)
        last_end = e.time_range.end if last_end is None else max(last_end, e.time_range.end)
    ops = max(calls, key=len, default=[])
    by_name = {}
    for e in ops:
        n, ms = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, ms + (e.time_range.end - e.time_range.start) / 1e3)
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:n_top]
    return len(ops), sum(ms for _, ms in by_name.values()), [(name, n, ms) for name, (n, ms) in top]


def gating(card: str) -> int:
    """Phase 14, the gating add-ons; returns K1-3pass's launches in 14c's
    timed runs of the loaded step (this slice's main path at 'high')."""
    import torch
    from openwakeword_tpu_torch import Model, convert, registry, testing
    from openwakeword_tpu_torch.io.checkpoints import save_checkpoint
    from openwakeword_tpu_torch.models import heads
    from openwakeword_tpu_torch.ns import NoiseSuppression, TorchNoiseSuppression
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    dev = torch.device("cuda", 0)
    launches = melspec_cuda.melspectrogram_frames.launches
    with np.load(testing.GATING_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.gating_inputs(int(fixture["seed"]))
    if inputs["sha256"] != str(fixture["inputs_sha256"]):
        fail("gating golden inputs do not regenerate bit-exactly with this numpy")
    head_paths = testing.write_head_checkpoints(inputs["heads"], tempfile.mkdtemp())
    emb = convert.embedding_from_jax(inputs["embedding"])
    verifiers = testing.gating_verifiers()

    # 14a. engine golden, both suppression profiles
    for profile in ("spectral", "mmse"):
        base_kw = dict(enable_noise_suppression=True, noise_suppression_algorithm=profile,
                       custom_verifier_threshold=testing.GATING_VERIFIER_THRESHOLD)
        runs = {}
        for name, kw in (("full", dict(vad_threshold=testing.GATING_VAD_THRESHOLD, custom_verifier_models=verifiers)),
                         ("no_vad", dict(custom_verifier_models=verifiers)), ("plain", {})):
            engine = MultiStreamEngine(wakeword_models=head_paths, n_streams=testing.GOLDEN_STREAMS,
                                       precision="highest", device=dev, embedding_params=emb, **base_kw, **kw)
            launches["direct"] = 0
            runs[name] = testing.run_golden(engine, inputs)
            if launches["direct"] != 3 * testing.PHASE_FRAMES:
                fail(f"gating golden ({profile}, {name}): K1 launched {launches['direct']} times in "
                     f"{3 * testing.PHASE_FRAMES} steps")
        err = float(np.abs(runs["full"] - fixture[f"scores_{profile}"]).max())
        gated, replaced = testing.gating_masks(runs["full"], runs["no_vad"], runs["plain"])
        cols = [engine.labels.index(n) for n in testing.GATING_VERIFIED]
        same = bool(np.array_equal(gated, fixture[f"gated_{profile}"])
                    and np.array_equal(replaced, fixture[f"replaced_{profile}"]))
        print(f"gating golden ({profile}): max |dscore| vs the JAX engine ('highest') {err:.3e} over "
              f"{runs['full'].shape}; gate closed on {gated.mean():.1%} of the rows, verifiers replaced "
              f"{replaced[..., cols].mean():.1%} of their labels' entries (JAX: {fixture[f'shares_{profile}'][0]:.1%}, "
              f"{fixture[f'shares_{profile}'][2]:.1%}; the same entries: {same}), K1 once per step")
        if not err < SCORE_TOL:
            fail(f"gating golden scores ({profile}) off by {err} >= {SCORE_TOL}")
        del engine

    # 14b. Model golden ('mmse' + VAD), and the native suppressor on this host
    model = Model(wakeword_models=head_paths, device=dev, embedding_params=emb, enable_speex_noise_suppression=True,
                  noise_suppression_algorithm="mmse", vad_threshold=testing.GATING_VAD_THRESHOLD)
    scores = testing.run_model_golden(model, testing.gating_packets())
    err = float(np.abs(scores - fixture["model_scores"]).max())
    print(f"gating Model golden ('mmse', VAD): max |dscore| vs the JAX Model {err:.3e} over {scores.shape}, "
          f"{int(np.any(scores != 0, axis=-1).sum())} calls with the gate open")
    if not err < SCORE_TOL:
        fail(f"gating Model golden scores off by {err} >= {SCORE_TOL}")
    try:
        native = NoiseSuppression()
    except (ImportError, OSError, RuntimeError) as e:
        fail(f"the native noise suppressor (native/ns.cpp) did not build or load: {e}")
    x = np.random.default_rng(140).integers(-8000, 8000, 16000).astype(np.int16)
    lsb = int(np.abs(native.process_frames(x).astype(np.int32)
                     - TorchNoiseSuppression(device=dev).process_frames(x).astype(np.int32)).max())
    print(f"native suppressor built on this host; PyTorch suppressor on the card within {lsb} LSB of it over 1 s")
    if lsb > 1:
        fail(f"the PyTorch suppressor on the card is {lsb} LSB from the native one")
    del model

    # 14c. the loaded step at full width against the bare bench step
    S, W, T = SCALE_STREAMS, 8, SCALE_FRAMES
    frames = testing.voiced_frames(W + T, S, seed=14)
    ver = testing.gating_verifiers(seed=15)
    loaded_kw = dict(enable_noise_suppression=True, vad_threshold=0.5, custom_verifier_models=ver,
                     custom_verifier_threshold=testing.GATING_VERIFIER_THRESHOLD)
    engines = {"bare": MultiStreamEngine(n_streams=S, device=dev),
               "loaded": MultiStreamEngine(n_streams=S, device=dev, **loaded_kw),
               "NS": MultiStreamEngine(n_streams=S, device=dev, enable_noise_suppression=True),
               "VAD": MultiStreamEngine(n_streams=S, device=dev, vad_threshold=0.5),
               "verifiers": MultiStreamEngine(n_streams=S, device=dev, custom_verifier_models=ver,
                                              custom_verifier_threshold=testing.GATING_VERIFIER_THRESHOLD)}
    walls, out = {name: [] for name in engines}, {}
    for name in ("bare", "loaded", "NS", "VAD", "verifiers", "loaded", "bare"):
        engine = engines[name]
        engine.reset()
        warm = engine.predict_frames(frames[:W])                 # includes the prime
        for k in launches:
            launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = engine.predict_frames(frames[W:])
        walls[name].append(time.perf_counter() - t0)
        used = {k: v for k, v in launches.items() if v}
        if used != {"direct_3pass": T}:
            fail(f"the {name} step at 'high' made mel launches {used} in {T} steps, expected {T} of direct_3pass")
        if name not in out:
            out[name] = np.concatenate([warm, scores])
    k1_loaded = len(walls["loaded"]) * T
    loaded = out["loaded"]
    if loaded.shape != (W + T, S, 11) or not (np.isfinite(loaded).all() and loaded.min() >= 0.0
                                                  and loaded.max() <= 1.0):
        fail(f"loaded scores are not finite values in [0, 1] of shape {(W + T, S, 11)}: {loaded.shape}")
    ops = {name: device_ops_per_step(lambda e=engines[name]: e.predict(frames[-1])) for name in engines}
    t0 = time.perf_counter()
    cpu_kw = dict(n_streams=8, device="cpu")
    want = MultiStreamEngine(**cpu_kw, **loaded_kw).predict_frames(frames[:, :8])
    base = MultiStreamEngine(**cpu_kw, enable_noise_suppression=True).predict_frames(frames[:, :8])
    cpu_s = time.perf_counter() - t0
    near = testing.near_verifier_threshold(base, engines["loaded"].labels, testing.GATING_VERIFIED,
                                           testing.GATING_VERIFIER_THRESHOLD)
    err = float(np.abs(loaded[:, :8] - want)[~near].max())
    closed = float((loaded[W:] == 0).all(axis=-1).mean())
    print(f"loaded step vs the CPU engine on streams 0-7 over {W + T} frames: max |dscore| {err:.3e} "
          f"({int(near.sum())} entries within 1e-3 of the verifier threshold left out; CPU runs {cpu_s:.1f} s); "
          f"gate closed on {closed:.1%} of the timed rows")
    if not err < SCORE_TOL:
        fail(f"the loaded step on the card disagrees with the CPU engine: {err} >= {SCORE_TOL}")
    if not (0.0 < closed < 1.0):
        fail(f"the VAD gate closed on {closed:.1%} of the loaded rows: the gate is not exercised")
    what = {"bare": "", "loaded": ", spectral NS + VAD 0.5 + 2 verifiers", "NS": ", spectral NS only",
            "VAD": ", VAD 0.5 only", "verifiers": ", 2 verifiers only"}
    for name in engines:
        ms = 1e3 * min(walls[name]) / T
        n_ops, busy, top = ops[name]
        print(f"{name} step ('high', bench configuration{what[name]}) at S={S}: {ms:.3f} ms per step (best of "
              f"{len(walls[name])} run(s) of {T}: {', '.join(f'{1e3 * w / T:.3f}' for w in walls[name])}), "
              f"{S * 0.08 / (ms / 1e3):.0f} streams in real time, {n_ops} device operations per step ({busy:.3f} ms "
              f"of them; the most in 3 traced steps), on {card}")
        print(f"  costliest device operations ({name}): "
              + "; ".join(f"{n} x {op[:70]} {t:.3f} ms" for op, n, t in top))
    del engines, out, loaded

    # an rnn head beside the bench heads, at full width
    rnn_path = os.path.join(tempfile.mkdtemp(), "rnn_head.npz")
    save_checkpoint(rnn_path, "head", heads.init_params(np.random.default_rng(12), "rnn"))
    models = [*registry.MODELS, rnn_path]
    engine = MultiStreamEngine(wakeword_models=models, n_streams=S, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    got = engine.predict_frames(frames[:6])
    rnn_s = time.perf_counter() - t0
    want = MultiStreamEngine(wakeword_models=models, n_streams=8, device="cpu").predict_frames(frames[:6, :8])
    err = float(np.abs(got[:, :8] - want).max())
    print(f"rnn head: bench configuration + one rnn head at S={S}, 6 frames in {rnn_s:.3f} s (prime included), "
          f"max |dscore| vs the CPU on streams 0-7 {err:.3e}, on {card}")
    if got.shape != (6, S, 12) or not np.isfinite(got).all() or not err < SCORE_TOL:
        fail(f"the rnn head run at S={S} gives shape {got.shape} or is {err} from the CPU")
    return k1_loaded


def student_and_onnx(card: str) -> dict:
    """Phase 15, the student embedding (15a) and the ONNX import (15b);
    returns the mel kernels' launches in the runs that put them on the main
    path: K1, K1-3pass and K1-1pass in the student engines at 'highest',
    'high' and 'fast', K1-3pass in the step with the Silero program."""
    import shutil
    import torch
    from openwakeword_tpu_torch import Model, config, convert, registry, testing
    from openwakeword_tpu_torch.io import loaders
    from openwakeword_tpu_torch.models import heads, silero
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    dev = torch.device("cuda", 0)
    launches = melspec_cuda.melspectrogram_frames.launches
    out = {"direct": 0, "direct_1pass": 0, "direct_3pass": 0}

    def run_counted(engine, frames, want):
        """predict_frames with the mel counts zeroed just before, checked just
        after: exactly one launch of ``want`` per step and no other."""
        for k in launches:
            launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = engine.predict_frames(frames)
        wall = time.perf_counter() - t0
        used = {k: v for k, v in launches.items() if v}
        if used != {want: frames.shape[0]}:
            fail(f"mel launches {used} in {frames.shape[0]} steps, expected one {want} per step")
        out[want] += frames.shape[0]
        return scores, wall

    def check_scores(scores, shape, what):
        if scores.shape != shape or not (np.isfinite(scores).all() and scores.min() >= 0.0
                                         and scores.max() <= 1.0):
            fail(f"{what}: scores are not finite values in [0, 1] of shape {shape}: {scores.shape}")

    # 15a. the student embedding: golden, then the bench heads at S=4096 per tier
    with np.load(testing.STUDENT_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.student_inputs(int(fixture["seed"]))
    if inputs["sha256"] != str(fixture["inputs_sha256"]):
        fail("student golden inputs do not regenerate bit-exactly with this numpy")
    head_paths = testing.write_head_checkpoints(inputs["heads"], tempfile.mkdtemp())
    engine = MultiStreamEngine(wakeword_models=head_paths, n_streams=testing.STUDENT_STREAMS, precision="highest",
                               device=dev, embedding_params=convert.student_from_jax(inputs["embedding"]))
    if engine.embedding != "student":
        fail(f"the engine resolved embedding={engine.embedding!r} from student params")
    scores, _ = run_counted(engine, inputs["pcm"], "direct")
    err = float(np.abs(scores - fixture["scores"]).max())
    print(f"student golden: max |dscore| vs the JAX engine ('highest', student embedding) {err:.3e} over "
          f"{scores.shape}, K1 once per step")
    if not err < 1e-4:
        fail(f"student golden scores off by {err} >= 1e-4")
    del engine

    S, W, T = SCALE_STREAMS, 8, SCALE_FRAMES
    frames = np.random.default_rng(150).integers(-2000, 2000, (W + T, S, 1280), dtype=np.int16)
    reference, walls, ops = None, {}, {}
    for precision, want in (("highest", "direct"), ("high", "direct_3pass"), ("fast", "direct_1pass")):
        # no student checkpoint on disk: the seeded init (seed 42), with a warning
        engine = MultiStreamEngine(n_streams=S, precision=precision, embedding="student", device=dev)
        warm = engine.predict_frames(frames[:W])                 # includes the prime
        scores, wall = run_counted(engine, frames[W:], want)
        scores = np.concatenate([warm, scores])
        check_scores(scores, (W + T, S, 11), f"student '{precision}'")
        if precision == "highest":
            reference, drift, limit = scores, 0.0, 0.0
        else:
            drift = float(np.abs(scores - reference).max())
            limit = SCORE_TOL if precision == "high" else TIER_DRIFT_TOL
            if not 0.0 < drift <= limit:
                fail(f"student '{precision}': max |dscore| vs the student's 'highest' {drift}, outside (0, {limit}]")
        t0 = time.perf_counter()
        cpu = MultiStreamEngine(n_streams=8, precision=precision, embedding="student",
                                device="cpu").predict_frames(frames[:, :8])
        cpu_s = time.perf_counter() - t0
        cpu_err = float(np.abs(scores[:, :8] - cpu).max())
        if precision == "highest":
            cpu_ref, cpu_limit = cpu, SCORE_TOL
        elif config.one_pass(precision):
            # two 1-pass runs that sum in other orders flip roundings that feed
            # the later products: each lies within E of fp32, so within 2 E of
            # each other, E the CPU's own 1-pass distance from its 'highest'
            cpu_limit = max(SCORE_TOL, 2.0 * float(np.abs(cpu - cpu_ref).max()))
        if not cpu_err < cpu_limit:
            fail(f"student '{precision}' on the card vs the CPU engine on streams 0-7: {cpu_err} >= {cpu_limit}")
        n_ops, busy, top = device_ops_per_step(lambda e=engine: e.predict(frames[-1]))
        ms = 1e3 * wall / T
        walls[precision], ops[precision] = ms, n_ops
        print(f"student step '{precision}' (bench heads, student embedding) at S={S}: {ms:.3f} ms per step over "
              f"{T} frames, {S * 0.08 / (ms / 1e3):.0f} streams in real time, {n_ops} device operations per step "
              f"({busy:.3f} ms of them), {want} {T} launches, max |dscore| vs the student's 'highest' {drift:.3e}"
              f"{f' (limit {limit})' if limit else ''}, vs the CPU engine on streams 0-7 {cpu_err:.3e} "
              f"(limit {cpu_limit:.3e}) "
              f"(CPU {cpu_s:.1f} s), state {str(engine.state['conv_caches']['blocks'].dtype).replace('torch.', '')}, "
              f"on {card}")
        print(f"  costliest device operations (student '{precision}'): "
              + "; ".join(f"{n} x {op[:70]} {t:.3f} ms" for op, n, t in top))
        del engine

    # 15b. ONNX: the committed graphs against the JAX goldens
    with np.load(testing.ONNX_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    onnx_in = testing.onnx_inputs(int(fixture["seed"]))
    if not np.array_equal(onnx_in["windows"], fixture["windows"]):
        fail("ONNX golden inputs do not regenerate bit-exactly with this numpy")
    path = {k: os.path.join(testing.ONNX_DIR, f) for k, f in testing.ONNX_FILES.items()}
    windows = torch.from_numpy(onnx_in["windows"]).to(dev)
    for key in ("head", "graph", "qdq"):
        kind, params, _ = loaders.load_model_file(path[key])
        head = convert.head_from_jax(params, dev)
        meta = head.pop("__meta__")
        got = heads.forward(head, windows, meta).cpu().numpy()
        err = float(np.abs(got - fixture[f"scores_{key}"]).max())
        print(f"onnx golden {testing.ONNX_FILES[key]} ({kind}, {meta['model_type']}): max |diff| vs the JAX "
              f"package {err:.3e} over {got.shape}")
        if not err < 1e-5:
            fail(f"{testing.ONNX_FILES[key]} on the card is {err} from the JAX golden (limit 1e-5)")
    params, meta = loaders.load_vad(path["silero"])
    prog = silero.from_meta(meta, params)
    vad_params = convert.vad_from_jax(prog.params, dev)
    got = testing.run_silero(prog.apply, vad_params, onnx_in["audio"], lambda t: t.cpu().numpy(),
                             lambda a: torch.from_numpy(a).to(dev))
    err = max(float(np.abs(a - fixture[n]).max()) for a, n in zip(got, ("silero_scores", "silero_h", "silero_c")))
    print(f"onnx golden {testing.ONNX_FILES['silero']} (Silero program, {testing.SILERO_CALLS} calls with the "
          f"state threaded): max |diff| vs the JAX package {err:.3e} (scores, h, c)")
    if not err < 1e-5:
        fail(f"the Silero program on the card is {err} from the JAX golden (limit 1e-5)")

    # Model with .onnx heads: golden, then Model.predict timed beside the .npz bench heads
    onnx_dir = tempfile.mkdtemp()
    golden_heads = []
    for key, name in (("head", "alexa_onnx"), ("graph", "cnn_graph"), ("qdq", "qdq_graph")):
        golden_heads.append(os.path.join(onnx_dir, f"{name}.onnx"))
        shutil.copy(path[key], golden_heads[-1])
    emb = convert.embedding_from_jax(testing.golden_inputs()["embedding"])
    model = Model(wakeword_models=golden_heads, device=dev, embedding_params=emb)
    scores = testing.run_model_golden(model, testing.model_packets())
    err = float(np.abs(scores - fixture["model_scores"]).max())
    print(f"onnx Model golden (dnn, conv graph and QDQ graph heads from .onnx): max |dscore| vs the JAX Model "
          f"{err:.3e} over {scores.shape}")
    if not err < SCORE_TOL:
        fail(f"the Model with .onnx heads is {err} from the JAX golden (limit {SCORE_TOL})")
    bench_onnx = []
    for name in ("alexa", "hey_mycroft", "hey_jarvis", "hey_rhasspy", "weather"):
        bench_onnx.append(os.path.join(onnx_dir, f"{name}.onnx"))
        shutil.copy(path["head"], bench_onnx[-1])
    models = {".npz bench heads (6)": Model(device=dev, embedding_params=emb),
              ".onnx heads (5 dnn + conv graph + QDQ graph)": Model(
                  wakeword_models=bench_onnx + golden_heads[1:], device=dev, embedding_params=emb)}
    frame = np.zeros(1280, np.int16)
    per_call = {name: [] for name in models}
    for name in list(models) + list(models)[::-1]:
        m = models[name]
        for _ in range(5):
            m.predict(frame)
        t0 = time.perf_counter()
        for _ in range(50):
            m.predict(frame)
        per_call[name].append(1e3 * (time.perf_counter() - t0) / 50)
    for name, m in models.items():
        print(f"onnx Model.predict with {name}: {min(per_call[name]):.3f} ms per 1280-sample call (runs "
              f"{', '.join(f'{v:.3f}' for v in per_call[name])}), {len(m.models)} heads, on {card}")
    del model, models

    # the step with the Silero program as its VAD gate at S=4096, against the bare step
    registry.VAD_MODELS["silero_vad"]["model_path"] = path["silero"]
    gate = 0.5277          # inside the range the seeded Silero-shaped graph scores this audio (0.5274-0.5287)
    vframes = testing.voiced_frames(W + T, S, seed=151)
    engines = {"bare": MultiStreamEngine(n_streams=S, device=dev),
               "silero": MultiStreamEngine(n_streams=S, device=dev, vad_threshold=gate)}
    if not isinstance(getattr(engines["silero"]._vad_apply, "__self__", None), silero.SileroProgram):
        fail("the engine's VAD stage did not load the Silero program")
    walls = {name: [] for name in engines}
    first = {}
    for name in ("bare", "silero", "silero", "bare"):
        engine = engines[name]
        engine.reset()
        warm = engine.predict_frames(vframes[:W])
        scores, wall = run_counted(engine, vframes[W:], "direct_3pass")
        walls[name].append(wall)
        first.setdefault(name, np.concatenate([warm, scores]))
    loaded = first["silero"]
    check_scores(loaded, (W + T, S, 11), "Silero-gated step")
    # the CPU engine step by step, noting the rows whose gate window holds a
    # VAD score within 1e-5 of the threshold (the card may gate them the other way)
    cpu = MultiStreamEngine(n_streams=8, device="cpu", vad_threshold=gate)
    want, near = [], []
    for t in range(W + T):
        want.append(cpu.predict(vframes[t, :8]))
        near.append((np.abs(cpu.state["vad_ring"][:, 0:3].numpy() - gate) < 1e-5).any(axis=-1))
    want, near = np.stack(want), np.stack(near)
    err = float(np.abs(loaded[:, :8] - want)[~near].max())
    closed = float((loaded[W:] == 0).all(axis=-1).mean())
    if not err < SCORE_TOL:
        fail(f"the Silero-gated step on the card vs the CPU engine on streams 0-7: {err} >= {SCORE_TOL}")
    if not 0.0 < closed < 1.0:
        fail(f"the Silero gate closed on {closed:.1%} of the rows: the gate is not exercised")
    print(f"silero step vs the CPU engine on streams 0-7 over {W + T} frames: max |dscore| {err:.3e} "
          f"({int(near.sum())} rows with a VAD score within 1e-5 of the gate left out); gate (threshold {gate}) "
          f"closed on {closed:.1%} of the timed rows")
    for name, engine in engines.items():
        ms = 1e3 * min(walls[name]) / T
        n_ops, busy, top = device_ops_per_step(lambda e=engine: e.predict(vframes[-1]))
        print(f"{name} step ('high', bench configuration{', Silero program as the VAD' if name == 'silero' else ''})"
              f" at S={S}: {ms:.3f} ms per step (runs {', '.join(f'{1e3 * w / T:.3f}' for w in walls[name])}), "
              f"{S * 0.08 / (ms / 1e3):.0f} streams in real time, {n_ops} device operations per step ({busy:.3f} "
              f"ms of them), on {card}")
        print(f"  costliest device operations ({name}): "
              + "; ".join(f"{n} x {op[:70]} {t:.3f} ms" for op, n, t in top))
    return out


def tflite_import(card: str) -> int:
    """Phase 16, the TFLite import (16a goldens, 16b the bench step with the
    int8 graph head at S=4096 in both quantized modes); returns K1-3pass's
    launches in 16b's timed runs."""
    import torch
    from openwakeword_tpu_torch import Model, convert, registry, testing
    from openwakeword_tpu_torch.io import loaders, tflite_graph
    from openwakeword_tpu_torch.models import embedding, heads
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    dev = torch.device("cuda", 0)
    launches = melspec_cuda.melspectrogram_frames.launches
    lsb = 1.0 / 256.0                    # the int8 graph's output step (scale 1/256, zero point -128)
    path = {k: os.path.join(testing.TFLITE_DIR, f) for k, f in testing.TFLITE_FILES.items()}

    # 16a. the committed graphs against the JAX goldens
    with np.load(testing.TFLITE_FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.tflite_inputs(int(fixture["seed"]))
    if inputs["sha256"] != str(fixture["inputs_sha256"]):
        fail("TFLite golden inputs do not regenerate bit-exactly with this numpy")
    windows = torch.from_numpy(inputs["windows"]).to(dev)
    for key, mode in testing.TFLITE_GOLDEN_HEADS:
        kind, params, _ = loaders.load_model_file(path[key], quantized=mode)
        head = convert.head_from_jax(params, dev)
        meta = head.pop("__meta__")
        got = heads.forward(head, windows, meta).cpu().numpy()
        want = fixture[f"scores_{key}_{mode}"]
        err = float(np.abs(got - want).max())
        if mode == "exact":
            print(f"tflite golden {testing.TFLITE_FILES[key]} ('exact', int8 weights "
                  f"{sorted({str(v.dtype).replace('torch.', '') for v in head.values()})}): largest difference "
                  f"from the JAX package {err / lsb:.0f} output LSBs over {got.shape} (bit-equal: "
                  f"{bool(np.array_equal(got, want))})")
            if not np.array_equal(got, want):
                fail(f"{testing.TFLITE_FILES[key]} under 'exact' on the card is not bit-equal to the JAX golden")
        else:
            print(f"tflite golden {testing.TFLITE_FILES[key]} ({kind}, {meta['model_type']}, '{mode}'): max |diff| "
                  f"vs the JAX package {err:.3e} over {got.shape}")
            if not err < 1e-5:
                fail(f"{testing.TFLITE_FILES[key]} on the card is {err} from the JAX golden (limit 1e-5)")
    folded = embedding.ensure_folded(convert.embedding_from_jax(loaders.load_embedding_params(path["embedding"]),
                                                                dev))
    got = embedding.apply_folded(folded, torch.from_numpy(inputs["mels"]).to(dev)).cpu().numpy()
    err = float(np.abs(got - fixture["embeddings"]).max())
    print(f"tflite golden {testing.TFLITE_FILES['embedding']} (embedding): max |diff| vs the JAX package {err:.3e}")
    if not err < 1e-4:
        fail(f"the .tflite embedding on the card is {err} from the JAX golden (limit 1e-4)")
    n_ops = 0
    for name, model, feeds in testing.int8_programs():
        prog = tflite_graph.TfliteProgram(model, quantized="exact")
        outs = [prog.apply({k: torch.from_numpy(np.array(v)).to(d) for k, v in prog.params.items()},
                           {k: torch.from_numpy(v).to(d) for k, v in feeds.items()})
                for d in (dev, torch.device("cpu"))]
        for k in outs[1]:
            if not torch.equal(outs[0][k].cpu(), outs[1][k]):
                fail(f"int8 program {name} under 'exact': the card is not bit-equal to the CPU")
        n_ops += 1
    print(f"tflite int8 programs under 'exact' ({n_ops} one-op graphs, the whole integer set): the card bit-equal "
          "to the CPU")
    model_dir = tempfile.mkdtemp()
    model_heads = testing.tflite_model_heads(model_dir)
    emb = convert.embedding_from_jax(testing.golden_inputs()["embedding"])
    model = Model(wakeword_models=model_heads, device=dev, embedding_params=emb)
    scores = testing.run_model_golden(model, testing.model_packets())
    err = float(np.abs(scores - fixture["model_scores"]).max())
    model = Model(wakeword_models=model_heads[3:], device=dev, embedding_params=emb, quantized_execution="exact")
    exact = testing.run_model_golden(model, testing.model_packets())
    err_exact = float(np.abs(exact - fixture["model_scores_exact"]).max())
    print(f"tflite Model golden (dnn, rnn, graph and int8 graph heads from .tflite): max |dscore| vs the JAX Model "
          f"{err:.3e} over {scores.shape}; the int8 head under 'exact' {err_exact:.3e} "
          f"({err_exact / lsb:.2f} output LSBs, {float((exact == fixture['model_scores_exact']).mean()):.1%} "
          f"bit-equal)")
    if not err < SCORE_TOL:
        fail(f"the Model with .tflite heads is {err} from the JAX golden (limit {SCORE_TOL})")
    if not err_exact <= lsb + SCORE_TOL:
        fail(f"the Model's exact int8 head is {err_exact} from the JAX golden (limit one LSB + {SCORE_TOL})")
    del model

    # 16b. the bench step with the int8 graph head, both modes, against the bare step
    S, W, T = SCALE_STREAMS, 8, SCALE_FRAMES
    frames = np.random.default_rng(160).integers(-2000, 2000, (W + T, S, 1280), dtype=np.int16)
    int8_head = [model_heads[3]]
    engines = {"bare": MultiStreamEngine(n_streams=S, device=dev),
               "exact": MultiStreamEngine(wakeword_models=list(registry.MODELS) + int8_head, n_streams=S,
                                          device=dev, quantized_execution="exact"),
               "dequant": MultiStreamEngine(wakeword_models=list(registry.MODELS) + int8_head,
                                            n_streams=S, device=dev, quantized_execution="dequant")}
    if engines["exact"]._step_params["heads"]["cnn2d_int8"]["t4_conv.w"].dtype != torch.int8:
        fail("the exact engine's int8 graph head does not hold int8 weights")
    walls, first, total = {name: [] for name in engines}, {}, 0
    for name in ("bare", "exact", "dequant", "dequant", "exact", "bare"):
        engine = engines[name]
        engine.reset()
        warm = engine.predict_frames(frames[:W])
        for k in launches:
            launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = engine.predict_frames(frames[W:])
        walls[name].append(time.perf_counter() - t0)
        used = {k: v for k, v in launches.items() if v}
        if used != {"direct_3pass": T}:
            fail(f"tflite step '{name}': mel launches {used} in {T} steps, expected one direct_3pass per step")
        total += T
        first.setdefault(name, np.concatenate([warm, scores]))
    for name, scores in first.items():
        n_labels = 11 if name == "bare" else 12
        if scores.shape != (W + T, S, n_labels) or not (np.isfinite(scores).all() and scores.min() >= 0.0
                                                        and scores.max() <= 1.0):
            fail(f"tflite step '{name}': scores are not finite values in [0, 1] of shape {(W + T, S, n_labels)}")
    for name in ("exact", "dequant"):
        cpu = MultiStreamEngine(wakeword_models=list(registry.MODELS) + int8_head, n_streams=8,
                                device="cpu", quantized_execution=name).predict_frames(frames[:, :8])
        diff = np.abs(first[name][:, :8] - cpu)
        err, err_int8 = float(diff[..., :11].max()), float(diff[..., 11].max())
        limit = lsb + SCORE_TOL if name == "exact" else SCORE_TOL
        print(f"tflite step '{name}' vs the CPU engine on streams 0-7 over {W + T} frames: max |dscore| {err:.3e} "
              f"on the bench heads, {err_int8:.3e} on the int8 graph head (limit {limit:.3e}; "
              f"{float((diff[..., 11] == 0).mean()):.1%} of its scores bit-equal); the int8 head's scores span "
              f"[{float(first[name][..., 11].min()):.4f}, {float(first[name][..., 11].max()):.4f}]")
        if not (err < SCORE_TOL and err_int8 <= limit):
            fail(f"tflite step '{name}' on the card vs the CPU engine: {err} / {err_int8} beyond {limit}")
    if np.abs(first["exact"][..., 11] / lsb - np.round(first["exact"][..., 11] / lsb)).max() > 1e-3:
        fail("the exact int8 head's scores left its output grid")
    for name, engine in engines.items():
        ms = 1e3 * min(walls[name]) / T
        n_ops, busy, top = device_ops_per_step(lambda e=engine: e.predict(frames[-1]), n_top=10)
        label = {"bare": "the bench heads", "exact": "+ the int8 graph head, 'exact'",
                 "dequant": "+ the int8 graph head, 'dequant'"}[name]
        print(f"tflite step {name} ('high', {label}) at S={S}: {ms:.3f} ms per step (runs "
              f"{', '.join(f'{1e3 * w / T:.3f}' for w in walls[name])}), {S * 0.08 / (ms / 1e3):.0f} streams in "
              f"real time, {n_ops} device operations per step ({busy:.3f} ms of them), on {card}")
        print(f"  costliest device operations ({name}): "
              + "; ".join(f"{n} x {op[:70]} {t:.3f} ms" for op, n, t in top))
    return total


def training(card: str) -> int:
    """Phase 17, the training slice on the card (17a augmentation, 17b the
    feature pre-compute, 17c the head trainer, 17d evaluation, 17e the plain
    mel path); returns K1-3pass's launches in 17d's evaluation."""
    import itertools
    import torch
    from openwakeword_tpu_torch import convert, data, testing
    from openwakeword_tpu_torch import eval as evaluation
    from openwakeword_tpu_torch.features import compute_features_from_generator
    from openwakeword_tpu_torch.ops import augment as A
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.training import trainer as T
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    launches = melspec_cuda.melspectrogram_frames.launches
    work = tempfile.mkdtemp()
    rng = np.random.default_rng(170)
    total = testing.TRAIN_CLIP_SAMPLES

    def wav(path, samples):
        data.write_audio(path, np.clip(np.round(samples), -32768, 32767).astype(np.int16))
        return path

    # 17a. augment_clips at full width on the card; each op against the port on the CPU
    for sub in ("clips", "bg", "rir", "eval"):
        os.makedirs(os.path.join(work, sub))
    clips = []
    for i in range(TRAIN_AUG_CLIPS):
        n = int(16000 * (0.8 + 1.2 * rng.random()))            # 0.8-2 s utterances
        clips.append(wav(os.path.join(work, "clips", f"{i}.wav"),
                         testing.vowel(n, rng) * (3000 + 9000 * rng.random()) + (rng.random(n) * 2 - 1) * 200))
    bgs = [wav(os.path.join(work, "bg", f"{i}.wav"), (rng.random(16000 * 5) * 2 - 1) * 4000) for i in range(4)]
    rirs = []
    for i, lag in enumerate((400, 1100)):
        rir = np.zeros(4000)
        rir[3 + i] = 20000.0
        rir[lag:] = (rng.random(4000 - lag) * 2 - 1) * 8000.0 * np.exp(-np.arange(4000 - lag) / 500.0)
        rirs.append(wav(os.path.join(work, "rir", f"{i}.wav"), rir))
    x = torch.from_numpy(np.stack([data.create_fixed_size_clip(data.read_audio(p), total,
                                                               rng=np.random.default_rng(i))
                                   for i, p in enumerate(clips[:AUG_CHECK_ROWS])]))
    gen = torch.Generator().manual_seed(171)
    b = x.shape[0]
    params = {"gain": A.draw_gain(gen, b), "tanh": A.draw_tanh_distortion(gen, b), "eq": A.draw_seven_band_eq(gen, b),
              "stop": A.draw_band_stop(gen, b), "semis": A.draw_pitch_shift(gen),
              "spec": A.draw_colored_noise(gen, x.shape),
              "decay": A.uniform(gen, (b,), -1.0, 2.0), "snr": A.draw_snr(gen, b, 10, 30),
              "mix_snr": A.uniform(gen, (b,), -10, 15), "rir": data.read_audio(rirs[0])}
    noise = torch.from_numpy(np.random.default_rng(172).uniform(-0.1, 0.1, x.shape).astype(np.float32))
    ops = {"gain": lambda v, p: A.apply_gain(v, p["gain"]),
           "tanh_distortion": lambda v, p: A.apply_tanh_distortion(v, p["tanh"]),
           "seven_band_eq": lambda v, p: A.apply_seven_band_eq(v, p["eq"]),
           "band_stop": lambda v, p: A.apply_band_stop(v, *p["stop"]),
           "pitch_shift": lambda v, p: A.apply_pitch_shift(v, p["semis"]),
           "colored_noise": lambda v, p: A.apply_colored_noise(p["spec"].to(v.device), total, p["decay"]),
           "add_noise_at_snr": lambda v, p: A.apply_noise_at_snr(v, noise.to(v.device), p["snr"]),
           "mix_at_snr": lambda v, p: A.mix_at_snr(noise.to(v.device), v, p["mix_snr"]),
           "reverberate": lambda v, p: A.reverberate(v, p["rir"])}
    report = []
    for name, op in ops.items():
        want = op(x, params).numpy()
        got = op(x.to(dev), params).cpu().numpy()
        if name == "pitch_shift":
            err = float(np.sqrt(np.mean((got.astype(np.float64) - want) ** 2) / np.mean(want.astype(np.float64) ** 2)))
            report.append(f"{name} {err:.2e} (relative RMS)")
            limit = PITCH_RMS_TOL
        else:
            err = float(np.abs(got - want).max() / np.abs(want).max())
            report.append(f"{name} {err:.2e}")
            limit = AUG_PEAK_TOL
        if not err <= limit:
            fail(f"augmentation op {name} on the card is {err} from the port on the CPU (limit {limit})")
    print(f"augment ops, card vs the port on the CPU over {tuple(x.shape)} (max |diff| over the peak): "
          + ", ".join(report))
    kw = dict(total_length=total, batch_size=TRAIN_AUG_CLIPS, background_clip_paths=bgs, RIR_paths=rirs, seed=173)
    walls = []
    for _ in range(2):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        augmented = np.concatenate(list(data.augment_clips(clips, device=dev, **kw)))
        walls.append(time.perf_counter() - t0)
    t0 = time.perf_counter()
    on_cpu = np.concatenate(list(data.augment_clips(clips, device="cpu", **kw)))
    cpu_wall = time.perf_counter() - t0
    diff = augmented.astype(np.float64) - on_cpu
    rms = float(np.sqrt(np.mean(diff ** 2) / np.mean(on_cpu.astype(np.float64) ** 2)))
    print(f"augment_clips ({TRAIN_AUG_CLIPS} clips of {total} samples, every op at its default probability, "
          f"{len(bgs)} background and {len(rirs)} RIR files): {TRAIN_AUG_CLIPS / min(walls):.1f} clips/s on the card "
          f"(runs {', '.join(f'{w:.3f}' for w in walls)} s; the port on the CPU "
          f"{TRAIN_AUG_CLIPS / cpu_wall:.1f} "
          f"clips/s), on {card}; card vs CPU: relative RMS {rms:.2e}, "
          f"{float((diff == 0).mean()):.1%} of the samples equal")
    if augmented.shape != (TRAIN_AUG_CLIPS, total) or augmented.dtype != np.int16 or not rms <= PITCH_RMS_TOL:
        fail(f"augment_clips on the card: shape {augmented.shape}, {augmented.dtype}, {rms} from the CPU")

    # 17b. the feature pre-compute against the JAX golden
    golden, inputs = testing.load_train_golden(), testing.train_inputs(testing.TRAIN_SEED)
    if inputs["sha256"] != str(golden["inputs_sha256"]):
        fail("training golden inputs do not regenerate bit-exactly with this numpy")
    emb = convert.embedding_from_jax(testing.golden_inputs()["embedding"])
    out = os.path.join(work, "features.npy")
    compute_features_from_generator(iter([inputs["clips"][:10], inputs["clips"][10:]]),
                                    n_total=testing.TRAIN_CLIPS, clip_duration=total, output_file=out,
                                    device=dev, embedding_params=emb)
    err = float(np.abs(np.load(out) - golden["features"]).max())
    t0 = time.perf_counter()
    compute_features_from_generator(iter([augmented]), n_total=TRAIN_AUG_CLIPS, clip_duration=total,
                                    output_file=os.path.join(work, "augmented.npy"), device=dev, embedding_params=emb)
    feat_s = time.perf_counter() - t0
    print(f"features of the golden clips on the card vs the JAX package: max |diff| {err:.3e} over "
          f"{golden['features'].shape} (limit {CNN_TOL}); the {TRAIN_AUG_CLIPS} augmented clips in {feat_s:.3f} s, "
          f"{TRAIN_AUG_CLIPS / feat_s:.1f} clips/s")
    if not err <= CNN_TOL:
        fail(f"compute_features_from_generator on the card is {err} from the JAX golden")

    # 17c. the trainer: the golden's 40 steps, then 1000 steps at full width
    stats, step = [], T._train_step

    def recording(*args, **kwargs):
        r = step(*args, **kwargs)
        stats.append(r[3])
        return r
    trainer = T.HeadTrainer(layer_dim=testing.TRAIN_WIDTH, device=dev)
    trainer.params = convert.head_from_jax(golden["init"], dev)
    T._train_step = recording
    try:
        trainer.train_model(iter(inputs["batches"]), feed_chunk=8, **testing.train_schedule())
    finally:
        T._train_step = step
    updated = np.array([bool(s["updated"]) for s in stats])
    survivors = np.array([int(s["n_survivors"]) for s in stats])
    loss = np.array([float(s["loss"]) for s in stats])
    loss_err = float(np.max(np.abs(loss - golden["loss"]) / np.abs(golden["loss"])))
    pred_err = float(np.abs(trainer.forward(inputs["held_out"]) - golden["held_out_pred"]).max())
    print(f"trainer golden ({testing.TRAIN_STEPS} steps, dnn width {testing.TRAIN_WIDTH}, batch "
          f"{testing.TRAIN_BATCH}): updates {int(updated.sum())} as JAX {np.array_equal(updated, golden['updated'])}, "
          f"survivors as JAX {np.array_equal(survivors, golden['n_survivors'])}, loss within {loss_err:.2e} "
          f"relative, held-out predictions within {pred_err:.2e}")
    if not (np.array_equal(updated, golden["updated"]) and np.array_equal(survivors, golden["n_survivors"])
            and loss_err <= TRAIN_LOSS_RTOL and pred_err <= TRAIN_PRED_TOL):
        fail("the trainer on the card does not reproduce the JAX trainer's 40 steps")
    pool = [testing.train_batch(rng, TRAIN_SCALE_BATCH) for _ in range(TRAIN_POOL)]
    held_out, held_y = testing.train_batch(rng, TRAIN_SCALE_BATCH)
    preds = {}
    for chunk in (1, 32):
        t = T.HeadTrainer(layer_dim=testing.TRAIN_WIDTH, seed=0, device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        t.train_model(itertools.islice(itertools.cycle(pool), TRAIN_SCALE_STEPS), max_steps=TRAIN_SCALE_STEPS,
                      warmup_steps=TRAIN_SCALE_STEPS // 10, hold_steps=TRAIN_SCALE_STEPS // 3, lr=1e-3,
                      feed_chunk=chunk)
        wall = time.perf_counter() - t0
        preds[chunk] = t.forward(held_out)
        acc = t.accuracy(preds[chunk], held_y)
        print(f"train_model: {TRAIN_SCALE_STEPS} steps at batch {TRAIN_SCALE_BATCH} (dnn width "
              f"{testing.TRAIN_WIDTH}, (16, 96) windows), feed_chunk {chunk}: {wall:.3f} s, "
              f"{TRAIN_SCALE_STEPS / wall:.1f} steps/s, {len(t.history['loss'])} updates, last loss "
              f"{t.history['loss'][-1]:.4f}, held-out accuracy {acc:.3f}, on {card}")
        if not (np.isfinite(t.history["loss"]).all() and acc > 0.9):
            fail(f"train_model at feed_chunk {chunk} did not learn (accuracy {acc})")
    chunk_err = float(np.abs(preds[1] - preds[32]).max())
    print(f"train_model feed_chunk 1 vs 32: max |dpred| {chunk_err:.3e}")
    # where a step's time goes: the step alone on batches already on the card
    layout = T._Layout(t.params)
    state = [layout.pack(t.params, dev), {"count": torch.zeros((), dtype=torch.int32, device=dev),
                                          "mu": layout.pack(t.opt_state["mu"], dev),
                                          "nu": layout.pack(t.opt_state["nu"], dev)},
             {"n_acc": torch.zeros((), dtype=torch.int32, device=dev),
              "acc_steps": torch.ones((), dtype=torch.int32, device=dev)}]
    resident = [(torch.from_numpy(bx).to(dev), torch.from_numpy(by.astype(np.float32)).to(dev)) for bx, by in pool[:4]]
    lr, neg_w = torch.tensor(1e-3, device=dev), torch.tensor(1.0, device=dev)

    def one_step(i=0):
        state[:] = T._train_step(*state, *resident[i % len(resident)], neg_w, lr, t.meta, layout)[:3]
    for i in range(20):
        one_step(i)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(TRAIN_PROFILE_STEPS):
        one_step(i)
    host = time.perf_counter() - t0
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    n_ops, busy, top = device_ops_per_step(one_step, n_top=4)
    print(f"train step alone (batch {TRAIN_SCALE_BATCH} on the card): {1e3 * wall / TRAIN_PROFILE_STEPS:.3f} ms per "
          f"step, {1e3 * host / TRAIN_PROFILE_STEPS:.3f} ms of it to dispatch; {n_ops} device operations per step "
          f"({busy:.3f} ms of them); costliest: " + "; ".join(f"{n} x {op[:50]} {ms:.3f} ms" for op, n, ms in top))
    if not chunk_err <= TRAIN_PRED_TOL:
        fail(f"feed_chunk 1 and 32 trained different heads ({chunk_err})")
    head = os.path.join(work, "trained.npz")
    t.save_model(head)

    # 17d. evaluation with the trained head through the engine (K1-3pass)
    neg = [wav(os.path.join(work, "eval", f"neg{i}.wav"), (rng.random(EVAL_SECONDS * 16000) * 2 - 1) * 2000)
           for i in range(EVAL_FILES // 2)]
    pos = [wav(os.path.join(work, "eval", f"pos{i}.wav"), testing.vowel(EVAL_SECONDS * 16000, rng) * 12000)
           for i in range(EVAL_FILES // 2)]
    for k in launches:
        launches[k] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    result = evaluation.evaluate_model(head, neg, pos, threshold=0.5, device=dev, embedding_params=emb)
    wall = time.perf_counter() - t0
    used = {k: v for k, v in launches.items() if v}
    n_eval = used.get("direct_3pass", 0)
    frames = EVAL_SECONDS * 16000 // 1280
    print(f"evaluate_model ({len(neg)} negative and {len(pos)} positive files of {EVAL_SECONDS} s, the trained head, "
          f"'high'): {wall:.3f} s, real-time factor {EVAL_FILES * EVAL_SECONDS / wall:.1f}, FA/h "
          f"{result['far_per_hour']:.2f}, FRR {result['frr']:.3f}, mel launches {used}, on {card}")
    if set(used) != {"direct_3pass"} or n_eval < 2 * frames:
        fail(f"evaluation made mel launches {used}, expected K1-3pass (direct_3pass) on every engine step")
    if not (result["n_positive_clips"] == len(pos) and np.isfinite(result["curve"]["far_per_hour"]).all()):
        fail("evaluate_model's report is incomplete")

    # 17e. the engine with use_pallas_melspec=False: the plain mel, no kernel
    kernel_scores, _ = evaluation.score_files_multi(neg + pos, [head], padding=1, device=dev, embedding_params=emb)
    for k in launches:
        launches[k] = 0
    plain_scores, _ = evaluation.score_files_multi(neg + pos, [head], padding=1, device=dev, embedding_params=emb,
                                                   use_pallas_melspec=False)
    used = {k: v for k, v in launches.items() if v}
    err = max(float(np.abs(plain_scores[p] - kernel_scores[p]).max()) for p in neg + pos)
    print(f"use_pallas_melspec=False: max |dscore| vs the kernel path {err:.3e} over {len(neg + pos)} files "
          f"(limit {SCORE_TOL}), mel launches {used}")
    if used or not err <= SCORE_TOL:
        fail(f"use_pallas_melspec=False launched {used} or moved the scores by {err}")
    return n_eval


def _run_recorded(module, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``module._train_step`` wrapped: returns
    (its result, [(time, loss)] of each step, read as the step ends)."""
    step, stamped = module._train_step, []

    def recording(*a):
        loss = step(*a)
        stamped.append((time.perf_counter(), float(loss)))
        return loss
    module._train_step = recording
    try:
        return fn(*args, **kwargs), stamped
    finally:
        module._train_step = step


def _steps_per_s(stamped) -> float:
    """Steps per second between the first and the last reading."""
    return (len(stamped) - 1) / (stamped[-1][0] - stamped[0][0])


def _relative_gap(got, want) -> float:
    return float(np.max(np.abs(np.asarray(got) - np.asarray(want)) / np.abs(np.asarray(want))))


def _assert_tree_equal(what: str, got, want) -> None:
    for k, v in want.items():
        if k == "__meta__":
            continue
        if isinstance(v, dict):
            _assert_tree_equal(f"{what}/{k}", got[k], v)
        elif not np.array_equal(np.asarray(got[k]), np.asarray(v)):
            fail(f"{what}/{k} does not read back to the source array")


def f2(card: str) -> dict:
    """Phase 18, slice F2 on the card (18a the exporters, 18b distillation,
    18c VAD training, 18d verifier mining); returns the mel kernels'
    launches in it."""
    import torch
    from openwakeword_tpu_torch import Model, convert, custom_verifier_model, registry, testing
    from openwakeword_tpu_torch.io import onnx_export, tflite_export, tflite_graph, tflite_import
    from openwakeword_tpu_torch.models import embedding, embedding_student, vad_net
    from openwakeword_tpu_torch.ops import melspec, melspec_cuda
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    from openwakeword_tpu_torch.training import distill
    from openwakeword_tpu_torch.training import vad as vad_training
    dev, cpu = torch.device("cuda", 0), torch.device("cpu")
    launches = melspec_cuda.melspectrogram_frames.launches
    work = tempfile.mkdtemp()
    total: dict = {}

    def take_launches() -> dict:
        used = {k: v for k, v in launches.items() if v}
        for k, v in used.items():
            total[k] = total.get(k, 0) + v
            launches[k] = 0
        return used

    # 18a. every artifact exported on this host (no onnx, no flatbuffers package)
    params = testing.export_params()
    port = testing.port_export_params(params, dev)
    export_s = {}

    def timed(fn):
        def run(*args, **kwargs):
            path = next(a for a in args if isinstance(a, str))
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            export_s[os.path.basename(path)] = time.perf_counter() - t0
            return out
        return run

    class TimedOnnx:
        def __getattr__(self, name):
            return timed(getattr(onnx_export, name))
    os.makedirs(os.path.join(work, "onnx"))
    onnx_paths = testing.write_onnx_artifacts(TimedOnnx(), port, os.path.join(work, "onnx"))
    with open(testing.EXPORT_FIXTURE) as f:
        want_hashes = json.load(f)
    got_hashes = {name: testing.sha256_file(path) for name, path in onnx_paths.items()}
    wrong = sorted(n for n in want_hashes if got_hashes.get(n) != want_hashes[n])
    print(f"ONNX export of {len(onnx_paths)} artifacts from card tensors: "
          + ", ".join(f"{os.path.basename(p)} {1e3 * export_s[os.path.basename(p)]:.1f} ms"
                      for p in onnx_paths.values()))
    if wrong or set(got_hashes) != set(want_hashes):
        fail(f"ONNX files differ from the JAX exporter's (sha256 of {wrong})")
    print(f"ONNX sha256: all {len(want_hashes)} equal to the JAX exporter's ({testing.EXPORT_FIXTURE})")
    tfl_paths = {name: os.path.join(work, f"{name}.tflite") for name in port["heads"]}
    for name, p in port["heads"].items():
        timed(tflite_export.export_head_tflite)(p, tfl_paths[name])
    tfl_paths["embedding"] = os.path.join(work, "embedding_model.tflite")
    timed(tflite_export.export_embedding_tflite)(port["embedding"], tfl_paths["embedding"])
    tfl_paths["melspectrogram"] = os.path.join(work, "melspectrogram.tflite")
    timed(tflite_export.export_melspectrogram_tflite)(tfl_paths["melspectrogram"])
    print("TFLite export: " + ", ".join(f"{os.path.basename(p)} {1e3 * export_s[os.path.basename(p)]:.1f} ms"
                                        for p in tfl_paths.values()))
    for name in port["heads"]:
        kind, got, _ = tflite_import.import_tflite_model(tfl_paths[name])
        if kind != "head":
            fail(f"{name}.tflite reads back as a {kind!r}")
        _assert_tree_equal(f"{name}.tflite", got, params["heads"][name])
    folded = {k: {f: (np.transpose(a.numpy(), (2, 3, 1, 0)) if a.ndim == 4 else a.numpy()) for f, a in g.items()}
              for k, g in embedding.ensure_folded(convert.embedding_from_jax(params["embedding"])).items()}
    _assert_tree_equal("embedding_model.tflite", tflite_import.import_embedding_tflite(tfl_paths["embedding"]), folded)
    consts = tflite_graph.TfliteProgram(tflite_import.load_tflite(tfl_paths["melspectrogram"])).params
    for suffix, want in (("dft_basis", np.ascontiguousarray(melspec.stft_power_basis().T)[:, None, :, None]),
                         ("mel_basis", melspec.mel_filterbank().T)):
        got = next(v for k, v in consts.items() if k.endswith(suffix))
        if not np.array_equal(np.asarray(got), np.asarray(want, np.float32)):
            fail(f"melspectrogram.tflite's {suffix} does not read back to the source array")
    print(f"TFLite read-back: {len(tfl_paths)} files equal to their source arrays")
    # the bench configuration at 'high' with the exported heads in place of the .npz ones
    bench = list(registry.MODELS)
    os.makedirs(os.path.join(work, "npz"))
    npz = testing.write_head_checkpoints({n: params["heads"][n] for n in bench}, os.path.join(work, "npz"))
    emb = convert.embedding_from_jax(params["embedding"])
    frames = np.random.default_rng(18).integers(-2000, 2000, (EXPORT_FRAMES, SCALE_STREAMS, 1280), dtype=np.int16)
    scores, n_3pass = {}, 0
    for fmt, files in (("npz", npz), ("onnx", [onnx_paths[n] for n in bench]),
                       ("tflite", [tfl_paths[n] for n in bench])):
        engine = MultiStreamEngine(wakeword_models=files, n_streams=SCALE_STREAMS, device=dev, embedding_params=emb)
        take_launches()
        scores[fmt] = engine.predict_frames(frames)
        used = take_launches()
        if used != {"direct_3pass": EXPORT_FRAMES}:
            fail(f"the engine with .{fmt} heads made mel launches {used}, expected {EXPORT_FRAMES} of direct_3pass")
        n_3pass += used["direct_3pass"]
        del engine
    err = {fmt: float(np.abs(scores[fmt] - scores["npz"]).max()) for fmt in ("onnx", "tflite")}
    print(f"bench configuration at 'high', S={SCALE_STREAMS}, {EXPORT_FRAMES} frames: max |dscore| vs the .npz heads "
          f".onnx {err['onnx']:.3e}, .tflite {err['tflite']:.3e} (limit {EXPORT_SCORE_TOL}); "
          f"{n_3pass} K1-3pass launches")
    if not (max(err.values()) <= EXPORT_SCORE_TOL and np.isfinite(scores["npz"]).all()):
        fail(f"exported heads score off their .npz heads by {err}")
    del scores, frames

    # 18b. distillation at full width: batch 256, the default CNN teacher on seeded weights
    teacher = emb
    init = embedding_student.init_params(np.random.default_rng(0))
    losses = {}
    for name, where in (("card", dev), ("cpu", cpu)):
        _, stamped = _run_recorded(distill, distill.distill, teacher, steps=CHECK_STEPS, batch_size=DISTILL_BATCH,
                                   eval_batches=1, log_every=0, init_params=init, device=where)
        losses[name] = [v for _, v in stamped]
    gap = _relative_gap(losses["card"], losses["cpu"])
    print(f"distill, {CHECK_STEPS} steps at batch {DISTILL_BATCH}, card vs CPU: losses {losses['card']} vs "
          f"{losses['cpu']}, max relative gap {gap:.3e} (limit {CHECK_LOSS_RTOL})")
    if not gap <= CHECK_LOSS_RTOL:
        fail(f"distillation on the card left the CPU's losses by {gap}")
    take_launches()
    t0 = time.perf_counter()
    (student, report), stamped = _run_recorded(distill, distill.distill, teacher, steps=DISTILL_STEPS,
                                               batch_size=DISTILL_BATCH, eval_batches=DISTILL_DRIFT_BATCHES,
                                               log_every=0, init_params=init, device=dev)
    wall = time.perf_counter() - t0
    print(f"distill: {DISTILL_STEPS} steps (cut from 3000 to fit ~30 s) at batch {DISTILL_BATCH} in {wall:.2f} s "
          f"with measure_drift ({DISTILL_DRIFT_BATCHES} x {DISTILL_BATCH}), {_steps_per_s(stamped):.2f} steps/s, "
          f"loss {stamped[0][1]:.4f} -> {stamped[-1][1]:.4f}; drift: mean cosine {report['mean_cosine']:.4f}, "
          f"relative rms {report['relative_rms_err']:.4f}, max |err| {report['max_abs_err']:.4f}, on {card}")
    if take_launches():
        fail("distillation launched a mel kernel (its mel is the plain fp32 frontend)")
    if not (np.isfinite([v for _, v in stamped]).all() and stamped[-1][1] < stamped[0][1]):
        fail("distillation did not lower its loss")
    t0 = time.perf_counter()
    drift = distill.measure_served_score_drift(student, teacher_params=teacher, wakeword_models=npz,
                                               noise_seconds=20.0, seed=3, device=dev)
    wall = time.perf_counter() - t0
    used = take_launches()
    print(f"served-score drift, six bench heads over 20 s of noise: max |dscore| {drift['max_abs_dscore']}, "
          f"{drift['total_activation_flips']} flips in {drift['total_frames']} frames, {wall:.2f} s, "
          f"mel launches {used}")
    if set(used) != {"direct"} or drift["total_frames"] < 6 * 240:
        fail(f"the served-score drift made mel launches {used} over {drift['total_frames']} frames, expected K1")

    # 18c. VAD training at the JAX package's defaults on synthetic speech
    rng = np.random.default_rng(181)
    clips = [testing.vowel(int(16000 * (0.8 + 1.2 * rng.random())), rng) * (0.2 + 0.6 * rng.random())
             for _ in range(VAD_CLIPS)]
    init = vad_net.init_params(np.random.default_rng(0))
    losses = {}
    for name, where in (("card", dev), ("cpu", cpu)):
        _, stamped = _run_recorded(vad_training, vad_training.train_vad, clips, steps=CHECK_STEPS, init_params=init,
                                   device=where)
        losses[name] = [v for _, v in stamped]
    gap = _relative_gap(losses["card"], losses["cpu"])
    print(f"train_vad, {CHECK_STEPS} steps, card vs CPU: losses {losses['card']} vs {losses['cpu']}, max relative "
          f"gap {gap:.3e} (limit {CHECK_LOSS_RTOL})")
    if not gap <= CHECK_LOSS_RTOL:
        fail(f"VAD training on the card left the CPU's losses by {gap}")
    t0 = time.perf_counter()
    vad_params, stamped = _run_recorded(vad_training, vad_training.train_vad, clips, steps=VAD_STEPS,
                                        init_params=init, device=dev)
    wall = time.perf_counter() - t0
    first, last = (np.mean([v for _, v in stamped[i]]) for i in (slice(0, 50), slice(-50, None)))
    result = vad_training.evaluate_vad(vad_params, clips, thresholds=[0.5], device=dev)
    print(f"train_vad: {VAD_STEPS} steps (batch 64, 20 frames, 2048 sequences) in {wall:.2f} s, "
          f"{_steps_per_s(stamped):.1f} steps/s, mean loss of the first / last 50 steps {first:.4f} / {last:.4f}; "
          f"evaluate_vad at 0.5: FAR {result['far'][0]:.4f}, FRR {result['frr'][0]:.4f} "
          f"({result['n_nonspeech_frames']} / {result['n_speech_frames']} frames), on {card}")
    if not (last < first and np.isfinite(result["far"]).all() and np.isfinite(result["frr"]).all()):
        fail("VAD training did not lower its loss or evaluate_vad is not finite")

    # 18d. verifier mining through the Model on the card against the CPU
    pcm = np.round(testing.vowel(16000 * 3, rng) * 9000 + (rng.random(16000 * 3) * 2 - 1) * 800).astype(np.int16)
    windows = {}
    for name, where in (("card", dev), ("cpu", cpu)):
        model = Model(wakeword_models=npz[:2], device=where, embedding_params=emb)
        take_launches()
        np.random.seed(18)
        t0 = time.perf_counter()
        windows[name] = custom_verifier_model.get_reference_clip_features(pcm, model, "alexa", threshold=0.0, N=3)
        wall = time.perf_counter() - t0
        used = take_launches()
        print(f"verifier mining on the {name}: {windows[name].shape} windows from 3 s x 3 passes in "
              f"{wall:.2f} s, mel launches {used}")
        if name == "card" and set(used) != {"direct"}:
            fail(f"mining on the card made mel launches {used}, expected K1 (direct)")
    err = float(np.abs(windows["card"] - windows["cpu"]).max()) if windows["card"].shape == windows["cpu"].shape \
        else float("inf")
    print(f"verifier windows, card vs CPU: max |diff| {err:.3e} (limit {CNN_TOL})")
    if not err <= CNN_TOL:
        fail(f"mined windows on the card differ from the CPU's by {err}")
    try:
        import sklearn  # noqa: F401
        w, b = custom_verifier_model.fold_verifier(custom_verifier_model.train_verifier_model(
            np.concatenate([windows["card"], windows["cpu"] + 1.0]), np.repeat([1, 0], len(windows["cpu"]))))
        print(f"verifier fit on this host: {w.shape} folded weights")
    except ImportError:
        try:
            custom_verifier_model.train_verifier_model(windows["card"], np.ones(len(windows["card"])))
            fail("train_verifier_model ran without scikit-learn")
        except ImportError as e:
            if "scikit-learn" not in str(e):
                fail(f"train_verifier_model's ImportError does not name scikit-learn: {e}")
        print("verifier fit: this host has no scikit-learn (train_verifier_model raises naming it); the fit is "
              "scikit-learn's on the host and is tested on the CPU (tests/test_torch_verifier.py)")
    return total


def slice_g(card: str) -> int:
    """Phase 19, slice G on the card (19a the sharded engine, 19b the
    sharded server, 19c data-parallel training, 19d the multi-device dry
    run); returns K1-3pass's launches on the sharded main path (19a's and
    19b's mesh runs)."""
    import torch
    from openwakeword_tpu_torch import testing
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.parallel import Mesh, MultiStreamEngine, StreamServer
    from openwakeword_tpu_torch.parallel.multichip import dryrun_multichip, mesh_devices
    from openwakeword_tpu_torch.training import trainer as T
    launches = melspec_cuda.melspectrogram_frames.launches
    devs = mesh_devices(MESH_ENTRIES, "cuda")
    distinct = len(set(devs)) == MESH_ENTRIES
    print(f"slice G: a {MESH_ENTRIES}-entry mesh on {', '.join(str(d) for d in devs)} "
          f"({'one card per entry' if distinct else 'repeated entries: the shards share one card'}; "
          f"{torch.cuda.device_count()} card(s)), on {card}")
    mesh = Mesh(devs)
    S, F = SCALE_STREAMS, SHARD_FRAMES
    rng = np.random.default_rng(19)
    total = 0

    def take(what: str, expect: int) -> int:
        used = {k: v for k, v in launches.items() if v}
        if used != {"direct_3pass": expect}:
            fail(f"{what} made mel launches {used}, expected {expect} of direct_3pass "
                 f"({MESH_ENTRIES} per sharded step)")
        return expect

    # 19a. the bench configuration, sharded against unsharded on the same weights
    t_phase = time.perf_counter()
    pcm = rng.integers(-2000, 2000, (2 * F + 1, S, 1280), dtype=np.int16)
    sharded = MultiStreamEngine(n_streams=S, mesh=mesh)
    whole = MultiStreamEngine(n_streams=S, device=devs[0])
    for k in launches:
        launches[k] = 0
    got = np.concatenate([np.stack([sharded.predict(pcm[t]) for t in range(F)]),
                          sharded.predict_frames(pcm[F:2 * F])])
    total += take("the sharded engine (predict, predict_frames)", MESH_ENTRIES * 2 * F)
    want = np.concatenate([np.stack([whole.predict(pcm[t]) for t in range(F)]), whole.predict_frames(pcm[F:2 * F])])
    err = float(np.abs(got - want).max())
    if got.shape != (2 * F, S, 11) or not (np.isfinite(got).all() and got.min() >= 0.0 and got.max() <= 1.0):
        fail(f"sharded scores are not finite values in [0, 1] of shape {(2 * F, S, 11)}: {got.shape}")
    n_leaves = 0
    for k, st in enumerate(sharded.shard_states):
        stack = [(sharded.stream_axes(k), st)]
        while stack:
            axes, tree = stack.pop()
            for key, leaf in tree.items():
                if isinstance(leaf, dict):
                    stack.append((axes[key], leaf))
                elif leaf.shape[axes[key]] != S // MESH_ENTRIES or leaf.device != devs[k]:
                    fail(f"shard {k} holds a state leaf of shape {tuple(leaf.shape)} on {leaf.device}")
                else:
                    n_leaves += 1
    snapshot = os.path.join(tempfile.mkdtemp(), "sharded.npz")
    sharded.save_state(snapshot)
    whole.load_state(snapshot)
    for k in launches:
        launches[k] = 0
    after = sharded.predict(pcm[2 * F])
    total += take("the sharded step after the snapshot", MESH_ENTRIES)
    load_err = float(np.abs(after - whole.predict(pcm[2 * F])).max())
    print(f"19a sharded engine, S={S} ({S // MESH_ENTRIES} per shard), {F} frames through predict and {F} through "
          f"predict_frames: max |dscore| vs the unsharded engine {err:.3e} (limit {SHARD_TOL}); "
          f"{MESH_ENTRIES} K1-3pass launches per step; every shard's {n_leaves // MESH_ENTRIES} state leaves hold "
          f"{S // MESH_ENTRIES} streams on their stream axis on its entry's device; save_state -> unsharded "
          f"load_state -> one step: max |dscore| {load_err:.3e}")
    if not (err <= SHARD_TOL and load_err <= SHARD_TOL):
        fail(f"the sharded engine disagrees with the unsharded one: {err}, after the snapshot {load_err}")
    steady = pcm[:F]
    walls = {}
    for name, eng in (("unsharded", whole), ("sharded", sharded), ("sharded", sharded), ("unsharded", whole)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        eng.predict_frames(steady)
        walls[name] = min(walls.get(name, float("inf")), (time.perf_counter() - t0) / F)
    print(f"19a step at S={S}, predict_frames over {F} frames, better of two turns: unsharded "
          f"{walls['unsharded'] * 1e3:.3f} ms, sharded over {MESH_ENTRIES} entries {walls['sharded'] * 1e3:.3f} ms "
          f"({walls['sharded'] / walls['unsharded']:.2f}x), on {card}")
    del sharded, whole

    # 19b. two 4096-slot servers, sharded and not, with 1% churn: step() then step_async()
    ticks = rng.integers(-2000, 2000, (SHARD_TICKS, S, 1280), dtype=np.int16)
    churn = [rng.choice(S, S // 100, replace=False) for _ in range(SHARD_TICKS)]
    sids = np.arange(S)
    recorded, tick_ms = {}, {}
    for name, where in (("unsharded", dict(device=devs[0])), ("sharded", dict(mesh=mesh))):
        srv = StreamServer(capacity=S, threshold=SHARD_THRESHOLD, warm_compile=True, **where)
        for _ in range(S):
            srv.add_stream()
        for k in launches:
            launches[k] = 0
        with testing.recording(srv) as rec:
            for half, tick in (("step", srv.step), ("step_async", srv.step_async)):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                span = range(0, SHARD_TICKS // 2) if half == "step" else range(SHARD_TICKS // 2, SHARD_TICKS)
                for t in span:
                    for sid in churn[t]:
                        srv.remove_stream(int(sid))
                        srv.add_stream()
                    srv.push_block(sids, ticks[t])
                    tick()
                srv.drain()
                tick_ms[name, half] = (time.perf_counter() - t0) / len(span) * 1e3
        n_launched = launches["direct_3pass"]
        if name == "sharded":
            total += take("the sharded server", MESH_ENTRIES * SHARD_TICKS)
        elif n_launched != SHARD_TICKS:
            fail(f"the unsharded server made {n_launched} K1-3pass launches in {SHARD_TICKS} ticks")
        recorded[name] = (np.stack([rec[f][0] for f in sorted(rec)]), np.stack([rec[f][1] for f in sorted(rec)]))
        del srv
    (sa, va), (sb, vb) = recorded["sharded"], recorded["unsharded"]
    srv_err = float(np.abs(sa - sb).max())
    clear = np.abs(sb - SHARD_THRESHOLD) > SHARD_TOL

    def activations(scores, valid):
        return np.argwhere((scores >= SHARD_THRESHOLD) & valid[:, :, None] & clear)
    acts_a, acts_b = activations(sa, va), activations(sb, vb)
    print(f"19b servers (capacity {S}, {SHARD_TICKS} ticks with 1% churn, step() then step_async()): sharded vs "
          f"unsharded max |dscore| {srv_err:.3e} over {sa.shape}, valid masks equal {np.array_equal(va, vb)}, "
          f"activations {len(acts_a)} vs {len(acts_b)}, equal {np.array_equal(acts_a, acts_b)}")
    for half in ("step", "step_async"):
        print(f"19b ms per tick ({half}, with churn): unsharded {tick_ms['unsharded', half]:.3f}, sharded over "
              f"{MESH_ENTRIES} entries {tick_ms['sharded', half]:.3f}, on {card}")
    if not (srv_err <= SHARD_TOL and np.array_equal(va, vb) and np.array_equal(acts_a, acts_b)):
        fail("the sharded server disagrees with the unsharded one")
    del recorded, ticks

    # 19c. data-parallel head training on a 2-entry mesh against one device
    batches = [testing.train_batch(rng, DP_BATCH) for _ in range(DP_STEPS)]
    runs, rates = {}, {}
    where_of = {"one device": dict(device=devs[0]), "mesh": dict(mesh=Mesh(devs[:DP_ENTRIES], ("data",)))}
    for name in ("one device", "mesh", "mesh", "one device"):           # in turns: the first run warms up
        stats, step = [], T._train_step

        def recording(*args, **kwargs):
            r = step(*args, **kwargs)
            stats.append(r[3])
            return r
        trainer = T.HeadTrainer(layer_dim=testing.TRAIN_WIDTH, seed=0, **where_of[name])
        T._train_step = recording
        try:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            trainer.train_model(iter(batches), max_steps=DP_STEPS, warmup_steps=4, hold_steps=4, lr=1e-3)
            wall = time.perf_counter() - t0
        finally:
            T._train_step = step
        runs[name] = (T._flatten(trainer.params), np.array([bool(s["updated"]) for s in stats]),
                      np.array([int(s["n_survivors"]) for s in stats]))
        rates[name] = max(rates.get(name, 0.0), DP_STEPS / wall)
    (p1, u1, n1), (pm, um, nm) = runs["one device"], runs["mesh"]
    r1, rm = rates["one device"], rates["mesh"]
    dp_err = max(float(np.abs(pm[k] - p1[k]).max()) for k in p1)
    print(f"19c HeadTrainer on a {DP_ENTRIES}-entry mesh vs one device, batch {DP_BATCH}, {DP_STEPS} steps: params "
          f"max |diff| {dp_err:.3e} (limit {DP_PARAM_TOL}), updates {int(um.sum())} / {int(u1.sum())}, gate equal "
          f"{np.array_equal(um, u1)}, survivors equal {np.array_equal(nm, n1)}; {rm:.1f} vs {r1:.1f} steps/s "
          f"(better of two runs in turns), on {card}")
    if not (dp_err <= DP_PARAM_TOL and np.array_equal(um, u1) and np.array_equal(nm, n1)):
        fail("data-parallel training disagrees with one device")

    # 19d. the multi-device dry run
    dryrun_multichip(MESH_ENTRIES, "cuda")
    print(f"slice G phase took {time.perf_counter() - t_phase:.1f} s")
    return total


def full_band(card: str) -> tuple:
    """Phase 20, the full band: the library rebuilt at ``config.FMAX`` =
    FULL_BAND_FMAX (254 live bins, K1-3pass with its mel weights loaded after
    the K loop), every mel kernel held to its plain version over that range
    at phase 3's limits (``mel_check``) at S=4096 and S=1 and timed against
    it at S=4096, the bench step at 'high' with each mel DFT held within
    SCORE_TOL of the same engine at 'highest', then the default library
    restored. Returns (the mel kernels' launches in the engine runs, the
    largest kernel-vs-plain error per variant)."""
    import torch
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    from openwakeword_tpu_torch.utils import cuda_build
    dev = torch.device("cuda", 0)
    mel, mel_plain = melspec_cuda.melspectrogram_frames, melspec_cuda.melspectrogram_frames_plain
    caches = (cuda_build.load_library, melspec_cuda._kernel_fn, melspec_cuda._device_consts)
    default_fmax = config.FMAX
    config.FMAX = FULL_BAND_FMAX
    for cache in caches:
        cache.cache_clear()
    built = cuda_build.load_library()
    first, count, padded = melspec_cuda.live_bins()
    print(f"full band: FMAX {config.FMAX:.0f} Hz, DFT bins {first}..{first + count - 1} ({count} live, padded to "
          f"{padded}; K1-1pass/K1-3pass over {melspec_cuda.mma_bins()}), library {built.path} built in "
          f"{built.build_seconds:.2f} s")
    for line in ptxas_lines(built.log, "melspec_frames_mma_kernel"):
        print(f"  ptxas (csrc/melspec_mma.cu, full band): {line}")
    errs = {}
    x_scale = torch.from_numpy((np.random.default_rng(20).uniform(-1, 1, (SCALE_STREAMS, melspec_cuda.WINDOW))
                                * 25000).astype(np.float32)).to(dev)
    bounds = mel_bounds(SCALE_STREAMS)
    for dft in melspec_cuda.DFTS:
        flops, _ = mel_work(SCALE_STREAMS, dft=dft)
        cols = melspec_cuda.factored_columns()[1] if dft == "factored" else count
        for arith in config.ARITHS:
            name = melspec_cuda.variant(dft, arith)
            errs[name] = max(mel_check(dft, arith, n, " (full band)")[0] for n in FULL_BAND_STREAMS)
            ms = sandwich(f"mel ({name}, full band)", lambda: mel(x_scale, dft, arith),
                          lambda: mel_plain(x_scale, dft, arith))
            passes = MEL_PASSES[arith][0]
            bound_ms, bound_by = bounds[name]
            print(f"mel kernel ({name}) at the full band, S={SCALE_STREAMS}: {ms[0]:.4f} ms (plain {ms[1]:.4f}), "
                  f"bound {bound_ms:.4f} ms ({bound_by}, {passes} x {flops / 1e9:.4f} GFLOP over {cols} DFT "
                  f"columns for {count} live bins; {bound_ms / ms[0]:.1%} of it), on {card}")
    launches = melspec_cuda.melspectrogram_frames.launches
    frames = np.random.default_rng(20).integers(-2000, 2000, (SCALE_FRAMES, SCALE_STREAMS, 1280), dtype=np.int16)
    used_total = {}
    for dft in melspec_cuda.DFTS:
        scores = {}
        for precision in ("highest", "high"):
            engine = MultiStreamEngine(n_streams=SCALE_STREAMS, precision=precision, mel_dft=dft, device=dev)
            engine.predict_frames(frames[:8])                # warm-up, includes the prime
            for k in launches:
                launches[k] = 0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scores[precision] = engine.predict_frames(frames)
            wall = time.perf_counter() - t0
            want = melspec_cuda.variant(dft, config.kernel_arith(precision))
            used = {k: v for k, v in launches.items() if v}
            if used != {want: SCALE_FRAMES}:
                fail(f"full band, {precision} ({dft}): mel launches {used}, expected {SCALE_FRAMES} of {want}")
            used_total[want] = used_total.get(want, 0) + SCALE_FRAMES
            out = scores[precision]
            if out.shape != (SCALE_FRAMES, SCALE_STREAMS, 11) or not (
                    np.isfinite(out).all() and out.min() >= 0.0 and out.max() <= 1.0):
                fail(f"full band, {precision} ({dft}): scores are not finite values in [0, 1] of the expected shape")
            print(f"full band engine {precision} (mel_dft={dft}): {wall / SCALE_FRAMES * 1e3:.3f} ms per step over "
                  f"{SCALE_FRAMES} frames x {SCALE_STREAMS} streams, {want} launches {launches[want]}, on {card}")
            del engine
        drift = float(np.abs(scores["high"] - scores["highest"]).max())
        print(f"full band engine (mel_dft={dft}): 'high' max |dscore| vs 'highest' {drift:.3e} (limit {SCORE_TOL})")
        if not drift <= SCORE_TOL:
            fail(f"full band engine (mel_dft={dft}): 'high' is {drift} from 'highest', above {SCORE_TOL}")
    config.FMAX = default_fmax
    for cache in caches:
        cache.cache_clear()
    restored = cuda_build.load_library()
    if melspec_cuda.live_bins() != (2, 120, 128):
        fail(f"full band: the default live range did not come back ({melspec_cuda.live_bins()})")
    print(f"full band: default library restored ({restored.path}, built in {restored.build_seconds:.2f} s)")
    return used_total, errs


def main():
    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke run needs an NVIDIA GPU")
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from openwakeword_tpu_torch import config, convert, testing
        from openwakeword_tpu_torch.models import embedding_stream
        from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda, melspec_cuda
        from openwakeword_tpu_torch.ops.bf16 import round_bf16
        from openwakeword_tpu_torch.parallel import ingest
        from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
        from openwakeword_tpu_torch.utils import cuda_build
    except ImportError as e:
        fail(f"cannot import the port ({e}); run from the root of a checkout")
    if "jax" in sys.modules:
        fail("the port imported jax")
    torch.backends.cuda.matmul.allow_tf32 = False      # plain versions in full fp32
    torch.backends.cudnn.allow_tf32 = False

    # 1. device
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    card = smi.splitlines()[0].strip()
    print(f"card: {card}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"{torch.cuda.get_device_name(0)}, {torch.cuda.device_count()} device(s)")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 2")
    # 2. build
    built = cuda_build.load_library()
    print(f"build: {built.path} in {built.build_seconds:.2f} s "
          f"(nvcc {' '.join(cuda_build.NVCC_FLAGS)})")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"  ptxas: {line.strip()}")
    t0 = time.perf_counter()
    if not ingest.warm():
        fail("the native ingest library (native/ingest.cpp) did not build or load")
    print(f"build: ingest library {ingest._lib._name} in {time.perf_counter() - t0:.2f} s")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 3")
    # 3. mel kernels vs plain on the card
    dev = torch.device("cuda", 0)
    mel, mel_plain = melspec_cuda.melspectrogram_frames, melspec_cuda.melspectrogram_frames_plain
    mel_err, mel_ms, mel_ratio = {}, {}, {}
    x_scale = torch.from_numpy((np.random.default_rng(0).uniform(-1, 1, (SCALE_STREAMS, melspec_cuda.WINDOW))
                                * 25000).astype(np.float32)).to(dev)
    first, count, padded = melspec_cuda.live_bins()
    print(f"mel kernel 1 computes DFT bins {first}..{first + count - 1} ({count} of 257, padded to {padded})")
    for dft in melspec_cuda.DFTS:
        for arith in ("fp32", "1pass", "3pass"):
            name = melspec_cuda.variant(dft, arith)
            mel_err[name] = 0.0
            for n in MEL_CHECK_STREAMS:
                err, ratio = mel_check(dft, arith, n)
                if not math.isnan(ratio):
                    mel_ratio[name] = min(mel_ratio.get(name, math.inf), ratio)
                mel_err[name] = max(mel_err[name], err)
            silence = mel(torch.zeros((7, melspec_cuda.WINDOW), device=dev), dft, arith)
            if float((silence + 100.0).abs().max()) > 1e-4:
                fail(f"silence does not give -100 dB ({name})")
            mel_ms[name] = sandwich(f"mel ({name})", lambda: mel(x_scale, dft, arith),
                                    lambda: mel_plain(x_scale, dft, arith))

    x_one = x_scale[:1].contiguous()
    mel_bound = mel_bounds(SCALE_STREAMS)
    # the fp32 kernels on the CUDA cores, each with its DFT's bound: S=1 and S=4096,
    # their rates, K2's registers, and an fp32 GEMM of K2's DFT shape
    for k, dft in ((1, "direct"), (2, "factored")):
        one_ms = min(cuda_ms(lambda: mel(x_one, dft), 200) for _ in range(2))
        for n, ms in ((1, one_ms), (SCALE_STREAMS, mel_ms[dft][0])):
            flops, nbytes = mel_work(n, dft=dft)
            bound_ms, bound_by = bound(flops, nbytes)
            print(f"mel kernel {k} at S={n}: {ms:.4f} ms, {flops / ms / 1e9:.2f} TFLOP/s over {flops / 1e9:.4f} "
                  f"GFLOP of live bins and {nbytes / 1e6:.4f} MB, bound {bound_ms:.4f} ms ({bound_by}; "
                  f"{bound_ms / ms:.1%} of it), on {card}")
    for line in ptxas_lines(built.log, "melspec_frames_factored_kernel"):
        print(f"  ptxas (csrc/melspec.cu, kernel 2): {line}")
    _, live_cols, _, _, _ = melspec_cuda.factored_columns()
    frames_f32 = torch.randn((melspec_cuda.FRAMES * SCALE_STREAMS, 512), device=dev)
    basis_f32 = torch.randn((512, 2 * live_cols), device=dev)
    gemm_ms = min(cuda_ms(lambda: torch.matmul(frames_f32, basis_f32)) for _ in range(2))
    gemm_flops = 2.0 * frames_f32.shape[0] * 512 * basis_f32.shape[1]
    print(f"yardstick: one fp32 torch.matmul {tuple(frames_f32.shape)} x {tuple(basis_f32.shape)} (kernel 2's DFT "
          f"product shape at S={SCALE_STREAMS}, TF32 off) {gemm_ms:.4f} ms, {gemm_flops / gemm_ms / 1e9:.1f} "
          f"TFLOP/s, on {card}")
    del frames_f32, basis_f32
    # the bf16 variants on the tensor cores: S=1 and S=4096, their rates and
    # bounds, their registers, and a bf16 GEMM of their DFT's shape
    for line in ptxas_lines(built.log, "melspec_frames_mma_kernel"):
        print(f"  ptxas (csrc/melspec_mma.cu): {line}")
    for line in ptxas_lines(built.log, "melspec_frames_factored_mma_kernel"):
        print(f"  ptxas (csrc/melspec_factored_mma.cu): {line}")
    frames_bf16 = torch.randn((melspec_cuda.FRAMES * SCALE_STREAMS, 512), device=dev, dtype=torch.bfloat16)
    basis_bf16 = torch.randn((512, 2 * melspec_cuda.mma_bins()), device=dev, dtype=torch.bfloat16)
    gemm_ms = min(cuda_ms(lambda: torch.matmul(frames_bf16, basis_bf16)) for _ in range(2))
    gemm_flops = 2.0 * frames_bf16.shape[0] * 512 * basis_bf16.shape[1]
    print(f"yardstick: one bf16 torch.matmul {tuple(frames_bf16.shape)} x {tuple(basis_bf16.shape)} (the DFT's "
          f"product shape at S={SCALE_STREAMS}, one pass) {gemm_ms:.4f} ms, {gemm_flops / gemm_ms / 1e9:.1f} TFLOP/s, "
          f"on {card}")
    del frames_bf16, basis_bf16
    # constants per value: one rounded bf16 plane (1-pass), or a hi and a lo plane (3-pass)
    for name, passes, const_bytes in (("direct_1pass", 1, 2), ("direct_3pass", 3, 4), ("factored_1pass", 1, 2),
                                      ("factored_3pass", 3, 4)):
        dft, arith = name.split("_")
        one_ms = min(cuda_ms(lambda: mel(x_one, dft, arith), 200) for _ in range(2))
        for n, ms in ((1, one_ms), (SCALE_STREAMS, mel_ms[name][0])):
            flops, nbytes = mel_work(n, const_bytes, dft)
            bound_ms, bound_by = bound(passes * flops, nbytes, peak=BF16_FLOPS)
            print(f"mel kernel ({name}) on the tensor cores at S={n}: {ms:.4f} ms, "
                  f"{passes * flops / ms / 1e9:.2f} TFLOP/s of the function's {passes} x {flops / 1e9:.4f} GFLOP, "
                  f"{passes * mma_flops(n, dft) / ms / 1e9:.2f} TFLOP/s of MMA work issued, {nbytes / 1e6:.4f} MB, "
                  f"bound {bound_ms:.4f} ms ({bound_by}; {bound_ms / ms:.1%} of it), on {card}")
    for name in ("direct_1pass", "factored_1pass"):
        print(f"mel kernel ({name}) at S={SCALE_STREAMS}: {mel_ms[name][0]:.4f} ms against the 1-pass bound "
              f"{mel_bound[name][0]:.4f} ms ({mel_bound[name][1]}, dense bf16 tensor-core rate; "
              f"{mel_bound[name][0] / mel_ms[name][0]:.1%} of it), on {card}")
    for name in ("direct_3pass", "factored_3pass"):
        print(f"mel kernel ({name}) at S={SCALE_STREAMS}: {mel_ms[name][0]:.4f} ms against the 3-pass bound "
              f"{mel_bound[name][0]:.4f} ms ({mel_bound[name][1]}, three times the 1-pass operations at the dense "
              f"bf16 tensor-core rate; {mel_bound[name][0] / mel_ms[name][0]:.1%} of it); mean |diff| to the "
              f"plain fp32 version at least {mel_ratio[name]:.2f}x that to the plain 3-pass one, on {card}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 4")
    # 4. golden against the JAX engine's committed scores, both mel DFTs
    with np.load(testing.FIXTURE) as z:
        fixture = {k: z[k] for k in z.files}
    inputs = testing.golden_inputs(int(fixture["seed"]))
    if inputs["sha256"] != str(fixture["inputs_sha256"]):
        fail("golden inputs do not regenerate bit-exactly with this numpy")
    mel_launches = {}
    for dft in melspec_cuda.DFTS:
        with tempfile.TemporaryDirectory() as d:
            engine = MultiStreamEngine(wakeword_models=testing.write_head_checkpoints(inputs["heads"], d),
                                       n_streams=testing.GOLDEN_STREAMS, precision="highest", mel_dft=dft,
                                       device=dev, embedding_params=convert.embedding_from_jax(inputs["embedding"]))
        if engine.labels != list(fixture["labels"]):
            fail(f"labels {engine.labels} != golden {list(fixture['labels'])}")
        mel.launches[dft] = 0
        golden_err = float(np.abs(testing.run_golden(engine, inputs) - fixture["scores"]).max())
        mel_launches[dft] = mel.launches[dft]
        print(f"golden (mel_dft={dft}): max |dscore| vs the JAX engine ('highest') = {golden_err:.3e} over "
              f"{fixture['scores'].shape}, {mel_launches[dft]} {dft} mel launches")
        if not golden_err < SCORE_TOL:
            fail(f"golden scores (mel_dft={dft}) off by {golden_err} >= {SCORE_TOL}")
        if mel_launches[dft] < 3 * testing.PHASE_FRAMES:
            fail(f"the {dft} mel kernel launched {mel_launches[dft]} times in the golden run")
        del engine

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 5")
    # 5. scale: the bench configuration at 4096 streams, both mel DFTs; at
    # 'high' the engine's CNN stage runs K4-high once per prime block on the
    # warm-up's first step and K3-high on every other step
    frames = np.random.default_rng(1).integers(-2000, 2000, (SCALE_FRAMES, SCALE_STREAMS, 1280),
                                               dtype=np.int16)
    scale_scores = {}
    engine_cnn = {"prime_high": 0, "step_high": 0}
    engine_feed = {"staged_frames": 0, "feed_waits": 0}
    cnn_want = (-(-SCALE_STREAMS // config.PRIME_BLOCK_STREAMS), 2 * SCALE_FRAMES - 1)
    for dft in melspec_cuda.DFTS:
        name = melspec_cuda.variant(dft, "3pass")           # the default tier 'high' runs K1-3pass / K2-3pass
        t0 = time.perf_counter()
        engine = MultiStreamEngine(n_streams=SCALE_STREAMS, mel_dft=dft, device=dev)
        torch.cuda.synchronize()
        print(f"scale ({dft}): engine with {len(engine.labels)} labels built in {time.perf_counter() - t0:.2f} s")
        cnn_step_cuda.cnn_prime.launches["3pass"] = cnn_step_cuda.cnn_step.launches["3pass"] = 0
        t0 = time.perf_counter()
        engine.predict_frames(frames)                        # warm-up, includes the prime
        warm_s = time.perf_counter() - t0
        for k in mel.launches:
            mel.launches[k] = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        scores = engine.predict_frames(frames)
        wall = time.perf_counter() - t0
        used = {k: v for k, v in mel.launches.items() if v}
        mel_launches[name] = mel.launches[name]
        cnn_used = (cnn_step_cuda.cnn_prime.launches["3pass"], cnn_step_cuda.cnn_step.launches["3pass"])
        if cnn_used != cnn_want:
            fail(f"the engine at 'high' ({dft}) launched K4-high {cnn_used[0]} and K3-high {cnn_used[1]} times "
                 f"over one prime and {cnn_want[1]} steady steps, expected {cnn_want[0]} and {cnn_want[1]}")
        engine_cnn["prime_high"] += cnn_used[0]
        engine_cnn["step_high"] += cnn_used[1]
        # on the card every frame of both runs goes through the pinned ring
        if engine.staged_frames != 2 * SCALE_FRAMES:
            fail(f"the engine ({dft}) staged {engine.staged_frames} frames through its pinned ring over "
                 f"{2 * SCALE_FRAMES} fed")
        engine_feed["staged_frames"] += engine.staged_frames
        engine_feed["feed_waits"] += engine.feed_waits
        if scores.shape != (SCALE_FRAMES, SCALE_STREAMS, 11):
            fail(f"scale scores ({dft}) have shape {scores.shape}")
        if not (np.isfinite(scores).all() and scores.min() >= 0.0 and scores.max() <= 1.0):
            fail(f"scale scores ({dft}) are not finite values in [0, 1]")
        if used != {name: SCALE_FRAMES}:
            fail(f"the engine at 'high' ({dft}) made mel launches {used} in {SCALE_FRAMES} steps, "
                 f"expected {SCALE_FRAMES} of {name}")
        rt = SCALE_STREAMS * SCALE_FRAMES * 0.08 / wall
        print(f"scale ({dft}): {SCALE_FRAMES} frames x {SCALE_STREAMS} streams in {wall:.4f} s "
              f"({wall / SCALE_FRAMES * 1e3:.3f} ms per step; warm-up run {warm_s:.2f} s), "
              f"{rt:.0f} streams in real time, {mel_launches[name]} {name} mel launches, K4-high {cnn_used[0]} and "
              f"K3-high {cnn_used[1]} launches, {engine.staged_frames} frames staged with {engine.feed_waits} "
              f"feed waits, on {card}")
        scale_scores[dft] = scores
        del engine, scores
    dft_err = float(np.abs(scale_scores["factored"] - scale_scores["direct"]).max())
    print(f"scale: max |dscore| factored vs direct {dft_err:.3e}")
    if not dft_err < SCORE_TOL:
        fail(f"the factored and direct engines disagree at scale: {dft_err} >= {SCORE_TOL}")
    del frames, scale_scores

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6")
    # 6. CNN kernels vs plain on the card
    kernel = cnn_step.CnnStepKernel(cnn_weights(), precision="highest", device=dev)
    params = kernel.params
    folded = params.folded
    cnn_err = {"prime": 0.0, "step": 0.0}
    for n in (1, 5, 100, 130, SCALE_STREAMS):
        rng = np.random.default_rng(100 + n)
        window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n)).astype(np.float32)).to(dev)
        k_emb, k_caches = cnn_step_cuda.cnn_prime(params, window)
        p_emb, p_caches = cnn_step_cuda.cnn_prime_plain(params, window)
        if n == 5:
            n_caches, n_emb = embedding_stream.init_caches(folded, window.permute(2, 0, 1))
        n_err = 0.0
        for i in range(5):
            torch.cuda.synchronize()
            what = "prime" if i == 0 else "step"
            err = max([max_diff(k_emb, p_emb)] + [max_diff(a, b) for a, b in zip(k_caches, p_caches)])
            if not (torch.isfinite(k_emb).all() and err <= CNN_TOL):
                fail(f"CNN {what} kernel disagrees with the plain version at S={n}: {err} > {CNN_TOL}")
            cnn_err[what] = max(cnn_err[what], err)
            n_err = max(n_err, err)
            if n == 5:
                nhwc = max([max_diff(k_emb.t(), n_emb)]
                           + [max_diff(k_caches[j], n_caches[name].permute(3, 1, 2, 0))
                              for j, name in enumerate(kernel.cache_names)])
                if not nhwc <= CNN_TOL:
                    fail(f"CNN {what} kernel disagrees with the NHWC engine step at S=5: {nhwc}")
            if i == 4:
                break
            new = torch.from_numpy(rng.uniform(-2, 8, (8, 32, n)).astype(np.float32)).to(dev)
            k_emb, k_caches = cnn_step_cuda.cnn_step(params, k_caches, new)
            p_emb, p_caches = cnn_step_cuda.cnn_step_plain(params, p_caches, new)
            if n == 5:
                n_caches, n_emb = embedding_stream.step(folded, n_caches, new.permute(2, 0, 1))
        print(f"CNN kernels vs plain, S={n}: max |diff| over a prime and 4 steps {n_err:.3e}")
    print(f"CNN kernels vs plain: prime {cnn_err['prime']:.3e}, step {cnn_err['step']:.3e} (tolerance {CNN_TOL})")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6b")
    # 6b. the bf16 variants vs plain: each call fed the plain version's caches,
    # and fed its inputs rounded beforehand (the same result, bit for bit)
    kernel16 = cnn_step.CnnStepKernel(cnn_weights(), precision="bf16", device=dev)
    params16 = kernel16.params
    cnn_err["prime_bf16"] = cnn_err["step_bf16"] = 0.0
    for n in CNN_CHECK_STREAMS:
        rng = np.random.default_rng(200 + n)
        window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n)).astype(np.float32)).to(dev)
        n_err = n_e = n_limit = 0.0
        n_ratio = math.inf
        got = cnn_step_cuda.cnn_prime(params16, window)
        want = cnn_step_cuda.cnn_prime_plain(params16, window)
        ref = cnn_step_cuda.cnn_prime_plain(params, window)
        rounding_invariant(f"CNN prime_bf16 kernel at S={n}", got,
                           lambda w: cnn_step_cuda.cnn_prime(params16, w), [window])
        for i in range(4):
            torch.cuda.synchronize()
            what = "prime_bf16" if i == 0 else "step_bf16"
            if not torch.isfinite(got[0]).all():
                fail(f"CNN {what} kernel gives non-finite embeddings at S={n}")
            err, e, limit, ratio = one_pass_checks(f"CNN {what} kernel at S={n}", got, want, ref)
            cnn_err[what] = max(cnn_err[what], err)
            n_err, n_e, n_limit, n_ratio = max(n_err, err), max(n_e, e), max(n_limit, limit), min(n_ratio, ratio)
            if i == 3:
                break
            caches = want[1]
            new = torch.from_numpy(rng.uniform(-2, 8, (8, 32, n)).astype(np.float32)).to(dev)
            got = cnn_step_cuda.cnn_step(params16, caches, new)
            want = cnn_step_cuda.cnn_step_plain(params16, caches, new)
            ref = cnn_step_cuda.cnn_step_plain(params, caches, new)
            rounding_invariant(f"CNN step_bf16 kernel at S={n}, step {i + 1}", got,
                               lambda rows, *cs: cnn_step_cuda.cnn_step(params16, list(cs), rows),
                               [new, *caches])
        print(f"CNN bf16 kernels vs plain, S={n}: max |diff| over a prime and 3 steps {n_err:.3e} "
              f"(limit 1e-4 + 2 E per tensor, at most {n_limit:.3e}; E, the plain bf16 version's distance "
              f"from fp32, at most {n_e:.3e}); conv 1's output: mean |diff| to the plain fp32 version at least "
              f"{n_ratio:.2f}x that to the plain bf16 one (need {ONE_PASS_CLOSER}); "
              f"the same on inputs rounded beforehand")
    print(f"CNN bf16 kernels vs plain: prime {cnn_err['prime_bf16']:.3e}, step {cnn_err['step_bf16']:.3e}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 6c")
    # 6c. the 3-pass variants vs plain: each call fed the plain version's caches;
    # within 1e-4 of each tensor's scale, and conv 1's output (the second cache)
    # nearer the plain 3-pass version than the plain fp32 one
    kernel3 = cnn_step.CnnStepKernel(cnn_weights(), device=dev)     # the default precision, 'high'
    params3 = kernel3.params
    if params3.arith != "3pass":
        fail(f"CnnStepKernel's default precision runs {params3.arith}, not the 3-pass variant")
    cnn_err["prime_high"] = cnn_err["step_high"] = 0.0
    cnn_ratio = math.inf
    for n in CNN_CHECK_STREAMS:
        rng = np.random.default_rng(300 + n)
        window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n)).astype(np.float32)).to(dev)
        got = cnn_step_cuda.cnn_prime(params3, window)
        want = cnn_step_cuda.cnn_prime_plain(params3, window)
        ref = cnn_step_cuda.cnn_prime_plain(params, window)
        n_err, n_ratio = 0.0, math.inf
        for i in range(4):
            torch.cuda.synchronize()
            what = "prime_high" if i == 0 else "step_high"
            if not torch.isfinite(got[0]).all():
                fail(f"CNN {what} kernel gives non-finite embeddings at S={n}")
            err = max(scaled_err(a, b) for a, b in zip([got[0], *got[1]], [want[0], *want[1]]))
            if not err <= CNN_TOL:
                fail(f"CNN {what} kernel disagrees with the plain version at S={n}: {err} of its scale > {CNN_TOL}")
            ratio = nearer(f"CNN {what} kernel at S={n}, conv 1's output", got[1][1], want[1][1], ref[1][1])
            cnn_err[what] = max(cnn_err[what], max(max_diff(a, b) for a, b in zip([got[0], *got[1]],
                                                                                  [want[0], *want[1]])))
            n_err, n_ratio = max(n_err, err), min(n_ratio, ratio)
            if i == 3:
                break
            caches = want[1]
            new = torch.from_numpy(rng.uniform(-2, 8, (8, 32, n)).astype(np.float32)).to(dev)
            got = cnn_step_cuda.cnn_step(params3, caches, new)
            want = cnn_step_cuda.cnn_step_plain(params3, caches, new)
            ref = cnn_step_cuda.cnn_step_plain(params, caches, new)
        cnn_ratio = min(cnn_ratio, n_ratio)
        print(f"CNN 3-pass kernels vs plain, S={n}: max |diff| over a prime and 3 steps {n_err:.3e} of each "
              f"tensor's scale (limit {CNN_TOL}); conv 1's output: mean |diff| to the plain fp32 version at least "
              f"{n_ratio:.2f}x that to the plain 3-pass one (need {THREE_PASS_CLOSER})")
    print(f"CNN 3-pass kernels vs plain: prime {cnn_err['prime_high']:.3e}, step {cnn_err['step_high']:.3e} "
          f"(max |diff|)")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7")
    # 7. CNN path at scale: prime with kernel 4, then 50 steps of kernel 3
    rng = np.random.default_rng(7)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, SCALE_STREAMS)).astype(np.float32)).to(dev)
    cnn_frames = torch.from_numpy(rng.uniform(-2, 8, (SCALE_FRAMES, 8, 32, SCALE_STREAMS))
                                  .astype(np.float32)).to(dev)
    kernel.prime(window)                                     # warm-up
    torch.cuda.synchronize()
    cnn_step_cuda.cnn_prime.launches["fp32"] = cnn_step_cuda.cnn_step.launches["fp32"] = 0
    t0 = time.perf_counter()
    caches, _ = kernel.prime(window)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for f in range(SCALE_FRAMES):
        caches, emb = kernel.step(caches, cnn_frames[f])
    torch.cuda.synchronize()
    cnn_wall = time.perf_counter() - t1
    cnn_launches = {"prime": cnn_step_cuda.cnn_prime.launches["fp32"],
                    "step": cnn_step_cuda.cnn_step.launches["fp32"]}
    if cnn_launches != {"prime": 1, "step": SCALE_FRAMES}:
        fail(f"the CNN path launched {cnn_launches}")
    p_emb, p_caches = cnn_step_cuda.cnn_prime_plain(params, window)
    for f in range(SCALE_FRAMES):
        p_emb, p_caches = cnn_step_cuda.cnn_step_plain(params, p_caches, cnn_frames[f])
    scale_err = max([max_diff(emb, p_emb)] + [max_diff(caches[name], c)
                                              for name, c in zip(kernel.cache_names, p_caches)])
    if not (emb.shape == (96, SCALE_STREAMS) and torch.isfinite(emb).all() and scale_err <= CNN_TOL):
        fail(f"the CNN path at scale is off: shape {tuple(emb.shape)}, max |diff| {scale_err}")
    print(f"CNN path: prime {(t1 - t0) * 1e3:.3f} ms, {SCALE_FRAMES} steps x {SCALE_STREAMS} streams in "
          f"{cnn_wall:.4f} s ({cnn_wall / SCALE_FRAMES * 1e3:.3f} ms per step), "
          f"{SCALE_STREAMS * SCALE_FRAMES * 0.08 / cnn_wall:.0f} streams in real time, "
          f"max |diff| vs plain after {SCALE_FRAMES} steps {scale_err:.3e}, on {card}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7b")
    # 7b. the bf16 path at scale: prime with K4-bf16, then 50 steps of K3-bf16
    kernel16.prime(window)                                   # warm-up
    torch.cuda.synchronize()
    cnn_step_cuda.cnn_prime.launches["1pass"] = cnn_step_cuda.cnn_step.launches["1pass"] = 0
    t0 = time.perf_counter()
    caches16, _ = kernel16.prime(window)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for f in range(SCALE_FRAMES - 1):
        caches16, emb16 = kernel16.step(caches16, cnn_frames[f])
    before_last = caches16
    caches16, emb16 = kernel16.step(caches16, cnn_frames[-1])
    torch.cuda.synchronize()
    cnn16_wall = time.perf_counter() - t1
    cnn_launches["prime_bf16"] = cnn_step_cuda.cnn_prime.launches["1pass"]
    cnn_launches["step_bf16"] = cnn_step_cuda.cnn_step.launches["1pass"]
    if (cnn_launches["prime_bf16"], cnn_launches["step_bf16"]) != (1, SCALE_FRAMES):
        fail(f"the bf16 CNN path launched {cnn_launches}")
    last = [before_last[name] for name in kernel16.cache_names]
    p16_emb, p16_caches = cnn_step_cuda.cnn_step_plain(params16, last, cnn_frames[-1])
    r_emb, r_caches = cnn_step_cuda.cnn_step_plain(params, last, cnn_frames[-1])
    if not (emb16.shape == (96, SCALE_STREAMS) and torch.isfinite(emb16).all()):
        fail(f"the bf16 CNN path at scale gives {tuple(emb16.shape)} or non-finite embeddings")
    scale16_err, scale16_e, scale16_limit, scale16_ratio = one_pass_checks(
        "the bf16 CNN path's last step", (emb16, [caches16[name] for name in kernel16.cache_names]),
        (p16_emb, p16_caches), (r_emb, r_caches))
    print(f"CNN bf16 path: prime {(t1 - t0) * 1e3:.3f} ms, {SCALE_FRAMES} steps x {SCALE_STREAMS} streams in "
          f"{cnn16_wall:.4f} s ({cnn16_wall / SCALE_FRAMES * 1e3:.3f} ms per step), last step vs plain on its "
          f"inputs {scale16_err:.3e} (limit 1e-4 + 2 E, at most {scale16_limit:.3e}; E {scale16_e:.3e}), conv 1's "
          f"output {scale16_ratio:.2f}x nearer the plain bf16 version than the plain fp32 one, on {card}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 7c")
    # 7c. the 3-pass path at scale: prime with K4-high, then 50 steps of K3-high
    kernel3.prime(window)                                    # warm-up
    torch.cuda.synchronize()
    cnn_step_cuda.cnn_prime.launches["3pass"] = cnn_step_cuda.cnn_step.launches["3pass"] = 0
    t0 = time.perf_counter()
    caches3, _ = kernel3.prime(window)
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    for f in range(SCALE_FRAMES - 1):
        caches3, emb3 = kernel3.step(caches3, cnn_frames[f])
    before_last = caches3
    caches3, emb3 = kernel3.step(caches3, cnn_frames[-1])
    torch.cuda.synchronize()
    cnn3_wall = time.perf_counter() - t1
    cnn_launches["prime_high"] = cnn_step_cuda.cnn_prime.launches["3pass"]
    cnn_launches["step_high"] = cnn_step_cuda.cnn_step.launches["3pass"]
    if (cnn_launches["prime_high"], cnn_launches["step_high"]) != (1, SCALE_FRAMES):
        fail(f"the 3-pass CNN path launched {cnn_launches}")
    last = [before_last[name] for name in kernel3.cache_names]
    p3_emb, p3_caches = cnn_step_cuda.cnn_step_plain(params3, last, cnn_frames[-1])
    r_emb, r_caches = cnn_step_cuda.cnn_step_plain(params, last, cnn_frames[-1])
    new3 = [caches3[name] for name in kernel3.cache_names]
    if not (emb3.shape == (96, SCALE_STREAMS) and torch.isfinite(emb3).all()):
        fail(f"the 3-pass CNN path at scale gives {tuple(emb3.shape)} or non-finite embeddings")
    scale3_err = max(scaled_err(a, b) for a, b in zip([emb3, *new3], [p3_emb, *p3_caches]))
    if not scale3_err <= CNN_TOL:
        fail(f"the 3-pass CNN path's last step is {scale3_err} of its scale from the plain version")
    scale3_ratio = nearer("the 3-pass CNN path's last step, conv 1's output", new3[1], p3_caches[1],
                                r_caches[1])
    print(f"CNN 3-pass path: prime {(t1 - t0) * 1e3:.3f} ms, {SCALE_FRAMES} steps x {SCALE_STREAMS} streams in "
          f"{cnn3_wall:.4f} s ({cnn3_wall / SCALE_FRAMES * 1e3:.3f} ms per step), last step vs plain on its "
          f"inputs {scale3_err:.3e} of each tensor's scale (limit {CNN_TOL}), conv 1's output {scale3_ratio:.2f}x "
          f"nearer the plain 3-pass version than the plain fp32 one, on {card}")

    print(f"[{time.perf_counter() - t_start:.1f} s] phase 8")
    # 8. CNN timing at S=4096
    new = cnn_frames[0]
    caches_list = [caches[name] for name in kernel.cache_names]
    nhwc_caches = {name: c.permute(3, 1, 2, 0).contiguous() for name, c in caches.items()}
    new_nhwc = new.permute(2, 0, 1).contiguous()
    nhwc_ms_1 = cuda_ms(lambda: embedding_stream.step(folded, nhwc_caches, new_nhwc))
    step_ms = sandwich("CNN step", lambda: cnn_step_cuda.cnn_step(params, caches_list, new),
                       lambda: cnn_step_cuda.cnn_step_plain(params, caches_list, new))
    nhwc_ms_2 = cuda_ms(lambda: embedding_stream.step(folded, nhwc_caches, new_nhwc))
    print(f"CNN step at S={SCALE_STREAMS}: engine's NHWC eager step {nhwc_ms_1:.4f} / {nhwc_ms_2:.4f} ms")
    prime_ms = sandwich("CNN prime", lambda: cnn_step_cuda.cnn_prime(params, window),
                        lambda: cnn_step_cuda.cnn_prime_plain(params, window), n_iter=10)
    weights = n_bytes(*params.taps, *params.biases, params.scale, params.shift)
    cnn_bound = {
        "step": bound(plain_flops(cnn_step_cuda.cnn_step_plain, params, caches_list, new),
                      weights + n_bytes(new) + 2 * n_bytes(*caches_list) + EMB_BYTES * SCALE_STREAMS),
        "prime": bound(plain_flops(cnn_step_cuda.cnn_prime_plain, params, window),
                       weights + n_bytes(window) + n_bytes(*caches_list) + EMB_BYTES * SCALE_STREAMS),
    }
    for what, ms in (("step", step_ms[0]), ("prime", prime_ms[0])):
        print(f"CNN {what} kernel at S={SCALE_STREAMS}: {ms:.4f} ms, bound {cnn_bound[what][0]:.4f} ms "
              f"({cnn_bound[what][1]}; {cnn_bound[what][0] / ms:.1%} of it), on {card}")
    conv_profile(card, lambda: cnn_step_cuda.cnn_step(params, caches_list, new),
                 lambda: cnn_step_cuda.cnn_prime(params, window), SCALE_STREAMS)
    step16_ms = sandwich("CNN step (bf16)", lambda: cnn_step_cuda.cnn_step(params16, caches_list, new),
                         lambda: cnn_step_cuda.cnn_step_plain(params16, caches_list, new))
    prime16_ms = sandwich("CNN prime (bf16)", lambda: cnn_step_cuda.cnn_prime(params16, window),
                          lambda: cnn_step_cuda.cnn_prime_plain(params16, window), n_iter=5)
    cnn_bound["step_bf16"] = bound(plain_flops(cnn_step_cuda.cnn_step_plain, params16, caches_list, new),
                                   weights + n_bytes(new) + 2 * n_bytes(*caches_list) + EMB_BYTES * SCALE_STREAMS,
                                   peak=BF16_FLOPS)
    cnn_bound["prime_bf16"] = bound(plain_flops(cnn_step_cuda.cnn_prime_plain, params16, window),
                                    weights + n_bytes(window) + n_bytes(*caches_list) + EMB_BYTES * SCALE_STREAMS,
                                    peak=BF16_FLOPS)
    for what, ms in (("step_bf16", step16_ms[0]), ("prime_bf16", prime16_ms[0])):
        print(f"CNN {what} kernel at S={SCALE_STREAMS}: {ms:.4f} ms, bound {cnn_bound[what][0]:.4f} ms "
              f"({cnn_bound[what][1]}, dense bf16 tensor-core rate; {cnn_bound[what][0] / ms:.1%} of it), "
              f"on {card}")
    conv_profile(card, lambda: cnn_step_cuda.cnn_step(params16, caches_list, new),
                 lambda: cnn_step_cuda.cnn_prime(params16, window), SCALE_STREAMS, "conv_mma_kernel", "_bf16")
    step3_ms = sandwich("CNN step (3-pass)", lambda: cnn_step_cuda.cnn_step(params3, caches_list, new),
                        lambda: cnn_step_cuda.cnn_step_plain(params3, caches_list, new))
    prime3_ms = sandwich("CNN prime (3-pass)", lambda: cnn_step_cuda.cnn_prime(params3, window),
                         lambda: cnn_step_cuda.cnn_prime_plain(params3, window), n_iter=3)
    # the plain 3-pass version runs three products per conv: its operations are
    # three times the 1-pass ones, at the dense bf16 rate
    cnn_bound["step_high"] = bound(plain_flops(cnn_step_cuda.cnn_step_plain, params3, caches_list, new),
                                   weights + n_bytes(new) + 2 * n_bytes(*caches_list) + EMB_BYTES * SCALE_STREAMS,
                                   peak=BF16_FLOPS)
    cnn_bound["prime_high"] = bound(plain_flops(cnn_step_cuda.cnn_prime_plain, params3, window),
                                    weights + n_bytes(window) + n_bytes(*caches_list) + EMB_BYTES * SCALE_STREAMS,
                                    peak=BF16_FLOPS)
    for what, ms in (("step_high", step3_ms[0]), ("prime_high", prime3_ms[0])):
        print(f"CNN {what} kernel at S={SCALE_STREAMS}: {ms:.4f} ms, bound {cnn_bound[what][0]:.4f} ms "
              f"({cnn_bound[what][1]}, three times the 1-pass operations at the dense bf16 tensor-core rate; "
              f"{cnn_bound[what][0] / ms:.1%} of it), on {card}")
    conv_profile(card, lambda: cnn_step_cuda.cnn_step(params3, caches_list, new),
                 lambda: cnn_step_cuda.cnn_prime(params3, window), SCALE_STREAMS, "conv_mma_kernel", "_high")

    print(f"[{time.perf_counter() - t_start:.1f} s] phases 9-12")
    mel_launches["direct_3pass"] = serving(card)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 13")
    mel_launches.update(tiers(card))
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 14")
    # K1-3pass's main-path launches: the serving runs' and the loaded step's
    mel_launches["direct_3pass"] += gating(card)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 15")
    for k, n in student_and_onnx(card).items():
        mel_launches[k] += n
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 16")
    mel_launches["direct_3pass"] += tflite_import(card)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 17")
    mel_launches["direct_3pass"] += training(card)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 18")
    for k, n in f2(card).items():
        mel_launches[k] = mel_launches.get(k, 0) + n
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 19")
    mel_launches["direct_3pass"] += slice_g(card)
    print(f"[{time.perf_counter() - t_start:.1f} s] phase 20")
    band_launches, band_errs = full_band(card)
    for k, n in band_launches.items():
        mel_launches[k] = mel_launches.get(k, 0) + n
    for k, e in band_errs.items():
        mel_err[k] = max(mel_err[k], e)

    # no single PyTorch call computes any of these functions (a mel frontend or a
    # 20-conv step is several calls), so library_ms is null throughout
    kernels = [
        ("melspec_frames", "melspec.cu", "openwakeword_tpu/ops/melspec_pallas.py:73",
         mel_launches["direct"], mel_err["direct"], mel_ms["direct"], mel_bound["direct"]),
        ("melspec_frames_factored", "melspec.cu", "openwakeword_tpu/ops/melspec_pallas.py:110",
         mel_launches["factored"], mel_err["factored"], mel_ms["factored"], mel_bound["factored"]),
        ("cnn_step", "cnn_step.cu", "openwakeword_tpu/ops/cnn_pallas.py:167",
         cnn_launches["step"], cnn_err["step"], step_ms, cnn_bound["step"]),
        ("cnn_prime", "cnn_step.cu", "openwakeword_tpu/ops/cnn_pallas.py:167",
         cnn_launches["prime"], cnn_err["prime"], prime_ms, cnn_bound["prime"]),
        ("melspec_frames_1pass", "melspec_mma.cu", "openwakeword_tpu/ops/melspec_pallas.py:73",
         mel_launches["direct_1pass"], mel_err["direct_1pass"], mel_ms["direct_1pass"], mel_bound["direct_1pass"]),
        ("melspec_frames_factored_1pass", "melspec_factored_mma.cu", "openwakeword_tpu/ops/melspec_pallas.py:110",
         mel_launches["factored_1pass"], mel_err["factored_1pass"], mel_ms["factored_1pass"],
         mel_bound["factored_1pass"]),
        ("cnn_step_bf16", "cnn_step_mma.cuh", "openwakeword_tpu/ops/cnn_pallas.py:167",
         cnn_launches["step_bf16"], cnn_err["step_bf16"], step16_ms, cnn_bound["step_bf16"]),
        ("cnn_prime_bf16", "cnn_step_mma.cuh", "openwakeword_tpu/ops/cnn_pallas.py:167",
         cnn_launches["prime_bf16"], cnn_err["prime_bf16"], prime16_ms, cnn_bound["prime_bf16"]),
        ("melspec_frames_3pass", "melspec_mma.cu", "openwakeword_tpu/ops/melspec_pallas.py:73",
         mel_launches["direct_3pass"], mel_err["direct_3pass"], mel_ms["direct_3pass"], mel_bound["direct_3pass"]),
        ("melspec_frames_factored_3pass", "melspec_factored_mma.cu", "openwakeword_tpu/ops/melspec_pallas.py:110",
         mel_launches["factored_3pass"], mel_err["factored_3pass"], mel_ms["factored_3pass"],
         mel_bound["factored_3pass"]),
        ("cnn_step_high", "cnn_step_mma.cuh", "openwakeword_tpu/ops/cnn_pallas.py:167",
         engine_cnn["step_high"], cnn_err["step_high"], step3_ms, cnn_bound["step_high"]),
        ("cnn_prime_high", "cnn_step_mma.cuh", "openwakeword_tpu/ops/cnn_pallas.py:167",
         engine_cnn["prime_high"], cnn_err["prime_high"], prime3_ms, cnn_bound["prime_high"]),
    ]
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"openwakeword_tpu_torch/csrc/{src}", "replaces": replaces,
         "launches": launches, "max_abs_err": err, "ms": ms[0], "plain_ms": ms[1], "bound_ms": bnd[0],
         "bound_by": bnd[1], "library_ms": None}
        for name, src, replaces, launches, err, ms, bnd in kernels], "engine_feed": engine_feed}))
    print(f"chip_smoke: all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
