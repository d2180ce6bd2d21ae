#!/usr/bin/env python3
"""Times the port's CNN step and prime kernels on one card, for comparing two trees in one call.

    python3 tools/cnn_times.py [--tree DIR] [--label NAME] [--streams S]

Imports ``openwakeword_tpu_torch`` from ``DIR`` (default: the checkout that
holds this script), builds its CUDA library, holds each CNN variant (K3/K4
and their 1-pass and 3-pass variants, ``cnn_step_cuda.VARIANTS``) against
its plain version on a prime and one step at S = 21 (ragged block tiles,
4-byte loads) and S = 36 (16-byte loads), each step fed the plain version's
caches: within 1e-4 (fp32), 1e-4 + 2 E (1-pass, E the plain 1-pass
version's distance from the plain fp32 one) or 1e-4 of each tensor's scale
(3-pass). Then it times each variant's step at S = ``--streams`` (default
4096) and its prime at S or at the engine's prime block
(``config.PRIME_BLOCK_STREAMS``), whichever is less, with CUDA events (the
better of two runs of 50 steps or 10 primes after warm-up calls), and
traces one 1-pass and one 3-pass step and prime under ``torch.profiler``
for each conv's device time; the step's caches are the plain prime's,
repeated along the streams past the prime's S. Prints the card's name and
power limit, the ptxas register and spill lines of the CNN kernels (the
fp32 ones from ``cnn_step.cu``, the 1-pass ones from ``cnn_step_bf16.cu``,
the 3-pass ones from ``cnn_step_high.cu``), and one JSON line ``{"label":
..., "tree": ..., "card": ..., "streams": {"step": S, "prime": S'}, "ms":
{variant: {"step": t, "prime": t}}, "max_err": {variant: e}, "convs_1pass":
{"step": [ms per conv], "prime": [...]}, "convs_3pass": {...}}``. To
compare two commits, unpack the other one with ``git archive`` into a
git-ignored directory (``dist/``) and run both trees in turns in one call:
A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

CHECK_STREAMS = (21, 36)
STREAMS = 4096
TOL = 1e-4                 # the JAX CNN kernel tests' tolerance (tests/test_cnn_pallas.py)


def cuda_ms(fn, n_iter: int, n_warm: int = 3) -> float:
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


def folded_weights(convert, embedding):
    """Seeded He-normal convs with non-trivial BatchNorm statistics, folded
    (``chip_smoke.py``'s ``cnn_weights``)."""
    rng = np.random.default_rng(11)
    p = embedding.init_params(rng)
    for k in [k for k in p if k.startswith("bn_")]:
        c = p[k]["gamma"].shape[0]
        p[k] = {"gamma": (0.7 + 0.5 * rng.random(c)).astype(np.float32),
                "beta": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "mean": (0.3 * (rng.random(c) - 0.5)).astype(np.float32),
                "var": (0.8 + 0.4 * rng.random(c)).astype(np.float32)}
    return embedding.fold_batchnorm(convert.embedding_from_jax(p))


def check(cnn_step_cuda, params, ref, arith: str, n: int, dev) -> float:
    """The variant's largest error over a prime and one step at S = n; exits
    past its tolerance."""
    import torch
    rng = np.random.default_rng(n)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n)).astype(np.float32)).to(dev)
    new = torch.from_numpy(rng.uniform(-2, 8, (8, 32, n)).astype(np.float32)).to(dev)
    calls = [(cnn_step_cuda.cnn_prime(params, window), cnn_step_cuda.cnn_prime_plain(params, window),
              cnn_step_cuda.cnn_prime_plain(ref, window))]
    caches = calls[0][1][1]
    calls.append((cnn_step_cuda.cnn_step(params, caches, new), cnn_step_cuda.cnn_step_plain(params, caches, new),
                  cnn_step_cuda.cnn_step_plain(ref, caches, new)))
    torch.cuda.synchronize()
    worst = 0.0
    for got, want, want32 in calls:
        for a, b, c in zip([got[0], *got[1]], [want[0], *want[1]], [want32[0], *want32[1]]):
            err = float((a - b).abs().max())
            if arith == "3pass":
                err /= max(float(b.abs().max()), 1e-30)
                limit = TOL
            elif arith == "1pass":
                limit = TOL + 2 * float((b - c).abs().max())
            else:
                limit = TOL
            if not (torch.isfinite(a).all() and err <= limit):
                sys.exit(f"cnn_times: {arith} is {err} from its plain version at S={n} (limit {limit})")
            worst = max(worst, err)
    return worst


def conv_ms(fn, n_convs: int) -> list:
    """Each conv's device ms in one call of ``fn``: the i-th CNN kernel launch
    of the call is conv i (a whole call of two traced, as chip_smoke.py's
    ``conv_profile``)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    filler = torch.zeros(1, device="cuda")
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            filler.add_(1.0)
            torch.cuda.synchronize()
            for _ in range(2):
                fn()
                torch.cuda.synchronize()
                time.sleep(0.005)
            filler.add_(1.0)
            torch.cuda.synchronize()
        launches = sorted((e for e in prof.events() if e.device_type == DeviceType.CUDA
                           and ("conv_layer_kernel" in e.name or "conv_mma_kernel" in e.name)),
                          key=lambda e: e.time_range.start)
        calls, current = [], []
        for e in launches:
            if current and e.time_range.start - current[-1].time_range.end > 2000:
                calls.append(current)
                current = []
            current.append(e)
        calls.append(current)
        whole = [c for c in calls if len(c) == n_convs]
        if whole:
            return [round((e.time_range.end - e.time_range.start) / 1e3, 5) for e in whole[0]]
    sys.exit(f"cnn_times: the profiler saw no whole call of {n_convs} conv launches in three traces")


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--streams", type=int, default=STREAMS, help="streams of the timed step (default 4096)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("cnn_times: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from openwakeword_tpu_torch import config, convert
    from openwakeword_tpu_torch.models import embedding
    from openwakeword_tpu_torch.ops import cnn_step, cnn_step_cuda
    from openwakeword_tpu_torch.utils import cuda_build
    if not cnn_step_cuda.__file__.startswith(tree):
        sys.exit(f"cnn_times: imported {cnn_step_cuda.__file__}, not the tree {tree}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    built = cuda_build.load_library()
    print(f"tree {tree}: built in {built.build_seconds:.1f} s, on {card}")
    keep = False
    for line in built.log.splitlines():
        if "Compiling entry" in line:
            keep = "conv_layer_kernel" in line or "conv_mma_kernel" in line
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    folded = {k: {n: t.to(dev) for n, t in v.items()} for k, v in folded_weights(convert, embedding).items()}
    ref = cnn_step.prep_params(folded)
    n_step, n_prime = args.streams, min(args.streams, int(config.PRIME_BLOCK_STREAMS))
    rng = np.random.default_rng(7)
    window = torch.from_numpy(rng.uniform(-2, 8, (76, 32, n_prime)).astype(np.float32)).to(dev)
    new = torch.from_numpy(rng.uniform(-2, 8, (8, 32, n_step)).astype(np.float32)).to(dev)
    # the plain prime's caches, repeated along the streams up to the step's S
    caches = [c.repeat(1, 1, 1, -(-n_step // n_prime))[..., :n_step].contiguous()
              for c in cnn_step_cuda.cnn_prime_plain(ref, window)[1]]
    ms, errs, convs = {}, {}, {}
    n_convs = len(cnn_step.conv_table())
    for arith in cnn_step_cuda.VARIANTS:
        params = cnn_step.prep_params(folded, arith)
        errs[arith] = max(check(cnn_step_cuda, params, ref, arith, n, dev) for n in CHECK_STREAMS)
        step = lambda: cnn_step_cuda.cnn_step(params, caches, new)       # noqa: E731
        prime = lambda: cnn_step_cuda.cnn_prime(params, window)           # noqa: E731
        ms[arith] = {"step": min(cuda_ms(step, 50) for _ in range(2)),
                     "prime": min(cuda_ms(prime, 10) for _ in range(2))}
        print(f"{arith}: step {ms[arith]['step']:.4f} ms at S={n_step}, prime {ms[arith]['prime']:.4f} ms "
              f"at S={n_prime}, max error vs plain {errs[arith]:.3e} at S={CHECK_STREAMS}", flush=True)
        if arith != "fp32":
            convs[arith] = {"step": conv_ms(step, n_convs), "prime": conv_ms(prime, n_convs)}
            print(f"{arith} per conv: {json.dumps(convs[arith])}")
    print(json.dumps({"label": args.label or tree, "tree": tree, "card": card,
                      "streams": {"step": n_step, "prime": n_prime}, "ms": ms, "max_err": errs,
                      "convs_1pass": convs["1pass"], "convs_3pass": convs["3pass"]}))


if __name__ == "__main__":
    main()
