#!/usr/bin/env python3
"""Times the port's mel kernels on one card, for comparing two trees in one call.

    python3 tools/mel_times.py [--tree DIR] [--label NAME] [--fmax HZ]

Imports ``openwakeword_tpu_torch`` from ``DIR`` (default: the checkout that
holds this script), sets ``config.FMAX`` to ``HZ`` where given (the
filterbank's upper edge, which sets the kernels' live range), builds its CUDA
library for that range, holds each mel kernel variant
(``melspec_cuda.VARIANTS``) against its plain version at S = 17 (one silent
stream) and times it with CUDA events at S = 1 and S = 4096 (the better of
two runs of 50 launches after 5 warm-up launches). Prints the card's name
and power limit, the ptxas lines of the mel kernels, and one JSON line
``{"label": ..., "tree": ..., "card": ..., "fmax": ..., "ms": {variant: {"1": t, "4096": t}},
"max_abs_err": {variant: e}}``. To compare two commits, unpack the other one
with ``git archive`` into a git-ignored directory (``dist/``) and run both
trees in turns in one call: A, B, B, A.
"""

import argparse
import json
import os
import subprocess
import sys

import numpy as np

STREAMS = (1, 4096)
CHECK_STREAMS = 17
TOL_DB = {"fp32": 2e-3, "3pass": 2e-3, "1pass": 2e-3 + 10 * np.log10(1 + 2 ** -7)}


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
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--tree", default=os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    ap.add_argument("--label", default=None)
    ap.add_argument("--fmax", type=float, default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        sys.exit("mel_times: needs an NVIDIA GPU (torch.cuda.is_available() is false)")
    tree = os.path.abspath(args.tree)
    sys.path.insert(0, tree)
    from openwakeword_tpu_torch import config
    from openwakeword_tpu_torch.ops import melspec_cuda
    from openwakeword_tpu_torch.utils import cuda_build
    if args.fmax is not None:
        config.FMAX = args.fmax
    if not melspec_cuda.__file__.startswith(tree):
        sys.exit(f"mel_times: imported {melspec_cuda.__file__}, not the tree {tree}")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.splitlines()[0].strip()
    built = cuda_build.load_library()
    print(f"tree {tree}: FMAX {config.FMAX}, live bins {melspec_cuda.live_bins()}, built in "
          f"{built.build_seconds:.1f} s, on {card}")
    keep = False
    for line in built.log.splitlines():
        if "Compiling entry" in line:
            keep = "melspec" in line
        if keep and ("Compiling entry" in line or "registers" in line or "spill" in line):
            print(f"  ptxas: {line.strip()}")
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(0)
    ms, errs = {}, {}
    for name in melspec_cuda.VARIANTS:
        dft, _, arith = name.partition("_")
        arith = arith or "fp32"
        w = (rng.uniform(-1, 1, (CHECK_STREAMS, melspec_cuda.WINDOW)) * 25000).astype(np.float32)
        w[CHECK_STREAMS // 2] = 0.0
        x = torch.from_numpy(w).to(dev)
        got = melspec_cuda.melspectrogram_frames(x, dft, arith)
        err = float((got - melspec_cuda.melspectrogram_frames_plain(x, dft, arith)).abs().max())
        if not err <= TOL_DB[arith]:
            sys.exit(f"mel_times: {name} is {err} dB from its plain version at S={CHECK_STREAMS}")
        errs[name] = err
        ms[name] = {}
        for n in STREAMS:
            x = torch.from_numpy((rng.uniform(-1, 1, (n, melspec_cuda.WINDOW)) * 25000).astype(np.float32)).to(dev)
            ms[name][str(n)] = min(cuda_ms(lambda: melspec_cuda.melspectrogram_frames(x, dft, arith))
                                   for _ in range(2))
        print(f"{name}: {ms[name]['1']:.4f} ms at S=1, {ms[name]['4096']:.4f} ms at S=4096, "
              f"max |diff| {err:.3e} dB at S={CHECK_STREAMS}")
    print(json.dumps({"label": args.label or tree, "tree": tree, "card": card, "fmax": config.FMAX, "ms": ms,
                      "max_abs_err": errs}))


if __name__ == "__main__":
    main()
