"""The plain reference against the program on the CPU, at a small size, for
both configurations, with a stream that starts mid-run.

Run: ``python -m pytest perfbench/tests -q`` from the repository's root.
"""

import pathlib
import sys
import tempfile

import numpy as np
import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from perfbench import inputs, spec, system  # noqa: E402
from perfbench.reference import pipeline  # noqa: E402

# float32 sums in other orders; the 1-pass control reads ~1e-2 here
TOL = 2e-5


@pytest.mark.parametrize("config", ["oww6", "oww6_vad_ns"])
def test_reference_matches_the_program(config):
    from openwakeword_tpu_torch.parallel.engine import MultiStreamEngine
    cell = spec.load(f"{config}.stream")
    seed, n, t, restart = 2 ** 31 + 17, 3, 30, 12
    w = system.weights(cell.config, seed)
    pcm = inputs.audio(seed, n, t, "cpu", cell.params["mix"])                    # (T, S, 1280)
    with system.head_files(w) as paths:
        engine = MultiStreamEngine(wakeword_models=paths, n_streams=n,
                                   **system.engine_kwargs(cell.config, w, "cpu"))
    got = [engine.predict(pcm[k]) for k in range(restart)]
    engine.reset_stream(1)                        # stream 1 starts again at step `restart`
    got += [engine.predict(pcm[k]) for k in range(restart, t)]
    got = np.stack(got)                                                          # (T, S, L)
    args = system.reference_args(cell.config, w)
    ref = pipeline.score_streams(pcm.transpose(1, 0, 2).reshape(n, -1), **args)["scores"]
    assert engine.labels == pipeline.head_labels(w.heads)
    for s in (0, 2):
        assert np.abs(got[:, s] - ref[s]).max() < TOL
    late = pipeline.score_streams(pcm[restart:, 1].reshape(1, -1), **args)["scores"][0]
    assert np.abs(got[restart:, 1] - late).max() < TOL
    # the scores are not trivially zero: heads and gate both at work
    assert (ref[:, 5:] > 0.05).mean() > 0.2


def test_head_files_round_trip():
    """The checkpoints the program loads hold the reference's arrays."""
    from openwakeword_tpu_torch.io.checkpoints import load_checkpoint
    cell = spec.load("oww6.stream")
    w = system.weights(cell.config, 5)
    with tempfile.TemporaryDirectory() as d:
        paths = inputs.write_head_files(w.heads, d)
        for path, head in zip(paths, w.heads):
            kind, params, meta = load_checkpoint(path)
            assert kind == "head" and params["__meta__"] == head["meta"]
            for layer, leaves in head["params"].items():
                for leaf, v in leaves.items():
                    np.testing.assert_array_equal(params[layer][leaf], v)


def test_inputs_depend_only_on_the_seed():
    mix = spec.load("oww6.stream").params["mix"]
    a = inputs.audio(2 ** 33 + 1, 3, 4, "cpu", mix)
    assert np.array_equal(a, inputs.audio(2 ** 33 + 1, 3, 4, "cpu", mix))
    assert not np.array_equal(a, inputs.audio(2 ** 33 + 2, 3, 4, "cpu", mix))


def test_reference_restores_the_tf32_flags():
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    try:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        cell = spec.load("oww6.stream")
        w = system.weights(cell.config, 3)
        pcm = np.zeros((1, 6 * pipeline.CHUNK), np.int16)
        out = pipeline.score_streams(pcm, **system.reference_args(cell.config, w))
        assert out["scores"].shape == (1, 6, 11) and not out["scores"][:, :5].any()
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved
