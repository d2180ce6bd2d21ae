"""Imported Silero VAD graphs as PyTorch programs (counterpart of
``openwakeword_tpu.models.silero``).

The reference runs ``silero_vad.onnx`` with onnxruntime, feeding
``{input (B, T), h (2, B, 64), c (2, B, 64), sr}`` and reading
``(score, hn, cn)``. Here the graph runs through ``io.onnx_graph`` with the
sample rate pinned to 16 kHz at import (the ``If`` branch folds away), and
``SileroProgram`` maps its named I/O onto the ``(params, x, h, c) ->
(score, h', c')`` convention of ``models.vad_net``, so the ``VAD`` class and
the engine's VAD stage take either network.
"""

from typing import Dict, Tuple

import numpy as np
import torch

from openwakeword_tpu_torch import config


class SileroProgram:
    """Role-mapped ONNX VAD program with the vad_net apply() contract."""

    def __init__(self, program):
        self.program = program
        self.params = program.params

        audio = h = c = None
        for name in program.input_names:
            low = name.lower()
            if low in ("h", "h0", "hidden") or low.endswith(".h"):
                h = name
            elif low in ("c", "c0", "cell") or low.endswith(".c"):
                c = name
            elif audio is None:
                audio = name
        remaining = [n for n in program.input_names if n not in (audio, h, c)]
        if h is None and remaining:
            h = remaining.pop(0)
        if c is None and remaining:
            c = remaining.pop(0)
        if audio is None or h is None or c is None:
            raise ValueError(f"Could not map VAD graph inputs {program.input_names} onto "
                             "(audio, h, c) roles")
        self._in = (audio, h, c)

        score = hn = cn = None
        for name in program.output_names:
            low = name.lower()
            if low in ("hn", "h1", "state_h") or low.endswith("hn"):
                hn = name
            elif low in ("cn", "c1", "state_c") or low.endswith("cn"):
                cn = name
            elif score is None:
                score = name
        remaining = [n for n in program.output_names if n not in (score, hn, cn)]
        if hn is None and remaining:
            hn = remaining.pop(0)
        if cn is None and remaining:
            cn = remaining.pop(0)
        if score is None or hn is None or cn is None:
            raise ValueError(f"Could not map VAD graph outputs {program.output_names} onto "
                             "(score, hn, cn) roles")
        self._out = (score, hn, cn)

    def apply(self, params: Dict, x: torch.Tensor, h: torch.Tensor, c: torch.Tensor
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """(B, N) normalized audio + (2, B, 64) state -> (score (B,), h', c').
        ``params`` is the program's params dict (numpy or tensors), the same
        object from call to call (each dict gets its own plan)."""
        out = self.program.apply(params, {self._in[0]: x, self._in[1]: h, self._in[2]: c})
        score = out[self._out[0]]
        if score.numel() == x.shape[0]:
            score = score.reshape(x.shape[0])
        if score.ndim > 1:
            score = score[..., 0]
        return score, out[self._out[1]], out[self._out[2]]

    @property
    def min_samples(self) -> int:
        return 256


def from_meta(meta: Dict, params: Dict) -> SileroProgram:
    """Rebuild a SileroProgram from checkpoint metadata carrying an ONNX
    program spec (a ``"format": "onnx_program"`` checkpoint)."""
    from openwakeword_tpu_torch.io.onnx_graph import OnnxProgram
    return SileroProgram(OnnxProgram.from_spec(meta["spec"], params))


def import_onnx(path_or_graph, static_sr: int = config.SAMPLE_RATE) -> SileroProgram:
    """Import a silero_vad.onnx (or structurally equivalent) graph."""
    from openwakeword_tpu_torch.io import onnx_proto as op
    from openwakeword_tpu_torch.io.onnx_graph import OnnxProgram

    graph = op.load_onnx(path_or_graph)["graph"] if isinstance(path_or_graph, str) else path_or_graph
    # pin every integer input (the sample-rate selector) so the If folds
    static = {vi["name"]: np.asarray(static_sr, np.int64) for vi in graph["inputs"]
              if vi["name"] not in graph["initializers"] and vi.get("elem_type") in (6, 7)}
    return SileroProgram(OnnxProgram(graph, static_inputs=static))
