"""The comparison that decides ``correct``.

The drivers hand over, for a sample of streams drawn from the seed, each
stream's raw PCM from its start and the scores the timed path produced for
it. The reference (``reference.pipeline``) scores the same PCM with the same
weights, and the run is correct when every number compared lies within its
limit, set in the cell's file:

* ``score_gap``: the widest gap between a score the program served and the
  reference's, over every step and label of the sample. Where the
  reference's VAD gate reading lies within ``GATE_MARGIN`` of the threshold,
  a score is held to the nearer of the gated and the ungated reference (a
  float32 rounding can tip a gate that close either way);
* ``unscored``: steps of the sample that came back without scores (limit 0);
* ``labels``: 1 when the program's labels differ from the configuration's.
"""

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from perfbench.reference import pipeline

GATE_MARGIN = 1e-4
GROUP = 32            # streams the reference scores at once


def compare(histories: Sequence[Dict], labels: List[str], ref_args: Dict, limits: Dict, device) -> Tuple[Dict, Dict]:
    """``histories``: [{"pcm": (T * 1280,) int16, "scores": (T, L) float32,
    NaN where no score came}]. Returns ({name: {"value", "limit"}}, {"steps":
    steps compared, "gate_ambiguous": steps held to either gate outcome})."""
    gap, unscored, ambiguous, steps = 0.0, 0, 0, 0
    want_labels = pipeline.head_labels(ref_args["heads"])
    for g in range(0, len(histories), GROUP):
        group = histories[g:g + GROUP]
        t_max = max(h["scores"].shape[0] for h in group)
        pcm = np.zeros((len(group), t_max * pipeline.CHUNK), np.int16)
        for i, h in enumerate(group):
            pcm[i, :h["pcm"].size] = h["pcm"]
        ref = pipeline.score_streams(pcm, device=device, **ref_args)
        for i, h in enumerate(group):
            t = h["scores"].shape[0]
            steps += t
            got = h["scores"]
            missing = np.isnan(got).any(axis=1)
            unscored += int(missing.sum())
            d = np.abs(got - ref["scores"][i, :t])
            if ref["gate"] is not None:
                near = np.abs(ref["gate"][i, :t] - ref_args["vad"]["threshold"]) < GATE_MARGIN
                ambiguous += int(near.sum())
                d[near] = np.minimum(d[near], np.abs(got - ref["ungated"][i, :t])[near])
            d = d[~missing]
            if d.size:
                gap = max(gap, float(d.max()))
        del ref
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    return {"score_gap": {"value": gap, "limit": limits["score_gap"]},
            "unscored": {"value": unscored, "limit": 0},
            "labels": {"value": int(list(labels) != want_labels), "limit": 0}}, \
        {"steps": steps, "gate_ambiguous": ambiguous}


def passed(checks: Dict) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())
