"""Wake-word detection metrics (reference openwakeword/metrics.py:24-100); a
copy of ``openwakeword_tpu.metrics``, kept here so the port imports nothing
of the JAX package.

``get_false_positives`` groups consecutive/nearby above-threshold frames into
single activation events: after each rising edge, further positives within
``grouping_window`` frames (default 50 = 4 s at 80 ms/frame) count as the same
event. (The reference's regex implementation truncates the suppression window
with the transition *count* rather than the score length -- a bug; the
documented grouping behavior is implemented here.)
"""

from typing import List

import numpy as np


def get_false_positives(scores: List, threshold: float, grouping_window: int = 50) -> int:
    """Number of distinct false-positive activation events in a score stream.

    Greedy earliest-first grouping: an above-threshold frame starts an event
    and suppresses the following ``grouping_window`` frames. The loop jumps
    between above-threshold indices (one iteration per *event*, not per
    frame), so threshold sweeps over multi-hour corpora stay cheap."""
    hits = np.flatnonzero(np.asarray(scores) >= threshold)
    count = 0
    pos = 0
    while pos < hits.size:
        count += 1
        pos = np.searchsorted(hits, hits[pos] + grouping_window)
    return int(count)


def generate_roc_curve_fprs(scores: list, n_points: int = 25,
                            time_per_prediction: float = 0.08, **kwargs) -> list:
    """False-positive events per hour across n_points thresholds in
    [0.01, 0.99], assuming every prediction should be negative."""
    scores = np.asarray(scores)
    if len(scores) == 0:
        return [0.0] * n_points
    total_hours = time_per_prediction * len(scores) / 3600
    return [get_false_positives(scores, threshold=t, **kwargs) / total_hours
            for t in np.linspace(0.01, 0.99, num=n_points)]


def generate_roc_curve_tprs(scores: list, n_points: int = 25) -> list:
    """True-positive rate across thresholds, assuming every prediction should
    be positive."""
    scores = np.asarray(scores)
    return [float(np.sum(scores >= t) / len(scores))
            for t in np.linspace(0.01, 0.99, num=n_points)]
