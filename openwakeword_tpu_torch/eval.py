"""Model evaluation: false-accept / true-accept methodology at engine speed
(counterpart of ``openwakeword_tpu.eval``).

Re-implements the reference's published evaluation recipe (reference
``notebooks/performance_metrics.ipynb`` cells 0-12 and ``metrics.py:24-100``)
as a library module driven by the batched multi-stream engine instead of a
process pool:

  * **False accepts** are counted on a long *negative* corpus (the reference
    uses the ~5.5 h Dinner Party Corpus): every frame score above threshold
    starts one activation event, and the following ``grouping_window`` frames
    (default 50 = 4 s) are suppressed so one activation is never
    double-counted. Reported as events per hour, with hours derived from the
    actual frame count (80 ms per score).
  * **False rejects** are counted per *positive* clip: a clip counts as a
    true accept when any frame in it scores at or above threshold (the
    per-clip-max rule), after padding each clip with silence so the full
    utterance fits the scoring windows.
  * ``far_tar_curve`` sweeps both over thresholds — the curve the reference
    publishes for every pretrained model (e.g. reference
    docs/models/alexa.md:70-78).

All scoring goes through the port's ``parallel.bulk_predict`` and
``bulk_predict_streaming`` (the multi-stream engine, whose mel stage is the
hand-written kernel of its tier on a CUDA device), so a 12 GB corpus
evaluates at engine throughput rather than ``ncpu`` host processes. Engine
options (``device``, ``precision``, ``embedding_params``, ...) pass through
``**kwargs``.
"""

import logging
from typing import Dict, Optional, Sequence

import numpy as np

from openwakeword_tpu_torch.metrics import get_false_positives


def score_files_multi(file_paths: Sequence[str],
                      wakeword_models: Sequence[str],
                      padding: int = 1,
                      batch_size: int = 1024,
                      segment_seconds: Optional[float] = None,
                      **kwargs):
    """Score WAV files through the batched engine, keeping EVERY label.

    The multiclass primitive (a timer-style model serves many labels from
    one forward pass — scoring the corpus once per label would multiply
    engine work by the label count). Returns
    ``({path: (n_frames, n_labels) float array}, labels)``.

    With ``segment_seconds`` set, files stream through the engine in
    bounded windows with carried state (fixed memory regardless of file
    length — required for multi-hour negative corpora like the reference's
    ~5.5 h DipCo set); scores match the one-shot path up to float32
    rounding (same frames and carried state).
    """
    if segment_seconds is not None:
        from openwakeword_tpu_torch.parallel.bulk import bulk_predict_streaming
        # the streaming path holds (streams x segment) decoded PCM int16 on
        # the host per step; derive the stream cap from the actual product
        # so the buffer stays ~128 MB at ANY segment length (a fixed
        # two-point threshold let short segments with large batch_size
        # double the bound)
        target_bytes = 128 << 20
        seg_streams = min(batch_size, max(1, int(
            target_bytes / (segment_seconds * 16000 * 2))))
        if seg_streams < batch_size:
            logging.info(
                "score_files: streaming path caps the engine at %d streams "
                "(requested batch_size=%d) to bound host segment memory; "
                "lower segment_seconds to raise the cap, or pass "
                "segment_seconds=None for the one-shot batch path",
                seg_streams, batch_size)
        return bulk_predict_streaming(
            list(file_paths), wakeword_models=list(wakeword_models),
            padding=padding, batch_size=seg_streams,
            segment_seconds=segment_seconds, **kwargs)
    from openwakeword_tpu_torch.parallel.bulk import bulk_predict
    preds = bulk_predict(list(file_paths), wakeword_models=list(wakeword_models),
                         padding=padding, batch_size=batch_size, **kwargs)
    mats: Dict[str, np.ndarray] = {}
    labels: Optional[list] = None
    for path, frames in preds.items():
        if labels is None and frames:
            labels = list(frames[0])
        cols = labels or []
        mats[path] = np.array([[f[c] for c in cols] for f in frames],
                              dtype=np.float32).reshape(len(frames), len(cols))
    return mats, (labels or [])


def score_files(file_paths: Sequence[str], wakeword_models: Sequence[str],
                label: Optional[str] = None, padding: int = 1,
                batch_size: int = 1024,
                segment_seconds: Optional[float] = None,
                **kwargs) -> Dict[str, np.ndarray]:
    """Single-label convenience over :func:`score_files_multi`.

    Returns {path: (n_frames,) float array} of per-frame scores for
    ``label`` (default: the first label of the first model).
    """
    mats, labels = score_files_multi(
        file_paths, wakeword_models, padding=padding, batch_size=batch_size,
        segment_seconds=segment_seconds, **kwargs)
    if label is not None and labels and label not in labels:
        raise KeyError(label)
    col = labels.index(label) if (label is not None and labels) else 0
    return {path: (np.ascontiguousarray(mat[:, col]) if mat.size
                   else np.zeros(0, np.float32))
            for path, mat in mats.items()}


def _as_streams(negative_scores) -> list:
    """Normalize to a list of per-file 1-D score streams. Event grouping
    must not suppress across file boundaries (an activation at the end of
    file A and another at the start of file B are two events), so callers
    pass per-file streams; a single 1-D array is treated as one stream."""
    if isinstance(negative_scores, np.ndarray) and negative_scores.ndim == 1:
        return [negative_scores]
    return [np.asarray(s) for s in negative_scores]


def false_accepts_per_hour(negative_scores, threshold: float,
                           grouping_window: int = 50,
                           frame_seconds: float = 0.08) -> float:
    """Distinct false-activation events per hour on a negative corpus
    (the DipCo-style FAR metric; hours derived from the frame count).
    ``negative_scores``: one 1-D score stream or a sequence of per-file
    streams (events are counted per file, so the grouping window never
    suppresses across file boundaries)."""
    streams = _as_streams(negative_scores)
    total = sum(s.size for s in streams)
    if total == 0:
        return 0.0
    hours = total * frame_seconds / 3600.0
    events = sum(get_false_positives(s, threshold=threshold,
                                     grouping_window=grouping_window)
                 for s in streams if s.size)
    return events / hours


def false_reject_rate(positive_clip_scores: Sequence[np.ndarray],
                      threshold: float) -> float:
    """Fraction of positive clips whose per-clip max score misses the
    threshold (the reference's per-clip false-reject rule); NaN when no
    clips are given."""
    clips = list(positive_clip_scores)
    if not clips:
        # no positives measured: the rate is undefined, not perfect
        return float("nan")
    maxima = np.array([np.max(c) if np.asarray(c).size else 0.0 for c in clips])
    return float(np.mean(maxima < threshold))


def far_tar_curve(negative_scores,
                  positive_clip_scores: Sequence[np.ndarray],
                  thresholds: Optional[Sequence[float]] = None,
                  grouping_window: int = 50,
                  frame_seconds: float = 0.08) -> Dict[str, np.ndarray]:
    """The published FAR/hr vs TAR trade-off curve.

    Args:
        negative_scores: per-frame score stream(s) from the negative corpus —
            a sequence of per-file arrays (preferred: event grouping then
            never suppresses across file boundaries) or one 1-D array.
        positive_clip_scores: per-clip score arrays from the positive set.
        thresholds: sweep points (default: 50 points in [0.01, 0.99] — denser
            than the reference's 25 for a smoother published curve).
    Returns:
        {"thresholds", "far_per_hour", "tar", "frr"} as float arrays.
    """
    if thresholds is None:
        thresholds = np.linspace(0.01, 0.99, 50)
    thresholds = np.asarray(thresholds, dtype=np.float64)
    far = np.array([false_accepts_per_hour(negative_scores, t,
                                           grouping_window, frame_seconds)
                    for t in thresholds])
    frr = np.array([false_reject_rate(positive_clip_scores, t)
                    for t in thresholds])
    return {"thresholds": thresholds, "far_per_hour": far,
            "tar": 1.0 - frr, "frr": frr}


def evaluate_model(wakeword_model: str,
                   negative_files: Sequence[str],
                   positive_files,
                   label: Optional[str] = None,
                   labels: Optional[Sequence[str]] = None,
                   threshold: float = 0.5,
                   padding: int = 2,
                   thresholds: Optional[Sequence[float]] = None,
                   segment_seconds: Optional[float] = 60.0,
                   **kwargs) -> Dict:
    """End-to-end evaluation: scores both corpora through the engine ONCE
    and reports headline numbers plus the full curve — per label.

    Single-label models return the flat dict of prior rounds
    (``far_per_hour`` / ``frr`` at ``threshold``, the swept ``curve``,
    ``negative_hours``, ``rejected_clips`` — the notebook's
    listen-to-the-failures list). Multiclass heads (the timer model serves
    many labels from one forward pass) evaluate every label from the same
    two engine passes: pass ``labels`` (or leave None for all served
    labels) and, when positives differ per class, make ``positive_files``
    a ``{label: [files]}`` dict; the result then carries ``per_label``
    with one flat result per label plus the single-label fields for the
    first requested label (so existing callers keep working).

    ``padding`` applies to positive clips only (it exists so short
    utterances fill the scoring windows); negatives are always scored
    unpadded so the FAR/hr denominator equals the real corpus duration.
    With no positive files for a label, its ``frr`` is NaN.

    ``segment_seconds`` (default 60) streams the negative corpus through
    the engine in bounded windows, so multi-hour recordings evaluate under
    a fixed memory budget; pass None to force the one-shot batch path.
    """
    pos_by_label = dict(positive_files) if isinstance(positive_files, dict) \
        else None
    all_pos_files = sorted({f for fs in pos_by_label.values() for f in fs}) \
        if pos_by_label is not None else list(positive_files)

    # negatives are scored UNPADDED: padding silence would count toward the
    # FAR denominator (negative_hours) without being part of the corpus,
    # systematically under-reporting false accepts per hour
    neg_mats, served = score_files_multi(
        negative_files, [wakeword_model], padding=0,
        segment_seconds=segment_seconds, **kwargs)
    pos_mats, served_p = score_files_multi(
        all_pos_files, [wakeword_model], padding=padding, **kwargs)
    served = served or served_p

    if labels is None:
        labels = [label] if label is not None else \
            (list(pos_by_label) if pos_by_label is not None else list(served))
    unknown = [lb for lb in labels if lb not in served]
    if unknown:
        raise KeyError(f"label(s) {unknown} not served by "
                       f"{wakeword_model!r} (labels: {served})")

    per_label: Dict[str, Dict] = {}
    for lbl in labels:
        col = served.index(lbl)
        # per-file streams: the 4 s activation-grouping window must not
        # suppress an event at the start of one file because another file
        # ended with an activation
        neg_streams = [np.ascontiguousarray(neg_mats[p][:, col])
                       if neg_mats[p].size else np.zeros(0, np.float32)
                       for p in negative_files]
        lbl_pos = pos_by_label.get(lbl, []) if pos_by_label is not None \
            else all_pos_files
        pos_clips = [np.ascontiguousarray(pos_mats[p][:, col])
                     if pos_mats[p].size else np.zeros(0, np.float32)
                     for p in lbl_pos]
        curve = far_tar_curve(neg_streams, pos_clips, thresholds=thresholds)
        maxima = np.array([np.max(c) if c.size else 0.0 for c in pos_clips]) \
            if pos_clips else np.zeros(0)
        rejected = [p for p, mx in zip(lbl_pos, maxima) if mx < threshold]
        per_label[lbl] = {
            "threshold": threshold,
            "far_per_hour": false_accepts_per_hour(neg_streams, threshold),
            "frr": false_reject_rate(pos_clips, threshold),
            "negative_hours": sum(s.size for s in neg_streams) * 0.08 / 3600.0,
            "n_positive_clips": len(pos_clips),
            "rejected_clips": rejected,
            "curve": curve,
        }

    out = dict(per_label[labels[0]])
    if len(per_label) > 1 or pos_by_label is not None:
        out["per_label"] = per_label
    return out


def render_model_page(model_name: str, results: Dict,
                      path: Optional[str] = None,
                      curve_points: int = 8) -> str:
    """Render an evaluation result into the markdown performance section
    the reference publishes for every pretrained model (reference
    docs/models/*.md, e.g. alexa.md's FAR/hr-vs-recall table) — so a
    multiclass evaluation assembles its per-model curve page with one
    call instead of by hand.

    ``results`` is an :func:`evaluate_model` return value (per-label pages
    are emitted when it carries ``per_label``). Writes to ``path`` when
    given; returns the markdown either way.
    """
    blocks = []
    per_label = results.get("per_label") or {"": results}
    for lbl, r in per_label.items():
        title = f"## Performance — {lbl}" if lbl else "## Performance"
        c = r["curve"]
        idx = np.linspace(0, len(c["thresholds"]) - 1,
                          min(curve_points, len(c["thresholds"]))).astype(int)
        rows = "\n".join(
            f"| {c['thresholds'][i]:.2f} | {c['far_per_hour'][i]:.2f} "
            f"| {100 * c['tar'][i]:.1f}% |" for i in idx)
        blocks.append(
            f"{title}\n\n"
            f"Measured on {r['negative_hours']:.2f} h of negative audio and "
            f"{r['n_positive_clips']} positive clips "
            f"(threshold {r['threshold']}): "
            f"**{r['far_per_hour']:.2f} false accepts/hr**, "
            f"**{100 * r['frr']:.1f}% false-reject rate**.\n\n"
            f"| threshold | false accepts / hour | recall |\n"
            f"|---|---|---|\n{rows}\n")
    md = f"# {model_name}\n\n" + "\n".join(blocks)
    if path is not None:
        with open(path, "w") as f:
            f.write(md)
    return md
