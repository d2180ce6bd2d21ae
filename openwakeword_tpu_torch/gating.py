"""Score post-processing on tensors (counterpart of ``openwakeword_tpu.gating``).

Warm-up zeroing, patience and debounce filters and the score-history push,
with the JAX package's semantics: history arrays are oldest-first with the
newest entry last, and filters run before the current scores are pushed.
"""

from typing import Tuple

import torch

from openwakeword_tpu_torch import config


def warmup_zero(scores: torch.Tensor, history_len: torch.Tensor) -> torch.Tensor:
    """Zero scores (..., L) whose stream has seen fewer than WARMUP_FRAMES
    calls; ``history_len`` is (...,) or (..., L)."""
    warm = history_len >= config.WARMUP_FRAMES
    while warm.ndim < scores.ndim:
        warm = warm[..., None]
    return torch.where(warm, scores, torch.zeros_like(scores))


def patience_filter(scores, raw_history, patience_vec, threshold_vec):
    """Keep a score only when the current raw score and the previous
    ``patience - 1`` raw-history entries all reach the threshold.

    scores: (..., L); raw_history: (..., L, H); patience_vec (int) and
    threshold_vec: (L,); patience 0 disables the filter for a label.
    """
    h = raw_history.shape[-1]
    idx = torch.arange(h, device=scores.device)
    in_window = idx >= (h - (patience_vec[..., :, None] - 1))
    misses = ((raw_history < threshold_vec[..., :, None]) & in_window).sum(dim=-1)
    satisfied = (misses == 0) & (scores >= threshold_vec)
    keep = (patience_vec <= 0) | satisfied
    return torch.where(keep, scores, torch.zeros_like(scores))


def debounce_filter(scores, history, threshold_vec, debounce_frames: int, active=None):
    """Suppress a supra-threshold score when one already fired within the
    last ``debounce_frames`` history entries; ``active`` optionally limits
    the filter to some labels."""
    recent = history[..., history.shape[-1] - debounce_frames:]
    fired_recently = (recent >= threshold_vec[..., :, None]).any(dim=-1)
    suppress = (scores >= threshold_vec) & fired_recently
    if active is not None:
        suppress = suppress & active
    return torch.where(suppress, torch.zeros_like(scores), scores)


def push_history(history, scores):
    """Append ``scores`` as the newest history entry, dropping the oldest."""
    return torch.cat([history[..., 1:], scores[..., None]], dim=-1)


def vad_gate(scores, gate_scores, vad_threshold: float):
    """Zero all scores (..., L) unless the largest VAD score of the gate
    window (..., G), 0.4-0.56 s back, reaches ``vad_threshold``. Negative
    entries mark ring slots not filled yet and read as 0."""
    gate_max = torch.where(gate_scores >= 0.0, gate_scores, torch.zeros_like(gate_scores)).amax(dim=-1)
    return torch.where((gate_max >= vad_threshold)[..., None], scores, torch.zeros_like(scores))


def validate_gating_args(patience, threshold, debounce_time) -> Tuple[bool, bool]:
    """Shared constructor validation -> (use_patience, use_debounce)."""
    use_patience = bool(patience)
    use_debounce = debounce_time > 0
    if use_patience and use_debounce:
        raise ValueError("patience and debounce_time are mutually exclusive "
                         "activation filters; pass only one of them")
    if (use_patience or use_debounce) and not threshold:
        raise ValueError("patience/debounce filtering needs per-model score "
                         "thresholds: pass them via the threshold argument")
    return use_patience, use_debounce
