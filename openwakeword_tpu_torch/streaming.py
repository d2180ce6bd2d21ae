"""Host-edge packet handling for streaming audio (a copy of
``openwakeword_tpu.streaming``; numpy only).

The device step consumes whole 80 ms frames (1280 samples at 16 kHz); real
clients deliver arbitrary packet sizes. ``ChunkAccumulator`` owns that gap:
it coalesces incoming PCM into whole frames and holds the tail until enough
arrives. One accumulator drives the single-stream ``AudioFeatures`` frontend;
the ``StreamServer`` keeps one per slot so a starved stream simply *waits*
instead of being fed silence.

Behavioral contract (matches the reference's accumulation semantics,
openwakeword/utils.py:409-452, re-derived rather than ported): a call that
completes at least one whole frame reports the number of samples handed to
the compute path this call; a call that doesn't reports the total number of
samples waiting. The single-stream Model turns that report into its
score-recycling decision for sub-frame calls (reference model.py:303-311).
"""

from typing import Optional

import numpy as np

from openwakeword_tpu_torch import config


class ChunkAccumulator:
    """Coalesce arbitrary-size PCM packets into whole fixed-size frames."""

    def __init__(self, frame_samples: int = config.CHUNK_SAMPLES,
                 dtype=np.int16):
        self.frame_samples = int(frame_samples)
        self._dtype = dtype
        self._pending = np.empty(0, dtype=dtype)

    @property
    def pending(self) -> int:
        """Samples currently waiting for a complete frame."""
        return int(self._pending.shape[0])

    def reset(self):
        self._pending = np.empty(0, dtype=self._dtype)

    def push(self, x) -> Optional[np.ndarray]:
        """Add a packet; return the ready whole-frame samples (a multiple of
        ``frame_samples``) or None when no frame completed.

        The packet is copied on entry: clients commonly reuse one receive
        buffer across packets, so stored views would be silently overwritten
        before the engine consumes them. Float input is rejected rather than
        unsafe-cast — normalized [-1, 1] float PCM would truncate to all
        zeros (the engine expects raw int16-range values, reference
        utils.py:194-199).
        """
        if isinstance(x, list):
            x = np.asarray(x, dtype=self._dtype)
        x = np.asarray(x)
        if self._dtype == np.int16 and x.dtype != np.int16:
            # same contract as the batch paths' _check_pcm (features.py):
            # float PCM would truncate to zeros, and wider integer PCM
            # (int32 WAVs) would silently wrap mod 65536 under astype
            raise ValueError(
                f"Expected 16-bit PCM audio (int16), got dtype {x.dtype}; "
                "scale/convert to int16 range and cast before pushing")
        x = x.astype(self._dtype, copy=True).reshape(-1)
        buf = np.concatenate([self._pending, x]) if self._pending.size else x
        n_ready = (buf.shape[0] // self.frame_samples) * self.frame_samples
        if n_ready == 0:
            self._pending = buf
            return None
        self._pending = buf[n_ready:].copy()
        return buf[:n_ready]
