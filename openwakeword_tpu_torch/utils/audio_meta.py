"""Pure-Python audio header probing: WAV, FLAC, and MP3 (a copy of
``openwakeword_tpu.utils.audio_meta``, kept here so the port imports nothing
of the JAX package).

Replaces the reference's torchaudio.info + mutagen duration/bitrate pipeline
(reference openwakeword/data.py:153-290) without native dependencies: the
dataset filters only need sample rate, channel count, duration, and average
bitrate, all of which live in a few header bytes.
"""

import os
import struct
from dataclasses import dataclass
from typing import Optional


@dataclass
class AudioInfo:
    format: str               # "wav" | "flac" | "mp3"
    sample_rate: int
    channels: int
    num_frames: int           # PCM frames (samples per channel); 0 if unknown
    bitrate: float            # average bits/second of the *encoded* stream

    @property
    def duration(self) -> float:
        return self.num_frames / self.sample_rate if self.sample_rate else 0.0


def _probe_wav(data: bytes, file_size: int) -> Optional[AudioInfo]:
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        return None
    pos = 12
    sr = ch = bits = 0
    data_size = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        size = struct.unpack_from("<I", data, pos + 4)[0]
        if cid == b"fmt ":
            ch = struct.unpack_from("<H", data, pos + 10)[0]
            sr = struct.unpack_from("<I", data, pos + 12)[0]
            bits = struct.unpack_from("<H", data, pos + 22)[0]
        elif cid == b"data":
            data_size = size
            break
        pos += 8 + size + (size & 1)
    if not sr or not ch:
        return None
    if data_size is None:                      # data chunk beyond the probe window
        data_size = max(0, file_size - 44)
    frames = data_size // max(1, ch * max(1, bits // 8))
    return AudioInfo("wav", sr, ch, frames, sr * ch * bits)


def _probe_flac(data: bytes, file_size: int) -> Optional[AudioInfo]:
    if data[:4] != b"fLaC":
        return None
    pos = 4
    while pos + 4 <= len(data):
        header = struct.unpack_from(">I", data, pos)[0]
        last = header >> 31
        btype = (header >> 24) & 0x7F
        length = header & 0xFFFFFF
        pos += 4
        if btype == 0 and pos + 18 <= len(data):   # STREAMINFO
            # 16+16+24+24 bits of block/frame sizes, then:
            # 20 bits sample rate | 3 bits channels-1 | 5 bits bps-1 |
            # 36 bits total samples
            packed = int.from_bytes(data[pos + 10:pos + 18], "big")
            sr = packed >> 44
            ch = ((packed >> 41) & 0x7) + 1
            total = packed & ((1 << 36) - 1)
            if not sr:
                return None
            dur = total / sr if total else 0.0
            bitrate = (8 * file_size / dur) if dur else 0.0
            return AudioInfo("flac", sr, ch, total, bitrate)
        if last:
            break
        pos += length
    return None


# MPEG audio frame header tables (layer III)
_MP3_BITRATES = {
    1: [0, 32, 40, 48, 56, 64, 80, 96, 112, 128, 160, 192, 224, 256, 320],  # MPEG1
    2: [0, 8, 16, 24, 32, 40, 48, 56, 64, 80, 96, 112, 128, 144, 160],      # MPEG2/2.5
}
_MP3_RATES = {3: [44100, 48000, 32000],     # version bits 11 = MPEG1
              2: [22050, 24000, 16000],     # 10 = MPEG2
              0: [11025, 12000, 8000]}      # 00 = MPEG2.5


def _probe_mp3(data: bytes, file_size: int) -> Optional[AudioInfo]:
    pos = 0
    if data[:3] == b"ID3":                     # skip ID3v2 tag
        tag_size = ((data[6] & 0x7F) << 21) | ((data[7] & 0x7F) << 14) \
            | ((data[8] & 0x7F) << 7) | (data[9] & 0x7F)
        pos = 10 + tag_size
    end = len(data) - 4
    while pos < end:
        if data[pos] == 0xFF and (data[pos + 1] & 0xE0) == 0xE0:
            b1, b2 = data[pos + 1], data[pos + 2]
            version = (b1 >> 3) & 0x3
            layer = (b1 >> 1) & 0x3
            if version == 1 or layer != 1:     # reserved version / not layer III
                pos += 1
                continue
            bitrate_idx = (b2 >> 4) & 0xF
            rate_idx = (b2 >> 2) & 0x3
            if bitrate_idx in (0, 15) or rate_idx == 3:
                pos += 1
                continue
            sr = _MP3_RATES[version][rate_idx]
            bitrate = _MP3_BITRATES[1 if version == 3 else 2][bitrate_idx] * 1000
            spf = 1152 if version == 3 else 576
            padding = (b2 >> 1) & 0x1
            frame_len = spf // 8 * bitrate // sr + padding
            mode = (data[pos + 3] >> 6) & 0x3
            channels = 1 if mode == 3 else 2

            # VBR? Xing/Info tag carries the exact frame count
            side_info = (17 if channels == 1 else 32) if version == 3 \
                else (9 if channels == 1 else 17)
            tag_at = pos + 4 + side_info
            total_frames = 0
            if data[tag_at:tag_at + 4] in (b"Xing", b"Info", b"VBRI"):
                if data[tag_at:tag_at + 4] == b"VBRI":
                    total_frames = struct.unpack_from(">I", data, tag_at + 14)[0]
                else:
                    flags = struct.unpack_from(">I", data, tag_at + 4)[0]
                    if flags & 1:
                        total_frames = struct.unpack_from(">I", data, tag_at + 8)[0]
            if total_frames:
                num_samples = total_frames * spf
                dur = num_samples / sr
                avg_bitrate = 8 * (file_size - pos) / dur if dur else bitrate
            else:                               # CBR estimate from file size
                n_frames_est = max(1, (file_size - pos) // max(1, frame_len))
                num_samples = n_frames_est * spf
                avg_bitrate = bitrate
            return AudioInfo("mp3", sr, channels, num_samples, float(avg_bitrate))
        pos += 1
    return None


def probe(path: str) -> AudioInfo:
    """Parse an audio file's header -> AudioInfo. Raises ValueError for
    unsupported/corrupt files (the only exception this function raises for
    bad file contents — truncated/malformed headers are caught internally)."""
    file_size = os.path.getsize(path)
    with open(path, "rb") as f:
        head = f.read(8192)
        if head[:3] == b"ID3" and len(head) >= 10:
            # an ID3v2 tag (cover art etc.) can be far larger than the probe
            # window; read through it so the MP3 sync scan sees real frames
            tag_size = ((head[6] & 0x7F) << 21) | ((head[7] & 0x7F) << 14) \
                | ((head[8] & 0x7F) << 7) | (head[9] & 0x7F)
            need = 10 + tag_size + 8192
            if need > len(head):
                head += f.read(need - len(head))
    for parser in (_probe_wav, _probe_flac, _probe_mp3):
        try:
            info = parser(head, file_size)
        except (struct.error, IndexError):
            # truncated or malformed header: treat like an unrecognized
            # format rather than leaking parser internals to callers
            info = None
        if info is not None:
            return info
    raise ValueError(f"Unsupported or corrupt audio file: {path} "
                     "(wav/flac/mp3 headers are recognized)")
