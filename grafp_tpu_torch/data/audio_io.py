"""Host audio IO (port of ``grafp_tpu.data.audio_io``; the
torchaudio.load/libsox role, reference modules/data.py:45).

WAV decode runs over the RIFF container (PCM 8/16/24/32-bit and
float32/64, any channel count) with numpy; it gives the same samples as
the JAX package's C++ reader, and on the card's host a C++ reader saved
no clear time over it (scripts/torch_port_wav_readers.py). MP3 (the fma
corpora's format) is decoded by the libmpg123 binding
(``native/mp3_native.py``); other formats, and mp3 on a host without
libmpg123, go to the ``ffmpeg`` binary when one is on PATH, else a clear
error says to transcode. All of it is host work: nothing here touches the
card.
"""

from __future__ import annotations

import os
import shutil
import struct
import subprocess
import wave
from typing import Tuple

import numpy as np

from grafp_tpu_torch.native import mp3_native


class AudioDecodeError(RuntimeError):
    pass


def _decode_pcm(raw: bytes, sampwidth: int, n_channels: int) -> np.ndarray:
    if sampwidth == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif sampwidth == 1:  # unsigned 8-bit
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    elif sampwidth == 3:  # packed 24-bit
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        vals = (
            b[:, 0].astype(np.int32)
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        vals = np.where(vals >= 1 << 23, vals - (1 << 24), vals)
        x = vals.astype(np.float32) / float(1 << 23)
    elif sampwidth == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / float(1 << 31)
    else:
        raise AudioDecodeError(f"unsupported PCM width {sampwidth}")
    if n_channels > 1:
        x = x.reshape(-1, n_channels)
    return x


def _read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Returns (samples (T,) or (T, C) float32 in [-1, 1], sample_rate)."""
    try:
        with wave.open(path, "rb") as w:
            sr = w.getframerate()
            n_ch = w.getnchannels()
            raw = w.readframes(w.getnframes())
            return _decode_pcm(raw, w.getsampwidth(), n_ch), sr
    except wave.Error:
        pass
    # wave stdlib rejects float/extensible WAVs; parse RIFF directly
    with open(path, "rb") as f:
        data = f.read()
    if data[:4] != b"RIFF" or data[8:12] != b"WAVE":
        raise AudioDecodeError(f"not a RIFF/WAVE file: {path}")
    pos, fmt, sr, n_ch, bits, audio_fmt = 12, None, None, None, None, None
    samples = None
    while pos + 8 <= len(data):
        cid = data[pos:pos + 4]
        csz = struct.unpack("<I", data[pos + 4:pos + 8])[0]
        body = data[pos + 8:pos + 8 + csz]
        if cid == b"fmt ":
            audio_fmt, n_ch, sr = struct.unpack("<HHI", body[:8])
            bits = struct.unpack("<H", body[14:16])[0]
            if audio_fmt == 0xFFFE and csz >= 40:  # WAVE_FORMAT_EXTENSIBLE
                audio_fmt = struct.unpack("<H", body[24:26])[0]
        elif cid == b"data":
            if audio_fmt in (1, None):
                samples = _decode_pcm(body, (bits or 16) // 8, n_ch or 1)
            elif audio_fmt == 3:  # IEEE float
                dt = "<f4" if bits == 32 else "<f8"
                samples = np.frombuffer(body, dtype=dt).astype(np.float32)
                if (n_ch or 1) > 1:
                    samples = samples.reshape(-1, n_ch)
            else:
                raise AudioDecodeError(f"unsupported wav format {audio_fmt}")
        pos += 8 + csz + (csz & 1)
    if samples is None or sr is None:
        raise AudioDecodeError(f"no data chunk in {path}")
    return samples, sr


def _read_via_ffmpeg(path: str) -> Tuple[np.ndarray, int]:
    ffmpeg = shutil.which("ffmpeg")
    ffprobe = shutil.which("ffprobe")
    if ffmpeg is None:
        raise AudioDecodeError(
            f"cannot decode '{os.path.splitext(path)[1]}' ({path}): no ffmpeg "
            f"on PATH and no built-in decoder; transcode to wav first"
        )
    sr = 44100
    if ffprobe:
        try:
            out = subprocess.run(
                [ffprobe, "-v", "quiet", "-show_entries", "stream=sample_rate",
                 "-of", "csv=p=0", path],
                capture_output=True, check=True, timeout=60,
            ).stdout.decode().strip().splitlines()
            sr = int(out[0])
        except Exception:
            pass
    proc = subprocess.run(
        [ffmpeg, "-v", "quiet", "-i", path, "-f", "f32le", "-ac", "1",
         "-ar", str(sr), "pipe:1"],
        capture_output=True, timeout=300,
    )
    if proc.returncode != 0:
        raise AudioDecodeError(f"ffmpeg failed on {path}")
    return np.frombuffer(proc.stdout, dtype="<f4").copy(), sr


def load_audio(
    path: str, mono: bool = True, native: bool = True
) -> Tuple[np.ndarray, int]:
    """Decode an audio file -> (float32 samples, sample_rate). Multi-channel
    audio is mean-downmixed when mono=True (reference data.py:54).
    ``native`` decodes mp3 with libmpg123 (else ffmpeg); wav is always
    read by ``_read_wav``."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".wav":
        x, sr = _read_wav(path)
    elif ext == ".mp3" and native:
        try:
            x, sr = mp3_native.read(path)
        except mp3_native.NativeUnavailable:
            # no libmpg123 on this host
            x, sr = _read_via_ffmpeg(path)
        except OSError:
            # libmpg123 rejected the stream (oddball mp3s: mid-stream
            # format changes, free-format frames). ffmpeg handles some
            # of those, so fall back when one exists; otherwise the
            # decode error propagates (corrupt file, not a missing
            # backend).
            if shutil.which("ffmpeg") is None:
                raise
            x, sr = _read_via_ffmpeg(path)
    else:
        x, sr = _read_via_ffmpeg(path)
    if mono and x.ndim > 1:
        x = x.mean(axis=1)
    return np.ascontiguousarray(x, np.float32), sr


def save_wav(path: str, x: np.ndarray, sr: int) -> None:
    """Write mono/stereo float32 [-1,1] as 16-bit PCM (test fixtures)."""
    x = np.asarray(x)
    # scale by 32768 (the decoder's divisor) so roundtrip error <= 0.5 LSB
    pcm = np.clip(np.round(x * 32768.0), -32768, 32767).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1 if pcm.ndim == 1 else pcm.shape[1])
        w.setsampwidth(2)
        w.setframerate(sr)
        w.writeframes(pcm.tobytes())
