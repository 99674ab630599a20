"""Synthetic wav corpora (the port's copy of the JAX repo's
``tests/fixtures.py:make_wav_dir``; there is no fma or MUSAN audio to
download): note-sequence "music", filtered noise and sparse decaying
impulse responses, drawn from one seeded ``RandomState`` per corpus and
written as 16-bit PCM by ``audio_io.save_wav``. The files are byte-equal
to the JAX fixture's for the same arguments."""

from __future__ import annotations

import os

import numpy as np

from grafp_tpu_torch.data.audio_io import save_wav


def _melody(rng: np.random.RandomState, t: np.ndarray, sr: int) -> np.ndarray:
    """A melodic random walk with per-note attack-decay envelopes, a
    per-track harmonic timbre, a slow bass voice and vibrato: notes change
    every 0.12-0.5 s, so every 1-s window of a track differs."""
    n = len(t)
    root = 110 * (2 ** (rng.randint(0, 24) / 12.0))
    timbre = rng.rand(6) / np.arange(1, 7)          # per-track harmonics
    phases = rng.rand(6) * 2 * np.pi

    def voice(note_lo, note_hi, dur_lo, dur_hi, octave, decay_s):
        # random-walk note sequence over semitones
        starts, degrees, pos, deg = [], [], 0, 0
        while pos < n:
            starts.append(pos)
            degrees.append(deg)
            deg = int(np.clip(deg + rng.randint(note_lo, note_hi + 1), -12, 12))
            pos += int(rng.uniform(dur_lo, dur_hi) * sr)
        starts = np.asarray(starts + [n])
        lens = np.diff(starts)
        semis = np.repeat(np.asarray(degrees, np.float64), lens)
        onset_t = np.repeat(starts[:-1], lens) / sr
        freq = root * octave * 2 ** (semis / 12.0)
        vib = 1.0 + 0.004 * np.sin(2 * np.pi * rng.uniform(4, 7) * t)
        phase = np.cumsum(2 * np.pi * freq * vib / sr)
        env = np.minimum((t - onset_t) / 0.01, 1.0)          # 10 ms attack
        env = env * np.exp(-(t - onset_t) / decay_s)
        x = sum(a * np.sin((h + 1) * phase + p)
                for h, (a, p) in enumerate(zip(timbre, phases)))
        return x * env

    lead = voice(-5, 5, 0.12, 0.5, 2.0, 0.35)
    bass = voice(-3, 3, 0.4, 1.0, 0.5, 0.8)
    x = lead + 0.5 * bass + 0.01 * rng.randn(n)
    return x * 0.3


def make_wav_dir(path: str, n: int = 8, dur_s: float = 4.0, sr: int = 16000,
                 seed: int = 0, kind: str = "music") -> list:
    """Write n wav files of ``kind`` ('music', 'noise' or 'ir') under
    ``path`` as <kind>_<i:03d>.wav, peak-normalised to 0.8; returns their
    paths. 'ir' files are 0.25 s whatever ``dur_s`` says, as in the
    fixture. An unknown kind raises ValueError."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    t = np.arange(int(dur_s * sr)) / sr
    out = []
    for i in range(n):
        if kind == "music":
            x = _melody(rng, t, sr)
        elif kind == "noise":
            x = rng.randn(len(t)) * 0.2
            k = rng.randint(2, 30)
            x = np.convolve(x, np.ones(k) / k, mode="same")
        elif kind == "ir":
            x = np.zeros(int(0.25 * sr))
            x[0] = 1.0
            taps = rng.randint(1, len(x), 20)
            x[taps] = rng.randn(20) * np.exp(-taps / (0.05 * sr))
        else:
            raise ValueError(kind)
        p = os.path.join(path, f"{kind}_{i:03d}.wav")
        save_wav(p, x / (np.abs(x).max() + 1e-9) * 0.8, sr)
        out.append(p)
    return out
