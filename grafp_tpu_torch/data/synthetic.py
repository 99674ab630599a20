"""Synthetic wav corpora (the port's copy of the JAX repo's
``tests/fixtures.py:make_wav_dir``; there is no fma or MUSAN audio to
download): note-sequence "music", filtered noise and sparse decaying
impulse responses, drawn from one seeded ``RandomState`` per corpus and
written as 16-bit PCM by ``audio_io.save_wav``. The files are byte-equal
to the JAX fixture's for the same arguments: a music track's numbers are
drawn in the fixture's order on the calling thread, and its arithmetic runs
on a thread per core."""

from __future__ import annotations

import collections
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from grafp_tpu_torch.data.audio_io import save_wav


def _melody_draws(rng: np.random.RandomState, n: int, sr: int) -> tuple:
    """Every random number of one melodic track of ``n`` samples, drawn
    from ``rng`` in the order the fixture's ``_melody`` draws them: (root,
    timbre, phases, the lead's and the bass's (starts, degrees, vibrato
    rate), the noise)."""
    root = 110 * (2 ** (rng.randint(0, 24) / 12.0))
    timbre = rng.rand(6) / np.arange(1, 7)          # per-track harmonics
    phases = rng.rand(6) * 2 * np.pi

    def notes(note_lo, note_hi, dur_lo, dur_hi):
        # random-walk note sequence over semitones
        starts, degrees, pos, deg = [], [], 0, 0
        while pos < n:
            starts.append(pos)
            degrees.append(deg)
            deg = int(np.clip(deg + rng.randint(note_lo, note_hi + 1), -12, 12))
            pos += int(rng.uniform(dur_lo, dur_hi) * sr)
        return starts, degrees, rng.uniform(4, 7)

    lead = notes(-5, 5, 0.12, 0.5)
    bass = notes(-3, 3, 0.4, 1.0)
    return root, timbre, phases, lead, bass, rng.randn(n)


def _melody_render(draws: tuple, t: np.ndarray, sr: int) -> np.ndarray:
    """The track of ``_melody_draws``' numbers: a melodic random walk with
    per-note attack-decay envelopes, a per-track harmonic timbre, a slow
    bass voice and vibrato (notes change every 0.12-0.5 s, so every 1-s
    window of a track differs). All of the arithmetic and none of the
    drawing, so tracks render in any order, on any thread."""
    n = len(t)
    root, timbre, phases, lead_notes, bass_notes, noise = draws

    def voice(notes, octave, decay_s):
        starts, degrees, vib_hz = notes
        starts = np.asarray(starts + [n])
        lens = np.diff(starts)
        semis = np.repeat(np.asarray(degrees, np.float64), lens)
        onset_t = np.repeat(starts[:-1], lens) / sr
        freq = root * octave * 2 ** (semis / 12.0)
        vib = 1.0 + 0.004 * np.sin(2 * np.pi * vib_hz * t)
        phase = np.cumsum(2 * np.pi * freq * vib / sr)
        env = np.minimum((t - onset_t) / 0.01, 1.0)          # 10 ms attack
        env = env * np.exp(-(t - onset_t) / decay_s)
        x = sum(a * np.sin((h + 1) * phase + p)
                for h, (a, p) in enumerate(zip(timbre, phases)))
        return x * env

    lead = voice(lead_notes, 2.0, 0.35)
    bass = voice(bass_notes, 0.5, 0.8)
    x = lead + 0.5 * bass + 0.01 * noise
    return x * 0.3


def _save_peak(path: str, x: np.ndarray, sr: int) -> None:
    save_wav(path, x / (np.abs(x).max() + 1e-9) * 0.8, sr)


def make_wav_dir(path: str, n: int = 8, dur_s: float = 4.0, sr: int = 16000,
                 seed: int = 0, kind: str = "music") -> list:
    """Write n wav files of ``kind`` ('music', 'noise' or 'ir') under
    ``path`` as <kind>_<i:03d>.wav, peak-normalised to 0.8; returns their
    paths. 'ir' files are 0.25 s whatever ``dur_s`` says, as in the
    fixture. An unknown kind raises ValueError."""
    os.makedirs(path, exist_ok=True)
    rng = np.random.RandomState(seed)
    t = np.arange(int(dur_s * sr)) / sr
    out = [os.path.join(path, f"{kind}_{i:03d}.wav") for i in range(n)]
    if kind == "music":
        _render_music(rng, t, sr, out)
        return out
    for p in out:
        if kind == "noise":
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
        _save_peak(p, x, sr)
    return out


def _render_music(rng: np.random.RandomState, t: np.ndarray, sr: int,
                  paths: list, write=_save_peak) -> None:
    """A 'music' corpus: this thread draws each track's numbers in turn
    (one ``RandomState`` stream, as the fixture), a thread per core renders
    each track and hands it to ``write(path, x, sr)`` (numpy's array loops
    and ctypes calls release the GIL), at most two tracks a thread ahead
    of the writes."""
    workers = len(os.sched_getaffinity(0))
    with ThreadPoolExecutor(workers) as pool:
        pending = collections.deque()
        for p in paths:
            draws = _melody_draws(rng, len(t), sr)
            pending.append(pool.submit(
                lambda p=p, d=draws: write(p, _melody_render(d, t, sr), sr)))
            while len(pending) > 2 * workers:
                pending.popleft().result()
        for f in pending:
            f.result()
