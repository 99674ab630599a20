"""Inputs of the benchmark's traffic mixes, from a seed.

``music_like_on_device`` is the recipe of ``chip_smoke.py:696-713``
(``music_like_tracks``) drawn on the device in bulk: the host loop took
9.5 s of a build run's set-up for 256 tracks on the H100's host;
``synthetic_clips`` of the clip recipe of ``chip_smoke.py:773-790``
(``synthetic_banks``), returning the raw clips so that the program and
the reference each pack their own banks; ``embed_batches`` of
``chip_smoke.py:716-731`` (``embed_calls``), over track lengths instead of
a pipeline. Nothing here imports the program.
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np
import torch


def seed_words(seed: int, stream: int) -> int:
    """A 32-bit seed for numpy from the run's seed (any size) and a
    stream number, so that each input draws from its own stream."""
    return int(np.random.SeedSequence([seed % (1 << 63), stream]).generate_state(1)[0])


def music_like_on_device(n: int, lo_s: float, hi_s: float, fs: int, seed: int, device,
                         chunk: int = 1 << 24,
                         lengths_seed: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Music-like tracks drawn on ``device``: n lengths uniform over
    lo_s..hi_s seconds from a generator seeded with ``lengths_seed``, the
    same for every run, so that every seed gives the same work; then, from
    a generator seeded with ``seed``, notes of 0.15-0.6 s one after
    another, cut at the track's end, each three partials at frequencies
    uniform over 80-5000 Hz, gains 0.02-0.2 and phases 0-6.3, over a floor
    of 0.005 N(0, 1). Returns (the tracks end to end, float32 (sum of
    lengths,), the lengths (n,) int64), both on the device; samples are
    computed ``chunk`` at a time."""
    fixed = torch.Generator(device=device).manual_seed(lengths_seed)
    lens = torch.randint(int(lo_s * fs), int(hi_s * fs) + 1, (n,), generator=fixed,
                         device=device)
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))
    kw = dict(generator=g, device=device)
    max_notes = int(hi_s * fs) // int(0.15 * fs) + 2
    durs = torch.randint(int(0.15 * fs), int(0.6 * fs), (n, max_notes), **kw)
    starts = durs.cumsum(1) - durs
    keep = starts < lens[:, None]
    offsets = lens.cumsum(0) - lens
    note_start = (starts + offsets[:, None])[keep]                  # ascending
    freq = (80 + 4920 * torch.rand((n, max_notes, 3), **kw))[keep]
    gain = (0.02 + 0.18 * torch.rand((n, max_notes, 3), **kw))[keep]
    phase = (6.3 * torch.rand((n, max_notes, 3), **kw))[keep]
    total = int(lens.sum())
    out = 0.005 * torch.randn(total, **kw)
    for s in range(0, total, chunk):
        t = torch.arange(s, min(s + chunk, total), device=device)
        note = torch.searchsorted(note_start, t, right=True) - 1
        tt = ((t - note_start[note]).to(torch.float32) / fs)[:, None]
        out[s:s + len(t)] += (gain[note] * torch.sin(2 * math.pi * freq[note] * tt
                                                     + phase[note])).sum(1)
    return out, lens


def synthetic_clips(fs: int, seed: int, n_noise: int = 512, n_ir: int = 256
                    ) -> Tuple[List[np.ndarray], List[np.ndarray]]:
    """(noise clips, impulse responses) at the training banks' counts:
    noise clips of 0.5-3 s at random gains; IRs of 0.05-2 s of
    exponentially decaying noise."""
    rs = np.random.RandomState(seed)
    noise = [(rs.uniform(0.05, 1.0) * rs.randn(rs.randint(fs // 2, 3 * fs)))
             .astype(np.float32) for _ in range(n_noise)]
    irs = []
    for _ in range(n_ir):
        n = rs.randint(fs // 20, 2 * fs)
        decay = np.exp(-np.arange(n) / (n * rs.uniform(0.05, 0.3)))
        irs.append((rs.randn(n) * decay).astype(np.float32))
    return noise, irs


def true_segments(samples: int, cfg: dict) -> int:
    """Fingerprints of a track of ``samples``: windows of n_frames frames
    every int(n_frames * (1 - overlap)) frames over its 1 + T // hop
    frames."""
    frames = 1 + samples // int(cfg["hop_len"])
    n = int(cfg["n_frames"])
    step = max(1, int(n * (1 - float(cfg["overlap"]))))
    return 0 if frames < n else (frames - n) // step + 1


def bucket_samples(samples: int, cfg: dict, bucket_s: float) -> int:
    """The padded length a DB build embeds a track at: n_fft plus the
    track rounded up to whole buckets of ``bucket_s`` seconds (at least
    one)."""
    bucket = int(bucket_s * int(cfg["fs"]))
    return int(cfg["n_fft"]) + max(bucket, int(math.ceil(samples / bucket)) * bucket)


def embed_batches(lengths: Sequence[int], cfg: dict, pack: int, batch: int,
                  bucket_s: float) -> int:
    """The embed batches a packed DB build runs for tracks of ``lengths``
    samples: per chunk of ``pack`` tracks, each run of consecutive tracks
    of one bucket length embeds its true segments in ceil(rows / batch)
    full batches."""
    calls = 0
    for c0 in range(0, len(lengths), pack):
        chunk = [(bucket_samples(t, cfg, bucket_s), true_segments(t, cfg))
                 for t in lengths[c0:c0 + pack]]
        i = 0
        while i < len(chunk):
            j, rows = i, 0
            while j < len(chunk) and chunk[j][1] > 0 and chunk[j][0] == chunk[i][0]:
                rows += chunk[j][1]
                j += 1
            calls += -(-rows // batch)
            i = max(j, i + 1)
    return calls
