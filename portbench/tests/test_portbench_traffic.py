"""The traffic generators: fixed for a fixed seed, in their stated ranges,
and the build's batch count against one worked by hand."""

import numpy as np
import pytest
import torch

from portbench.yardstick import traffic

CFG = {"fs": 16000, "hop_len": 512, "n_fft": 1024, "n_frames": 32, "overlap": 0.9}


def test_music_like_tracks_repeat_for_a_seed_and_differ_across_seeds():
    a, la = traffic.music_like_on_device(3, 1.0, 2.0, 16000, 7, "cpu")
    b, lb = traffic.music_like_on_device(3, 1.0, 2.0, 16000, 7, "cpu")
    c, lc = traffic.music_like_on_device(3, 1.0, 2.0, 16000, 8, "cpu")
    assert torch.equal(a, b) and torch.equal(la, lb)
    # the lengths (the work) are the same for every seed, the audio is not
    assert torch.equal(la, lc) and not torch.equal(a, c)
    assert all(16000 <= int(n) <= 32000 for n in la) and a.dtype == torch.float32
    assert a.shape[0] == int(la.sum())


def test_music_like_tracks_follow_the_recipe():
    """Notes of 0.15-0.6 s, three partials of gains <= 0.2 over a 0.005
    floor: |x| stays under 3 x 0.2 plus the floor, and every 0.6 s holds a
    note change (the spectrum's peak moves)."""
    w, lens = traffic.music_like_on_device(2, 3.0, 3.0, 8000, 3, "cpu", chunk=5000)
    assert int(lens.sum()) == w.shape[0] == 48000
    assert float(w.abs().max()) < 0.6 + 0.05
    peaks = [int(torch.fft.rfft(w[i:i + 1200]).abs()[1:].argmax()) for i in range(0, 24000, 1200)]
    assert len(set(peaks)) > 5


def test_synthetic_clips_shapes_and_ranges():
    noise, irs = traffic.synthetic_clips(1000, 5, n_noise=6, n_ir=4)
    assert len(noise) == 6 and len(irs) == 4
    assert all(500 <= len(n) < 3000 for n in noise)
    assert all(50 <= len(i) < 2000 for i in irs)
    again = traffic.synthetic_clips(1000, 5, n_noise=6, n_ir=4)
    assert all(np.array_equal(x, y) for x, y in zip(noise + irs, again[0] + again[1]))


def test_seed_words_take_large_seeds_and_separate_streams():
    big = 2 ** 31 + 12345
    assert 0 <= traffic.seed_words(big, 1) < 2 ** 32
    assert traffic.seed_words(big, 1) != traffic.seed_words(big, 2)
    assert traffic.seed_words(big, 1) == traffic.seed_words(big, 1)


@pytest.mark.parametrize("samples, want", [(16000, 1), (16000 + 3 * 512, 2), (15000, 0),
                                           (160000, 94)])
def test_true_segments_by_hand(samples, want):
    # frames = 1 + T // 512; segments = (frames - 32) // 3 + 1
    assert traffic.true_segments(samples, CFG) == want


def test_embed_batches_by_hand():
    # buckets of 1 s at fs 16000: tracks of 1.5, 1.9, 3.0 and 1.2 s, pack 2,
    # batch 8. Chunk 1: both pad to 2 s -> one run of 6 + 10 = 16 rows -> 2
    # batches. Chunk 2: 3 s (21 rows -> 3 batches), then 2 s (3 rows -> 1).
    lengths = [24000, 30400, 48000, 19200]
    segs = [traffic.true_segments(t, CFG) for t in lengths]
    assert segs == [6, 10, 21, 3]
    assert traffic.embed_batches(lengths, CFG, pack=2, batch=8, bucket_s=1.0) == 2 + 3 + 1
