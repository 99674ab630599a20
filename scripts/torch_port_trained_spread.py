#!/usr/bin/env python3
"""How far each package's bf16 and int8_static serving rows lie from its
own f32 (and bf16) rows on one trained checkpoint: the port
(grafp_tpu_torch.fp.FingerprintPipeline) beside the JAX package
(grafp_tpu.fp.builder.FingerprintPipeline), on the CPU.

    python scripts/torch_port_trained_spread.py [--root DIR]

1. Trains the port in f32 at size t's full width (``Config()``) for
   STEPS steps of PAIRS pairs: 1-s crops of 64 seeded music-like tracks of
   4-8 s, the second view shifted by up to 50 ms and augmented from seeded
   noise and IR banks; the state_dict goes to DIR/trained.pt and is reused
   when there.
2. Carries it to the JAX package (the weight bridge run backwards).
3. Serves 8 seeded music-like tracks of 8-9.5 s through each package's
   ``fingerprint_track`` in batches of 64 under f32, bf16 and int8_static
   (compute dtype bf16; the maxima calibrated lazily on the first
   track's first 64 segments, the same in both packages): the port with
   its default k-NN strategy (the kernel path's plain version on the CPU)
   and 'onehot', JAX with 'auto' (its path on a CPU: 'onehot') and
   'pallas' (its path on a TPU, the kernels in interpret mode).
4. Prints, per run, each row's cosine to its own row under the other mode
   (min, mean, 1st percentile, how many rows lie nearest their own row),
   and the cosines between the packages' rows under each mode.

It imports JAX and both packages; it runs on the CPU only, on THREADS
torch threads (about half an hour on 4 cores).
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

STEPS, PAIRS = 100, 16
THREADS = 4
SERVE_BATCH = 64
PORT_STRATEGIES = ("auto", "onehot")
JAX_STRATEGIES = ("auto", "pallas")
MODES = {"f32": dict(compute_dtype="float32"), "bf16": dict(compute_dtype="bfloat16"),
         "int8_static": dict(compute_dtype="bfloat16", serve_quant="int8_static")}
PAIRS_OF_MODES = (("bf16", "f32"), ("int8_static", "bf16"), ("int8_static", "f32"))


def music_like_tracks(n: int, lo_s: float, hi_s: float, fs: int, seed: int):
    """chip_smoke.py's seeded music-like tracks: notes of 0.15-0.6 s, each
    three random partials at random gains, over a faint noise floor."""
    rs = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        t = rs.randint(int(lo_s * fs), int(hi_s * fs) + 1)
        w = 0.005 * rs.randn(t)
        i = 0
        while i < t:
            dur = rs.randint(int(0.15 * fs), int(0.6 * fs))
            tt = np.arange(min(dur, t - i)) / fs
            for f, a in zip(rs.uniform(80, 5000, 3), rs.uniform(0.02, 0.2, 3)):
                w[i:i + len(tt)] += a * np.sin(2 * np.pi * f * tt + rs.uniform(0, 6.3))
            i += dur
        out.append(w.astype(np.float32))
    return out


def train_banks(fs: int, seed: int):
    """64 noise clips of 0.5-3 s and 32 decaying-noise IRs of 0.05-0.5 s."""
    from grafp_tpu_torch.dsp.augment import AugmentBanks

    rs = np.random.RandomState(seed)
    noise = [(rs.uniform(0.05, 1.0) * rs.randn(rs.randint(fs // 2, 3 * fs))).astype(np.float32)
             for _ in range(64)]
    irs = []
    for _ in range(32):
        n = rs.randint(fs // 20, fs // 2)
        decay = np.exp(-np.arange(n) / (n * rs.uniform(0.05, 0.3)))
        irs.append((rs.randn(n) * decay).astype(np.float32))
    return AugmentBanks.from_arrays(noise_clips=noise, ir_clips=irs,
                                    noise_len=2 * fs, ir_len=2 * fs)


def train(steps: int, pairs: int) -> dict:
    """The port's f32 state_dict after ``steps`` steps (see the module
    docstring), printing each step's loss."""
    import torch

    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train import create_train_state, make_train_step

    cfg = Config()
    fs = cfg["fs"]
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                        train=True)
    state = create_train_state(model, cfg, steps_per_epoch=steps)
    step = make_train_step(model, cfg, train_banks(fs, 1), device="cpu")
    tracks = music_like_tracks(64, 4.0, 8.0, fs, seed=2)
    rs = np.random.RandomState(3)
    for i in range(steps):
        x_i, x_j = [], []
        for _ in range(pairs):
            w = tracks[rs.randint(len(tracks))]
            s = rs.randint(0, len(w) - fs - 1600) + 800
            off = rs.randint(-800, 800)
            x_i.append(w[s:s + fs])
            x_j.append(w[s + off:s + off + fs])
        m = step(state, np.stack(x_i), np.stack(x_j), torch.Generator().manual_seed(1000 + i))
        print(f"step {i} loss {float(m['loss']):.4f}", flush=True)
    return model.state_dict()


def port_rows(state_dict, strategy: str, tracks) -> dict:
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.fp import FingerprintPipeline
    from grafp_tpu_torch.models import build_model

    rows = {}
    for name, fields in MODES.items():
        cfg = Config(knn_strategy=strategy, **fields)
        model = build_model(cfg, device="cpu")
        model.load_state_dict(state_dict)
        pipe = FingerprintPipeline(model, cfg, batch_size=SERVE_BATCH, device="cpu")
        rows[name] = np.concatenate([pipe.fingerprint_track(w) for w in tracks])
    return rows


def jax_rows(state_dict, strategy: str, tracks) -> dict:
    import jax
    import jax.numpy as jnp

    from grafp_tpu.core.config import Config as JConfig
    from grafp_tpu.fp.builder import FingerprintPipeline as JPipeline
    from grafp_tpu.models import build_model as j_build_model
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.models import build_model
    from tests.torch_port_util import jax_variables_from_port

    port = build_model(Config(), device="cpu")
    port.load_state_dict(state_dict)
    rows = {}
    for name, fields in MODES.items():
        cfg = JConfig(knn_strategy=strategy, **fields)
        model = j_build_model(cfg)
        shapes = jax.eval_shape(lambda k: model.init(
            {"params": k}, jnp.zeros((2, cfg["n_mels"], cfg["n_frames"])), False),
            jax.random.key(0))
        params, stats = (jax.tree.map(jnp.asarray, t)
                         for t in jax_variables_from_port(port, shapes))
        pipe = JPipeline(model, cfg, params, stats, batch_size=SERVE_BATCH)
        rows[name] = np.concatenate([np.asarray(pipe.fingerprint_track(w), np.float32)
                                     for w in tracks])
    return rows


def own_and_other(a: np.ndarray, b: np.ndarray):
    """Each row of ``a``'s cosine to the same row of ``b``, and its largest
    cosine to any other row of ``b`` (float64)."""
    a = a / np.linalg.norm(a, axis=1, keepdims=True).astype(np.float64)
    b = b / np.linalg.norm(b, axis=1, keepdims=True).astype(np.float64)
    c = a @ b.T
    own = np.diag(c).copy()
    np.fill_diagonal(c, -2.0)
    return own, c.max(1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "torch_port_trained_spread"))
    args = ap.parse_args(argv)
    import jax

    jax.config.update("jax_platforms", "cpu")
    import torch

    torch.set_num_threads(THREADS)
    os.makedirs(args.root, exist_ok=True)
    ckpt = os.path.join(args.root, "trained.pt")
    if not os.path.exists(ckpt):
        torch.save(train(STEPS, PAIRS), ckpt)
    state_dict = torch.load(ckpt)
    tracks = music_like_tracks(8, 8.0, 9.5, 16000, seed=5)
    runs = {}
    for pkg, strategies, fn in (("port", PORT_STRATEGIES, port_rows),
                                ("jax", JAX_STRATEGIES, jax_rows)):
        for strategy in strategies:
            t0 = time.perf_counter()
            runs[f"{pkg}/{strategy}"] = fn(state_dict, strategy, tracks)
            print(f"{pkg}/{strategy}: {len(runs[f'{pkg}/{strategy}']['f32'])} rows a mode, "
                  f"{time.perf_counter() - t0:.1f} s", flush=True)
    for run, rows in runs.items():
        for a, b in PAIRS_OF_MODES:
            own, other = own_and_other(rows[a], rows[b])
            print(f"{run:12s} {a:11s} vs {b:4s}: cos min {own.min():.5f} mean "
                  f"{own.mean():.5f} 1st pct {np.percentile(own, 1):.5f}; nearest their "
                  f"own row {int((own > other).sum())} of {len(own)}", flush=True)
    names = list(runs)
    for i, x in enumerate(names):
        for y in names[i + 1:]:
            for mode in MODES:
                own, _ = own_and_other(runs[x][mode], runs[y][mode])
                print(f"{x} vs {y} {mode}: cos min {own.min():.6f} mean {own.mean():.6f}",
                      flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
