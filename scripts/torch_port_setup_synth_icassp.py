#!/usr/bin/env python3
"""A synthetic ICASSP-protocol workspace for the port's CLIs: the
counterpart of scripts/setup_synth_icassp.py, with its arguments and its
files.

It plays the reference's setup_icassp.py for a host with no fma or MUSAN
audio: it synthesises the corpora (grafp_tpu_torch.data.synthetic, byte-equal
to the JAX repo's test fixture), writes the config (config/grafp.yaml with
the paths and sizes resolved), the frozen ``eval_tracks_indices.npy`` split
(reference test_fp.py:244-252) and the test_config epoch matrix; after it
the sweeps scripts/torch_port_e2e_cli_icassp*.sh run through
``python -m grafp_tpu_torch.cli.train`` and ``.test_fp``.

    python scripts/torch_port_setup_synth_icassp.py --root DIR \\
        [--train_tracks 400] [--eval_tracks 2400] [--dur 20] [--bsz 128] [--tiny]

ROOT/train_tracks, eval_tracks, noise and ir are written when they hold
fewer files than asked, else reused. ``--tiny`` selects a 1 kHz, 16-mel,
f32 geometry for quick CPU runs.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np
import yaml

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the 1 kHz geometry of --tiny (the JAX repo's tests/test_cli_e2e.py scale)
TINY = dict(fs=1000, win_len=256, hop_len=128, n_mels=16, n_fft=256, n_frames=8,
            overlap=0.5, compute_dtype="float32", n_dummy=4, n_query=2)


def setup(root: str, train_tracks: int = 400, eval_tracks: int = 2400,
          dur: float = 20.0, bsz: int = 128, tiny: bool = False) -> str:
    """Write the workspace under ``root``; returns its absolute path."""
    from grafp_tpu_torch.data.synthetic import make_wav_dir

    fs = 1000 if tiny else 16000
    root = os.path.abspath(root)
    os.makedirs(os.path.join(root, "data"), exist_ok=True)
    for name, n, secs, seed, kind in (
        ("train_tracks", train_tracks, dur, 10, "music"),
        ("eval_tracks", eval_tracks, dur, 20, "music"),
        ("noise", 24, 5.0, 30, "noise"),
        ("ir", 12, 0.5, 40, "ir"),
    ):
        d = os.path.join(root, name)
        if not os.path.isdir(d) or len(os.listdir(d)) < n:
            print(f"[setup] generating {n} x {secs}s '{kind}' wavs -> {d}", flush=True)
            make_wav_dir(d, n=n, dur_s=secs, sr=fs, seed=seed, kind=kind)

    # the shipped grafp.yaml with paths and sizes resolved (the role of the
    # reference's setup_config.py:5-17)
    with open(os.path.join(REPO, "config", "grafp.yaml")) as f:
        cfg = yaml.safe_load(f)
    cfg.update(
        data_dir=os.path.join(root, "data"),
        train_dir=os.path.join(root, "train_tracks"),
        val_dir=os.path.join(root, "train_tracks"),
        noise_dir=os.path.join(root, "noise"),
        ir_dir=os.path.join(root, "ir"),
        train_sz=train_tracks,
        val_sz=eval_tracks,
        bsz_train=bsz,
    )
    if tiny:
        cfg.update(TINY)
    with open(os.path.join(root, "synth.yaml"), "w") as f:
        yaml.safe_dump(cfg, f, sort_keys=False)

    # the frozen eval split (the reference's data/fma_medium_indices.npy):
    # a seeded shuffle; the dummy DB takes all but the last n_query_db
    indices = np.random.RandomState(42).permutation(eval_tracks)
    np.save(os.path.join(root, "data", "eval_tracks_indices.npy"), indices)

    # the test_config matrix (the reference's config/test_config.yaml)
    with open(os.path.join(root, "test_config.yaml"), "w") as f:
        yaml.safe_dump({"tc_29": ["best"]}, f)
    print(f"[setup] workspace ready at {root}", flush=True)
    return root


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(), "grafp_cli_e2e"))
    ap.add_argument("--train_tracks", type=int, default=400)
    ap.add_argument("--eval_tracks", type=int, default=2400)
    ap.add_argument("--dur", type=float, default=20.0)
    ap.add_argument("--bsz", type=int, default=128)
    ap.add_argument("--n_query_db", type=int, default=200,
                    help="accepted as the JAX script does; the split is frozen "
                         "whole and the sweeps pass their own --n_query_db")
    ap.add_argument("--tiny", action="store_true", default=False,
                    help="1 kHz / 16-mel geometry in f32 for quick CPU runs")
    args = ap.parse_args(argv)
    setup(args.root, train_tracks=args.train_tracks, eval_tracks=args.eval_tracks,
          dur=args.dur, bsz=args.bsz, tiny=args.tiny)
    return 0


if __name__ == "__main__":
    sys.exit(main())
