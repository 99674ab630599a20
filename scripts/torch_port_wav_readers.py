#!/usr/bin/env python3
"""Time the wav decoders on the corpus of chip_smoke.py's phase 9.

    python scripts/torch_port_wav_readers.py [--rounds 3] [--out FILE.json]

Writes 512 train tracks of 10 s and 120 val tracks of 30 s as 16-bit mono
wav at 16 kHz (phase 9's layout) into a temporary directory, then decodes
every file, round after round, with each reader in turn:

- ``numpy``: the port's ``grafp_tpu_torch.data.audio_io.load_audio``, whose
  reader is numpy over the RIFF container;
- ``c++``: the JAX package's native reader (``grafp_tpu.native.wav_native``,
  ``g++``-built C++ behind ctypes; it imports no JAX) followed by
  ``load_audio``'s downmix and copy: the port's ``load_audio`` read wav
  through a copy of that C++ reader until it was measured with this
  script and removed for want of a gain (PERF.md).

Both must give the same samples bit for bit. The files are read warm (just
written, so in the page cache, as an epoch's tracks are after the first).
Prints ms per file and seconds per corpus for each reader and round, and
the card's name and power limit beside them (the decoding is host work; the
card only names the machine). The JSON goes to ``--out`` as well.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FS = 16000
CORPUS = {"train": (512, 10.0), "val": (120, 30.0)}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=30).stdout.strip() or "no card"
    except OSError:
        return "no card"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rounds", type=int, default=3)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)

    from grafp_tpu.native import wav_native as cxx
    from grafp_tpu_torch.data.audio_io import load_audio, save_wav

    def via_cxx(path):
        x, sr = cxx.read(path)
        if x.ndim > 1:
            x = x.mean(axis=1)
        return np.ascontiguousarray(x, np.float32), sr

    readers = {"numpy": load_audio, "c++": via_cxx}
    rs = np.random.RandomState(0)
    out = {"card": card(), "cpus": os.cpu_count(), "rounds": []}
    with tempfile.TemporaryDirectory() as root:
        files = {}
        for name, (n, secs) in CORPUS.items():
            files[name] = [os.path.join(root, f"{name}_{i:04d}.wav") for i in range(n)]
            for path in files[name]:
                save_wav(path, rs.uniform(-0.5, 0.5, int(secs * FS)).astype(np.float32), FS)
        for path in files["train"][:4] + files["val"][:4]:
            a, b = (r(path) for r in readers.values())
            if a[1] != b[1] or a[0].tobytes() != b[0].tobytes():
                raise SystemExit(f"the readers disagree on {path}")
        for r in range(args.rounds):
            order = list(readers) if r % 2 == 0 else list(readers)[::-1]
            row = {}
            for reader in order:
                for name, paths in files.items():
                    t0 = time.perf_counter()
                    for path in paths:
                        readers[reader](path)
                    secs = time.perf_counter() - t0
                    row[f"{reader} {name}"] = {"s": secs, "ms_per_file": 1e3 * secs / len(paths)}
            out["rounds"].append(row)
            print(f"round {r + 1}: " + "; ".join(
                f"{k} {v['ms_per_file']:.4f} ms/file ({v['s']:.4f} s)" for k, v in row.items())
                + f" [{out['card']}; {out['cpus']} cpus]", flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
