#!/usr/bin/env python3
"""Memmap-format smoke test on the port: the counterpart of
unit_tests/db_test.py (the reference unit_tests/db_test.py contract), with
its flag and its lines.

    python scripts/torch_port_db_test.py --emb_dir DIR

Opens every ``dummy_db`` memmap under DIR (``**/dummy_db_shape.npy``) with
the port's ``retrieval/memmap_io.py:load_memmap_data`` and prints
``{dir}: dummy_db shape (n, d)`` for each, or ``no dummy_db memmaps under
DIR`` when it finds none; a memmap that does not open raises. The memmaps
are host files: like the JAX tool, it touches no device.
"""

from __future__ import annotations

import argparse
import glob
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    from grafp_tpu_torch.retrieval.memmap_io import load_memmap_data

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--emb_dir", required=True, type=str)
    args = ap.parse_args(argv)
    found = 0
    for shape_file in glob.glob(os.path.join(args.emb_dir, "**", "dummy_db_shape.npy"),
                                recursive=True):
        d = os.path.dirname(shape_file)
        _, shape = load_memmap_data(d, "dummy_db", display=False)
        print(f"{d}: dummy_db shape {tuple(shape)}")
        found += 1
    if not found:
        print(f"no dummy_db memmaps under {args.emb_dir}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
