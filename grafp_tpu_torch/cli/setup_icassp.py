"""Rebase the index files onto local dataset roots for the ICASSP
reproduction (port of the root ``setup_icassp.py``; reference
setup_icassp.py contract):

    python -m grafp_tpu_torch.cli.setup_icassp --test_dir D --noise_dir D \\
        --ir_dir D [--eval_type fma_medium]

Creates data/, checkpoint/ and runs/ in the working directory and writes
``data/<eval_type>.json``, ``data/ir.json`` and ``data/noise.json``.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Reproducibility setup")
    p.add_argument("--test_dir", default=None, type=str)
    p.add_argument("--ir_dir", default=None, type=str)
    p.add_argument("--noise_dir", default=None, type=str)
    p.add_argument("--eval_type", default="fma_medium", type=str)
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from grafp_tpu_torch.data.indexing import update_index

    args = build_argparser().parse_args(argv)
    for d in ("data", "checkpoint", "runs"):
        os.makedirs(d, exist_ok=True)
    update_index(args.test_dir, f"data/{args.eval_type}.json")
    update_index(args.ir_dir, "data/ir.json")
    update_index(args.noise_dir, "data/noise.json")


if __name__ == "__main__":
    main()
