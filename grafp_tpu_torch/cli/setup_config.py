"""Point the experiment YAMLs at local dataset roots (port of the root
``setup_config.py``; reference setup_config.py contract):

    python -m grafp_tpu_torch.cli.setup_config --noise_dir D --ir_dir D \\
        [--train_dir D] [--val_dir D]

Rewrites ``config/grafp.yaml`` and ``config/ast.yaml`` of the working
directory through the port's ``Config.save``.
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

CONFIGS = ("config/grafp.yaml", "config/ast.yaml")


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    p.add_argument("--train_dir", required=False, default=None)
    p.add_argument("--val_dir", required=False, default=None)
    p.add_argument("--noise_dir", required=True)
    p.add_argument("--ir_dir", required=True)
    return p


def main(argv: Optional[Sequence[str]] = None) -> None:
    from grafp_tpu_torch.core.config import load_config

    args = build_argparser().parse_args(argv)
    for cfg_path in CONFIGS:
        config = load_config(cfg_path)
        if args.train_dir is not None:
            config["train_dir"] = args.train_dir
        if args.val_dir is not None:
            config["val_dir"] = args.val_dir
        config["noise_dir"] = args.noise_dir
        config["ir_dir"] = args.ir_dir
        config.save(cfg_path)


if __name__ == "__main__":
    main()
