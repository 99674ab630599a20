"""Evaluation driver of the baseline encoders (port of the JAX package's
``baselines/test_fp.py``; reference baselines/test_fp.py):

    python -m grafp_tpu_torch.cli.baseline_test_fp [test_fp CLI arguments]

The test_fp CLI (``test_fp_main``) with ``--encoder ast`` and ``--config
config/ast.yaml`` where the arguments do not set them, and the baselines'
tc9-tc12 offset / overlap presets (reference baselines/test_fp.py:
186-197): with ``--model tc9`` .. ``tc12`` the config is resolved with the
preset's offset and overlap into a temporary directory, never into the
working tree, and handed to test_fp.
"""

from __future__ import annotations

import os
import sys
import tempfile
from typing import Optional, Sequence

from grafp_tpu_torch.cli.baseline_train import with_defaults

PRESETS = {"tc9": (0.2, 0.5), "tc10": (0.05, 0.9),
           "tc11": (0.1, 0.8), "tc12": (0.125, 0.75)}
DEFAULTS = (("--encoder", "ast"), ("--config", "config/ast.yaml"))


def resolved_config(config_path: str, model: Optional[str]):
    """The Config of ``config_path`` with the (offset, overlap) preset of
    ``model`` applied, or None when ``model`` has no baseline preset."""
    from grafp_tpu_torch.core.config import load_config

    if model not in PRESETS:
        return None
    cfg = load_config(config_path)
    cfg["offset"], cfg["overlap"] = PRESETS[model]
    return cfg


def main(argv: Optional[Sequence[str]] = None, device=None):
    """Run the test_fp CLI with the baselines' defaults and presets;
    ``device`` as ``test_fp_main.main`` takes it (None = the card)."""
    from grafp_tpu_torch.cli import test_fp_main

    argv = with_defaults(sys.argv[1:] if argv is None else argv, DEFAULTS)
    args, _ = test_fp_main.build_argparser().parse_known_args(argv)
    cfg = resolved_config(args.config, args.model)
    if cfg is None:
        return test_fp_main.main(argv, device=device)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, f"{args.model}.yaml")
        cfg.save(path)
        # argparse keeps the last --config
        return test_fp_main.main(argv + ["--config", path], device=device)


if __name__ == "__main__":
    main()
