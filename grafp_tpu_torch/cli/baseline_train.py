"""Training driver of the baseline encoders (port of the JAX package's
``baselines/train.py``; reference baselines/train.py):

    python -m grafp_tpu_torch.cli.baseline_train [train CLI arguments]

The train CLI (``train_main``) with the baselines' defaults where the
arguments do not set them: ``--encoder ast``, ``--config
config/ast.yaml`` and validation every 25 epochs (reference
baselines/train.py:87). ``--encoder nafp`` trains the NAFP encoder, whose
config needs ``n_mels: 256``.
"""

from __future__ import annotations

import sys
from typing import List, Optional, Sequence

DEFAULTS = (("--encoder", "ast"), ("--config", "config/ast.yaml"),
            ("--validate_every", "25"))


def with_defaults(argv: Sequence[str], defaults=DEFAULTS) -> List[str]:
    """``argv`` with each (flag, value) of ``defaults`` appended where no
    argument names the flag (``--flag value`` or ``--flag=value``)."""
    argv = list(argv)
    for flag, value in defaults:
        if not any(a == flag or a.startswith(flag + "=") for a in argv):
            argv += [flag, value]
    return argv


def main(argv: Optional[Sequence[str]] = None, device=None):
    """Run the train CLI with the baselines' defaults; ``device`` as
    ``train_main.main`` takes it (None = the card)."""
    from grafp_tpu_torch.cli.train_main import main as train

    return train(with_defaults(sys.argv[1:] if argv is None else argv), device=device)


if __name__ == "__main__":
    main()
