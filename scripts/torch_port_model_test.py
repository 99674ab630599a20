#!/usr/bin/env python3
"""Checkpoint-compatibility smoke test on the port: the counterpart of
unit_tests/model_test.py (the reference unit_tests/model_test.py
contract), with its flags and its line.

    python scripts/torch_port_model_test.py --ckp CKPT.pth
        [--config config/grafp.yaml] [--encoder grafp|ast|nafp]
        [--device cuda|cpu]

Builds the model of --config with ``arch`` set to --encoder, loads --ckp
(the port's own .pth or the reference's, ``cli/test_fp_main.py:
load_any_checkpoint``), runs zeros of shape (1, n_mels, n_frames) through
it in eval mode and prints ``OK: checkpoint loads and runs; h=(..)
z=(..)``. It runs on the card by default and raises without one;
``--device cpu`` runs it on the CPU.

The JAX tool also loads a JAX (Orbax) checkpoint directory. This one
cannot: reading Orbax needs JAX, which the port never imports. Given a
directory it exits non-zero with ``load_any_checkpoint``'s message, which
names the converter: ``python scripts/torch_port_orbax_to_pth.py CKPT_DIR
OUT.pth --config CONFIG`` (on a machine with JAX), then pass OUT.pth.
"""

from __future__ import annotations

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def main(argv=None) -> int:
    import torch

    from grafp_tpu_torch.cli.test_fp_main import load_any_checkpoint
    from grafp_tpu_torch.core.config import load_config
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.models import build_model

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ckp", required=True, type=str)
    ap.add_argument("--config", default="config/grafp.yaml", type=str)
    ap.add_argument("--encoder", default="grafp", type=str)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = load_config(args.config)
    cfg["arch"] = args.encoder
    model = build_model(cfg, device=dev)
    try:
        state = load_any_checkpoint(args.ckp, model)
    except ValueError as e:
        raise SystemExit(str(e)) from None
    model.load_state_dict(state)
    with torch.no_grad():
        h, z = model(torch.zeros((1, cfg["n_mels"], cfg["n_frames"]), device=dev))
    print(f"OK: checkpoint loads and runs; h={tuple(h.shape)} z={tuple(z.shape)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
