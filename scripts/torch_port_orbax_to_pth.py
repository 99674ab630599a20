#!/usr/bin/env python3
"""Convert a JAX package checkpoint into the PyTorch port's ``.pth``.

    python scripts/torch_port_orbax_to_pth.py CKPT_DIR OUT.pth \\
        [--config config/grafp.yaml]

CKPT_DIR is an Orbax directory written by ``grafp_tpu.train.checkpoint.
save_ckp`` (``checkpoint/model_<name>_<tag>``). Its params and BatchNorm
statistics go through ``grafp_tpu_torch.convert.state_dict_from_jax`` onto
a port model built from the config on the CPU (which checks every key and
shape), and OUT.pth holds them with the epoch and the loss and hit-rate
logs in the port's checkpoint format. It holds no optimizer state (optax's
is not carried over): ``test_fp`` and ``generate`` serve it; the train
CLI refuses to resume from it. This script imports JAX and orbax; the port
itself never does.
"""

from __future__ import annotations

import argparse
import os
import sys

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def convert(ckpt_dir: str, out_path: str, cfg) -> str:
    """Write ``ckpt_dir``'s weights and logs to ``out_path`` in the port's
    format; returns the path."""
    from grafp_tpu.train.checkpoint import load_ckp
    from grafp_tpu_torch.convert import state_dict_from_jax
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train.checkpoint import FORMAT, log_fields

    restored = load_ckp(ckpt_dir)
    model = build_model(cfg, device="cpu")
    state_dict = state_dict_from_jax(restored["params"], restored["batch_stats"], model)
    payload = {"format": FORMAT, "state_dict": state_dict, "optimizer": None,
               "step": None,
               **log_fields(restored.get("epoch", 0), restored.get("loss", []),
                            restored.get("valid_acc", []), restored.get("hit_rate"))}
    os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
    torch.save(payload, out_path)
    return out_path


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("ckpt_dir")
    p.add_argument("out_path")
    p.add_argument("--config", default="config/grafp.yaml")
    args = p.parse_args(argv)
    from grafp_tpu_torch.core.config import load_config

    print(convert(args.ckpt_dir, args.out_path, load_config(args.config)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
