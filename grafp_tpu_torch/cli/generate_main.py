"""Standalone fingerprint extraction (port of
``grafp_tpu.cli.generate_main``; reference generate.py:19-103):

    python -m grafp_tpu_torch.cli.generate --test_dir DIR --ckp CKPT.pth \\
        --output_dir OUT

No augmentation; the fingerprints of every track of the directory (or
index JSON), on the card, -> <output_dir>/fingerprints.npy.
"""

from __future__ import annotations

import argparse
import os


def build_argparser():
    p = argparse.ArgumentParser(description="GraFPrint Embedding generation")
    p.add_argument("--config", default="config/grafp.yaml", type=str)
    p.add_argument("--ckp", default=None, type=str)
    p.add_argument("--test_dir", default=None, type=str)
    p.add_argument("--output_dir", default="output", type=str)
    return p


def main(argv=None, device=None):
    """Run the CLI; ``device`` None means the card (raises without one),
    the tests pass "cpu". Returns the (rows, d) fingerprints, or None when
    the checkpoint is missing."""
    from grafp_tpu_torch.cli.test_fp_main import load_any_checkpoint
    from grafp_tpu_torch.core.config import load_config
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.data.dataset import FingerprintDataset, TrackLoader
    from grafp_tpu_torch.fp.builder import FingerprintPipeline, create_db
    from grafp_tpu_torch.models import build_model

    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    cfg = load_config(args.config)

    print("Loading model...")
    model = build_model(cfg, device=dev)
    dataset = FingerprintDataset(cfg, path=args.test_dir, train=False)
    loader = TrackLoader(dataset, list(range(len(dataset))))

    print("Loading checkpoint...")
    if args.ckp is None or not os.path.exists(args.ckp):
        print(f"=> no checkpoint found at '{args.ckp}'")
        return None
    print(f"=> loading checkpoint '{args.ckp}'")
    model.load_state_dict(load_any_checkpoint(args.ckp, model))
    pipeline = FingerprintPipeline(model, cfg, device=dev)
    return create_db(loader, pipeline, output_dir=args.output_dir, concat=True)
