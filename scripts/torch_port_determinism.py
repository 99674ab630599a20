#!/usr/bin/env python3
"""Is the port's train step deterministic? The reproduction of ROADMAP.md
C11 (the f32 step on the card is not).

    python scripts/torch_port_determinism.py [--device cuda|cpu]

For f32 and bf16: one train step (``make_train_step``, size t) from one
init on scripts/torch_port_bf16_train_study.py's batch and banks, twice;
prints both losses and each parameter that differs between the two
updated models, with its largest |d|. Then the f32 step twice under
``torch.use_deterministic_algorithms(True)``, printing the warnings of any
op without a deterministic implementation. ``CUBLAS_WORKSPACE_CONFIG`` is
set to ``:4096:8`` (which deterministic cuBLAS needs) before the card is
touched, for every run. The JAX package's jitted step gives one answer
for one input; a run here that prints a differing parameter shows the
port's step does not.
"""

from __future__ import annotations

import argparse
import os
import sys
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))


def step_twice(study, dtype: str, data, cfg, init, device):
    """One step of ``dtype`` from ``init``, twice: (the two losses, {name:
    largest |d|} of the parameters and statistics that differ)."""
    banks, x_i, x_j, _ = data
    out = []
    for _ in range(2):
        state, losses, _ = study.train(dtype, 1, banks, x_i, x_j, cfg, init, device)
        out.append((float(losses[0]), state.model.state_dict()))
    (la, a), (lb, b) = out
    diff = {k: float((a[k].double() - b[k].double()).abs().max())
            for k in a if a[k].is_floating_point() and not a[k].equal(b[k])}
    return (la, lb), diff


def main(argv=None, cfg=None) -> int:
    """``cfg`` (None: ``Config()``) sets the model and the clip length."""
    os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    import torch_port_bf16_train_study as study
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.core.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = cfg if cfg is not None else Config()
    data = study.study_data(clip=cfg.clip_frames)
    init = study.initial_state_dict(cfg)
    print(f"device={study.device_name(dev)}", flush=True)
    for dtype in ("float32", "bfloat16"):
        losses, diff = step_twice(study, dtype, data, cfg, init, dev)
        worst = sorted(diff.items(), key=lambda kv: -kv[1])
        print(f"{dtype} step twice: losses {losses[0]!r} {losses[1]!r}; "
              f"{len(diff)} of {len(init)} tensors differ {worst}", flush=True)
    torch.use_deterministic_algorithms(True, warn_only=True)
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            losses, diff = step_twice(study, "float32", data, cfg, init, dev)
    finally:
        torch.use_deterministic_algorithms(False)
    print(f"float32 step twice, deterministic algorithms: losses {losses[0]!r} "
          f"{losses[1]!r}; {len(diff)} tensors differ {sorted(diff.items())}; "
          f"warnings {sorted({str(w.message) for w in caught})}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
