#!/usr/bin/env python3
"""bf16 against f32 training on the port: the counterpart of
scripts/bf16_train_study.py, with its data, its protocol and its five
result lines.

The same initial weights train for N steps under compute_dtype float32 and
under bfloat16, on the same batch, the same augment banks and the same
per-step generators (step i draws from a generator on the device seeded
1000 + i, as the JAX script's step draws from ``jax.random.key(1000 + i)``);
the script prints both loss trajectories' ends, their relative difference,
the cosine between the two trained models' fingerprints of a held-out
batch, and the last ten steps' mean losses.

    python scripts/torch_port_bf16_train_study.py [STEPS] [--device cuda|cpu]

It runs on the card by default and raises without one; ``--device cpu``
runs it on the CPU. Its first line names the card as ``nvidia-smi
--query-gpu=name,power.limit --format=csv,noheader`` gives it (the JAX
script prints its backend there). The kernels are built before the first
step, so neither run's seconds include the build.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

DEFAULT_STEPS = 60


def initial_state_dict(cfg) -> dict:
    """The model of ``cfg`` initialised from ``torch.Generator().manual_seed(0)``,
    as a state_dict on the CPU: the one init both dtypes start from (the
    parameters are f32 whatever the compute dtype)."""
    import torch

    from grafp_tpu_torch.models import build_model

    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    return {k: v.clone() for k, v in model.state_dict().items()}


def train(dtype: str, steps: int, banks, x_i, x_j, cfg=None, state_dict=None,
          device=None, step_seconds=None):
    """``steps`` train steps of the model of ``cfg`` (None: ``Config()``)
    under ``compute_dtype=dtype`` from ``state_dict`` (None:
    ``initial_state_dict``), on the fixed batch (``x_i``, ``x_j``) with
    ``banks`` (None: no augment) on ``device`` (None = the card; raises
    without one). Returns (the TrainState after the steps, the losses
    (steps,), seconds of the steps on the host clock from a synchronised
    start to a synchronised end). A list ``step_seconds`` gets each step's
    seconds, the device synchronised after each."""
    import torch

    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train import create_train_state, make_train_step

    dev = resolve_device(device)
    cfg = dataclasses.replace(cfg if cfg is not None else Config(), compute_dtype=dtype)
    if state_dict is None:
        state_dict = initial_state_dict(cfg)
    model = build_model(cfg, device=dev, train=True)
    model.load_state_dict(state_dict)
    # the JAX script's steps_per_epoch is its step count: one epoch, one lr
    state = create_train_state(model, cfg, steps_per_epoch=steps)
    step = make_train_step(model, cfg, banks, device=dev)
    x_i, x_j = (torch.as_tensor(np.asarray(x), dtype=torch.float32, device=dev)
                for x in (x_i, x_j))
    sync = torch.cuda.synchronize if dev.type == "cuda" else (lambda: None)
    losses = []
    sync()
    t0 = last = time.perf_counter()
    for i in range(steps):
        m = step(state, x_i, x_j, torch.Generator(device=dev).manual_seed(1000 + i))
        losses.append(m["loss"])
        if step_seconds is not None:
            sync()
            now = time.perf_counter()
            step_seconds.append(now - last)
            last = now
    sync()
    seconds = time.perf_counter() - t0
    return state, torch.stack(losses).float().cpu().numpy(), seconds


def fingerprints(model, cfg, waves) -> np.ndarray:
    """The eval-mode fingerprints (f32) of ``waves``' log-mel under the
    log-mel of ``cfg`` (None: ``Config()``), on the model's device."""
    import torch

    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.dsp.melspec import LogMelConfig, log_mel_spectrogram

    dev = next(model.parameters()).device
    x = torch.as_tensor(np.asarray(waves), dtype=torch.float32, device=dev)
    mcfg = LogMelConfig.from_config(cfg if cfg is not None else Config())
    with torch.no_grad():
        _, z = model.eval()(log_mel_spectrogram(x, mcfg))
    return z.float().cpu().numpy()


def run(dtype: str, steps: int, banks, x_i, x_j, x_eval, cfg=None,
        state_dict=None, device=None):
    """The JAX script's run(): ``train`` (see there for the arguments),
    then the eval-mode forward of ``x_eval``'s log-mel. Returns (losses
    (steps,), z (len(x_eval), d) f32, seconds of the steps)."""
    state, losses, seconds = train(dtype, steps, banks, x_i, x_j, cfg, state_dict, device)
    return losses, fingerprints(state.model, cfg, x_eval), seconds


def study_data(pairs: int = 64, eval_rows: int = 32, clip: int = 16000):
    """The JAX script's data from ``RandomState(0)``: 8 noise clips of
    64,000 samples and 4 IRs of [1.0, randn(8000) * 0.05] as AugmentBanks
    (noise_len 64,000, ir_len 8,192), then x_i and x_j of (pairs, clip)
    and x_eval of (eval_rows, clip). Returns (banks, x_i, x_j, x_eval)."""
    from grafp_tpu_torch.dsp.augment import AugmentBanks

    rng = np.random.RandomState(0)
    banks = AugmentBanks.from_arrays(
        noise_clips=[rng.randn(64000).astype(np.float32) for _ in range(8)],
        ir_clips=[np.r_[1.0, rng.randn(8000) * 0.05].astype(np.float32)
                  for _ in range(4)],
        noise_len=64000, ir_len=8192,
    )
    x_i = rng.randn(pairs, clip).astype(np.float32)
    x_j = rng.randn(pairs, clip).astype(np.float32)
    x_eval = rng.randn(eval_rows, clip).astype(np.float32)
    return banks, x_i, x_j, x_eval


def run_line(tag: str, losses: np.ndarray, seconds: float) -> str:
    """The JAX script's per-dtype line (``tag`` 'f32 ' or 'bf16')."""
    return f"[{tag}] {seconds:.0f}s  loss[0]={losses[0]:.4f} loss[-1]={losses[-1]:.4f}"


def row_cosines(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Each row of ``a``'s cosine to the same row of ``b``."""
    return np.sum(a * b, -1) / (np.linalg.norm(a, axis=-1) * np.linalg.norm(b, axis=-1))


def summary_lines(l32, z32, l16, z16) -> list:
    """The JAX script's last three lines: the losses' relative difference,
    the trained fingerprints' cosine, the last ten steps' mean losses."""
    rel = np.abs(l16 - l32) / np.maximum(np.abs(l32), 1e-6)
    cos = row_cosines(z16, z32)
    return [f"loss |rel diff|: mean {rel.mean():.4f} max {rel.max():.4f} "
            f"final {rel[-1]:.4f}",
            f"trained-fingerprint cosine bf16-vs-f32 runs: "
            f"min {cos.min():.4f} mean {cos.mean():.4f}",
            f"last-10-step mean loss: f32 {l32[-10:].mean():.4f} "
            f"bf16 {l16[-10:].mean():.4f}"]


def device_name(dev) -> str:
    """The card's name and power limit (nvidia-smi), or 'cpu'."""
    if dev.type != "cuda":
        return "cpu"
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def main(argv=None, cfg=None) -> int:
    """The study at the JAX script's defaults; ``cfg`` (None: ``Config()``)
    sets the model and the clip length (``cfg.clip_frames``)."""
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.core.device import resolve_device

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("steps", nargs="?", type=int, default=DEFAULT_STEPS)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    cfg = cfg if cfg is not None else Config()
    banks, x_i, x_j, x_eval = study_data(clip=cfg.clip_frames)
    if dev.type == "cuda":
        from grafp_tpu_torch.ops.build import build_all

        build_all(["mrconv_concat", "max_neighbors", "grapher_block"])
    print(f"device={device_name(dev)} steps={args.steps}", flush=True)
    init = initial_state_dict(cfg)
    l32, z32, t32 = run("float32", args.steps, banks, x_i, x_j, x_eval, cfg, init, dev)
    print(run_line("f32 ", l32, t32), flush=True)
    l16, z16, t16 = run("bfloat16", args.steps, banks, x_i, x_j, x_eval, cfg, init, dev)
    print(run_line("bf16", l16, t16), flush=True)
    for line in summary_lines(l32, z32, l16, z16):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
