#!/usr/bin/env python3
"""The training input pipeline on an mp3 corpus, against the card's train
step: the counterpart of scripts/profile_input_pipeline.py.

The reference feeds its GPU with DataLoader(batch_size=256, shuffle=True,
num_workers=8) running decode -> mono -> resample -> crop -> CPU augment
in worker processes (reference train.py:124-127, modules/data.py:45-57).
In the port the augment runs on the card inside the train step, so the
host only decodes, resamples and crops; this script measures what that
host side sustains on an mp3 corpus (fma's format, 44.1 kHz masters) and
what each cache mode buys:

  stage rates        decode (libmpg123), sinc resample to the model's rate,
                     crop + norm: tracks/s each, one thread
  PairBatcher epochs pairs/s per epoch for
                       (a) no cache       (decodes again every epoch, the
                                           reference's way)
                       (b) cache_decoded  (RAM dict; epoch 2+ warm)
                       (c) cache_dir      (disk .npy + memmap; epoch 2+
                                           warm, and a fresh dataset warm
                                           from epoch 1)
  verdict            each mode against the card's rate: a bf16 train step
                     at the run's --bsz on the run's first batch, timed on
                     the card in the same run (pairs/s = bsz / step s);
                     feed / device < 1 means input-bound.

    python scripts/torch_port_profile_input_pipeline.py [--root ROOT]
        [--tracks 384] [--dur 30] [--bsz 128] [--master_sr 44100]
        [--threads 4] [--skip-synth]

The corpus (ROOT/mp3_tracks, written by the port's LAME binding; the host
needs libmp3lame to write it and libmpg123 to read it) is reused when it
holds enough tracks; scripts/torch_port_e2e_train_input_mp3.sh trains on
it.
"""

from __future__ import annotations

import argparse
import os
import shutil
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

DEVICE_STEPS = 5               # timed steps after two of warm-up


def build_corpus(root: str, n: int, dur: float, sr_master: int) -> str:
    """``n`` melodic tracks of ``dur`` s at ``sr_master`` Hz as 128 kbps mp3
    under ROOT/mp3_tracks (RandomState(1234), one stream, as the JAX
    script's); reused when it holds ``n``. Returns the directory."""
    from grafp_tpu_torch.data import synthetic
    from grafp_tpu_torch.native import mp3_native

    d = os.path.join(root, "mp3_tracks")
    os.makedirs(d, exist_ok=True)
    have = len([f for f in os.listdir(d) if f.endswith(".mp3")])
    if have >= n:
        print(f"[corpus] reusing {have} mp3 tracks in {d}")
        return d
    if not mp3_native.encoder_available():
        raise mp3_native.NativeUnavailable("libmp3lame is not on this host: the mp3 "
                                           "corpus cannot be written")
    t = np.arange(int(dur * sr_master)) / sr_master
    t0 = time.time()
    synthetic._render_music(
        np.random.RandomState(1234), t, sr_master,
        [os.path.join(d, f"track_{i:05d}.mp3") for i in range(n)],
        write=lambda p, x, sr: mp3_native.write(p, x.astype(np.float32), sr, kbps=128))
    el = time.time() - t0
    print(f"[corpus] {n} x {dur:.0f}s mp3 @ {sr_master} Hz in {el:.0f}s "
          f"({n * dur / el:.0f}x realtime)", flush=True)
    return d


def micro_rates(track_dir: str, fs: int, n_sample: int = 24) -> dict:
    """Decode, resample and crop + norm of ``n_sample`` tracks on one
    thread: tracks/s of each stage and of all three ("full")."""
    from grafp_tpu_torch.data.audio_io import load_audio
    from grafp_tpu_torch.data.resample import resample_sinc

    paths = sorted(os.path.join(track_dir, f) for f in os.listdir(track_dir)
                   if f.endswith(".mp3"))[:n_sample]
    t0 = time.time()
    decoded = [load_audio(p) for p in paths]
    t_dec = time.time() - t0
    t0 = time.time()
    res = [resample_sinc(x, sr, fs) for x, sr in decoded]
    t_res = time.time() - t0
    t0 = time.time()
    for x in res:
        nv = 1e-8 + np.quantile(np.abs(x), 0.95)
        _ = (x[: fs] / nv).astype(np.float32)
    t_crop = time.time() - t0
    n = len(paths)
    sr_in = decoded[0][1]
    print(f"[micro] decode {n / t_dec:8.1f} tracks/s   ({t_dec / n * 1e3:.1f} ms/track, "
          f"libmpg123)")
    print(f"[micro] resample {n / t_res:6.1f} tracks/s   ({t_res / n * 1e3:.1f} ms/track, "
          f"sinc {sr_in} -> {fs} Hz)")
    print(f"[micro] crop+norm {n / t_crop:5.1f} tracks/s   ({t_crop / n * 1e3:.1f} ms/track)")
    full = t_dec + t_res + t_crop
    print(f"[micro] full prep {n / full:6.1f} tracks/s   (1 thread)")
    return {"decode": n / t_dec, "resample": n / t_res, "crop": n / t_crop,
            "full": n / full}


def write_banks(root: str, fs: int) -> tuple:
    """ROOT/noise (24 x 5 s) and ROOT/ir (12), as the mp3 sweep writes them;
    returns their directories."""
    from grafp_tpu_torch.data.synthetic import make_wav_dir

    dirs = []
    for name, n, dur, seed, kind in (("noise", 24, 5.0, 30, "noise"),
                                     ("ir", 12, 0.5, 40, "ir")):
        d = os.path.join(root, name)
        if not os.path.isdir(d) or len(os.listdir(d)) < n:
            make_wav_dir(d, n=n, dur_s=dur, sr=fs, seed=seed, kind=kind)
        dirs.append(d)
    return tuple(dirs)


def device_pairs_per_s(cfg, x_i, x_j, noise_dir: str, ir_dir: str, device) -> float:
    """Pairs/s of the train step of ``cfg`` (the train CLI's model, banks
    from an 0.8 split of the noise and IR corpora) on one batch (x_i, x_j):
    the mean of DEVICE_STEPS steps after two of warm-up."""
    import torch

    from grafp_tpu_torch.cli.train_main import step_generator
    from grafp_tpu_torch.data.dataset import build_augment_banks
    from grafp_tpu_torch.data.indexing import load_augmentation_index
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.train import create_train_state, make_train_step

    banks = build_augment_banks(load_augmentation_index(noise_dir, splits=0.8)["train"],
                                load_augmentation_index(ir_dir, splits=0.8)["train"],
                                cfg["fs"])
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device=device,
                        train=True)
    state = create_train_state(model, cfg, 1)
    step = make_train_step(model, cfg, banks, device=device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    x_i = torch.as_tensor(x_i, device=device)
    x_j = torch.as_tensor(x_j, device=device)
    for i in range(2 + DEVICE_STEPS):
        if i == 2:
            sync()
            t0 = time.perf_counter()
        step(state, x_i, x_j, step_generator(0, 0, i, device))
    sync()
    secs = (time.perf_counter() - t0) / DEVICE_STEPS
    rate = len(x_i) / secs
    print(f"[device] {cfg['compute_dtype']} train step at bsz {len(x_i)}: {secs * 1e3:.1f} ms, "
          f"{rate:.1f} pairs/s", flush=True)
    return rate


def epoch_rate(batcher, label: str, device_rate: float) -> float:
    t0 = time.time()
    n_pairs = 0
    for xi, _ in batcher:
        n_pairs += len(xi)
    dt = time.time() - t0
    rate = n_pairs / dt
    print(f"[epoch] {label:34s} {rate:8.1f} pairs/s ({dt:6.1f}s for {n_pairs} pairs)  "
          f"{rate / device_rate:5.2f}x device step", flush=True)
    return rate


def run(root: str, tracks: int = 384, dur: float = 30.0, bsz: int = 128,
        master_sr: int = 44100, threads: int = 4, skip_synth: bool = False,
        device=None, **overrides) -> dict:
    """The corpus, the stage rates, the card's step rate and the three
    modes' epochs; returns {"micro", "device_pairs_per_s", "epochs" {mode:
    pairs/s}, "cache_gib"}. ``overrides``: Config fields (the tests' small
    geometry); ``device`` None means the card."""
    from grafp_tpu_torch.core import Config
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.data.dataset import FingerprintDataset, PairBatcher

    device = resolve_device(device)
    track_dir = (os.path.join(root, "mp3_tracks") if skip_synth
                 else build_corpus(root, tracks, dur, master_sr))
    cfg = Config(**{**dict(data_dir=os.path.join(root, "data"), train_sz=tracks,
                           val_sz=tracks, compute_dtype="bfloat16"), **overrides})
    micro = micro_rates(track_dir, cfg["fs"])

    def fresh(**kw):
        ds = FingerprintDataset(cfg, track_dir, train=True, seed=42, **kw)
        return PairBatcher(ds, bsz, seed=42, num_threads=threads)

    x_i, x_j = next(iter(fresh()))
    noise_dir, ir_dir = write_banks(root, cfg["fs"])
    dev_rate = device_pairs_per_s(cfg, x_i, x_j, noise_dir, ir_dir, device)

    res = {}
    # (a) no cache: every epoch decodes and resamples (the reference's way)
    b = fresh()
    res["none_ep1"] = epoch_rate(b, "no cache, epoch 1", dev_rate)
    res["none_ep2"] = epoch_rate(b, "no cache, epoch 2", dev_rate)
    # (b) RAM cache
    b = fresh(cache_decoded=True)
    res["ram_ep1"] = epoch_rate(b, "cache_decoded (RAM), epoch 1", dev_rate)
    res["ram_ep2"] = epoch_rate(b, "cache_decoded (RAM), epoch 2", dev_rate)
    # (c) disk cache: a cold epoch, a warm one, then a fresh dataset
    cdir = os.path.join(root, "decoded_cache")
    shutil.rmtree(cdir, ignore_errors=True)
    b = fresh(cache_dir=cdir)
    res["disk_ep1"] = epoch_rate(b, "cache_dir (disk), epoch 1 cold", dev_rate)
    res["disk_ep2"] = epoch_rate(b, "cache_dir (disk), epoch 2 warm", dev_rate)
    res["disk_fresh"] = epoch_rate(fresh(cache_dir=cdir), "cache_dir, fresh dataset ep 1",
                                   dev_rate)
    gib = sum(os.path.getsize(os.path.join(cdir, f)) for f in os.listdir(cdir)) / 2**30
    print(f"[disk] cache size {gib:.2f} GiB for {tracks} x {dur:.0f}s tracks")

    steady = res["disk_fresh"]
    bound = "INPUT-bound" if steady < dev_rate else "DEVICE-bound"
    print(f"\n[verdict] steady-state feed (disk cache): {steady:.0f} pairs/s vs device "
          f"{dev_rate:.0f} pairs/s -> {bound} (x{steady / dev_rate:.2f})")
    print(f"[verdict] uncached feed: {res['none_ep2']:.0f} pairs/s "
          f"(x{res['none_ep2'] / dev_rate:.2f} of device), the reference's decode-every-"
          f"epoch mode; one thread's full prep {micro['full']:.1f} tracks/s", flush=True)
    return {"micro": micro, "device_pairs_per_s": dev_rate, "epochs": res,
            "cache_gib": gib}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "grafp_input_prof"))
    ap.add_argument("--tracks", type=int, default=384)
    ap.add_argument("--dur", type=float, default=30.0)
    ap.add_argument("--bsz", type=int, default=128)
    ap.add_argument("--master_sr", type=int, default=44100)
    ap.add_argument("--threads", type=int, default=4)
    ap.add_argument("--skip-synth", action="store_true")
    args = ap.parse_args(argv)
    run(args.root, tracks=args.tracks, dur=args.dur, bsz=args.bsz,
        master_sr=args.master_sr, threads=args.threads, skip_synth=args.skip_synth)
    return 0


if __name__ == "__main__":
    sys.exit(main())
