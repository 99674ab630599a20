#!/usr/bin/env python3
"""The whole system through the PyTorch/CUDA port on one card: the
counterpart of scripts/e2e_synthetic_icassp.py, with its stages and
arguments.

1. Synthesise "music" tracks, a noise and an IR corpus at 16 kHz
   (grafp_tpu_torch.data.synthetic.make_wav_dir, byte-equal to the JAX
   repo's test fixture).
2. Train the flagship model (Config(), bf16) with the port's train step
   for --epochs epochs: FingerprintDataset + PairBatcher over the tracks,
   the augment banks of an 0.8 split of the noise and IR corpora, each
   step's augment drawing from a torch.Generator seeded from (epoch,
   step) as cli/train_main.py:step_generator does.
3. For SNR 10, 5 and 0, each with a new FingerprintPipeline (a folded
   copy of the trained weights), build the dummy DB from all tracks but
   the last --queries and the paired clean / corrupted DBs from those, at
   the tc_29 geometry (offset 0.05, overlap 0.9), and print the hit rates
   of eval_faiss with 'ivfpq' and 'l2' (test_ids "200", lengths 1 3 5 11
   19, 64 cells).

Beside the JAX script's output it prints the SNR-10 'l2' row of the model
before its first step (so the gain from training can be read), each
epoch's mean loss and seconds, the DB builds' seconds and fingerprints/s,
and the kernels' launches (#3 and #4 in the train step, #5 and #3 in the
builds) from their wrappers' ``.launches`` counters.

    python scripts/torch_port_e2e_synthetic_icassp.py [--tracks 300]
        [--dur 15] [--epochs 12] [--bsz 64] [--queries 40] [--root DIR]

The corpora go under ROOT/corpus_<tracks>x<dur>s and are reused when
complete (ROOT defaults to torch_port_e2e under the temp directory); the
fingerprint DBs under ROOT/fp_snr<snr> are rebuilt every run.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

FS = 16000
SNRS = (10, 5, 0)
INDEX_TYPES = ("ivfpq", "l2")
# the JAX script's eval_faiss arguments
EVAL = dict(test_ids="200", test_seq_len="1 3 5 11 19", n_centroids=64)


def make_corpora(root: str, n_tracks: int, dur_s: float, fs: int = FS,
                 seed: int = 0) -> str:
    """The three corpora under ROOT/corpus_<n>x<dur>s (the JAX script's
    make_corpora: 24 noise clips of 5 s, 12 IRs); reused when a former
    call finished them. Returns the corpus directory."""
    from grafp_tpu_torch.data.synthetic import make_wav_dir

    path = os.path.join(root, f"corpus_{n_tracks}x{dur_s:g}s_{fs}Hz")
    done = os.path.join(path, "complete")
    if os.path.exists(done):
        print(f"[data] reusing {path}", flush=True)
        return path
    t0 = time.time()
    make_wav_dir(os.path.join(path, "tracks"), n=n_tracks, dur_s=dur_s, sr=fs,
                 seed=seed, kind="music")
    make_wav_dir(os.path.join(path, "noise"), n=24, dur_s=5.0, sr=fs,
                 seed=seed + 1, kind="noise")
    make_wav_dir(os.path.join(path, "ir"), n=12, dur_s=0.5, sr=fs,
                 seed=seed + 2, kind="ir")
    open(done, "w").close()
    print(f"[data] {n_tracks} tracks + corpora in {time.time() - t0:.0f}s", flush=True)
    return path


def e2e_config(corpus: str, n_tracks: int, bsz: int, **overrides):
    """The JAX script's Config: tc_29 geometry (offset .05, overlap .9;
    reference test_fp.py:189-191), bf16, every track in both splits."""
    from grafp_tpu_torch.core import Config

    return Config(**{**dict(
        data_dir=corpus,
        train_dir=os.path.join(corpus, "tracks"),
        val_dir=os.path.join(corpus, "tracks"),
        noise_dir=os.path.join(corpus, "noise"),
        ir_dir=os.path.join(corpus, "ir"),
        offset=0.05, overlap=0.9,
        train_sz=n_tracks, val_sz=n_tracks,
        bsz_train=bsz, compute_dtype="bfloat16"), **overrides})


def _launches():
    from grafp_tpu_torch.ops.grapher_block import grapher_block
    from grafp_tpu_torch.ops.mrconv_concat import mrconv_concat, mrconv_concat_backward

    return {"mrconv_concat": mrconv_concat,
            "mrconv_concat_backward": mrconv_concat_backward,
            "grapher_block": grapher_block}


def _zero_launches():
    for fn in _launches().values():
        fn.launches = 0


def _read_launches():
    return {name: fn.launches for name, fn in _launches().items()}


def run(root: str, tracks: int = 300, dur: float = 15.0, epochs: int = 12,
        bsz: int = 64, queries: int = 40, device=None, snrs=SNRS,
        init_state=None, fs: int = FS, **overrides) -> dict:
    """The three stages; returns {"epoch_loss" (mean loss of each epoch),
    "epoch_s", "step_losses" (per epoch), "steps", "baseline" (the
    untrained model's SNR-10 'l2' hit rates, or None when 10 is not in
    ``snrs``), "hit_rates" {snr:
    {index_type: (4, n_sl)}}, "build" {snr: (seconds, rows)}, "launches"
    {"e2e_train": ..., "e2e_build": ...} (the builds of ``snrs``, not the
    baseline's), "embed_batches" (the model calls of those builds)}.

    ``init_state``: a state_dict to start from instead of the seeded
    initialisation; ``fs``: the corpora's and the Config's sample rate;
    ``overrides``: other Config fields."""
    import torch

    from grafp_tpu_torch.cli.train_main import step_generator
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.data.dataset import (
        FingerprintDataset, PairBatcher, TrackLoader, build_augment_banks,
    )
    from grafp_tpu_torch.data.indexing import load_augmentation_index
    from grafp_tpu_torch.fp.builder import (
        FingerprintPipeline, create_dummy_db, create_fp_db,
    )
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss
    from grafp_tpu_torch.train import create_train_state, make_train_step

    device = resolve_device(device)
    os.makedirs(root, exist_ok=True)
    corpus = make_corpora(root, tracks, dur, fs=fs)
    cfg = e2e_config(corpus, tracks, bsz, fs=fs, **overrides)

    noise = load_augmentation_index(cfg["noise_dir"], splits=0.8)
    irs = load_augmentation_index(cfg["ir_dir"], splits=0.8)
    train_banks = build_augment_banks(noise["train"], irs["train"], cfg.fs)
    test_banks = build_augment_banks(noise["test"], irs["test"], cfg.fs)

    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device=device,
                        train=True)
    if init_state is not None:
        model.load_state_dict(init_state)
    ds = FingerprintDataset(cfg, cfg.train_dir, train=True, seed=0)
    loader = PairBatcher(ds, bsz, seed=0, num_threads=2)
    state = create_train_state(model, cfg, max(len(loader), 1))
    step = make_train_step(model, cfg, train_banks, device=device)

    eval_ds = FingerprintDataset(cfg, cfg.train_dir, train=False)
    idx = np.arange(len(eval_ds))
    dummy_loader = TrackLoader(eval_ds, idx[: len(idx) - queries])
    query_loader = TrackLoader(eval_ds, idx[len(idx) - queries:])
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)

    def build(snr: int):
        """A new pipeline of the current weights at ``snr``; the DBs under
        ROOT/fp_snr<snr>; (dir, seconds, rows, embed batches run)."""
        cfg["val_snr"] = [snr, snr]
        pipe = FingerprintPipeline(model, cfg, bucket_s=dur, device=device)
        batches, embed = [0], pipe.embed

        def counted(spec):
            batches[0] += 1
            return embed(spec)

        pipe.embed = counted
        fp_dir = os.path.join(root, f"fp_snr{snr}")
        t0 = time.time()
        rows, _ = create_dummy_db(dummy_loader, pipe, fp_dir, verbose=False)
        rows_q, _ = create_fp_db(query_loader, pipe, test_banks, fp_dir, verbose=False)
        sync()
        return fp_dir, time.time() - t0, rows + 2 * rows_q, batches[0]

    def evaluate(fp_dir: str, index_type: str):
        return eval_faiss(fp_dir, index_type=index_type, verbose=False, device=device,
                          **EVAL)

    out = {"baseline": None, "hit_rates": {}, "build": {}}
    if 10 in snrs:
        fp_dir, secs, rows, _ = build(10)
        out["baseline"] = evaluate(fp_dir, "l2")
        print(f"[eval] untrained (epoch 0) SNR 10 l2: {_table(out['baseline'])} "
              f"(DBs {rows} rows in {secs:.1f}s)", flush=True)

    print(f"[train] {epochs} epochs x {len(loader)} steps (bsz {bsz})", flush=True)
    out.update(epoch_loss=[], epoch_s=[], step_losses=[], steps=0)
    _zero_launches()
    for epoch in range(epochs):
        t0 = time.time()
        losses = []
        for i, (xi, xj) in enumerate(loader):
            m = step(state, torch.as_tensor(xi, device=device),
                     torch.as_tensor(xj, device=device),
                     step_generator(0, epoch, i, device))
            losses.append(float(m["loss"]))
        out["steps"] += len(losses)
        out["step_losses"].append(losses)
        out["epoch_loss"].append(float(np.mean(losses)))
        out["epoch_s"].append(time.time() - t0)
        print(f"[train] epoch {epoch}: loss {out['epoch_loss'][-1]:.4f} "
              f"({out['epoch_s'][-1]:.1f}s)", flush=True)
    out["launches"] = {"e2e_train": _read_launches()}

    # ---- evaluation protocol ----
    build_launches = {name: 0 for name in _launches()}
    out["embed_batches"] = 0
    for snr in snrs:
        _zero_launches()
        fp_dir, secs, rows, batches = build(snr)
        for name, n in _read_launches().items():
            build_launches[name] += n
        out["embed_batches"] += batches
        out["build"][snr] = (secs, rows)
        print(f"[fp] SNR {snr}: DBs built in {secs:.1f}s ({rows} rows, "
              f"{rows / secs:.0f} fp/s)", flush=True)
        out["hit_rates"][snr] = {}
        for index_type in INDEX_TYPES:
            hr = evaluate(fp_dir, index_type)
            out["hit_rates"][snr][index_type] = hr
            print(f"[eval] SNR {snr} {index_type}: {_table(hr)}", flush=True)
    out["launches"]["e2e_build"] = build_launches
    print(f"[launches] {out['launches']}", flush=True)
    return out


def _table(hr) -> str:
    return (f"top1-exact {np.round(hr[0], 1)}  top1-near {np.round(hr[1], 1)} "
            f"top3 {np.round(hr[2], 1)}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tracks", type=int, default=300)
    ap.add_argument("--dur", type=float, default=15.0)
    ap.add_argument("--epochs", type=int, default=12)
    ap.add_argument("--bsz", type=int, default=64)
    ap.add_argument("--queries", type=int, default=40)
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "torch_port_e2e"))
    args = ap.parse_args(argv)
    run(args.root, tracks=args.tracks, dur=args.dur, epochs=args.epochs,
        bsz=args.bsz, queries=args.queries)
    return 0


if __name__ == "__main__":
    sys.exit(main())
