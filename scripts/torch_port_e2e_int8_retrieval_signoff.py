#!/usr/bin/env python3
"""The int8_static retrieval sign-off on the port: the counterpart of
scripts/e2e_int8_retrieval_signoff.py, with its arguments, its protocol and
its last line.

The same trained checkpoint serves under bf16 and under serve_quant
'int8_static' at SNR 10, 5 and 0, and the script prints the top-1 exact,
top-1 near and top-3 hit-rate deltas (int8_static - bf16, percentage
points) at query lengths 1 3 5 9 11 19. The protocol is the test_fp CLI's
(cli/test_fp_main.py; reference test_fp.py:87-158 + eval.py:170-332) in
one process: the frozen ``eval_tracks_indices.npy`` split, the last
``n_query_db`` tracks as queries, the test-split noise and IR banks,
``create_dummy_db`` once per quant mode, then per SNR ``create_fp_db``
with the pipeline's ``val_snr`` set to (snr, snr) and ``eval_faiss``
'ivfpq' with the config's ``scan_topk`` / ``scan_recall``. The A/B is
controlled: same checkpoint, same corruption seed, same seeded test ids;
only the serving quantisation differs. Beside the JAX script's output it
prints each build's seconds and fingerprints/s and the kernels' launches
per quant mode.

Needs r5's workspace (scripts/torch_port_setup_synth_icassp.py, then
scripts/torch_port_e2e_cli_icassp_r5.sh, which writes ROOT/synth_eval.yaml
and trains ROOT/run/checkpoint/model_tc29r5_best.pth):

    python scripts/torch_port_e2e_int8_retrieval_signoff.py [--root ROOT]
        [--ckp tc29r5] [--n_query_db 200] [--test_ids 400]
        [--snrs 10 5 0] [--seed 42]

The DBs go under ROOT/signoff/<quant>/.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

QUANTS = ("bf16", "int8_static")
SEQ_LENS = "1 3 5 9 11 19"


def _launches():
    from grafp_tpu_torch.fp.graphs import KERNEL_WRAPPERS

    return {fn.__name__: fn.launches for fn in KERNEL_WRAPPERS}


def run(root: str, ckp: str = "tc29r5", n_query_db: int = 200, test_ids="400",
        snrs=(10, 5, 0), seed: int = 42, device=None) -> dict:
    """The sign-off; returns {"hit_rates" {(quant, snr): (4, 6) array},
    "summary" (the last line's object), "dummy_dirs" {quant: dir},
    "launches" {quant: {kernel: launches of its builds; int8_static's
    include its lazy calibration's one forward}}, "embed_batches" {quant:
    model calls of its builds}, "build_s" {(quant, snr or "dummy"):
    seconds}}. ``device`` None means the card."""
    import torch

    from grafp_tpu_torch.cli.test_fp_main import load_any_checkpoint
    from grafp_tpu_torch.core.config import load_config
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.data.dataset import (
        FingerprintDataset, TrackLoader, build_augment_banks,
    )
    from grafp_tpu_torch.data.indexing import load_augmentation_index
    from grafp_tpu_torch.fp.builder import (
        FingerprintPipeline, create_dummy_db, create_fp_db,
    )
    from grafp_tpu_torch.fp.graphs import KERNEL_WRAPPERS
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss

    device = resolve_device(device)
    sync = torch.cuda.synchronize if device.type == "cuda" else (lambda: None)
    root = os.path.abspath(root)
    cfg_path = os.path.join(root, "synth_eval.yaml")
    cfg = load_config(cfg_path)
    ckp_path = os.path.join(root, "run", "checkpoint", f"model_{ckp}_best.pth")
    print(f"checkpoint: {ckp_path}", flush=True)

    # the CLI's frozen split (cli/test_fp_main.py)
    dataset = FingerprintDataset(cfg, path=os.path.join(root, "eval_tracks"), train=False)
    indices = np.load(os.path.join(cfg["data_dir"], "eval_tracks_indices.npy"))
    split1 = len(dataset) - n_query_db
    dummy_loader = TrackLoader(dataset, indices[:split1])
    query_loader = TrackLoader(dataset, indices[split1:])
    print(f"dummy {len(dummy_loader)} tracks, query {len(query_loader)} tracks",
          flush=True)

    noise_test = load_augmentation_index(cfg["noise_dir"], splits=0.8)["test"]
    ir_test = load_augmentation_index(cfg["ir_dir"], splits=0.8)["test"]
    banks = build_augment_banks(noise_test, ir_test, cfg["fs"])

    out = {"hit_rates": {}, "dummy_dirs": {}, "launches": {}, "embed_batches": {},
           "build_s": {}}
    for quant in QUANTS:
        qcfg = load_config(cfg_path)
        if quant != "bf16":
            qcfg["serve_quant"] = quant
        model = build_model(qcfg, device=device)
        model.load_state_dict(load_any_checkpoint(ckp_path, model))
        pipe = FingerprintPipeline(model, qcfg, device=device)
        batches, embed = [0], pipe.embed

        def counted(spec, embed=embed, batches=batches):
            batches[0] += 1
            return embed(spec)

        pipe.embed = counted
        for fn in KERNEL_WRAPPERS:
            fn.launches = 0
        dummy_dir = os.path.join(root, "signoff", quant, "dummy")
        t0 = time.time()
        rows, _ = create_dummy_db(dummy_loader, pipe, dummy_dir, verbose=False)
        sync()
        secs = out["build_s"][(quant, "dummy")] = time.time() - t0
        out["dummy_dirs"][quant] = dummy_dir
        print(f"[{quant}] dummy db built in {secs:.0f}s ({rows} rows, "
              f"{rows / secs:.0f} fp/s)", flush=True)
        for snr in snrs:
            # corrupt_tracks reads the pipeline's val_snr per call
            pipe.val_snr = (float(snr), float(snr))
            fp_dir = os.path.join(root, "signoff", quant, f"snr{snr}")
            t0 = time.time()
            rows_q, _ = create_fp_db(query_loader, pipe, banks, fp_dir, seed=seed,
                                     ir_prob=1.0, verbose=False)
            sync()
            out["build_s"][(quant, snr)] = time.time() - t0
            hr = eval_faiss(
                emb_dir=fp_dir, emb_dummy_dir=dummy_dir, index_type="ivfpq",
                test_ids=test_ids, test_seq_len=SEQ_LENS, verbose=False,
                scan_topk=qcfg.scan_topk, scan_recall=qcfg.scan_recall, device=device)
            out["hit_rates"][(quant, snr)] = np.asarray(hr, np.float64)
            print(f"[{quant}] SNR {snr:>2}: top1-exact {np.round(hr[0], 2)} "
                  f"top1-near {np.round(hr[1], 2)} top3 {np.round(hr[2], 2)} "
                  f"({time.time() - t0:.0f}s; DBs {2 * rows_q} rows in "
                  f"{out['build_s'][(quant, snr)]:.1f}s)", flush=True)
        out["launches"][quant] = _launches()
        out["embed_batches"][quant] = batches[0]
        print(f"[{quant}] {batches[0]} embed batches, launches "
              f"{out['launches'][quant]}", flush=True)
        del pipe, model
        if device.type == "cuda":
            torch.cuda.empty_cache()

    # ---- deltas (int8_static - bf16), percentage points ----
    print(f"\n==== int8_static - bf16 hit-rate deltas (pp; seq lens {SEQ_LENS}) ====",
          flush=True)
    summary = {}
    for snr in snrs:
        d = out["hit_rates"][("int8_static", snr)] - out["hit_rates"][("bf16", snr)]
        print(f"SNR {snr:>2}: top1-exact {np.round(d[0], 2)}\n"
              f"        top1-near  {np.round(d[1], 2)}\n"
              f"        top3       {np.round(d[2], 2)}", flush=True)
        summary[str(snr)] = {
            "top1_exact_delta_pp": [float(x) for x in d[0]],
            "top1_near_delta_pp": [float(x) for x in d[1]],
            "top3_delta_pp": [float(x) for x in d[2]],
            "bf16_top1_exact": [float(x) for x in out["hit_rates"][("bf16", snr)][0]],
        }
    worst = min(min(v["top1_exact_delta_pp"] + v["top3_delta_pp"])
                for v in summary.values())
    out["summary"] = {"signoff": "int8_static_vs_bf16", "worst_delta_pp": worst,
                      "per_snr": summary}
    print(json.dumps(out["summary"]), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", default=os.path.join(tempfile.gettempdir(),
                                                   "grafp_cli_e2e_r5"))
    ap.add_argument("--ckp", default="tc29r5")
    ap.add_argument("--n_query_db", type=int, default=200)
    ap.add_argument("--test_ids", default="400")
    ap.add_argument("--snrs", type=int, nargs="+", default=[10, 5, 0])
    ap.add_argument("--seed", type=int, default=42)
    args = ap.parse_args(argv)
    run(args.root, ckp=args.ckp, n_query_db=args.n_query_db, test_ids=args.test_ids,
        snrs=tuple(args.snrs), seed=args.seed)
    return 0


if __name__ == "__main__":
    sys.exit(main())
