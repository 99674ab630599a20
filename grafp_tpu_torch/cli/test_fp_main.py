"""Evaluation driver with the reference CLI contract (port of
``grafp_tpu.cli.test_fp_main``; reference test_fp.py:34-57):

    python -m grafp_tpu_torch.cli.test_fp --config config/grafp.yaml \\
        --test_config config/test_config.yaml --test_dir D [--small_test] ...

For every checkpoint name and epoch of the test config it loads
``checkpoint/model_<name>_<epoch>.pth`` (this package's format or a
reference ``.pth``), builds the dummy DB and the clean and corrupted query
DBs from the frozen ``<data_dir>/<test_dir>_indices.npy`` split under
``logs/store/...``, and runs ``eval_faiss`` ('ivfpq', or exact 'l2' with
``--small_test``) on the card. It keeps the tc_27/29/30/31 offset and
overlap presets (test_fp.py:184-198) and the ``sanir`` switch that turns
off the queries' IR corruption.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

ORBAX_SCRIPT = "scripts/torch_port_orbax_to_pth.py"


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Neuralfp Testing")
    p.add_argument("--config", default="config/grafp.yaml", type=str)
    p.add_argument("--test_config", default="config/test_config.yaml", type=str)
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--test_dir", default="data/fma_medium.json", type=str)
    p.add_argument("--noise_idx", default=None, type=str)
    p.add_argument("--noise_split", default="all", type=str)
    p.add_argument("--fp_dir", default="fingerprints", type=str)
    p.add_argument("--query_lens", default=None, type=str)
    p.add_argument("--encoder", default="grafp", type=str)
    p.add_argument("--n_dummy_db", default=None, type=int)
    p.add_argument("--n_query_db", default=500, type=int)
    p.add_argument("--small_test", action="store_true", default=False)
    p.add_argument("--text", default="test", type=str)
    p.add_argument("--test_snr", default=None, type=int)
    p.add_argument("--recompute", action="store_true", default=False)
    p.add_argument("--k", default=3, type=int)
    p.add_argument("--model", default=None, type=str)
    p.add_argument("--test_ids", default="2000", type=str)
    p.add_argument("--shuffle", action="store_true", default=False)
    return p


def create_table(hit_rates, overlap, dur, test_seq_len=(1, 3, 5, 9, 11, 19),
                 text="test") -> str:
    """HTML hit-rate table (reference test_fp.py:63-85).

    The ``<th colspan="5"{text}</th>`` below is the reference's own
    malformed HTML (no '>' after the attribute, test_fp.py:66), kept so
    that the TensorBoard text is byte-equal to the reference's."""
    from grafp_tpu_torch.utils.helpers import seconds_from_query_len

    table = f"""<table>
    <tr>
    <th colspan="5"{text}</th>
    <th>Query Length</th>
    <th>Top-1 Exact</th>
    <th>Top-1 Near</th>
    <th>Top-3 Exact</th>
    <th>Top-10 Exact</th>
    </tr>
    """
    for idx, q_len in enumerate(test_seq_len):
        table += f"""
        <tr>
        <td>{seconds_from_query_len(q_len, overlap, dur)}</td>
        <td>{hit_rates[0][idx]}</td>
        <td>{hit_rates[1][idx]}</td>
        <td>{hit_rates[2][idx]}</td>
        <td>{hit_rates[3][idx]}</td>
        </tr>
        """
    return table + "</table>"


def load_any_checkpoint(ckp_path: str, model):
    """The state_dict of a ``.pth`` checkpoint, this package's or the
    reference's, for ``model``. A JAX package (Orbax) directory raises,
    naming the script that converts it."""
    from grafp_tpu_torch.train.checkpoint import model_state_dict

    if os.path.isdir(ckp_path):
        raise ValueError(
            f"{ckp_path} is a directory: an Orbax checkpoint of the JAX package. "
            f"Convert it with `python {ORBAX_SCRIPT} {ckp_path} OUT.pth "
            "--config CONFIG` and pass the .pth")
    return model_state_dict(ckp_path, model)


def resolve_ckpt_path(model_folder: str, ckp_name: str, epoch) -> str:
    """``model_<name>_<epoch>.pth`` when it exists, else the JAX package's
    Orbax directory name (which ``load_any_checkpoint`` refuses)."""
    pth = os.path.join(model_folder, f"model_{ckp_name}_{epoch}.pth")
    if os.path.isfile(pth):
        return pth
    return os.path.join(model_folder, f"model_{ckp_name}_{epoch}")


def main(argv=None, device=None):
    """Run the CLI; ``device`` None means the card (raises without one),
    the tests pass "cpu". Returns {checkpoint path: (fingerprint dir,
    hit rates)} of the checkpoints it evaluated."""
    import yaml

    from grafp_tpu_torch.core.config import load_config
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.core.mesh import db_mesh_from_config
    from grafp_tpu_torch.data.dataset import (
        FingerprintDataset,
        TrackLoader,
        build_augment_banks,
    )
    from grafp_tpu_torch.data.indexing import load_augmentation_index
    from grafp_tpu_torch.fp.builder import (
        FingerprintPipeline,
        create_dummy_db,
        create_fp_db,
    )
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss
    from grafp_tpu_torch.utils.helpers import (
        TensorBoardWriter,
        create_fp_dir,
        query_len_from_seconds,
    )

    args = build_argparser().parse_args(argv)
    dev = resolve_device(device)
    cfg = load_config(args.config)
    data_dir = cfg["data_dir"]
    if args.test_snr is not None:
        cfg["val_snr"] = [int(args.test_snr), int(args.test_snr)]
    if args.test_dir == "data/fma_medium.json":
        cfg["val_sz"] = 25000
    else:
        cfg["val_sz"] = 106574

    with open(args.test_config) as fp:
        test_cfg = yaml.safe_load(fp)

    if args.shuffle:
        raise ValueError("--shuffle is not supported: the frozen split decides "
                         "the order")

    # ablation presets (test_fp.py:184-198)
    if args.model is not None:
        test_cfg = {args.model: test_cfg[args.model]}
        presets = {
            "tc_27": (0.2, 0.5), "tc_29": (0.05, 0.9),
            "tc_30": (0.1, 0.8), "tc_31": (0.125, 0.75),
        }
        if args.model in presets:
            cfg["offset"], cfg["overlap"] = presets[args.model]

    print("Creating new model...")
    if args.encoder == "resnet":
        raise NotImplementedError
    cfg["arch"] = args.encoder
    cfg["k"] = args.k
    model = build_model(cfg, device=dev)

    print("Creating dataloaders ...")
    if args.noise_idx is not None:
        noise_test = load_augmentation_index(
            cfg["noise_dir"], json_path=args.noise_idx, splits=0.8
        )[args.noise_split]
    else:
        noise_test = load_augmentation_index(cfg["noise_dir"], splits=0.8)["test"]
    ir_test = load_augmentation_index(cfg["ir_dir"], splits=0.8)["test"]
    banks = build_augment_banks(noise_test, ir_test, cfg["fs"])
    # "sanir" in --text turns off the queries' IR corruption (test_fp.py:223-231)
    ir_prob = 0.0 if "sanir" in args.text else 1.0
    if ir_prob == 0.0:
        print("Queries without IR augmentation!")

    dataset = FingerprintDataset(cfg, path=args.test_dir, train=False)
    split2 = args.n_query_db
    split1 = args.n_dummy_db if args.n_dummy_db is not None else len(dataset) - split2
    test_dir_name = args.test_dir.split("/")[-1].split(".")[0]
    indices = np.load(f"{data_dir}/{test_dir_name}_indices.npy")
    dummy_indices = indices[:split1]
    query_indices = indices[split1:split1 + split2]
    print(f"Creating dummy db with {len(dummy_indices)} samples and "
          f"query db with {len(query_indices)} samples")
    dummy_loader = TrackLoader(dataset, dummy_indices)
    query_loader = TrackLoader(dataset, query_indices)

    index_type = "l2" if args.small_test else "ivfpq"
    test_seq_len = [1, 3, 5, 9, 11, 19]
    if args.query_lens is not None:
        test_seq_len = [query_len_from_seconds(float(q), cfg["overlap"], dur=cfg["dur"])
                        for q in args.query_lens.split(",")]

    results = {}
    model_folder = "checkpoint"
    for ckp_name, epochs in test_cfg.items():
        if not isinstance(epochs, list):
            epochs = [epochs]
        writer = TensorBoardWriter(f"runs/{ckp_name}")
        for epoch in epochs:
            ckp = resolve_ckpt_path(model_folder, ckp_name, epoch)
            if not os.path.exists(ckp):
                print(f"=> no checkpoint found at '{ckp}'")
                continue
            print(f"=> loading checkpoint '{ckp}'")
            model.load_state_dict(load_any_checkpoint(ckp, model))
            pipeline = FingerprintPipeline(model, cfg, device=dev)

            large = args.test_dir == "data/fma_large.json"
            fp_dir = create_fp_dir(resume=ckp, train=False, large=large)
            if args.recompute or not os.path.isfile(f"{fp_dir}/dummy_db.mm"):
                print("=> Computing dummy fingerprints...")
                create_dummy_db(dummy_loader, pipeline, fp_dir, verbose=False)
            else:
                print("=> Skipping dummy db creation...")
            create_fp_db(query_loader, pipeline, banks, fp_dir,
                         seed=args.seed, ir_prob=ir_prob, verbose=False)

            # mesh_db > 1 shards the index over that many cards, or falls
            # back to one card with a notice when fewer are visible
            hit_rates = eval_faiss(emb_dir=fp_dir, test_ids=args.test_ids,
                                   test_seq_len=" ".join(map(str, test_seq_len)),
                                   index_type=index_type, scan_topk=cfg["scan_topk"],
                                   scan_recall=cfg["scan_recall"], device=dev,
                                   mesh=db_mesh_from_config(cfg))
            text = f"{args.text}_{epoch}"
            label = epoch if isinstance(epoch, int) else 0
            writer.add_text("table", create_table(hit_rates, cfg["overlap"], cfg["dur"],
                                                  test_seq_len, text=text), label)
            print("-------Test hit-rates-------")
            print(f"Top-1 exact hit rate = {hit_rates[0]}")
            print(f"Top-1 near hit rate = {hit_rates[1]}")
            results[ckp] = (fp_dir, hit_rates)
        writer.close()
    return results
