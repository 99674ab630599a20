"""Training driver with the reference CLI contract (port of
``grafp_tpu.cli.train_main``; reference train.py:34-52):

    python -m grafp_tpu_torch.cli.train --config config/grafp.yaml --ckp tc_xx \\
        [--train_dir D] [--val_dir D] [--epochs N] [--resume PATH] [--seed S]
        [--encoder grafp] [--n_dummy_db N] [--n_query_db N] [--k K]
        [--validate_every E] [--cache_decoded] [--cache_dir D]

The flow of the reference's train.py:97-233: augmentation indices (0.8
train/test splits), the train loader (shuffled pairs, drop-last), the
validation loaders (a seeded split into n_dummy / n_query full tracks),
the model, Adam and the per-epoch cosine schedule, the retrieval
validation (an exact 'l2' index over the dummy DB) at epoch 1 and every
``validate_every`` epochs, and the checkpoints model_<ckp>_{current, best,
<epoch>}.pth with the loss and hit-rate logs, under ``checkpoint/`` of the
working directory. Each step runs on the card (``main``'s ``device``, None
= the card); the loader's threads only decode and crop.

On N cards, data parallel:

    torchrun --nproc_per_node N -m grafp_tpu_torch.cli.train --config ... --ckp ...

Each rank joins the process group (``parallel.initialize_distributed``,
NCCL on the cards), takes card LOCAL_RANK, and reads and decodes only its
B / N rows of each global batch (``bsz_train`` stays the global batch);
the step computes the global batch's loss and gradients
(``train/step.py``), so the run follows the one-process run up to
reduction order. Rank 0 alone validates, saves the checkpoints and writes
TensorBoard; the other ranks wait for it at a barrier. ``--resume`` loads
on every rank. Without torchrun nothing changes.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch


def build_argparser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Grafprint Training")
    p.add_argument("--config", default="config/grafp.yaml", type=str)
    p.add_argument("--train_dir", default=None, type=str, metavar="PATH")
    p.add_argument("--val_dir", default=None, type=str, metavar="PATH")
    p.add_argument("--epochs", default=None, type=int, metavar="N")
    p.add_argument("--resume", default=None, type=str, metavar="PATH")
    p.add_argument("--seed", default=42, type=int)
    p.add_argument("--ckp", default="test", type=str)
    p.add_argument("--encoder", default="grafp", type=str)
    p.add_argument("--n_dummy_db", default=None, type=int)
    p.add_argument("--n_query_db", default=None, type=int)
    p.add_argument("--k", default=3, type=int)
    p.add_argument("--validate_every", default=10, type=int,
                   help="retrieval-validation period in epochs; 0 disables "
                        "validation, the epoch-1 run included")
    p.add_argument("--cache_decoded", action="store_true", default=False,
                   help="decode and resample each training track once and keep "
                        "it in RAM")
    p.add_argument("--cache_dir", default=None, type=str,
                   help="disk-backed decode cache: decoded tracks are written "
                        "once as <cache_dir>/<idx>.npy and memmapped thereafter")
    return p


def validate(epoch, query_loader, dummy_loader, banks, model, cfg,
             output_root_dir, every: int = 10, device=None):
    """Reference train.py:84-95: a small retrieval eval with an exact index
    at epoch 1 and every ``every`` epochs (the reference's own ``if
    epoch==1 or epoch % 10 == 0``); ``every`` 0 disables it. ``model`` is
    an eval-mode model holding the weights to validate. Returns the (4,
    n_sl) hit rates, or None when it did not run."""
    from grafp_tpu_torch.fp.builder import (
        FingerprintPipeline,
        create_dummy_db,
        create_fp_db,
    )
    from grafp_tpu_torch.retrieval.evaluate import eval_faiss

    if every <= 0 or not (epoch == 1 or epoch % every == 0):
        return None
    # a new pipeline, and on the card new graph captures, each validation:
    # the pipeline serves a folded copy of the weights as they are now, and
    # its graphs hold that copy's addresses
    pipeline = FingerprintPipeline(model, cfg, device=device)
    create_dummy_db(dummy_loader, pipeline, output_root_dir, verbose=False)
    create_fp_db(query_loader, pipeline, banks, output_root_dir, verbose=False)
    hit_rates = eval_faiss(emb_dir=output_root_dir, test_ids="all", index_type="l2",
                           n_centroids=32, verbose=False, device=device)
    print("-------Validation hit-rates-------")
    print(f"Top-1 exact hit rate = {hit_rates[0]}")
    print(f"Top-1 near hit rate = {hit_rates[1]}")
    return hit_rates


def step_generator(seed: int, epoch: int, step: int, device) -> torch.Generator:
    """The augment's generator of one train step, seeded from (seed, epoch,
    step): a resumed run draws what an uninterrupted one does (the JAX
    driver's ``fold_in`` of epoch and step into its root key)."""
    state = np.random.SeedSequence([seed, epoch, step]).generate_state(1, np.uint64)[0]
    return torch.Generator(device=device).manual_seed(int(state))


def main(argv=None, device=None):
    """Run the CLI; ``device`` None means the card (raises without one),
    the tests pass "cpu". Returns {"epoch_seconds", "loss", "hit_rates"}
    of the epochs this call ran: the train loop's wall time per epoch
    (validation excluded), the summed step losses, and the hit rates or
    None per epoch."""
    from grafp_tpu_torch.core.config import load_config, override
    from grafp_tpu_torch.core.device import resolve_device
    from grafp_tpu_torch.data.dataset import (
        FingerprintDataset,
        PairBatcher,
        TrackLoader,
        build_augment_banks,
    )
    from grafp_tpu_torch.data.indexing import load_augmentation_index
    from grafp_tpu_torch.models import build_model
    from grafp_tpu_torch.parallel import distributed
    from grafp_tpu_torch.train import create_train_state, make_train_step
    from grafp_tpu_torch.train.checkpoint import (
        load_ckp,
        restore_train_state,
        save_ckp,
        train_payload,
    )
    from grafp_tpu_torch.utils.helpers import (
        TensorBoardWriter,
        count_parameters,
        create_fp_dir,
    )

    args = build_argparser().parse_args(argv)
    joined = distributed.initialize_distributed(device=device)
    rank, ranks = distributed.rank(), distributed.world_size()
    lead = rank == 0                      # validates, saves and logs
    dev = resolve_device(device)
    cfg = load_config(args.config)
    if args.encoder == "resnet":
        raise NotImplementedError  # deprecated in the reference too
    cfg["arch"] = args.encoder
    cfg["k"] = args.k
    writer = TensorBoardWriter(f"runs/{args.ckp}") if lead else None
    train_dir = override(cfg["train_dir"], args.train_dir)
    valid_dir = override(cfg["val_dir"], args.val_dir)
    model_folder = "checkpoint"
    num_epochs = override(cfg["n_epochs"], args.epochs)

    print("Intializing augmentation pipeline...")
    noise_train = load_augmentation_index(cfg["noise_dir"], splits=0.8)["train"]
    ir_train = load_augmentation_index(cfg["ir_dir"], splits=0.8)["train"]
    noise_val = load_augmentation_index(cfg["noise_dir"], splits=0.8)["test"]
    ir_val = load_augmentation_index(cfg["ir_dir"], splits=0.8)["test"]
    train_banks = build_augment_banks(noise_train, ir_train, cfg["fs"])
    val_banks = build_augment_banks(noise_val, ir_val, cfg["fs"])

    print("Loading dataset...")
    train_ds = FingerprintDataset(cfg, train_dir, train=True, seed=args.seed,
                                  cache_decoded=args.cache_decoded,
                                  cache_dir=args.cache_dir)
    train_loader = PairBatcher(train_ds, cfg["bsz_train"], seed=args.seed,
                               shard=(rank, ranks))

    valid_ds = FingerprintDataset(cfg, valid_dir, train=False)
    n_dummy = override(cfg["n_dummy"], args.n_dummy_db)
    n_query = override(cfg["n_query"], args.n_query_db)
    indices = np.arange(len(valid_ds))
    np.random.seed(args.seed)
    np.random.shuffle(indices)
    dummy_loader = TrackLoader(valid_ds, indices[:n_dummy])
    query_loader = TrackLoader(valid_ds, indices[n_dummy:n_dummy + n_query])

    print("Creating new model...")
    model = build_model(cfg, generator=torch.Generator().manual_seed(args.seed),
                        device=dev, train=True)
    served = build_model(cfg, device=dev)          # eval mode, for validation
    steps_per_epoch = max(len(train_loader), 1)
    state = create_train_state(model, cfg, steps_per_epoch)
    print(count_parameters(model, args.encoder))
    step = make_train_step(model, cfg, train_banks, device=dev)

    start_epoch, loss_log, hit_rate_log = 0, [], []
    best_loss, best_hr = float("inf"), 0.0
    if args.resume:
        if os.path.exists(args.resume):
            print(f"=> loading checkpoint '{args.resume}'")
            payload = load_ckp(args.resume)
            restore_train_state(state, payload)
            start_epoch = int(payload["epoch"])
            loss_log = list(payload["loss"])
            hit_rate_log = list(payload["valid_acc"])
            # continue the loader's epoch count: the batch order and the
            # crops of epoch e are seeded by e
            train_loader.epoch = start_epoch
        else:
            print(f"=> no checkpoint found at '{args.resume}'")

    history = {"epoch_seconds": [], "loss": [], "hit_rates": []}
    for epoch in range(start_epoch + 1, num_epochs + 1):
        print(f"#######Epoch {epoch}#######")
        t0 = time.time()
        step_losses = []
        for idx, (x_i, x_j) in enumerate(train_loader):
            metrics = step(state, x_i, x_j, step_generator(args.seed, epoch, idx, dev))
            # the losses stay on the card until the epoch ends: fetching
            # each one would wait for its step
            step_losses.append(metrics["loss"])
            if idx % 10 == 0:
                print(f"Step [{idx}/{len(train_loader)}]\t Net Loss: "
                      f"{float(metrics['loss'])}")
        loss_epoch = float(torch.stack(step_losses).sum()) if step_losses else 0.0
        seconds = time.time() - t0
        print(f"epoch time: {seconds:.1f}s")
        loss_log.append(loss_epoch)
        history["epoch_seconds"].append(seconds)
        history["loss"].append(loss_epoch)
        if not lead:
            history["hit_rates"].append(None)
            distributed.barrier()           # rank 0 validates and saves
            continue
        writer.add_scalar("Loss/train", loss_epoch, epoch)

        output_root_dir = create_fp_dir(ckp=args.ckp, epoch=epoch)
        served.load_state_dict(model.state_dict())
        hit_rates = validate(epoch, query_loader, dummy_loader, val_banks, served, cfg,
                             output_root_dir, every=args.validate_every, device=dev)
        # NaN, not the previous value as the reference pads (train.py:206),
        # where validation did not run, so the log records when it ran
        hit_rate_log.append(hit_rates[0] if hit_rates is not None else np.nan)
        if hit_rates is not None:
            writer.add_scalar("Exact Hit_rate (2 sec)", hit_rates[0][0], epoch)
            if hit_rates.shape[1] > 1:
                writer.add_scalar("Exact Hit_rate (4 sec)", hit_rates[0][1], epoch)
            writer.add_scalar("Near Hit_rate (2 sec)", hit_rates[1][0], epoch)

        payload = train_payload(state, epoch, loss_log, hit_rate_log, hit_rates)
        save_ckp(payload, args.ckp, model_folder, "current")
        if loss_epoch < best_loss:
            best_loss = loss_epoch
            save_ckp(payload, args.ckp, model_folder, "best")
        if hit_rates is not None and float(hit_rates[0][0]) > best_hr:
            best_hr = float(hit_rates[0][0])
            save_ckp(payload, args.ckp, model_folder, epoch)
        history["hit_rates"].append(hit_rates)
        distributed.barrier()

    if lead:
        writer.close()
    if joined:
        torch.distributed.destroy_process_group()
    return history
