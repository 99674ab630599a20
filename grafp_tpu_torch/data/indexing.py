"""Dataset and augmentation file indexing (port of
``grafp_tpu.data.indexing``), reference-compatible.

Reproduces the reference's util.py:21-88,154-175: recursive glob, seeded
shuffle (numpy seed 42), truncation to train_sz/val_sz, JSON caches of
{str(i): abspath}, 0.8 train/test augmentation splits, and update_index
path rebasing, so the reference's frozen index artifacts
(data/fma_medium.json, *_indices.npy) load unchanged.

One deviation from the JAX package: a cached index JSON whose sampled
paths all are missing is stale (the cache is keyed by the data dir's
basename only). The JAX package re-globs and writes over it; the port
re-indexes in memory, says so, and leaves the file as it was, so a
frozen protocol artifact is never rewritten.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Optional, Sequence, Union

import numpy as np


def load_index(
    cfg,
    data_dir: str,
    ext: Sequence[str] = ("wav", "mp3"),
    shuffle_dataset: bool = True,
    mode: str = "train",
) -> Dict[str, str]:
    if data_dir.endswith(".json"):
        print(f"=>Loading indices from index file {data_dir}")
        with open(data_dir, "r") as fp:
            return json.load(fp)

    print(f"=>Loading indices from {data_dir}")
    if not os.path.exists(data_dir):
        raise FileNotFoundError(f"Directory {data_dir} not found")

    json_path = os.path.join(cfg["data_dir"], data_dir.split("/")[-1] + ".json")
    stale = False
    if os.path.exists(json_path):
        print(f"Loading indices from {json_path}")
        with open(json_path, "r") as fp:
            cached = json.load(fp)
        # the cache is keyed by the dir's BASENAME only: one written for
        # another (since deleted) dir of that name would shadow this
        # corpus, so if none of its first paths exists, index afresh
        sample = list(cached.values())[:8]
        if not sample or any(os.path.exists(p) for p in sample):
            return cached
        stale = True
        print(f"=>Stale index {json_path} (no cached path exists); "
              "re-indexing in memory, the file stays as it is")

    fpaths = glob.glob(os.path.join(data_dir, "**/*.*"), recursive=True)
    fpaths = [p for p in fpaths if p.split(".")[-1] in ext]
    indices = list(range(len(fpaths)))
    if shuffle_dataset:
        np.random.seed(42)
        np.random.shuffle(indices)
    size = cfg["train_sz"] if mode == "train" else cfg["val_sz"]
    dataset = {str(i): fpaths[ix] for i, ix in enumerate(indices[:size])}
    if not stale:
        os.makedirs(os.path.dirname(json_path) or ".", exist_ok=True)
        with open(json_path, "w") as fp:
            json.dump(dataset, fp)
    return dataset


def load_augmentation_index(
    data_dir: str,
    splits: Union[float, Sequence[float]],
    json_path: Optional[str] = None,
    ext: Sequence[str] = ("wav", "mp3"),
    shuffle_dataset: bool = True,
) -> Dict[str, List[str]]:
    dataset = {"train": [], "test": [], "validate": []}
    if json_path is None:
        json_path = os.path.join(data_dir, data_dir.split("/")[-1] + ".json")
    if not os.path.exists(json_path):
        fpaths = glob.glob(os.path.join(data_dir, "**/*.*"), recursive=True)
        fpaths = [p for p in fpaths if p.split(".")[-1] in ext]
        dataset_size = len(fpaths)
        indices = list(range(dataset_size))
        if shuffle_dataset:
            np.random.seed(42)
            np.random.shuffle(indices)
        if isinstance(splits, (list, tuple, np.ndarray)):
            # NB: faithful to the reference's arithmetic (util.py:70-73),
            # including its quirky third-split bounds.
            s = [int(splits[i] * dataset_size) for i in range(len(splits))]
            train_idxs = indices[: s[0]]
            valid_idxs = indices[s[0]: s[0] + s[1]]
            test_idxs = indices[s[1]:]
            dataset["validate"] = [fpaths[ix] for ix in valid_idxs]
        else:
            s = int(splits * dataset_size)
            train_idxs, test_idxs = indices[:s], indices[s:]
        dataset["train"] = [fpaths[ix] for ix in train_idxs]
        dataset["test"] = [fpaths[ix] for ix in test_idxs]
        with open(json_path, "w") as fp:
            json.dump(dataset, fp)
    else:
        with open(json_path, "r") as fp:
            dataset = json.load(fp)
    return dataset


def update_index(data_dir: str, idx_path: str) -> str:
    """Rebase absolute paths in an index JSON onto a new dataset root
    (reference util.py:154-175; used by setup_icassp)."""
    with open(idx_path, "r") as fp:
        index = json.load(fp)
    dir_name = idx_path.split("/")[-1].split(".")[0]
    new_index: Dict[str, Union[str, List[str]]] = {}
    if isinstance(list(index.values())[0], list):
        for key, value in index.items():
            new_index[key] = [
                os.path.join(data_dir, v.split(dir_name)[-1][1:]) for v in value
            ]
    else:
        for key, value in index.items():
            new_index[key] = os.path.join(data_dir, value.split(dir_name)[-1][1:])
    with open(idx_path, "w") as fp:
        json.dump(new_index, fp)
    return idx_path
