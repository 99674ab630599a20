"""Driver helpers with the reference's util.py contracts (port of
``grafp_tpu.utils.helpers``)."""

from __future__ import annotations

import os
from typing import Optional

import torch


def query_len_from_seconds(seconds: float, overlap: float, dur: float) -> int:
    """Reference util.py:103-105."""
    hop = dur * (1 - overlap)
    return int((seconds - dur) / hop + 1)


def seconds_from_query_len(query_len: int, overlap: float, dur: float) -> float:
    """Reference util.py:107-109."""
    hop = dur * (1 - overlap)
    return int((query_len - 1) * hop + dur)


def create_fp_dir(resume: Optional[str] = None, ckp=None, epoch=1,
                  train: bool = True, large: bool = False,
                  parent_dir: Optional[str] = None) -> str:
    """Fingerprint output dir layout, reference util.py:133-152
    (logs/store/{valid,medium,large}/model_<ckp>_epoch_<n>), relative to
    the working directory."""
    if train:
        parent_dir = "logs/store/valid"
    else:
        if large:
            parent_dir = "logs/store/large"
        elif parent_dir is None:
            parent_dir = "logs/store/medium"
    os.makedirs(parent_dir, exist_ok=True)
    if resume is not None:
        ckp_name = resume.split("/")[-1].split(".pt")[0]
    else:
        ckp_name = f"model_{ckp}_epoch_{epoch}"
    fp_dir = os.path.join(parent_dir, ckp_name)
    os.makedirs(fp_dir, exist_ok=True)
    return fp_dir


def count_parameters(model: torch.nn.Module, encoder: str = "grafp",
                     write_summary: bool = True) -> int:
    """Parameter table -> stdout + model_summary_<encoder>.txt in the
    working directory (reference util.py:177-191, without prettytable).
    Rows are the model's ``named_parameters()``, sorted by name."""
    rows = sorted((name, p.numel()) for name, p in model.named_parameters())
    total = sum(n for _, n in rows)
    width = max((len(n) for n, _ in rows), default=10)
    lines = [f"{'Modules':{width}s} | Parameters", "-" * (width + 13)]
    lines += [f"{n:{width}s} | {c}" for n, c in rows]
    lines.append(f"Total Trainable Params: {total}")
    table = "\n".join(lines)
    print(table)
    if write_summary:
        with open(f"model_summary_{encoder}.txt", "w") as f:
            f.write(table)
    return total


class TensorBoardWriter:
    """Thin SummaryWriter wrapper; prints scalars to stdout where
    tensorboard is not installed."""

    def __init__(self, logdir: str):
        try:
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            self._w = None
        else:
            self._w = SummaryWriter(logdir)

    def add_scalar(self, tag, value, step):
        if self._w:
            self._w.add_scalar(tag, value, step)
        else:
            print(f"[tb] {tag}@{step} = {value}")

    def add_text(self, tag, text, step):
        if self._w:
            self._w.add_text(tag, text, step)

    def close(self):
        if self._w:
            self._w.close()
