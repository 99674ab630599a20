"""Weight bridge from the JAX package's flax trees to the port.

``state_dict_from_jax`` takes ``params`` and ``batch_stats`` as nested
dicts of numpy arrays, with the keys the JAX package's models and
``train/checkpoint.py`` use, and returns the port model's state_dict, so
that both packages compute the same function. Layout changes:

* ``peak/conv/kernel`` HWIO -> OIHW;
* dense kernels (``.../Dense_0/kernel``, ``projector/fc*/kernel``) (I, O)
  -> (O, I);
* ``down{i}/conv/kernel`` (3, I, O) -> (O, I, 3);
* grouped kernels keep their (g, I/g, O/g) layout: ``gconv/
  GroupedPointwiseConv_0/kernel`` (MRConv, EdgeConv, GIN) and SAGE's
  ``gconv/nn1/kernel`` and ``gconv/nn2/kernel``, told from a Downsample's
  3-D kernel by their owner; GIN's 0-d ``gconv/eps`` keeps its name;
* BatchNorm {scale, bias} + batch_stats {mean, var} -> {weight, bias,
  running_mean, running_var};
* LayerNorm ``scale`` -> ``weight`` (the AST's, (D,)); NAFP's full-shape
  LayerNorm {scale, bias} (H, W, C) -> (C, H, W);
* the AST's ``cls_token`` and ``pos_embed`` keep their names and layout;
* the ``act_scales`` collection of a static int8 model
  (``.../Dense_0/amax``, ``.../GroupedPointwiseConv_0/amax``) -> the
  quantised layers' ``amax`` buffers.
"""

from __future__ import annotations

from typing import Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}
# owners of grouped (g, I/g, O/g) kernels: the auto-named grouped conv of
# MRConv, EdgeConv and GIN, and SAGE's two named ones
_GROUPED = ("GroupedPointwiseConv_0", "nn1", "nn2")


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Dict[Tuple[str, ...], np.ndarray]:
    out = {}
    for key, val in tree.items():
        path = prefix + (str(key),)
        if isinstance(val, Mapping):
            out.update(_flatten(val, path))
        else:
            out[path] = np.asarray(val)
    return out


def _port_entry(path: Tuple[str, ...], arr: np.ndarray) -> Tuple[str, np.ndarray]:
    """(port state_dict key, array in the port's layout) for one leaf."""
    *mods, leaf = path
    if mods and mods[-1] == "BatchNorm_0":
        mods.pop()                    # layers.BatchNorm wraps nn.BatchNorm
        if mods and mods[-1] == "BatchNorm_0":
            mods[-1] = "bn"           # MRConv's auto-named BatchNorm wrapper
        return ".".join(mods + [_BN_LEAVES[leaf]]), arr
    grouped = bool(mods) and mods[-1] in _GROUPED
    if mods and mods[-1] == "Dense_0":
        mods.pop()
    if grouped:
        if mods[-1] == "GroupedPointwiseConv_0":
            mods[-1] = "conv"
    elif leaf in ("scale", "bias") and arr.ndim == 3:     # (H, W, C) -> (C, H, W)
        arr = arr.transpose(2, 0, 1)
    elif leaf == "kernel":
        if arr.ndim == 4:                                  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3:                                # (3, I, O) -> (O, I, 3)
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 2:                                # (I, O) -> (O, I)
            arr = arr.T
    name = {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)
    return ".".join(mods + [name]), arr


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        model: nn.Module,
                        act_scales: Optional[Mapping] = None) -> Dict[str, torch.Tensor]:
    """The port ``model``'s state_dict holding the JAX weights, as f32 CPU
    tensors: the port keeps every parameter and statistic in f32 and casts
    to the compute dtype at use, as flax does, so one tree serves the
    serving and the training model. ``act_scales``, JAX's collection of
    that name, goes onto the quantised layers' ``amax`` buffers; without it
    they are left out (a quantised model loads a plain checkpoint). Raises
    KeyError on a missing or extra key (an ``act_scales`` leaf that maps to
    no ``amax`` buffer included), or on two leaves that map to one key, and
    ValueError on a shape mismatch, against ``model.state_dict()``."""
    leaves = {**_flatten(params), **_flatten(batch_stats)}
    scales = _flatten(act_scales or {})
    out: Dict[str, torch.Tensor] = {}
    for path, arr in list(leaves.items()) + list(scales.items()):
        key, arr = _port_entry(path, arr)
        if key in out:
            raise KeyError(f"state_dict_from_jax: two leaves map to {key}, the "
                           f"second {'/'.join(path)}")
        if path in scales and not key.endswith(".amax"):
            raise KeyError(f"state_dict_from_jax: act_scales leaf {'/'.join(path)} "
                           "is no activation max")
        out[key] = torch.tensor(np.asarray(arr, np.float32))
    want = model.state_dict()
    missing = sorted(k for k in set(want) - set(out) if not k.endswith(".amax"))
    extra = sorted(set(out) - set(want))
    if missing or extra:
        raise KeyError(f"state_dict_from_jax: missing {missing[:8]} "
                       f"({len(missing)}), extra {extra[:8]} ({len(extra)})")
    for key, val in out.items():
        if tuple(val.shape) != tuple(want[key].shape):
            raise ValueError(f"state_dict_from_jax: {key} has shape "
                             f"{tuple(val.shape)}, the model wants "
                             f"{tuple(want[key].shape)}")
    return out
