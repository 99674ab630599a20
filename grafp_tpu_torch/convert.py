"""Weight bridge from the JAX package's flax trees to the port.

``state_dict_from_jax`` takes ``params`` and ``batch_stats`` as nested
dicts of numpy arrays, with the keys the JAX package's models and
``train/checkpoint.py`` use, and returns the port model's state_dict, so
that both packages compute the same function. Layout changes:

* ``peak/conv/kernel`` HWIO -> OIHW;
* dense kernels (``.../Dense_0/kernel``, ``projector/fc*/kernel``) (I, O)
  -> (O, I);
* ``down{i}/conv/kernel`` (3, I, O) -> (O, I, 3);
* ``gconv/GroupedPointwiseConv_0/kernel`` keeps its (g, I/g, O/g) layout;
* BatchNorm {scale, bias} + batch_stats {mean, var} -> {weight, bias,
  running_mean, running_var}.
"""

from __future__ import annotations

from typing import Dict, Mapping, Tuple

import numpy as np
import torch
import torch.nn as nn

_BN_LEAVES = {"scale": "weight", "bias": "bias", "mean": "running_mean",
              "var": "running_var"}


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
    if mods and mods[-1] == "Dense_0":
        mods.pop()
    if mods and mods[-1] == "GroupedPointwiseConv_0":
        mods[-1] = "conv"
    elif leaf == "kernel":
        if arr.ndim == 4:                                  # HWIO -> OIHW
            arr = arr.transpose(3, 2, 0, 1)
        elif arr.ndim == 3:                                # (3, I, O) -> (O, I, 3)
            arr = arr.transpose(2, 1, 0)
        elif arr.ndim == 2:                                # (I, O) -> (O, I)
            arr = arr.T
    name = {"kernel": "weight"}.get(leaf, leaf)
    return ".".join(mods + [name]), arr


def state_dict_from_jax(params: Mapping, batch_stats: Mapping,
                        model: nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``model``'s state_dict holding the JAX weights (f32 CPU
    tensors; ``load_state_dict`` casts them to each parameter's dtype, as
    flax casts at use). Raises KeyError on a missing or extra key and
    ValueError on a shape mismatch, against ``model.state_dict()``."""
    leaves = {**_flatten(params), **_flatten(batch_stats)}
    out: Dict[str, torch.Tensor] = {}
    for path, arr in leaves.items():
        key, arr = _port_entry(path, arr)
        out[key] = torch.tensor(np.asarray(arr, np.float32))
    want = model.state_dict()
    missing = sorted(set(want) - set(out))
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
