"""Serving-time BatchNorm folding (port of ``grafp_tpu.models.fold_bn``).

Every BatchNorm of the graph encoder follows a linear map (a pointwise
conv, the grouped MRConv conv, a Downsample's strided conv), so in eval
mode

    BN(x W + b) = x (W s) + ((b - mu) s + beta),   s = gamma / sqrt(var + eps)

and the BatchNorm pass can go. ``fold_batch_norms`` returns a copy of a
``SimCLRModel`` in which every such pair is one linear map with a bias
and the BatchNorm is gone: the stem, the Downsamples, the FFNs' fc1/fc2,
and the Grapher's fc1, fc2 and graph conv (the grouped conv of MRConv in
either layout, EdgeConv and GIN; a fused Grapher reads the folded weights
through ``Grapher.folded_weights`` as before). The bias-free stem and FFN
linears take the shift as a new bias. SAGE's ``nn1_bn`` and ``nn2_bn``
stay: the JAX fold knows no such site (``grafp_tpu/models/fold_bn.py:
linear_for`` raises on them), and the serving path, which always folds,
must still serve the model.

Under int8 serving (``quant``) the fold commutes with the weight
quantisation: a channel's BatchNorm scale s multiplies its weight column,
so its scale becomes |s| sw and round(w s / (|s| sw)) = sign(s) round(w /
sw); the activation scale is taken over the layer's input, which the fold
does not change. Folded int8 serving is held against unfolded int8 in
``tests/test_torch_port_quant.py``.

The JAX package keeps the fold for export only: XLA already fuses each
eval BatchNorm into the matmul before it (``grafp_tpu/models/fold_bn.py``).
Eager PyTorch runs each BatchNorm as separate f32 elementwise passes, 28
of them per forward of size t, so here the fold is the serving path
(``fp.builder.FingerprintPipeline`` serves through it).

``neutral_batch_stats`` is the counterpart of the JAX function of that
name on a nested dict of numpy statistics: with it, a JAX tree folded by
``grafp_tpu``'s ``fold_batch_norms`` maps through
``convert.state_dict_from_jax`` onto the port's unfolded model, whose
BatchNorms then compute y = x + bias.
"""

from __future__ import annotations

import copy
from typing import Mapping

import numpy as np
import torch
import torch.nn as nn

from grafp_tpu_torch.models.gnn import FFN, Downsample, GraphEncoder, Grapher
from grafp_tpu_torch.models.layers import (
    BN_EPS,
    BatchNorm,
    GroupedPointwiseConv,
    PointwiseConv,
)

# (owner type, linear attribute, BatchNorm attribute) of every eval pair
_PAIRS = ((GraphEncoder, "stem", "stem_bn"), (Downsample, "conv", "bn"),
          (FFN, "fc1", "fc1_bn"), (FFN, "fc2", "fc2_bn"),
          (Grapher, "fc1", "fc1_bn"), (Grapher, "fc2", "fc2_bn"))


def _fold(lin: nn.Module, bn: BatchNorm, out_axis_shape) -> None:
    """Scale ``lin.weight`` by the BatchNorm's s along the output channel
    (viewed as ``out_axis_shape`` broadcast against the weight) and set
    its bias to (b - mu) s + beta; computed in f64, stored in f32, so each
    folded value is rounded once."""
    with torch.no_grad():
        s = bn.weight.double() * torch.rsqrt(bn.running_var.double() + BN_EPS)
        t = bn.bias.double() - bn.running_mean.double() * s
        w = lin.weight
        w.copy_(w.double() * s.reshape(out_axis_shape))
        bias = t if lin.bias is None else lin.bias.double() * s + t
        if lin.bias is None:
            lin.bias = nn.Parameter(bias.float())
        else:
            lin.bias.copy_(bias)


def fold_batch_norms(model: nn.Module) -> nn.Module:
    """A copy of ``model`` (a ``SimCLRModel`` or a ``GraphEncoder``) in eval
    mode with every (linear -> BatchNorm) pair folded into the linear, eps
    1e-5, and the BatchNorm replaced by ``nn.Identity``; the weights each
    forward would rebuild (the fused Grapher's, the grouped conv's dense
    weight, a quantised layer's int8 weight) are frozen in the copy. The
    input model is left as it is. A model already folded comes back
    unchanged."""
    out = copy.deepcopy(model).eval()
    for m in list(out.modules()):
        for owner, lin_name, bn_name in _PAIRS:
            bn = getattr(m, bn_name, None) if isinstance(m, owner) else None
            if not isinstance(bn, BatchNorm):
                continue
            lin = getattr(m, lin_name)
            # PointwiseConv (out, in); nn.Conv1d (out, in, 3)
            _fold(lin, bn, (-1,) + (1,) * (lin.weight.dim() - 1))
            setattr(m, bn_name, nn.Identity())
        gconv = m.gconv if isinstance(m, Grapher) else None
        if isinstance(getattr(gconv, "bn", None), BatchNorm):
            # grouped (g, cig, cog): the BN channel is the flattened (g, cog)
            g, _, cog = gconv.conv.weight.shape
            _fold(gconv.conv, gconv.bn, (g, 1, cog))
            gconv.bn = nn.Identity()
    for m in out.modules():
        if isinstance(m, (Grapher, GroupedPointwiseConv, PointwiseConv)):
            m.freeze()
    return out


def neutral_batch_stats(batch_stats: Mapping) -> dict:
    """mean 0 and var 1 - eps for every statistic of a nested dict of
    arrays, so that a BatchNorm computes x * scale + bias on folded
    parameters (``grafp_tpu/models/fold_bn.py:neutral_batch_stats``)."""
    out = {}
    for key, val in batch_stats.items():
        if isinstance(val, Mapping):
            out[key] = neutral_batch_stats(val)
        elif key == "mean":
            out[key] = np.zeros_like(np.asarray(val))
        else:
            out[key] = np.full_like(np.asarray(val), 1.0 - BN_EPS)
    return out
