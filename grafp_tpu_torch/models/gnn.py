"""ViG-style dynamic-graph encoder with Max-Relative graph convolution
(port of ``grafp_tpu.models.gnn``, eval-mode forward).

Node tensors are channels-last (B, N, C). Every Grapher block rebuilds
the k-NN graph from its current features inside one CUDA kernel
(``ops.mrconv_concat``), which emits [x || max_k(x_nbr) - x]; the grouped
MRConv conv absorbs the reference's channel interleave in its weights.

Reference quirk kept: the reference never increments its block counter,
so every block runs dilation 1 and drop_path 0 (graph_encoder.py:139-151,
``dilation_schedule='reference'``). Other graph convs and dilations > 1
belong to a later slice of the port.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.models.layers import (
    BatchNorm,
    GroupedPointwiseConv,
    PointwiseConv,
    act_layer,
    uniform_,
)
from grafp_tpu_torch.ops.mrconv_concat import mrconv_concat

SIZE_PRESETS = {
    # size: (blocks per stage, channels per stage)  graph_encoder.py:96-110
    "t": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "s": ((2, 2, 6, 2), (80, 160, 400, 640)),
    "m": ((2, 2, 16, 2), (96, 192, 384, 768)),
    "l": ((2, 2, 18, 2), (128, 256, 512, 1024)),
}

_LATER = "the port's later graph-conv slice"


class MRConv(nn.Module):
    """Max-Relative graph conv on the concat layout: GroupedConv([x || rel
    - x]) -> BN -> act (torch_vertex.py:11-34)."""

    def __init__(self, in_features: int, out_features: int, act: str = "relu",
                 groups: int = 4, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = GroupedPointwiseConv(in_features, out_features, groups,
                                         dtype=dtype)
        self.bn = BatchNorm(out_features, dtype=dtype)
        self.act = act_layer(act)

    def forward(self, y: torch.Tensor) -> torch.Tensor:
        return self.act(self.bn(self.conv(y)))


class Grapher(nn.Module):
    """fc1 -> kNN + MRConv (C -> 2C) -> fc2 (2C -> C) + residual
    (torch_vertex.py:142-194)."""

    def __init__(self, features: int, k: int = 3, dilation: int = 1,
                 conv: str = "mr", act: str = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if conv != "mr":
            raise NotImplementedError(f"conv {conv!r}: {_LATER}")
        if dilation != 1:
            raise NotImplementedError(f"dilation {dilation}: {_LATER}")
        c = features
        self.k = k
        self.fc1 = PointwiseConv(c, c, dtype=dtype)
        self.fc1_bn = BatchNorm(c, dtype=dtype)
        self.gconv = MRConv(2 * c, 2 * c, act=act, dtype=dtype)
        self.fc2 = PointwiseConv(2 * c, c, dtype=dtype)
        self.fc2_bn = BatchNorm(c, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shortcut = x
        x = self.fc1_bn(self.fc1(x))
        x = self.gconv(mrconv_concat(x.contiguous(), self.k))
        x = self.fc2_bn(self.fc2(x))
        return x + shortcut


class FFN(nn.Module):
    """Pointwise MLP with 4x expansion + residual; bias-free fcs
    (graph_encoder.py:45-67)."""

    def __init__(self, features: int, hidden: int, act: str = "relu",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.fc1 = PointwiseConv(features, hidden, bias=False, dtype=dtype)
        self.fc1_bn = BatchNorm(hidden, dtype=dtype)
        self.act = act_layer(act)
        self.fc2 = PointwiseConv(hidden, features, bias=False, dtype=dtype)
        self.fc2_bn = BatchNorm(features, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.act(self.fc1_bn(self.fc1(x)))
        return self.fc2_bn(self.fc2(y)) + x


class Downsample(nn.Module):
    """Stride-2 length-3 conv along the node axis + BN. The reference's
    3x3 conv on a width-1 map only ever touches its centre column
    (graph_encoder.py:16-28)."""

    def __init__(self, in_features: int, features: int,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.conv = nn.Conv1d(in_features, features, 3, stride=2, padding=1,
                              dtype=dtype or torch.float32)
        self.bn = BatchNorm(features, dtype=dtype)

    def init_weights(self, g: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.conv.in_channels * 3)
        uniform_(self.conv.weight, bound, g)
        uniform_(self.conv.bias, bound, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.conv(x.to(self.conv.weight.dtype).transpose(1, 2))
        return self.bn(y.transpose(1, 2))


class GraphEncoder(nn.Module):
    """(B, N, C_in) node features -> (B, emb_dims) embedding
    (graph_encoder.py:69-191): stem, per-stage Grapher+FFN blocks with a
    Downsample between stages, 1x1 projection, mean over nodes."""

    def __init__(self, in_features: int = 8, size: str = "t", k: int = 3,
                 conv: str = "mr", act: str = "relu", emb_dims: int = 1024,
                 dilation_schedule: str = "reference",
                 drop_path_schedule: str = "reference",
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        if dilation_schedule != "reference" or drop_path_schedule != "reference":
            raise NotImplementedError(
                f"schedules other than 'reference': {_LATER}")
        blocks, channels = SIZE_PRESETS[size]
        self.stem = PointwiseConv(in_features, channels[0], bias=False,
                                  dtype=dtype)
        self.stem_bn = BatchNorm(channels[0], dtype=dtype)
        self.layers = []
        idx = 0
        for i, (nb, ch) in enumerate(zip(blocks, channels)):
            if i > 0:
                self._add(f"down{i}", Downsample(channels[i - 1], ch, dtype=dtype))
            for _ in range(nb):
                self._add(f"block{idx}_grapher",
                          Grapher(ch, k=k, conv=conv, act=act, dtype=dtype))
                self._add(f"block{idx}_ffn",
                          FFN(ch, hidden=ch * 4, act=act, dtype=dtype))
                idx += 1
        self.proj = PointwiseConv(channels[-1], emb_dims, dtype=dtype)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.layers.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.stem_bn(self.stem(x)), negative_slope=0.2)
        for name in self.layers:
            x = getattr(self, name)(x)
        return torch.mean(self.proj(x), dim=1)
