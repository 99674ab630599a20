"""ViG-style dynamic-graph encoder with Max-Relative graph convolution
(port of ``grafp_tpu.models.gnn``; eval and train modes).

Node tensors are channels-last (B, N, C). Every Grapher block rebuilds
the k-NN graph from its current features inside one CUDA kernel
(``ops.mrconv_concat.MRConvConcat``: a forward kernel that emits [x ||
max_k(x_nbr) - x] and a backward kernel for its gradient); the grouped
MRConv conv absorbs the reference's channel interleave in its weights.
In train mode every BatchNorm uses the batch's statistics.

With ``fuse_serving='on'`` an eval-mode Grapher whose shape the guard
admits runs as one fused op instead (``ops.grapher_block``: fc1, kNN
MRConv, grouped conv, fc2, the three BatchNorms folded in, and the
residual); 'auto' means off, as in the JAX package.

Reference quirk kept: the reference never increments its block counter,
so every block runs dilation 1 and drop_path 0 (graph_encoder.py:139-151,
``dilation_schedule='reference'``, ``drop_path_schedule='reference'``).
Other graph convs, dilations > 1 and DropPath belong to a later slice of
the port.
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
    cast,
    grouped_as_concat_dense,
    uniform_,
)
from grafp_tpu_torch.ops.grapher_block import GrapherBlock, grapher_block_supported
from grafp_tpu_torch.ops.mrconv_concat import MRConvConcat

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
    (torch_vertex.py:142-194).

    ``fuse_serving``: 'on' runs an eval-mode block with relu whose shape
    ``grapher_block_supported`` admits as one fused op on BatchNorm-folded
    weights, folded from the live parameters on every call; 'auto' and
    'off' never fuse ('auto' resolves to off, as in the JAX package).
    Training never fuses. Both paths share the same submodules and
    state_dict keys."""

    def __init__(self, features: int, k: int = 3, dilation: int = 1,
                 conv: str = "mr", act: str = "relu",
                 dtype: Optional[torch.dtype] = None, fuse_serving: str = "auto"):
        super().__init__()
        if conv != "mr":
            raise NotImplementedError(f"conv {conv!r}: {_LATER}")
        if dilation != 1:
            raise NotImplementedError(f"dilation {dilation}: {_LATER}")
        if fuse_serving not in ("auto", "on", "off"):
            raise ValueError(f"fuse_serving must be auto|on|off, got {fuse_serving!r}")
        c = features
        self.k = k
        self.dtype = dtype
        self.fuse = fuse_serving == "on" and act == "relu"
        self.fc1 = PointwiseConv(c, c, dtype=dtype)
        self.fc1_bn = BatchNorm(c, dtype=dtype)
        self.gconv = MRConv(2 * c, 2 * c, act=act, dtype=dtype)
        self.fc2 = PointwiseConv(2 * c, c, dtype=dtype)
        self.fc2_bn = BatchNorm(c, dtype=dtype)

    def folded_weights(self, dt: torch.dtype):
        """(w1, c1, wg, cg, w2, c2) of the fused op: each BatchNorm folded
        into the linear before it, weights (in, out) in ``dt``, biases
        (1, out) in f32 (``grafp_tpu/models/gnn.py:241-254``)."""
        c = self.fc1.weight.shape[0]
        s1, t1 = self.fc1_bn.affine()
        sg, tg = self.gconv.bn.affine()
        s2, t2 = self.fc2_bn.affine()
        wgd = grouped_as_concat_dense(self.gconv.conv.weight, 2 * c, 2 * c)
        return ((self.fc1.weight * s1[:, None]).t().to(dt).contiguous(),
                (self.fc1.bias * s1 + t1)[None],
                (wgd * sg).to(dt).contiguous(),
                (self.gconv.conv.bias * sg + tg)[None],
                (self.fc2.weight * s2[:, None]).t().to(dt).contiguous(),
                (self.fc2.bias * s2 + t2)[None])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.dtype or x.dtype
        if (self.fuse and not self.training
                and grapher_block_supported(x.shape[1], x.shape[2], dt, self.k)):
            return GrapherBlock.apply(x.to(dt).contiguous(), self.k,
                                      *self.folded_weights(dt))
        shortcut = x
        x = self.fc1_bn(self.fc1(x))
        x = self.gconv(MRConvConcat.apply(x.contiguous(), self.k))
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
        self.dtype = dtype
        # f32 master weights, cast to the compute dtype at use
        self.conv = nn.Conv1d(in_features, features, 3, stride=2, padding=1)
        self.bn = BatchNorm(features, dtype=dtype)

    def init_weights(self, g: torch.Generator) -> None:
        bound = 1.0 / math.sqrt(self.conv.in_channels * 3)
        uniform_(self.conv.weight, bound, g)
        uniform_(self.conv.bias, bound, g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        conv = self.conv
        y = F.conv1d(cast(x, self.dtype).transpose(1, 2),
                     cast(conv.weight, self.dtype), cast(conv.bias, self.dtype),
                     stride=conv.stride, padding=conv.padding)
        return self.bn(y.transpose(1, 2))


class GraphEncoder(nn.Module):
    """(B, N, C_in) node features -> (B, emb_dims) embedding
    (graph_encoder.py:69-191): stem, per-stage Grapher+FFN blocks with a
    Downsample between stages, 1x1 projection, mean over nodes.
    ``fuse_serving`` goes to every Grapher."""

    def __init__(self, in_features: int = 8, size: str = "t", k: int = 3,
                 conv: str = "mr", act: str = "relu", emb_dims: int = 1024,
                 dilation_schedule: str = "reference",
                 drop_path_schedule: str = "reference",
                 dtype: Optional[torch.dtype] = None, fuse_serving: str = "auto"):
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
                          Grapher(ch, k=k, conv=conv, act=act, dtype=dtype,
                                  fuse_serving=fuse_serving))
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
