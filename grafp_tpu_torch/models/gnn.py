"""ViG-style dynamic-graph encoder (port of ``grafp_tpu.models.gnn``; eval
and train modes).

Node tensors are channels-last (B, N, C). Every Grapher block rebuilds
the k-NN graph from its current features. The Max-Relative conv at
dilation 1 under ``knn_strategy`` 'auto' or 'pallas' runs it inside one
CUDA kernel (``ops.mrconv_concat.MRConvConcat``: a forward kernel that
emits [x || max_k(x_nbr) - x] and a backward kernel for its gradient), the
grouped MRConv conv absorbing the reference's channel interleave in its
weights. The other blocks take the JAX package's other paths
(``grafp_tpu/models/gnn.py:259-303``), with no kernel: a dilated block or
'exact' the graph of ``ops.knn.knn_graph`` (k * dilation nearest, every
dilation-th kept), gather and max; 'onehot' and 'approx' the strategies of
``ops.mrconv_neighbors``; both feed the pair-layout MRConv (the interleave
[x_0, rel_0, ...] and the block-diagonal grouped conv, with the concat
layout's parameters). EdgeConv, SAGE and GIN (``conv``) consume the
graph's indices. In train mode every BatchNorm uses the batch's
statistics, and the residual branches pass DropPath.

With ``fuse_serving='on'``, or 'auto' on a CUDA tensor, an eval-mode
kernel-path Grapher whose shape the guard admits runs as one fused op
instead (``ops.grapher_block``: fc1, kNN MRConv, grouped conv, fc2, the
three BatchNorms folded in, and the residual).

``quant`` ('dynamic' | 'static' | 'calibrate', serving only) makes every
pointwise and grouped conv of the encoder int8 (``models/layers.py``): the
stem, each Grapher's fc1, graph conv and fc2, each FFN's fc1 and fc2, and
the projection; the Downsamples stay full precision, as in the JAX
package. A quantised Grapher never fuses (``grafp_tpu/models/gnn.py:
221-223``), so on the card it launches the MRConv kernel.

Schedules: the reference never increments its block counter, so every
block runs dilation 1 and drop_path 0 (graph_encoder.py:139-151,
``dilation_schedule='reference'``, ``drop_path_schedule='reference'``);
'ramp' gives the written intent, dilation min(idx // 4 + 1, 128 // k) and
a drop_path rate rising linearly to ``drop_path`` (``dilation_for_block``,
``drop_path_for_block``). ``remat`` recomputes each Grapher and FFN in the
backward (``torch.utils.checkpoint``) instead of keeping its activations.
"""

from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from grafp_tpu_torch.models.layers import (
    BatchNorm,
    DropPath,
    GroupedPointwiseConv,
    PointwiseConv,
    act_layer,
    cast,
    frozen_statistics,
    grouped_as_concat_dense,
    uniform_,
)
from grafp_tpu_torch.ops.grapher_block import GrapherBlock, grapher_block_supported
from grafp_tpu_torch.ops.knn import dilate_neighbors, gather_neighbors, knn_graph
from grafp_tpu_torch.ops.mrconv_concat import MRConvConcat
from grafp_tpu_torch.ops.mrconv_neighbors import max_relative_neighbors

SIZE_PRESETS = {
    # size: (blocks per stage, channels per stage)  graph_encoder.py:96-110
    "t": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "s": ((2, 2, 6, 2), (80, 160, 400, 640)),
    "m": ((2, 2, 16, 2), (96, 192, 384, 768)),
    "l": ((2, 2, 18, 2), (128, 256, 512, 1024)),
}

KNN_STRATEGIES = ("auto", "pallas", "exact", "approx", "onehot")
# the fused op's weights, in GrapherBlock's argument order
_FUSED = ("w1", "c1", "wg", "cg", "w2", "c2")


def _affine(bn: nn.Module, like: torch.Tensor):
    """A BatchNorm's eval map as (s, t); for one that ``models/fold_bn.py``
    has folded away, the identity over ``like``'s channels."""
    if isinstance(bn, BatchNorm):
        return bn.affine()
    return torch.ones_like(like), torch.zeros_like(like)


class MRConv(nn.Module):
    """Max-Relative graph conv: GroupedConv(interleave(x, rel - x)) -> BN ->
    act (torch_vertex.py:11-34). ``layout`` 'concat' takes the kernel's
    (B, N, 2C) [x || rel - x], the interleave absorbed in the dense weight;
    'pair' takes x and rel - x apart, interleaves them and applies the
    block-diagonal grouped conv. Both layouts have the same parameters."""

    def __init__(self, in_features: int, out_features: int, act: str = "relu",
                 groups: int = 4, dtype: Optional[torch.dtype] = None, quant=None,
                 layout: str = "concat"):
        super().__init__()
        self.conv = GroupedPointwiseConv(in_features, out_features, groups,
                                         dtype=dtype, quant=quant,
                                         concat_interleaved=layout == "concat")
        self.bn = BatchNorm(out_features, dtype=dtype)
        self.act = act_layer(act)

    def forward(self, x: torch.Tensor, rel: Optional[torch.Tensor] = None) -> torch.Tensor:
        if rel is not None:
            b, n, c = x.shape
            x = torch.stack([x, rel], dim=-1).reshape(b, n, 2 * c)
        return self.act(self.bn(self.conv(x)))


class EdgeConv(nn.Module):
    """EdgeConv (torch_vertex.py:37-52): the max over the neighbours of
    act(BN(GroupedConv([x_i || x_j - x_i]))), on the plain concat."""

    def __init__(self, in_features: int, out_features: int, act: str = "relu",
                 groups: int = 4, dtype: Optional[torch.dtype] = None, quant=None):
        super().__init__()
        self.conv = GroupedPointwiseConv(2 * in_features, out_features, groups,
                                         dtype=dtype, quant=quant,
                                         concat_interleaved=False)
        self.bn = BatchNorm(out_features, dtype=dtype)
        self.act = act_layer(act)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        nbrs = gather_neighbors(x, idx)                     # (B, N, k, C)
        ctr = x[:, :, None, :]
        feats = torch.cat([ctr.expand_as(nbrs), nbrs - ctr], dim=-1)
        return torch.amax(self.act(self.bn(self.conv(feats))), dim=2)


class SAGEConv(nn.Module):
    """GraphSAGE (torch_vertex.py:55-70): act(BN(GroupedConv([x || max_k
    act(BN(GroupedConv(x_j)))])))."""

    def __init__(self, in_features: int, out_features: int, act: str = "relu",
                 groups: int = 4, dtype: Optional[torch.dtype] = None, quant=None):
        super().__init__()
        c = in_features
        self.nn1 = GroupedPointwiseConv(c, c, groups, dtype=dtype, quant=quant,
                                        concat_interleaved=False)
        self.nn1_bn = BatchNorm(c, dtype=dtype)
        self.nn2 = GroupedPointwiseConv(2 * c, out_features, groups, dtype=dtype,
                                        quant=quant, concat_interleaved=False)
        self.nn2_bn = BatchNorm(out_features, dtype=dtype)
        self.act = act_layer(act)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        h = self.act(self.nn1_bn(self.nn1(x)))
        agg = torch.amax(gather_neighbors(h, idx), dim=2)
        return self.act(self.nn2_bn(self.nn2(torch.cat([x, agg], dim=-1))))


class GINConv(nn.Module):
    """GIN (torch_vertex.py:73-89): act(BN(GroupedConv((1 + eps) x + sum_k
    x_j))), eps an f32 scalar parameter from 0. As in JAX, the f32 eps
    makes the sum f32 before the conv casts it to the compute dtype."""

    def __init__(self, in_features: int, out_features: int, act: str = "relu",
                 groups: int = 4, dtype: Optional[torch.dtype] = None, quant=None):
        super().__init__()
        self.eps = nn.Parameter(torch.zeros(()))
        self.conv = GroupedPointwiseConv(in_features, out_features, groups,
                                         dtype=dtype, quant=quant,
                                         concat_interleaved=False)
        self.bn = BatchNorm(out_features, dtype=dtype)
        self.act = act_layer(act)

    def forward(self, x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        agg = torch.sum(gather_neighbors(x, idx), dim=2)
        y = (1.0 + self.eps) * x.to(torch.float32) + agg.to(torch.float32)
        return self.act(self.bn(self.conv(y)))


_INDEX_CONVS = {"edge": EdgeConv, "sage": SAGEConv, "gin": GINConv}


class Grapher(nn.Module):
    """fc1 -> kNN graph + graph conv (C -> 2C) -> fc2 (2C -> C) -> DropPath
    + residual (torch_vertex.py:142-194).

    The kernel path (``kernel``): ``conv`` 'mr' at dilation 1 under
    ``knn_strategy`` 'auto' or 'pallas'. ``fuse_serving``: 'on' runs an
    eval-mode kernel-path block with relu whose shape
    ``grapher_block_supported`` admits as one fused op on BatchNorm-folded
    weights, folded from the live parameters on every call; 'auto' does so
    on a CUDA tensor and never on the CPU; 'off' never fuses. Training,
    ``quant`` and the other paths never fuse. Both paths share the same
    submodules and state_dict keys. ``knn_block_rows`` tiles the query rows
    of ``knn_graph``.

    Why 'auto' fuses on the card: on an H100 80GB HBM3 at 700 W the
    BatchNorm-folded bf16 forward from log-mel took 7.2-8.0 ms fused
    against 9.0-10.6 ms unfused at B = 128, and 13.6 against 17.5 ms at
    B = 256, each fingerprint nearest its own row of the unfolded f32
    plain path, at cosine >= 0.9988 (``chip_smoke.py``). The JAX package
    resolves 'auto' to off because its fused block lost on a TPU v5e
    (``grafp_tpu/models/gnn.py``). On the CPU 'auto' keeps the unfused
    path, which the parity tests hold against the JAX package."""

    def __init__(self, features: int, k: int = 3, dilation: int = 1,
                 conv: str = "mr", act: str = "relu", drop_path: float = 0.0,
                 knn_block_rows: int = 0, knn_strategy: str = "auto",
                 dtype: Optional[torch.dtype] = None, fuse_serving: str = "auto",
                 quant=None):
        super().__init__()
        if conv != "mr" and conv not in _INDEX_CONVS:
            raise NotImplementedError(f"conv:{conv} is not supported")
        if knn_strategy not in KNN_STRATEGIES:
            raise ValueError(f"knn strategy {knn_strategy!r}: one of {KNN_STRATEGIES}")
        if fuse_serving not in ("auto", "on", "off"):
            raise ValueError(f"fuse_serving must be auto|on|off, got {fuse_serving!r}")
        c = features
        self.k, self.dilation, self.conv = k, dilation, conv
        self.knn_block_rows, self.knn_strategy = knn_block_rows, knn_strategy
        self.dtype = dtype
        self.kernel = conv == "mr" and dilation == 1 and knn_strategy in ("auto", "pallas")
        self.fuse_serving = (fuse_serving if self.kernel and act == "relu" and not quant
                             else "off")
        self.fc1 = PointwiseConv(c, c, dtype=dtype, quant=quant)
        self.fc1_bn = BatchNorm(c, dtype=dtype)
        if conv == "mr":
            self.gconv = MRConv(2 * c, 2 * c, act=act, dtype=dtype, quant=quant,
                                layout="concat" if self.kernel else "pair")
        else:
            self.gconv = _INDEX_CONVS[conv](c, 2 * c, act=act, dtype=dtype, quant=quant)
        self.fc2 = PointwiseConv(2 * c, c, dtype=dtype, quant=quant)
        self.fc2_bn = BatchNorm(c, dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def folded_weights(self, dt: torch.dtype):
        """(w1, c1, wg, cg, w2, c2) of the fused op: each BatchNorm folded
        into the linear before it, weights (in, out) in ``dt``, biases
        (1, out) in f32 (``grafp_tpu/models/gnn.py:241-254``)."""
        c = self.fc1.weight.shape[0]
        s1, t1 = _affine(self.fc1_bn, self.fc1.bias)
        sg, tg = _affine(self.gconv.bn, self.gconv.conv.bias)
        s2, t2 = _affine(self.fc2_bn, self.fc2.bias)
        wgd = grouped_as_concat_dense(self.gconv.conv.weight, 2 * c, 2 * c)
        return ((self.fc1.weight * s1[:, None]).t().to(dt).contiguous(),
                (self.fc1.bias * s1 + t1)[None],
                (wgd * sg).to(dt).contiguous(),
                (self.gconv.conv.bias * sg + tg)[None],
                (self.fc2.weight * s2[:, None]).t().to(dt).contiguous(),
                (self.fc2.bias * s2 + t2)[None])

    def freeze(self) -> None:
        """Keep the fused op's weights, folded in the compute dtype, as
        buffers (moved by ``.to``, not saved), so that a serving copy whose
        parameters no longer change rebuilds nothing per call
        (``models/fold_bn.py``). A Grapher that never fuses keeps none."""
        if self.fuse_serving == "off":
            return
        with torch.no_grad():
            for name, w in zip(_FUSED, self.folded_weights(self.dtype or torch.float32)):
                self.register_buffer(f"frozen_{name}", w.detach().clone(),
                                     persistent=False)

    def fuses(self, x: torch.Tensor) -> bool:
        """Whether this call runs the fused op (``fuse_serving`` resolved
        on x's device)."""
        return (self.fuse_serving == "on"
                or (self.fuse_serving == "auto" and x.is_cuda))

    def neighbors(self, x: torch.Tensor) -> torch.Tensor:
        """The block's graph: the k * dilation nearest of every node, every
        dilation-th kept, (B, N, k) indices."""
        idx = knn_graph(x, self.k * self.dilation, block_rows=self.knn_block_rows)
        return dilate_neighbors(idx, self.dilation)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``mask``: DropPath's keep mask, drawn beforehand (remat), else
        drawn here."""
        dt = self.dtype or x.dtype
        if (self.fuses(x) and not self.training
                and grapher_block_supported(x.shape[1], x.shape[2], dt, self.k)):
            frozen = [self._buffers.get(f"frozen_{n}") for n in _FUSED]
            if frozen[0] is None or frozen[0].dtype != dt:
                frozen = self.folded_weights(dt)
            return GrapherBlock.apply(x.to(dt).contiguous(), self.k, *frozen)
        shortcut = x
        x = self.fc1_bn(self.fc1(x))
        if self.kernel:
            x = self.gconv(MRConvConcat.apply(x.contiguous(), self.k))
        elif self.conv != "mr":
            x = self.gconv(x, self.neighbors(x))
        elif self.dilation > 1 or self.knn_strategy == "exact":
            x = self.gconv(x, torch.amax(gather_neighbors(x, self.neighbors(x)), dim=2) - x)
        else:
            rel = max_relative_neighbors(x, self.k, self.knn_strategy,
                                         compute_dtype=self.dtype or torch.float32)
            x = self.gconv(x, rel - x)
        x = self.fc2_bn(self.fc2(x))
        return self.drop_path(x, mask) + shortcut


class FFN(nn.Module):
    """Pointwise MLP with 4x expansion -> DropPath + residual; bias-free fcs
    (graph_encoder.py:45-67)."""

    def __init__(self, features: int, hidden: int, act: str = "relu",
                 drop_path: float = 0.0, dtype: Optional[torch.dtype] = None,
                 quant=None):
        super().__init__()
        self.fc1 = PointwiseConv(features, hidden, bias=False, dtype=dtype, quant=quant)
        self.fc1_bn = BatchNorm(hidden, dtype=dtype)
        self.act = act_layer(act)
        self.fc2 = PointwiseConv(hidden, features, bias=False, dtype=dtype, quant=quant)
        self.fc2_bn = BatchNorm(features, dtype=dtype)
        self.drop_path = DropPath(drop_path)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = self.act(self.fc1_bn(self.fc1(x)))
        return self.drop_path(self.fc2_bn(self.fc2(y)), mask) + x


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


def dilation_for_block(idx: int, k: int, schedule: str) -> int:
    """Per-block dilation: 'reference' 1 (the shipped behaviour), else
    'ramp', min(idx // 4 + 1, 128 // k) (graph_encoder.py:127-128,147 as
    written; ``grafp_tpu/models/gnn.py:356-362``)."""
    if schedule == "reference":
        return 1
    return min(idx // 4 + 1, max(128 // k, 1))


def drop_path_for_block(idx: int, n_blocks: int, peak: float, schedule: str) -> float:
    """Per-block DropPath rate: 'reference' 0, else 'ramp', peak * idx /
    (n_blocks - 1) (``grafp_tpu/models/gnn.py:365-370``)."""
    if schedule == "reference":
        return 0.0
    if n_blocks <= 1:
        return peak
    return peak * idx / (n_blocks - 1)


class GraphEncoder(nn.Module):
    """(B, N, C_in) node features -> (B, emb_dims) embedding
    (graph_encoder.py:69-191): stem, per-stage Grapher+FFN blocks with a
    Downsample between stages, 1x1 projection, mean over nodes. Block idx
    gets ``dilation_for_block`` and, Grapher and FFN alike,
    ``drop_path_for_block``; ``conv``, ``knn_block_rows``, ``knn_strategy``
    and ``fuse_serving`` go to every Grapher, ``quant`` to every pointwise
    and graph conv. ``remat``, in train mode, recomputes each Grapher and
    FFN in the backward: its DropPath mask is drawn before the block, and
    the recompute leaves the running statistics alone
    (``layers.frozen_statistics``), so a step computes what it computes
    without remat."""

    def __init__(self, in_features: int = 8, size: str = "t", k: int = 3,
                 conv: str = "mr", act: str = "relu", emb_dims: int = 1024,
                 dilation_schedule: str = "reference", drop_path: float = 0.1,
                 drop_path_schedule: str = "reference", knn_block_rows: int = 0,
                 knn_strategy: str = "auto", remat: bool = False,
                 dtype: Optional[torch.dtype] = None, fuse_serving: str = "auto",
                 quant=None):
        super().__init__()
        blocks, channels = SIZE_PRESETS[size]
        n_blocks = sum(blocks)
        self.remat = remat
        self.stem = PointwiseConv(in_features, channels[0], bias=False,
                                  dtype=dtype, quant=quant)
        self.stem_bn = BatchNorm(channels[0], dtype=dtype)
        self.layers = []
        idx = 0
        for i, (nb, ch) in enumerate(zip(blocks, channels)):
            if i > 0:
                self._add(f"down{i}", Downsample(channels[i - 1], ch, dtype=dtype))
            for _ in range(nb):
                dp = drop_path_for_block(idx, n_blocks, drop_path, drop_path_schedule)
                self._add(f"block{idx}_grapher", Grapher(
                    ch, k=k, dilation=dilation_for_block(idx, k, dilation_schedule),
                    conv=conv, act=act, drop_path=dp, knn_block_rows=knn_block_rows,
                    knn_strategy=knn_strategy, dtype=dtype, fuse_serving=fuse_serving,
                    quant=quant))
                self._add(f"block{idx}_ffn", FFN(ch, hidden=ch * 4, act=act, drop_path=dp,
                                                 dtype=dtype, quant=quant))
                idx += 1
        self.proj = PointwiseConv(channels[-1], emb_dims, dtype=dtype, quant=quant)

    def _add(self, name: str, module: nn.Module) -> None:
        self.add_module(name, module)
        self.layers.append(name)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.leaky_relu(self.stem_bn(self.stem(x)), negative_slope=0.2)
        for name in self.layers:
            block = getattr(self, name)
            if self.remat and self.training and isinstance(block, (Grapher, FFN)):
                # the mask is drawn here, outside the recomputed region, and
                # the recompute leaves the running statistics alone
                x = checkpoint(block, x, block.drop_path.mask(x), use_reentrant=False,
                               preserve_rng_state=False,
                               context_fn=lambda: (contextlib.nullcontext(),
                                                   frozen_statistics(block)))
            else:
                x = block(x)
        return torch.mean(self.proj(x), dim=1)
