"""AST baseline encoder: a ViT over spectrogram patches (port of
``grafp_tpu.models.ast``; reference encoder/ast_encoder.py:278-415).

(64, 100) log-mel -> (64, 10)-patch conv embedding -> 10 tokens of 640,
a cls token and learned positions -> 8 pre-norm blocks (10 heads, qkv
bias, exact GELU, MLP x4, LayerNorm eps 1e-6) -> final LayerNorm -> head
Linear(640 -> 1024) on the cls token.

Dtype rule, flax's: the residual stream stays f32 (the cls token and the
positions are f32 parameters, and ``x + attn`` promotes); each LayerNorm
normalises in f32; every dense layer and the patch conv cast their input
and weight to the compute dtype and return it, and GELU runs on that
output. Attention takes bf16 q, k, v, forms f32 logits and an f32
softmax, rounds the probabilities to bf16 and returns bf16
(``jax.nn.dot_product_attention``'s XLA path). On the card attention is
``scaled_dot_product_attention``, a library call as in the JAX package;
``dot_product_attention_reference`` is the explicit form that the CPU
runs and the card's checks compare with.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from grafp_tpu_torch.models.layers import PointwiseConv, conv2d, torch_default_init

LN_EPS = 1e-6


def dot_product_attention_reference(q: torch.Tensor, k: torch.Tensor,
                                    v: torch.Tensor) -> torch.Tensor:
    """softmax(q k^T / sqrt(hd)) v over (B, heads, T, hd): the logits and
    the softmax in f32, the probabilities rounded to v's dtype, the
    product accumulated in f32 and returned in v's dtype."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    logits = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    return torch.matmul(probs.float(), v.float()).to(v.dtype)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor,
                          v: torch.Tensor) -> torch.Tensor:
    """Attention over (B, heads, T, hd): the library's fused attention on
    the card, the explicit form on the CPU."""
    if q.is_cuda:
        return F.scaled_dot_product_attention(q, k, v)
    return dot_product_attention_reference(q, k, v)


class ViTBlock(nn.Module):
    """x + proj(attn(LN1(x))), then + fc2(gelu(fc1(LN2(x))))."""

    def __init__(self, dim: int = 640, n_heads: int = 10, mlp_ratio: float = 4.0,
                 dtype: Optional[torch.dtype] = None):
        super().__init__()
        hidden = int(dim * mlp_ratio)
        self.n_heads = n_heads
        self.norm1 = nn.LayerNorm(dim, eps=LN_EPS)
        self.qkv = PointwiseConv(dim, 3 * dim, dtype=dtype)
        self.proj = PointwiseConv(dim, dim, dtype=dtype)
        self.norm2 = nn.LayerNorm(dim, eps=LN_EPS)
        self.mlp_fc1 = PointwiseConv(dim, hidden, dtype=dtype)
        self.mlp_fc2 = PointwiseConv(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, d = x.shape
        h = self.n_heads
        qkv = self.qkv(self.norm1(x)).reshape(b, t, 3, h, d // h).permute(2, 0, 3, 1, 4)
        attn = dot_product_attention(qkv[0], qkv[1], qkv[2])
        x = x + self.proj(attn.transpose(1, 2).reshape(b, t, d))
        y = F.gelu(self.mlp_fc1(self.norm2(x)))
        return x + self.mlp_fc2(y)


class ASTEncoder(nn.Module):
    """(B, 64, 100) spectrogram -> (B, 1024) embedding."""

    def __init__(self, img_size: Tuple[int, int] = (64, 100),
                 patch_size: Tuple[int, int] = (64, 10), embed_dim: int = 640,
                 depth: int = 8, n_heads: int = 10, n_classes: int = 1024,
                 mlp_ratio: float = 4.0, dtype: Optional[torch.dtype] = None):
        super().__init__()
        self.img_size = tuple(img_size)
        self.dtype = dtype
        self.out_features = n_classes
        n_patches = (img_size[0] // patch_size[0]) * (img_size[1] // patch_size[1])
        self.patch = nn.Conv2d(1, embed_dim, tuple(patch_size), stride=tuple(patch_size))
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, 1 + n_patches, embed_dim))
        self.depth = depth
        for i in range(depth):          # block{i}: the flax tree's names
            setattr(self, f"block{i}", ViTBlock(embed_dim, n_heads, mlp_ratio, dtype=dtype))
        self.norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.head = PointwiseConv(embed_dim, n_classes, dtype=dtype)

    def init_weights(self, g: torch.Generator) -> None:
        # the reference's conv default; cls token and positions stay zero
        torch_default_init(self.patch.weight, self.patch.bias,
                           self.patch.weight[0].numel(), g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, hgt, wid = x.shape
        if (hgt, wid) != self.img_size:
            raise ValueError(
                f"Input feature size ({hgt}*{wid}) doesn't match model "
                f"({self.img_size[0]}*{self.img_size[1]}).")
        y = conv2d(x[:, None], self.patch, self.dtype)               # (B, D, 1, P)
        tokens = y.flatten(2).transpose(1, 2).float()                # patch order
        tokens = torch.cat([self.cls_token.expand(b, -1, -1), tokens], dim=1)
        tokens = tokens + self.pos_embed
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        return self.head(self.norm(tokens)[:, 0])
