"""Operation and byte counts of the work the algorithms need, from shapes,
and the H100's published peaks. The counts do not depend on how the
program implements the work, so a later change of implementation leaves
them right.

Peaks (NVIDIA's H100 SXM data sheet, dense, at the 700 W limit): 989
TFLOP/s bf16, 67 TFLOP/s float32 outside the tensor cores, 3.35 TB/s of
HBM. ``bound_ms`` and ``block_bound_ms`` are frozen copies of
``chip_smoke.py:392-420`` (the selection kernels #1-#4 and the fused
Grapher block #5); ``grafp_model_flops`` is the account of
``scripts/flops_model.py:36-80`` without its "extract" term (the one-hot
gather rounds of one TPU implementation, not work the model needs) and
without the log-mel frontend, which a DB build shares between
overlapping segments.
"""

from __future__ import annotations

BF16_OPS_S = 989e12
F32_OPS_S = 67e12
HBM_BYTES_S = 3.35e12
PEAK_OPS_S = {"bfloat16": BF16_OPS_S, "float32": F32_OPS_S}
ESIZE = {"bfloat16": 2, "float32": 4}

# size: (blocks per stage, channels per stage), GraFP graph_encoder.py:96-110
SIZES = {
    "t": ((2, 2, 6, 2), (64, 128, 256, 512)),
    "s": ((2, 2, 6, 2), (80, 160, 400, 640)),
    "m": ((2, 2, 16, 2), (96, 192, 384, 768)),
    "l": ((2, 2, 18, 2), (128, 256, 512, 1024)),
}
NAFP_CHANNELS = (128, 128, 256, 256, 512, 512, 1024, 1024)


def grafp_nodes(cfg: dict) -> int:
    """Graph nodes of the first stage: (n_mels / peak_stride) * n_frames."""
    return int(cfg["n_mels"]) // int(cfg["peak_stride"]) * int(cfg["n_frames"])


def grafp_stages(cfg: dict):
    """[(nodes, channels, blocks)] of the encoder's stages."""
    blocks, channels = SIZES[cfg["size"]]
    n = grafp_nodes(cfg)
    out = []
    for i, (nb, c) in enumerate(zip(blocks, channels)):
        out.append((n >> i, c, nb))
    return out


def projector_flops(cfg: dict, h: int) -> int:
    d, u = int(cfg["d"]), int(cfg["u"])
    return 2 * (h * d * u + d * u * d)


def grafp_model_flops(cfg: dict) -> int:
    """Multiply-add operations (2 a MAC) of one fingerprint's forward from
    its log-mel patch: the peak conv, the stem, per Grapher fc1, the k-NN
    score product, the grouped (4) MRConv conv and fc2, per FFN its two
    4x products, the Downsamples, the projection and the projector."""
    k_h, k_w = (int(v) for v in cfg["blur_kernel"])
    n0 = grafp_nodes(cfg)
    f = int(cfg["n_filters"])
    stages = grafp_stages(cfg)
    total = 2 * n0 * f * 3 * k_h * k_w               # peak conv
    total += 2 * n0 * f * stages[0][1]               # stem
    prev_c = None
    for n, c, nb in stages:
        if prev_c is not None:
            total += 2 * n * 3 * prev_c * c          # Downsample
        fc1, scores = 2 * n * c * c, 2 * n * n * c
        gconv, fc2 = 2 * n * (2 * c) * (2 * c) // 4, 2 * n * (2 * c) * c
        grapher = fc1 + scores + gconv + fc2
        total += nb * (grapher + 2 * 2 * n * c * 4 * c)
        prev_c = c
    n_last, c_last, _ = stages[-1]
    total += 2 * n_last * c_last * int(cfg["h"])     # projection
    return total + projector_flops(cfg, int(cfg["h"]))


def nafp_model_flops(cfg: dict) -> int:
    """Operations of one NAFP fingerprint's forward from its (n_mels,
    n_frames) log-mel: every conv's 2 * C_out * H_out * W_out * C_in * 3,
    and the projector (LayerNorm and ReLU are not counted)."""
    h, w, c_in = int(cfg["n_mels"]), int(cfg["n_frames"]), 1
    total = 0
    for c in NAFP_CHANNELS:
        w = (w - 1) // 2 + 1                         # (1, 3) conv, stride (1, 2)
        total += 2 * c * h * w * c_in * 3
        h = (h - 1) // 2 + 1                         # (3, 1) conv, stride (2, 1)
        total += 2 * c * h * w * c * 3
        c_in = c
    return total + projector_flops(cfg, c_in * h * w)


def model_flops(cfg: dict) -> int:
    arch = cfg["arch"]
    if arch == "grafp":
        return grafp_model_flops(cfg)
    if arch == "nafp":
        return nafp_model_flops(cfg)
    raise ValueError(f"no FLOP account for arch {arch!r}")


def bound_ms(b: int, n: int, c: int, dtype: str, backward: bool, k: int) -> float:
    """The least time of one call of a selection kernel (mrconv_concat #3
    forward, #4 backward), ms: the larger of bytes over the HBM rate and
    operations over the peaks. Bytes: forward 3 B N C (x in, [x || rel -
    x] out), backward 4 B N C (x and a 2C-wide gradient in, dx out).
    Operations: the score product at the dtype's peak, a compare and a
    select per score and round on the f32 units, and for the backward the
    scatter's adds, k rows of C per row."""
    esize = ESIZE[dtype]
    t_bytes = (4 if backward else 3) * b * n * c * esize / HBM_BYTES_S
    t_ops = 2 * b * n * n * c / PEAK_OPS_S[dtype] + 2 * k * b * n * n / F32_OPS_S
    if backward:
        t_ops += 2 * k * b * n * c / F32_OPS_S
    return 1e3 * max(t_bytes, t_ops)


def block_bound_ms(b: int, n: int, c: int, dtype: str, k: int) -> float:
    """The least time of one fused Grapher block (#5), ms. Bytes: x in, out
    written, the folded weights (7 C^2 in the dtype, 4 C f32) read once.
    Operations: fc1, the grouped conv (as the dense 2C x 2C), fc2 and the
    score product, 2 B N C (7C + N), at the dtype's peak, plus a compare
    and a select per score and round on the f32 units."""
    esize = ESIZE[dtype]
    t_bytes = (2 * b * n * c * esize + 7 * c * c * esize + 4 * c * 4) / HBM_BYTES_S
    t_ops = 2 * b * n * c * (7 * c + n) / PEAK_OPS_S[dtype] + 2 * k * b * n * n / F32_OPS_S
    return 1e3 * max(t_bytes, t_ops)


def forward_block_bounds_ms(cfg: dict, batch: int) -> float:
    """Sum of ``block_bound_ms`` over the encoder's Graphers for one
    forward of ``batch`` segments."""
    dt = cfg["compute_dtype"]
    return sum(nb * block_bound_ms(batch, n, c, dt, int(cfg["k"]))
               for n, c, nb in grafp_stages(cfg))


def step_select_bounds_ms(cfg: dict, batch: int, backward: bool) -> float:
    """Sum of ``bound_ms`` over the encoder's Graphers for one train-mode
    forward (or its backward) of ``batch`` rows."""
    dt = cfg["compute_dtype"]
    return sum(nb * bound_ms(batch, n, c, dt, backward, int(cfg["k"]))
               for n, c, nb in grafp_stages(cfg))
