"""Checkpoints (port of ``grafp_tpu.train.checkpoint``): the port's own
``.pth`` format, and the import of the reference's ``.pth`` state_dicts.

Native format: one ``torch.save`` file per tag,
``<folder>/model_<name>_<tag>.pth``, the reference's path scheme and
single-file payload (reference util.py:111-122, train.py:212-220): the
model's state_dict (parameters and BatchNorm statistics, f32),
the Adam state_dict, ``TrainState.step`` (which drives the cosine
schedule), ``epoch``, the loss log ``loss``, the hit-rate log
``valid_acc`` and this epoch's ``hit_rate``, plus ``format``, the marker
that tells it from a reference ``.pth``. The JAX package keeps the same
payload in Orbax directories; ``scripts/torch_port_orbax_to_pth.py``
converts one into this format (weights only, ``optimizer`` None).

Reference import (test_fp.py:290-297's contract), for the three archs,
told apart by the keys as the JAX package does: ``encoder.blocks.*`` is an
AST (ast_encoder.py:278-415), ``encoder.conv_layers.*`` a NAFP
(neural_audio_fp.py:12-46), anything else a GraFPrint model. Strip
DataParallel ``module.`` prefixes, drop the dead ``relative_pos`` buffers
(torch_vertex.py:164-172, never read in forward) and
``num_batches_tracked``, map the torch conv/linear layouts onto the JAX
package's flax tree with this module's own numpy copy of its mappings,
then onto the port's state_dict with ``convert.state_dict_from_jax``. The
reference's Downsample 3x3 convs keep only their centre kernel column (on
the width-1 node layout the other columns multiply padding); the grouped
MRConv conv keeps its (g, I/g, O/g) layout; NAFP's LayerNorms go (C, H, W)
-> (H, W, C) in the tree and back in the port. A key the mapping does not
read, a key it misses, or a wrong shape raises.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Mapping, Optional, Tuple

import numpy as np
import torch

from grafp_tpu_torch.convert import state_dict_from_jax

FORMAT = "grafp_tpu_torch/1"


# ---------------------------------------------------------------------------
# the native format
# ---------------------------------------------------------------------------

def _hit_list(hit_rates) -> Optional[list]:
    """A (4, n_sl) hit-rate array as nested floats (None stays None)."""
    return None if hit_rates is None else np.asarray(hit_rates, np.float64).tolist()


def log_fields(epoch: int, loss: Iterable[float], valid_acc: Iterable,
               hit_rate=None) -> Dict[str, Any]:
    """The payload's run record: ``epoch``, the loss log, ``valid_acc``
    with one entry per epoch (its top-1 exact hit rates, or NaN where
    validation did not run) and this epoch's (4, n_sl) ``hit_rate``, as
    plain floats and lists."""
    return {
        "epoch": int(epoch),
        "loss": [float(x) for x in loss],
        "valid_acc": [float(v) if np.ndim(v) == 0 else _hit_list(v) for v in valid_acc],
        "hit_rate": _hit_list(hit_rate),
    }


def train_payload(state, epoch: int, loss: Iterable[float],
                  valid_acc: Iterable, hit_rate=None) -> Dict[str, Any]:
    """The native payload of a ``TrainState`` after ``epoch`` epochs."""
    return {
        "format": FORMAT,
        "state_dict": state.model.state_dict(),
        "optimizer": state.optimizer.state_dict(),
        "step": int(state.step),
        **log_fields(epoch, loss, valid_acc, hit_rate),
    }


def save_ckp(payload: Dict[str, Any], model_name: str, model_folder: str, text) -> str:
    """Write ``payload`` to ``<model_folder>/model_<model_name>_<text>.pth``
    (a temporary file, then a rename, so a reader never sees half a file)
    and return its path."""
    os.makedirs(model_folder, exist_ok=True)
    path = os.path.abspath(os.path.join(model_folder, f"model_{model_name}_{text}.pth"))
    tmp = f"{path}.{os.getpid()}.tmp"
    torch.save({**payload, "format": FORMAT}, tmp)
    os.replace(tmp, path)
    return path


def load_ckp(path: str) -> Dict[str, Any]:
    """A ``.pth`` file's payload, its tensors on the CPU, native or
    reference. It is
    unpickled, as the reference's own loader does, so load only files you
    trust."""
    return torch.load(path, map_location="cpu", weights_only=False)


def is_native(payload) -> bool:
    return isinstance(payload, dict) and payload.get("format") == FORMAT


def restore_train_state(state, payload: Mapping[str, Any]) -> None:
    """Continue a run: the model's parameters and BatchNorm statistics,
    Adam's moments and step counts, and ``state.step``, from a native
    payload, in place."""
    if not is_native(payload):
        raise ValueError("--resume takes a checkpoint of this package's train "
                         "CLI; a reference .pth holds no optimizer state to resume")
    if payload["optimizer"] is None:
        raise ValueError("this checkpoint holds weights only (converted from "
                         "an Orbax directory): it serves, it cannot resume a run")
    state.model.load_state_dict(payload["state_dict"])
    state.optimizer.load_state_dict(payload["optimizer"])
    state.step = int(payload["step"])


# ---------------------------------------------------------------------------
# reference .pth import
# ---------------------------------------------------------------------------

def _strip_module_prefix(sd: Dict[str, Any]) -> Dict[str, Any]:
    if any(k.startswith("module.") for k in sd):
        return {k.replace("module.", "", 1): v for k, v in sd.items()}
    return sd


def _conv2d_to_hwio(w: np.ndarray) -> np.ndarray:
    """torch (O, I, kh, kw) -> flax (kh, kw, I, O)."""
    return np.transpose(w, (2, 3, 1, 0))


def _pointwise_to_dense(w: np.ndarray) -> np.ndarray:
    """torch 1x1 conv (O, I, 1, 1) -> Dense kernel (I, O)."""
    return np.transpose(w[:, :, 0, 0], (1, 0))


def _grouped_pointwise(w: np.ndarray, groups: int) -> np.ndarray:
    """torch grouped 1x1 conv (O, I/g, 1, 1) -> (g, I/g, O/g)."""
    o, ig = w.shape[0], w.shape[1]
    og = o // groups
    return np.transpose(w[:, :, 0, 0].reshape(groups, og, ig), (0, 2, 1))


def _downsample_conv(w: np.ndarray) -> np.ndarray:
    """torch (O, I, 3, 3) -> length-3 flax Conv kernel (3, I, O), keeping
    the centre width column (the only live one on width-1 inputs)."""
    return np.transpose(w[:, :, :, 1], (2, 1, 0))


def _torch_backbone_positions() -> Dict[int, Tuple[str, int]]:
    """torch flat-Sequential position -> ('block', idx) or ('down', stage).
    Stage layout (graph_encoder.py:139-152): blocks [2, 2, 6, 2] with a
    Downsample before stages 1..3."""
    pos = {}
    p = 0
    idx = 0
    for stage, nb in enumerate((2, 2, 6, 2)):
        if stage > 0:
            pos[p] = ("down", stage)
            p += 1
        for _ in range(nb):
            pos[p] = ("block", idx)
            p += 1
            idx += 1
    return pos


def _unflatten(flat: Mapping[Tuple[str, ...], np.ndarray]) -> Dict:
    tree: Dict = {}
    for path, val in flat.items():
        node = tree
        for key in path[:-1]:
            node = node.setdefault(key, {})
        node[path[-1]] = val
    return tree


class _Reads(dict):
    """A state_dict that records the keys read from it."""

    def __init__(self, *a):
        super().__init__(*a)
        self.read = set()

    def __getitem__(self, key):
        self.read.add(key)
        return super().__getitem__(key)


def torch_state_dict_to_tree(sd: Mapping[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """A reference SimCLR(GraphEncoder) state_dict (numpy values) ->
    (params, batch_stats) nested dicts with the JAX package's keys and
    layouts, f32. Raises KeyError on a missing key or on a key the mapping
    does not read."""
    sd = _Reads({k: np.asarray(v) for k, v in _strip_module_prefix(dict(sd)).items()
                 if "relative_pos" not in k and "num_batches_tracked" not in k})

    P: Dict[Tuple[str, ...], np.ndarray] = {}
    S: Dict[Tuple[str, ...], np.ndarray] = {}

    def bn(dst_prefix: Tuple[str, ...], src_prefix: str):
        P[dst_prefix + ("scale",)] = sd[f"{src_prefix}.weight"]
        P[dst_prefix + ("bias",)] = sd[f"{src_prefix}.bias"]
        S[dst_prefix + ("mean",)] = sd[f"{src_prefix}.running_mean"]
        S[dst_prefix + ("var",)] = sd[f"{src_prefix}.running_var"]

    # peak extractor (peak_extractor.py:22-30)
    P[("peak", "conv", "kernel")] = _conv2d_to_hwio(sd["peak_extractor.convs.0.weight"])
    P[("peak", "conv", "bias")] = sd["peak_extractor.convs.0.bias"]

    # stem (graph_encoder.py:131-133)
    P[("encoder", "stem", "Dense_0", "kernel")] = _pointwise_to_dense(
        sd["encoder.stem.0.weight"])
    bn(("encoder", "stem_bn", "BatchNorm_0"), "encoder.stem.1")

    for p, (kind, i) in _torch_backbone_positions().items():
        src = f"encoder.backbone.{p}"
        if kind == "down":
            P[("encoder", f"down{i}", "conv", "kernel")] = _downsample_conv(
                sd[f"{src}.conv.0.weight"])
            P[("encoder", f"down{i}", "conv", "bias")] = sd[f"{src}.conv.0.bias"]
            bn(("encoder", f"down{i}", "bn", "BatchNorm_0"), f"{src}.conv.1")
            continue
        g = ("encoder", f"block{i}_grapher")
        P[g + ("fc1", "Dense_0", "kernel")] = _pointwise_to_dense(sd[f"{src}.0.fc1.0.weight"])
        P[g + ("fc1", "Dense_0", "bias")] = sd[f"{src}.0.fc1.0.bias"]
        bn(g + ("fc1_bn", "BatchNorm_0"), f"{src}.0.fc1.1")
        P[g + ("gconv", "GroupedPointwiseConv_0", "kernel")] = _grouped_pointwise(
            sd[f"{src}.0.graph_conv.gconv.nn.0.weight"], groups=4)
        P[g + ("gconv", "GroupedPointwiseConv_0", "bias")] = sd[
            f"{src}.0.graph_conv.gconv.nn.0.bias"]
        bn(g + ("gconv", "BatchNorm_0", "BatchNorm_0"), f"{src}.0.graph_conv.gconv.nn.1")
        P[g + ("fc2", "Dense_0", "kernel")] = _pointwise_to_dense(sd[f"{src}.0.fc2.0.weight"])
        P[g + ("fc2", "Dense_0", "bias")] = sd[f"{src}.0.fc2.0.bias"]
        bn(g + ("fc2_bn", "BatchNorm_0"), f"{src}.0.fc2.1")

        f = ("encoder", f"block{i}_ffn")
        P[f + ("fc1", "Dense_0", "kernel")] = _pointwise_to_dense(sd[f"{src}.1.fc1.0.weight"])
        bn(f + ("fc1_bn", "BatchNorm_0"), f"{src}.1.fc1.1")
        P[f + ("fc2", "Dense_0", "kernel")] = _pointwise_to_dense(sd[f"{src}.1.fc2.0.weight"])
        bn(f + ("fc2_bn", "BatchNorm_0"), f"{src}.1.fc2.1")

    # head + projector (graph_encoder.py:156, simclr.py:24-27)
    P[("encoder", "proj", "Dense_0", "kernel")] = _pointwise_to_dense(sd["encoder.proj.weight"])
    P[("encoder", "proj", "Dense_0", "bias")] = sd["encoder.proj.bias"]
    _projector(sd, P)
    return _finish(sd, "grafp", P, S)


def _finish(sd: "_Reads", arch: str, P: Dict, S: Dict) -> Tuple[Dict, Dict]:
    """Raise on a key the ``arch`` mapping did not read; else the f32
    (params, batch_stats) trees."""
    unread = sorted(set(sd) - sd.read)
    if unread:
        raise KeyError(f"torch import: {len(unread)} keys the {arch} mapping does "
                       f"not read: {unread[:8]}")
    to_f32 = lambda t: {k: np.asarray(v, np.float32) for k, v in t.items()}  # noqa: E731
    return _unflatten(to_f32(P)), _unflatten(to_f32(S))


def _projector(sd: Mapping, P: Dict) -> None:
    """The SimCLR projector Linear(h, d*u) -> ELU -> Linear(d*u, d)
    (simclr.py:24-27)."""
    for i, name in ((0, "fc1"), (2, "fc2")):
        P[("projector", name, "kernel")] = np.transpose(sd[f"projector.{i}.weight"])
        P[("projector", name, "bias")] = sd[f"projector.{i}.bias"]


def torch_ast_state_dict_to_tree(sd: Mapping[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """A reference SimCLR(ASTEncoder) state_dict -> (params, {}) with the
    JAX package's keys and layouts (its
    ``checkpoint.torch_ast_state_dict_to_tree``)."""
    sd = _Reads({k: np.asarray(v) for k, v in _strip_module_prefix(dict(sd)).items()})
    P: Dict[Tuple[str, ...], np.ndarray] = {}
    e = ("encoder",)
    P[e + ("patch", "kernel")] = _conv2d_to_hwio(sd["encoder.patch_embed.projection.weight"])
    P[e + ("patch", "bias")] = sd["encoder.patch_embed.projection.bias"]
    P[e + ("cls_token",)] = sd["encoder.cls_token"]
    P[e + ("pos_embed",)] = sd["encoder.pos_embed"]
    depth = max(int(k.split(".")[2]) for k in sd if k.startswith("encoder.blocks.")) + 1
    for i in range(depth):
        src, blk = f"encoder.blocks.{i}", e + (f"block{i}",)
        for ln in ("norm1", "norm2"):
            P[blk + (ln, "scale")] = sd[f"{src}.{ln}.weight"]
            P[blk + (ln, "bias")] = sd[f"{src}.{ln}.bias"]
        for lin, dst in (("attn.qkv", "qkv"), ("attn.proj", "proj"),
                         ("mlp.fc1", "mlp_fc1"), ("mlp.fc2", "mlp_fc2")):
            P[blk + (dst, "kernel")] = np.transpose(sd[f"{src}.{lin}.weight"])
            P[blk + (dst, "bias")] = sd[f"{src}.{lin}.bias"]
    P[e + ("norm", "scale")] = sd["encoder.norm.weight"]
    P[e + ("norm", "bias")] = sd["encoder.norm.bias"]
    P[e + ("head", "kernel")] = np.transpose(sd["encoder.head.weight"])
    P[e + ("head", "bias")] = sd["encoder.head.bias"]
    _projector(sd, P)
    return _finish(sd, "ast", P, {})


def torch_nafp_state_dict_to_tree(sd: Mapping[str, np.ndarray]) -> Tuple[Dict, Dict]:
    """A reference SimCLR(NAFPEncoder) state_dict (Sequential indices 6i
    conv a, 6i+1 LayerNorm a, 6i+3 conv b, 6i+4 LayerNorm b) -> (params,
    {}) with the JAX package's keys and layouts (its
    ``checkpoint.torch_nafp_state_dict_to_tree``)."""
    sd = _Reads({k: np.asarray(v) for k, v in _strip_module_prefix(dict(sd)).items()})
    P: Dict[Tuple[str, ...], np.ndarray] = {}
    e, src = ("encoder",), "encoder.conv_layers"
    n_stages = sum(1 for k in sd if k.startswith(src + ".") and k.endswith(".weight")
                   and dict.__getitem__(sd, k).ndim == 4) // 2
    for i in range(n_stages):
        for half, conv, ln in (("a", 6 * i, 6 * i + 1), ("b", 6 * i + 3, 6 * i + 4)):
            P[e + (f"conv{i}{half}", "kernel")] = _conv2d_to_hwio(sd[f"{src}.{conv}.weight"])
            P[e + (f"conv{i}{half}", "bias")] = sd[f"{src}.{conv}.bias"]
            for leaf, name in (("scale", "weight"), ("bias", "bias")):
                # torch (C, H, W) -> the tree's (H, W, C)
                P[e + (f"ln{i}{half}", leaf)] = np.transpose(sd[f"{src}.{ln}.{name}"], (1, 2, 0))
    _projector(sd, P)
    return _finish(sd, "nafp", P, {})


def checkpoint_arch(keys: Iterable[str]) -> str:
    """The arch of a reference state_dict, from its keys (the JAX
    package's ``import_torch_checkpoint``)."""
    keys = _strip_module_prefix(dict.fromkeys(keys))
    if any(k.startswith("encoder.blocks.") for k in keys):
        return "ast"
    if any(k.startswith("encoder.conv_layers.") for k in keys):
        return "nafp"
    return "grafp"


_TO_TREE = {"grafp": torch_state_dict_to_tree, "ast": torch_ast_state_dict_to_tree,
            "nafp": torch_nafp_state_dict_to_tree}


def reference_state_dict(payload) -> Dict[str, np.ndarray]:
    """The model state_dict of a reference ``.pth`` payload (a dict with
    ``state_dict``, or the state_dict itself), as numpy arrays."""
    sd = payload["state_dict"] if "state_dict" in payload else payload
    return {k: v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
            for k, v in sd.items()}


def import_torch_checkpoint(payload, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The port ``model``'s state_dict holding a reference ``.pth``
    payload's weights, arch 'grafp', 'ast' or 'nafp' (told by the keys);
    a checkpoint of another arch than ``model``'s fails the key checks."""
    sd = reference_state_dict(payload)
    params, batch_stats = _TO_TREE[checkpoint_arch(sd)](sd)
    return state_dict_from_jax(params, batch_stats, model)


def model_state_dict(path: str, model: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """The weights of a ``.pth`` checkpoint, native or reference, as the
    port ``model``'s state_dict."""
    payload = load_ckp(path)
    if is_native(payload):
        return payload["state_dict"]
    return import_torch_checkpoint(payload, model)
