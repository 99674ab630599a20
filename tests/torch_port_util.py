"""Shared helpers for the torch-port parity tests (tests/test_torch_port_*).

Inputs and random weights are made with numpy and handed to both the JAX
package and the port, so both compute on identical values.
"""

import numpy as np
import pytest
import torch


def randomize_jax_variables(params, batch_stats, seed: int = 0):
    """Copies of a flax (params, batch_stats) pair with every BatchNorm's
    scale/bias/mean/var and every grouped-conv bias drawn from numpy, so
    that no BN is the identity."""
    rs = np.random.RandomState(seed)

    def walk(tree, path=()):
        out = {}
        for key, val in tree.items():
            p = path + (key,)
            if isinstance(val, dict) or hasattr(val, "items"):
                out[key] = walk(val, p)
                continue
            a = np.asarray(val, np.float32)
            if "BatchNorm_0" in p and key == "scale":
                a = 1.0 + 0.1 * rs.randn(*a.shape)
            elif key == "bias" and ("BatchNorm_0" in p
                                    or "GroupedPointwiseConv_0" in p):
                a = 0.1 * rs.randn(*a.shape)
            elif key == "mean":
                a = 0.2 * rs.randn(*a.shape)
            elif key == "var":
                a = 0.5 + rs.rand(*a.shape)
            out[key] = a.astype(np.float32)
        return out

    return walk(params), walk(batch_stats)


def load_jax_weights(model, params, batch_stats):
    """Load JAX weights into the port model through the weight bridge."""
    from grafp_tpu_torch.convert import state_dict_from_jax

    model.load_state_dict(state_dict_from_jax(params, batch_stats, model))
    return model


def bf16_ulp(ref: np.ndarray) -> np.ndarray:
    """One bf16 unit in the last place at each value of ``ref`` (8
    significant bits)."""
    mag = np.maximum(np.abs(ref.astype(np.float64)), np.finfo(np.float32).tiny)
    return np.exp2(np.floor(np.log2(mag)) - 7)


def to_torch(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(a, np.float32)).to(dtype)


def jax_variables_from_port(model, shapes):
    """A flax (params, batch_stats) pair of numpy arrays holding the port
    ``model``'s values, for the tree whose leaves' ``.shape`` ``shapes``
    gives (e.g. ``jax.eval_shape`` of the JAX model's init, so the JAX
    side needs no init run): the weight bridge run backwards."""
    from grafp_tpu_torch.convert import _port_entry

    state = {k: v.detach().cpu().float().numpy()
             for k, v in model.state_dict().items()}

    def build(tree, path=()):
        out = {}
        for key, val in tree.items():
            p = path + (str(key),)
            if hasattr(val, "items"):
                out[key] = build(val, p)
                continue
            # the bridge permutes elements; invert it on an index array
            idx = np.arange(int(np.prod(val.shape))).reshape(val.shape)
            name, moved = _port_entry(p, idx)
            flat = np.empty(idx.size, np.float32)
            flat[moved.reshape(-1)] = state[name].reshape(-1)
            out[key] = flat.reshape(val.shape)
        return out

    return build(shapes["params"]), build(shapes.get("batch_stats", {}))


# every residual branch's last BatchNorm scale is multiplied by this in
# calibrate()
RESIDUAL_GAIN = 0.1


def calibrate(model, spec, forward=None, last_bn=("fc2_bn",)) -> None:
    """Make seeded random weights behave like trained ones for the row
    checks (here and in chip_smoke.py): the scale of every residual
    branch's last BatchNorm (the modules whose names end with one of
    ``last_bn``) times RESIDUAL_GAIN, then every BatchNorm's running
    statistics set to the biased statistics of its input in one train-mode
    forward (``forward``, else ``model``) over the log-mel ``spec``. The
    port's BatchNorm normalises the last axis, torch's BatchNorm1d/2d (the
    reference replica's) axis 1.

    Without this the fingerprints of unrelated inputs crowd (mean pairwise
    cosine 0.999996), so no cosine floor can tell two rows apart; with the
    statistics alone the twelve residual branches at full gain turn f32
    rounding into different k-NN selections layer after layer (a folded
    and an unfolded f32 model then part to cosine 0.95)."""
    from grafp_tpu_torch.models.layers import BatchNorm

    stats, hooks = {}, []

    def keep(bn, inputs):
        x = inputs[0].to(torch.float32)
        if not isinstance(bn, BatchNorm):
            x = x.movedim(1, -1)
        axes = tuple(range(x.dim() - 1))
        mean = x.mean(axes)
        stats[bn] = (mean, ((x - mean) ** 2).mean(axes))

    with torch.no_grad():
        for name, m in model.named_modules():
            if name.endswith(tuple(last_bn)):
                m.weight.mul_(RESIDUAL_GAIN)
            if isinstance(m, (BatchNorm, torch.nn.modules.batchnorm._BatchNorm)):
                hooks.append(m.register_forward_pre_hook(keep))
        was = model.training
        model.train(True)
        (forward or model)(torch.as_tensor(spec))
        model.train(was)
        for h in hooks:
            h.remove()
        for bn, (mean, var) in stats.items():
            bn.running_mean.copy_(mean)
            bn.running_var.copy_(var)


def calibrate_baseline(model, seed: int = 0) -> None:
    """The counterpart of ``calibrate`` for the baseline encoders (AST,
    NAFP; here and in chip_smoke.py): every LayerNorm's affine drawn as
    ``randomize_jax_variables`` draws a BatchNorm's (scale 1 + 0.1 N(0, 1),
    bias 0.1 N(0, 1)), and the AST's cls token and positions drawn from
    0.5 N(0, 1), all from numpy with ``seed``. The initial weights leave
    cls and positions at zero, and then every clip's cls token starts
    alike."""
    rs = np.random.RandomState(seed)
    with torch.no_grad():
        for name, p in model.named_parameters():
            leaf = name.rsplit(".", 1)[-1]
            if leaf in ("cls_token", "pos_embed"):
                draw = 0.02 * rs.randn(*p.shape)
            elif name.rsplit(".", 2)[-2].startswith(("norm", "ln")):
                draw = (leaf == "weight") + 0.1 * rs.randn(*p.shape)
            else:
                continue
            p.copy_(torch.as_tensor(draw.astype(np.float32)))


def calibrated_jax_variables(model, shapes, spec, seed: int = 0):
    """A flax (params, batch_stats) pair for the JAX tree of ``shapes`` and
    the same weights in the port ``model``: BatchNorm affines and
    grouped-conv biases drawn as ``randomize_jax_variables`` does, then
    ``calibrate``d on ``spec`` in the port and mapped back to the JAX tree
    by ``jax_variables_from_port``."""
    load_jax_weights(model, *randomize_jax_variables(
        *jax_variables_from_port(model, shapes), seed=seed))
    calibrate(model, spec)
    return jax_variables_from_port(model, shapes)


def hold_rows(what: str, got, ref, floor=None, mean_floor=None, device=None):
    """Rows of ``got`` against the same rows of ``ref`` (arrays or tensors,
    (rows, d)), here and in chip_smoke.py: each must lie nearer its own ref
    row than any other ref row (by cosine, in f64 on ``device``, else the
    CPU), so that a shifted, swapped or misordered row fails; where floors
    are given, the cosines to the own rows must exceed them, and ``floor``
    must exceed every cosine between a row and another ref row, else it
    could not tell the rows apart. Prints the cosines; raises
    AssertionError. Returns (least cosine to the own row, largest cosine
    between two different rows)."""
    dev = torch.device(device or "cpu")

    def rows(x):
        x = x if torch.is_tensor(x) else torch.from_numpy(np.array(x, np.float64))
        return torch.nn.functional.normalize(x.to(dev, torch.float64), dim=1)

    g, r = rows(got), rows(ref)

    def require(cond, msg):
        if not cond:
            raise AssertionError(f"{what}: {msg}")

    require(g.shape == r.shape and len(g) > 1,
            f"shapes {tuple(g.shape)} and {tuple(r.shape)}")
    own, other = [], []
    for i in range(0, len(g), 4096):
        c = g[i:i + 4096] @ r.T
        rows = torch.arange(len(c), device=dev)
        own.append(c[rows, rows + i])
        c[rows, rows + i] = -2.0
        other.append(c.max(1).values)
    own, other = torch.cat(own), torch.cat(other)
    least, largest = own.min().item(), other.max().item()
    print(f"{what}: cos to the own row min {least:.8f} mean {own.mean().item():.8f}; "
          f"largest cosine between two different rows {largest:.6f}; least margin "
          f"{(own - other).min().item():.4g} ({len(g)} rows)"
          + (f"; floors {floor} / {mean_floor}" if floor else ""), flush=True)
    require(bool((own > other).all()), "a row lies nearer another row than its own")
    if floor is not None:
        require(floor > largest, f"the floor {floor} cannot tell rows apart")
        require(least > floor, f"a row is below cos {floor}")
    if mean_floor is not None:
        require(own.mean().item() > mean_floor, f"mean cos below {mean_floor}")
    return least, largest


@pytest.fixture(scope="module")
def one_torch_thread():
    """torch on one intra-op thread for a test module. The suite runs
    several test processes at once (pytest-xdist), and each process's
    default thread team, one thread per core, otherwise spin-waits on the
    other processes' cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
