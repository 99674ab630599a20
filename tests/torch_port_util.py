"""Shared helpers for the torch-port parity tests (tests/test_torch_port_*).

Inputs and random weights are made with numpy and handed to both the JAX
package and the port, so both compute on identical values.
"""

import numpy as np
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
