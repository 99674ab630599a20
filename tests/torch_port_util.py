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


# Shapes past the one-pass selection kernels' old limit (k <= 8 and
# k * N <= 8192) that the card's split selection takes: k = 8 at the old
# edge, 9 and 16 in round groups, 3,200 nodes (the ast frontend's stage 1)
# in key windows, and k = N.
WIDE_SHAPES = [((1, 1024, 8), 8), ((1, 1024, 8), 9), ((1, 1024, 8), 16),
               ((1, 3200, 4), 3), ((1, 12, 4), 12)]
WIDE_IDS = [f"N{s[1]}-k{k}" for s, k in WIDE_SHAPES]
WIDE_KINDS = ["random", "duplicates", "scaled", "straddle"]


def wide_input(shape, k: int, kind: str, rng) -> np.ndarray:
    """x (B, N, C) of ``kind``: random; duplicates (the first N/8 rows, at
    least 2, identical: a tie group larger than k at N = 1024); scaled
    (x[1::4] = 2 x[0::4], exact ties between distinct rows); straddle
    (groups of s power-of-two scaled copies, s the smallest size that does
    not divide k, so a tie group crosses the k budget); identical (every row
    the first: one tie group of N)."""
    x = rng.randn(*shape).astype(np.float32)
    n = shape[1]
    if kind == "duplicates":
        x[:, : max(n // 8, 2)] = x[:, :1]
    elif kind == "scaled":
        x[:, 1::4] = 2.0 * x[:, 0::4]
    elif kind == "straddle":
        s = straddle_size(k)
        for t in range(1, s):
            x[:, t::s] = 2.0 ** t * x[:, 0::s][:, : x[:, t::s].shape[1]]
    elif kind == "identical":
        x[:] = x[:, :1]
    return x


def straddle_size(k: int) -> int:
    """wide_input's 'straddle' group size: the smallest s >= 2 that does
    not divide k."""
    return next(s for s in range(2, k + 2) if k % s)


def wide_f32_tol(x: np.ndarray, k: int, kind: str) -> np.ndarray:
    """The f32 tolerance (B, N, C) of a neighbour mean on wide_input's
    ``x``: 1e-6, plus the rounding of a tie group's mean, which each side
    sums in another order, up to about half an ulp a term, where the
    groups outgrow it: for 'duplicates', only on the rows whose k selected
    neighbours take in its group (the first max(N/8, 2) rows, identical),
    2^-24 (N/8) |x_0|; for 'straddle', whose every row lies in a group of s
    power-of-two scaled copies (up to 2^(s-1) |x|), 2^-24 s max|x|."""
    tol = np.full(x.shape, 1e-6)
    if kind == "straddle":
        return tol + 2.0 ** -24 * straddle_size(k) * np.abs(x).max(1, keepdims=True)
    if kind != "duplicates":
        return tol
    xn = x.astype(np.float64)
    xn /= np.linalg.norm(xn, axis=-1, keepdims=True)
    scores = np.einsum("bnc,bmc->bnm", xn, xn)
    takes = (scores > scores[..., :1]).sum(-1) < k        # (B, N)
    group = max(x.shape[1] // 8, 2)
    return tol + 2.0 ** -24 * group * np.abs(x[:, :1]) * takes[..., None]


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


# an 'ivfpq' search scans its bf16 decode cache in f32: its distances lie
# within this of the float64 ones (the f32 rounding bound of |q|^2 +
# |r|^2 - 2 q.r for unit 128-d rows is 3e-5)
IVFPQ_EPS = 1e-4
F32_U = 2.0 ** -24


def _assigned(x: np.ndarray, c: np.ndarray):
    """Nearest of the centroids c (S, m, d) for the rows x (S, n, d) of S
    spaces, by the index's x.c - |c|^2 / 2, in float64: (ids, sure), each
    (S, n), sure where the best beats the runner-up by more than twice a
    bound of the f32 rounding of a score, (d + 2) u (|x| |c| + |c|^2 / 2)
    at the largest |c|."""
    half = 0.5 * (c * c).sum(-1)                            # (S, m)
    ct = np.swapaxes(c, 1, 2)
    bound = (c.shape[-1] + 2) * F32_U * (
        np.sqrt((x * x).sum(-1)) * np.sqrt(2 * half.max(1))[:, None]
        + half.max(1)[:, None])                             # (S, n)
    ids, gap = [], []
    for s in range(0, x.shape[1], 1024):
        score = x[:, s:s + 1024] @ ct - half[:, None, :]    # (S, n, m)
        best = score.argmax(-1)
        top = np.take_along_axis(score, best[..., None], -1)[..., 0]
        np.put_along_axis(score, best[..., None], -np.inf, -1)
        ids.append(best)
        gap.append(top - score.max(-1))
    return np.concatenate(ids, axis=1), np.concatenate(gap, axis=1) > 2 * bound


def ivfpq_candidate_faults(q, dist, cand, exact, rows_of, centroids, codebooks,
                           nprobe: int, eps: float = IVFPQ_EPS):
    """An 'ivfpq' search held to a float64 recomputation from the raw rows
    and the index's centroids and codebooks alone, here and in
    chip_smoke.py: q (n, d) queries, dist and cand (n, k) the search's
    squared distances and ids (-1 for none), exact (n,) each query's
    exact top-1 row, rows_of(ids) the raw rows. Each row's cell (nearest
    centroid) and PQ code (nearest codeword per subspace) are recomputed,
    as are each query's nprobe probed cells (the best q.c - |c|^2 / 2) and
    the squared distance from q to the row's decode rounded to bf16, as
    the index's cache holds it. Where no assignment or probe could fall
    the other way in f32, counts the faults:
    - 'unprobed': a candidate in a cell that its query does not probe;
    - 'distance': a candidate's distance off the recomputed one by more
      than ``eps``;
    - 'missed': the exact top-1 in a probed cell, nearer than every
      candidate by more than ``eps``, and not among them.
    Returns ({fault: count}, the number of queries whose exact top-1 was
    held to the last rule)."""
    q = np.asarray(q, np.float64)
    c = np.asarray(centroids, np.float64)
    cb = np.asarray(codebooks, np.float64)                  # (S, ksub, dsub)
    n, k = cand.shape
    n_sub, nlist = cb.shape[0], c.shape[0]
    half = 0.5 * (c * c).sum(1)
    probe = q @ c.T - half                                  # (n, nlist)
    probe_bound = (c.shape[1] + 2) * F32_U * (np.abs(q) @ np.abs(c).T + half)
    ranked = -np.sort(-probe, axis=1)
    last_in = ranked[:, min(nprobe, nlist) - 1]
    first_out = ranked[:, nprobe] if nprobe < nlist else np.full(n, -np.inf)
    slack = 2 * probe_bound.max(1)

    ids = np.concatenate([cand.reshape(-1), exact])
    owner = np.concatenate([np.repeat(np.arange(n), k), np.arange(n)])
    valid = ids >= 0
    x = np.asarray(rows_of(np.maximum(ids, 0)), np.float64)
    cell, cell_sure = (a[0] for a in _assigned(x[None], c[None]))
    code, code_sure = _assigned(x.reshape(len(x), n_sub, -1).transpose(1, 0, 2), cb)
    dec = cb[np.arange(n_sub)[:, None], code].transpose(1, 0, 2).reshape(len(x), -1)
    dec = torch.from_numpy(dec.astype(np.float32)).bfloat16().double().numpy()
    d64 = ((q[owner] - dec) ** 2).sum(1)
    sure = valid & cell_sure & code_sure.all(0)
    score = probe[owner, cell]
    probed = score > first_out[owner] + slack[owner]
    unprobed = score < last_in[owner] - slack[owner]

    nc = n * k
    c_sure, c_valid = sure[:nc].reshape(n, k), valid[:nc].reshape(n, k)
    faults = {"unprobed": int((sure & unprobed)[:nc].sum()),
              "distance": int((sure[:nc] & (np.abs(d64[:nc] - dist.reshape(-1)) > eps))
                              .sum())}
    far = np.where(c_valid, d64[:nc].reshape(n, k), -np.inf).max(1)
    far = np.where(c_valid.all(1), far, np.inf)           # fewer than k: any row
    held = (sure[nc:] & probed[nc:] & (c_sure | ~c_valid).all(1)
            & (d64[nc:] < far - eps))
    faults["missed"] = int((held & ~(cand == exact[:, None]).any(1)).sum())
    return faults, int(held.sum())


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
