"""One answer for one input (ROADMAP.md C11, C12, C13).

The JAX package's jitted programs give one answer for one input. On the
card the port's did not in two places: cuDNN's f32 weight gradients of the
PeakEmbed and Downsample convolutions (C11), and the k-means update, whose
``index_add_`` added each cluster's rows with float atomics (C12). On the
CPU both run in a fixed order, so the CPU part here holds the repaired
forms to what they must be:

* ``kmeans.cluster_sums`` (the one-hot product, chunk by chunk) against
  the JAX package's one-hot product over all rows, and ``kmeans`` with
  the JAX function's draws against ``grafp_tpu.retrieval.kmeans`` at
  ``tests/test_torch_port_retrieval.py``'s tolerances (centroids atol
  1e-5, assignments equal), tie groups included, for one space and for
  PQ-like subspaces;
* the train step's scope: cuDNN's ``deterministic`` flag is set while the
  step's forward runs (a forward hook on a Downsample and on the
  PeakEmbed) and while its backward forms their weight gradients (hooks on
  the gradients), and is restored when ``step`` returns;
* NAFP's convs: products when the forward records gradients (C13), cuDNN's
  convs when it does not, one embedding either way;
* ``scripts/torch_port_determinism.py``'s index paths and the train CLI at
  a tiny size (its step paths: tests/test_torch_port_bf16_study.py).

The ``cuda`` part runs the f32 train step and k-means (2^18 rows, k = 400;
and 64 PQ subspaces) twice on the card and requires every tensor equal bit
for bit; it skips without a card. It imports no JAX, so on the card's
machine: ``python -m pytest --noconftest -q -m cuda
tests/test_torch_port_determinism.py``.
"""

import contextlib
import io
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.models import build_model  # noqa: E402
from grafp_tpu_torch.retrieval import kmeans as tkm  # noqa: E402
from grafp_tpu_torch.train import create_train_state, make_train_step  # noqa: E402

TINY = dict(fs=1000, win_len=256, hop_len=128, n_fft=256, n_mels=16, n_frames=8)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tied_data(rs, m: int, d: int, k: int) -> np.ndarray:
    """Clustered rows with a tie group of 21 equal rows and rows that lie
    exactly half way between two others (equal distances to both)."""
    data = (3 * rs.randn(k, d)[rs.randint(0, k, m)] + rs.randn(m, d)).astype(np.float32)
    data[:20] = data[20]
    data[30:40] = 0.5 * (data[40:50] + data[50:60])
    return data


def _jax_draws(key, m: int, k: int, iters: int):
    """The row draws of grafp_tpu.retrieval.kmeans.kmeans (kmeans.py:33-50)."""
    import jax

    init = np.asarray(jax.random.permutation(key, m)[:k])
    reseed = np.stack([np.asarray(jax.random.randint(kk, (k,), 0, m))
                       for kk in jax.random.split(key, iters)])
    return init, reseed


@pytest.mark.parametrize("chunk", [64, 1 << 14])
def test_cluster_sums_match_jax_one_hot_product(monkeypatch, chunk):
    """The sums and counts of the update, in chunks of ``chunk`` rows or
    one chunk, against the JAX package's (M, k) one-hot product
    (grafp_tpu/retrieval/kmeans.py:40-43) on the same centroids."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from grafp_tpu.retrieval import kmeans as jkm

    monkeypatch.setattr(tkm, "ASSIGN_ROWS", chunk)
    rs = np.random.RandomState(5)
    m, d, k = 600, 8, 16
    data = _tied_data(rs, m, d, k)
    cent = data[rs.choice(m, k, replace=False)]
    cent[3] = cent[2]                                  # two equal centroids
    onehot = jax.nn.one_hot(jkm.assign(jnp.asarray(data), jnp.asarray(cent)), k)
    want_sums = np.asarray(jnp.matmul(onehot.T, jnp.asarray(data)))
    want_counts = np.asarray(jnp.sum(onehot, axis=0))
    sums, counts = tkm.cluster_sums(torch.tensor(data)[None], torch.tensor(cent)[None])
    np.testing.assert_array_equal(counts[0].numpy(), want_counts)
    assert want_counts[3] == 0                         # the lower id takes the tie
    np.testing.assert_allclose(sums[0].numpy(), want_sums, rtol=0, atol=1e-4)


@pytest.mark.parametrize("spaces", [1, 4])
def test_kmeans_with_jax_draws_matches_jax_with_ties(spaces):
    """kmeans over ``spaces`` independent spaces (the PQ trainer's form),
    each against the JAX function on its own draws; the data holds tie
    groups. Tolerances of test_torch_port_retrieval.py's k-means test."""
    jax = pytest.importorskip("jax")
    import jax.numpy as jnp

    from grafp_tpu.retrieval import kmeans as jkm

    rs = np.random.RandomState(6)
    m, d, k, iters = 600, 4, 16, 6
    data = np.stack([_tied_data(rs, m, d, k) for _ in range(spaces)])
    keys = jax.random.split(jax.random.key(7), spaces)
    draws = [_jax_draws(kk, m, k, iters) for kk in keys]
    init = torch.tensor(np.stack([a for a, _ in draws]))
    reseed = torch.tensor(np.stack([b for _, b in draws]))
    got_c, got_a = tkm.kmeans(torch.tensor(data), k, iters, init=init, reseed=reseed)
    for s in range(spaces):
        want_c, want_a = jkm.kmeans(keys[s], jnp.asarray(data[s]), k, iters)
        np.testing.assert_allclose(got_c[s].numpy(), np.asarray(want_c), rtol=0, atol=1e-5)
        np.testing.assert_array_equal(got_a[s].numpy(), np.asarray(want_a))


def test_train_step_runs_its_convolutions_under_deterministic_cudnn():
    """cuDNN's deterministic flag, read by forward hooks on the PeakEmbed
    and a Downsample and by hooks on their weights' gradients, is set
    during the step's forward and backward, and is what it was before once
    the step returns."""
    cudnn = torch.backends.cudnn
    cfg = Config(**TINY)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device="cpu",
                        train=True)
    seen = []
    for name, module in (("peak", model.peak), ("down1", model.encoder.down1)):
        module.register_forward_hook(
            lambda *_, name=name: seen.append((f"{name} forward", cudnn.deterministic)))
        module.conv.weight.register_hook(
            lambda g, name=name: seen.append((f"{name} weight grad", cudnn.deterministic)))
    state = create_train_state(model, cfg)
    step = make_train_step(model, cfg, device="cpu")
    x = torch.randn(2, cfg.clip_frames, generator=torch.Generator().manual_seed(1))
    before = cudnn.deterministic
    try:
        for flag in (False, True):
            cudnn.deterministic = flag
            seen.clear()
            step(state, x, x + 0.1, torch.Generator())
            assert sorted(seen) == [("down1 forward", True), ("down1 weight grad", True),
                                    ("peak forward", True), ("peak weight grad", True)]
            assert cudnn.deterministic is flag
    finally:
        cudnn.deterministic = before


def test_nafp_convs_are_products_only_when_gradients_are_taken(monkeypatch):
    """NAFP's forward runs its 16 convs as products (``strided_conv``,
    whose gradients take no cuDNN algorithm, ROADMAP.md C13) when it
    records gradients, and as ``layers.conv2d`` (cuDNN on the card) when it
    does not; the two f32 embeddings agree within 1e-5."""
    from grafp_tpu_torch.models import nafp

    calls = []
    for name in ("strided_conv", "conv2d"):
        monkeypatch.setattr(nafp, name, lambda *a, fn=getattr(nafp, name), name=name:
                            calls.append(name) or fn(*a))
    enc = nafp.NAFPEncoder()
    enc.init_weights(torch.Generator().manual_seed(0))
    x = torch.randn(2, 256, 32, generator=torch.Generator().manual_seed(1))
    z_grad = enc(x)
    assert calls == ["strided_conv"] * 16
    calls.clear()
    with torch.no_grad():
        z = enc(x)
    assert calls == ["conv2d"] * 16
    assert z_grad.requires_grad and z_grad.shape == z.shape == (2, 1024)
    np.testing.assert_allclose(z_grad.detach().numpy(), z.numpy(), rtol=0, atol=1e-5)


def _determinism_script():
    from tests.torch_port_util import load_script

    return load_script("torch_port_determinism")


def test_determinism_probe_index_paths():
    """The script's index paths on 600 seeded rows: every path trains,
    fills and searches twice and reports no differing tensor (on the CPU
    nothing runs out of order)."""
    det = _determinism_script()
    lines = []
    res = det.run(["ivf", "ivfpq", "ivfpq-rr"], "cpu", rows=600, queries=20,
                  report=lines.append)
    assert len(res) == len(lines) == 3
    want = {"ivf": 3, "ivfpq": 5, "ivfpq-rr": 7}       # tensors compared
    for (label, r), line in zip(res.items(), lines):
        kind = label.split()[0]
        assert r["differ"] == {} and r["tensors"] == want[kind], (label, r)
        assert line.startswith(f"{kind} on 600 rows, top 20 of 20 queries: train "), line
        assert f"0 of {want[kind]} tensors differ []" in line, line


def test_determinism_probe_train_cli(tmp_path, monkeypatch):
    """The script's CLI path at the tiny geometry: two runs of the train
    CLI, two epochs of one step on 4 tracks, save byte-equal checkpoints."""
    monkeypatch.setitem(sys.modules, "tensorflow", None)   # TensorBoard without TF
    det = _determinism_script()
    cfg = Config(**TINY)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        r = det.cli_twice(str(tmp_path), cfg, device="cpu", tracks=4, seconds=2.0)
    assert r["files_equal"] and r["differ"] == {} and r["tensors"] > 100, r
    assert cfg == Config(**TINY)                       # the caller's config untouched


@pytest.fixture()
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _bits(t: torch.Tensor) -> torch.Tensor:
    return t.detach().reshape(-1).view(torch.uint8)


@pytest.mark.cuda
def test_f32_train_step_is_bit_equal_run_to_run(card):
    """One f32 size-t step at 64 pairs, twice from one init on one batch:
    every parameter, BatchNorm statistic and Adam moment, the loss and the
    grad norm equal bit for bit (C11: the three conv weights differed)."""
    cfg = Config()
    g = torch.Generator().manual_seed(2)
    x_i = torch.randn(64, cfg.clip_frames, generator=g).to(card)
    x_j = x_i + 0.3 * torch.randn(64, cfg.clip_frames, generator=g).to(card)
    model = build_model(cfg, generator=torch.Generator().manual_seed(0), device=card,
                        train=True)
    init = {k: v.clone() for k, v in model.state_dict().items()}
    runs = []
    for _ in range(2):
        model.load_state_dict(init)
        state = create_train_state(model, cfg)
        m = make_train_step(model, cfg, device=card)(
            state, x_i, x_j, torch.Generator(device=card).manual_seed(3))
        moments = [v for st in state.optimizer.state.values() for v in st.values()
                   if torch.is_tensor(v)]
        runs.append([*model.state_dict().values(), *moments, m["loss"], m["grad_norm"]])
    assert len(runs[0]) == len(runs[1]) > 300
    differ = [i for i, (a, b) in enumerate(zip(*runs)) if not torch.equal(_bits(a), _bits(b))]
    assert differ == []


@pytest.mark.cuda
@pytest.mark.parametrize("spaces,k,d", [(1, 400, 128), (64, 256, 2)])
def test_kmeans_is_bit_equal_run_to_run(card, spaces, k, d):
    """k-means on 2^18 seeded rows twice: centroids and assignments equal
    bit for bit, as the coarse quantizer (k = 400) and as 64 PQ subspaces
    of 256 centroids (C12: index_add_'s atomics changed them)."""
    g = torch.Generator(device=card).manual_seed(4)
    data = torch.randn(spaces, 1 << 18, d, device=card, generator=g)
    runs = [tkm.kmeans(data, k, generator=torch.Generator().manual_seed(5))
            for _ in range(2)]
    assert torch.equal(_bits(runs[0][0]), _bits(runs[1][0]))
    assert torch.equal(runs[0][1], runs[1][1])
