"""The port's host data path (grafp_tpu_torch/data/*, grafp_tpu_torch/native/*)
against the JAX package's, on the CPU, on wav files synthesised in a temp
dir.

Tolerances: none. Decoded samples, resampled signals, index dicts, pair
batches, tracks and augment banks are equal bit for bit (the same numpy
arithmetic on the same bytes; the port's wav reader equals both of the JAX
package's, its C++ reader and its Python one, whose conversions are exact
or round once, as numpy's)."""

import json
import os
import struct
import wave

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from grafp_tpu.core.config import Config as JConfig  # noqa: E402
from grafp_tpu.data import audio_io as jio  # noqa: E402
from grafp_tpu.data import dataset as jds  # noqa: E402
from grafp_tpu.data import indexing as jidx  # noqa: E402
from grafp_tpu.data.resample import resample_sinc as j_resample  # noqa: E402
from grafp_tpu_torch.core import Config  # noqa: E402
from grafp_tpu_torch.data import audio_io as tio  # noqa: E402
from grafp_tpu_torch.data import dataset as tds  # noqa: E402
from grafp_tpu_torch.data import indexing as tidx  # noqa: E402
from grafp_tpu_torch.data.resample import resample_sinc as t_resample  # noqa: E402
from grafp_tpu_torch.native import mp3_native  # noqa: E402
from tests.fixtures import make_wav_dir  # noqa: E402
from tests.torch_port_util import one_torch_thread  # noqa: E402,F401

pytestmark = pytest.mark.usefixtures("one_torch_thread")

FS = 8000


def _riff(path, body: bytes, fmt_code: int, bits: int, n_ch: int, sr: int = FS):
    fmt = struct.pack("<HHIIHH", fmt_code, n_ch, sr, sr * n_ch * bits // 8,
                      n_ch * bits // 8, bits)
    with open(path, "wb") as f:
        f.write(b"RIFF" + struct.pack("<I", 4 + 8 + len(fmt) + 8 + len(body)) + b"WAVE")
        f.write(b"fmt " + struct.pack("<I", len(fmt)) + fmt)
        f.write(b"data" + struct.pack("<I", len(body)) + body)


def _write(kind: str, path: str) -> None:
    x = np.clip(np.random.RandomState(0).randn(3001, 2) * 0.3, -0.99, 0.99)
    if kind == "pcm16":
        jio.save_wav(path, x[:, 0], FS)
    elif kind == "stereo16":
        jio.save_wav(path, x, FS)
    elif kind == "pcm24":
        vals = np.clip(x[:, 0] * (1 << 23), -(1 << 23), (1 << 23) - 1).astype("<i4")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(3)
            w.setframerate(FS)
            w.writeframes(b"".join(v.tobytes()[:3] for v in vals))
    elif kind == "pcm32":
        _riff(path, (x[:, 0] * (1 << 31)).astype("<i4").tobytes(), 1, 32, 1)
    elif kind == "float32":
        _riff(path, x[:, 0].astype("<f4").tobytes(), 3, 32, 1)
    elif kind == "float64_stereo":
        _riff(path, x.astype("<f8").tobytes(), 3, 64, 2)
    elif kind == "pcm8":
        _riff(path, np.round(x[:, 0] * 127 + 128).astype(np.uint8).tobytes(), 1, 8, 1)


KINDS = ["pcm16", "stereo16", "pcm24", "pcm32", "float32", "float64_stereo", "pcm8"]


@pytest.mark.parametrize("native", [True, False], ids=["native", "python"])
@pytest.mark.parametrize("kind", KINDS)
def test_load_audio_equals_jax(tmp_path, kind, native):
    """The port's one wav reader against the JAX package's C++ reader
    (native) and its Python reader."""
    path = str(tmp_path / f"{kind}.wav")
    _write(kind, path)
    for mono in (True, False):
        want, wsr = jio.load_audio(path, mono=mono, native=native)
        got, sr = tio.load_audio(path, mono=mono)
        assert sr == wsr == FS and got.dtype == np.float32
        assert got.tobytes() == want.tobytes(), (kind, native, mono)


def test_load_audio_refuses_a_file_that_is_not_audio(tmp_path):
    (tmp_path / "junk.wav").write_bytes(b"not audio" * 8)
    with pytest.raises(tio.AudioDecodeError):
        tio.load_audio(str(tmp_path / "junk.wav"))


def test_mp3_decodes_as_jax(tmp_path):
    """mp3 through the libmpg123 binding, equal to the JAX package's
    decode (the fixture is encoded with the port's LAME binding, which
    writes the JAX package's bytes: tests/test_torch_port_rehearsals.py)."""
    if not (mp3_native.decoder_available() and mp3_native.encoder_available()):
        pytest.skip("libmpg123/libmp3lame not present on this host")
    t = np.arange(2 * FS) / FS
    x = 0.3 * np.stack([np.sin(2 * np.pi * 440 * t), np.sin(2 * np.pi * 660 * t)], 1)
    path = str(tmp_path / "a.mp3")
    mp3_native.write(path, x.astype(np.float32), FS)
    want, wsr = jio.load_audio(path)
    got, sr = tio.load_audio(path)
    assert sr == wsr and got.tobytes() == want.tobytes()


@pytest.mark.parametrize("rates", [(44100, 16000), (8000, 16000), (22050, 8000),
                                   (16000, 16000)])
def test_resample_sinc_equals_jax(rates):
    x = np.random.RandomState(1).randn(12345).astype(np.float32)
    got, want = t_resample(x, *rates), j_resample(x, *rates)
    assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


@pytest.fixture(scope="module")
def audio_dir(tmp_path_factory):
    p = tmp_path_factory.mktemp("tracks")
    make_wav_dir(str(p), n=6, dur_s=3.0, sr=FS)
    make_wav_dir(str(p / "sub"), n=3, dur_s=2.0, sr=FS, seed=3)
    return p


def _cfgs(data_dir, **kw):
    kw = {"fs": FS, "train_sz": 6, "val_sz": 5, **kw}
    return (JConfig(data_dir=str(data_dir / "jax"), **kw),
            Config(data_dir=str(data_dir / "port"), **kw))


def test_indices_equal_jax(audio_dir, tmp_path):
    jc, tc = _cfgs(tmp_path)
    for mode in ("train", "valid"):
        want = jidx.load_index(jc, str(audio_dir), mode=mode)
        assert tidx.load_index(tc, str(audio_dir), mode=mode) == want
        # the second call reads the cache each one wrote
        assert tidx.load_index(tc, str(audio_dir), mode=mode) == want
        os.remove(os.path.join(tc.data_dir, f"{audio_dir.name}.json"))
        os.remove(os.path.join(jc.data_dir, f"{audio_dir.name}.json"))
    aug = {}
    for name, mod in (("jax", jidx), ("port", tidx)):
        aug[name] = [mod.load_augmentation_index(str(audio_dir), splits=s,
                                                 json_path=str(tmp_path / f"{name}{i}.json"))
                     for i, s in enumerate((0.8, [0.5, 0.3]))]
    assert aug["port"] == aug["jax"]
    for name, mod in (("jax", jidx), ("port", tidx)):
        idx = tmp_path / f"{name}_rebase" / "tracks.json"
        idx.parent.mkdir()
        idx.write_text(json.dumps({"0": "/old/root/tracks/a/b.wav"}))
        mod.update_index("/new/root", str(idx))
    assert ((tmp_path / "jax_rebase" / "tracks.json").read_text()
            == (tmp_path / "port_rebase" / "tracks.json").read_text())


def test_stale_index_cache_stays_untouched(audio_dir, tmp_path):
    """A cached index whose paths are gone is re-indexed in memory and the
    file keeps its bytes (the JAX package writes over it)."""
    jc, tc = _cfgs(tmp_path)
    stale = json.dumps({str(i): f"/gone/track_{i}.wav" for i in range(6)}).encode()
    for c in (jc, tc):
        os.makedirs(c.data_dir)
        with open(os.path.join(c.data_dir, f"{audio_dir.name}.json"), "wb") as f:
            f.write(stale)
    want = jidx.load_index(jc, str(audio_dir))
    got = tidx.load_index(tc, str(audio_dir))
    assert got == want and all(os.path.exists(p) for p in got.values())
    assert open(os.path.join(tc.data_dir, f"{audio_dir.name}.json"), "rb").read() == stale
    assert open(os.path.join(jc.data_dir, f"{audio_dir.name}.json"), "rb").read() != stale


def _datasets(audio_dir, tmp_path, train=True, **kw):
    jc, tc = _cfgs(tmp_path, train_sz=8)
    return (jds.FingerprintDataset(jc, str(audio_dir), train=train, seed=42,
                                   **{k: v and f"{v}_jax" if k == "cache_dir" else v
                                      for k, v in kw.items()}),
            tds.FingerprintDataset(tc, str(audio_dir), train=train, seed=42,
                                   **{k: v and f"{v}_port" if k == "cache_dir" else v
                                      for k, v in kw.items()}))


@pytest.mark.parametrize("threads,cache", [(1, None), (4, None), (4, "decoded"),
                                           (4, "dir")])
def test_pair_batches_equal_jax(audio_dir, tmp_path, threads, cache):
    """Two epochs of pair batches, byte for byte, at one and four threads,
    and through each decode cache (cold in epoch 1, warm in epoch 2)."""
    kw = {"decoded": {"cache_decoded": True},
          "dir": {"cache_dir": str(tmp_path / "cache")}}.get(cache, {})
    jd, td = _datasets(audio_dir, tmp_path, **kw)
    jb = jds.PairBatcher(jd, batch_size=3, seed=7, num_threads=threads)
    tb = tds.PairBatcher(td, batch_size=3, seed=7, num_threads=threads)
    epochs = []
    for _ in range(2):
        want, got = list(jb), list(tb)
        assert len(got) == len(want) == 2
        for (wi, wj), (gi, gj) in zip(want, got):
            assert gi.dtype == np.float32 and gi.shape == (3, FS)
            assert gi.tobytes() == wi.tobytes() and gj.tobytes() == wj.tobytes()
        epochs.append(got)
    assert not np.array_equal(epochs[0][0][0], epochs[1][0][0])
    if cache == "dir":
        assert sorted(os.listdir(tmp_path / "cache_port")) == sorted(
            os.listdir(tmp_path / "cache_jax"))


def test_resumed_batcher_continues_the_epochs(audio_dir, tmp_path):
    _, td = _datasets(audio_dir, tmp_path)
    run = tds.PairBatcher(td, batch_size=3, seed=7, num_threads=2)
    first = [list(run) for _ in range(3)][2]
    resumed = tds.PairBatcher(td, batch_size=3, seed=7, num_threads=2)
    resumed.epoch = 2
    for (a, b), (c, d) in zip(first, list(resumed)):
        assert a.tobytes() == c.tobytes() and b.tobytes() == d.tobytes()


def test_track_loader_equals_jax(audio_dir, tmp_path):
    jd, td = _datasets(audio_dir, tmp_path, train=False)
    want = list(jds.TrackLoader(jd, [4, 0, 7]))
    got = list(tds.TrackLoader(td, [4, 0, 7]))
    assert [g.tobytes() for g in got] == [w.tobytes() for w in want]
    with pytest.raises(ValueError):
        tds.TrackLoader(_datasets(audio_dir, tmp_path)[1], [0])


def test_error_budget_skips_a_corrupt_file_as_jax(tmp_path):
    d = tmp_path / "mixed"
    make_wav_dir(str(d), n=3, dur_s=2.0, sr=FS, seed=5)
    for i in range(2):
        (d / f"bad_{i}.wav").write_bytes(b"not audio")
    jc, tc = _cfgs(tmp_path, error_threshold=1)
    jd = jds.FingerprintDataset(jc, str(d), train=True, seed=0)
    td = tds.FingerprintDataset(tc, str(d), train=True, seed=0)
    for _ in range(3):
        for i in range(len(td)):
            (wi, wj), (gi, gj) = jd[i], td[i]
            assert gi.tobytes() == wi.tobytes() and gj.tobytes() == wj.tobytes()
    assert td.error_counts == jd.error_counts and td.ignore_idx == jd.ignore_idx
    assert len(td.ignore_idx) == 2


def test_batcher_worker_failure_reaches_the_consumer(audio_dir, tmp_path):
    import concurrent.futures

    _, td = _datasets(audio_dir, tmp_path)

    class Corrupt:
        cfg = td.cfg

        def __len__(self):
            return len(td)

        def __getitem__(self, i):
            if i >= 2:
                raise ValueError("corrupt batch payload")
            return td[i]

    batcher = tds.PairBatcher(Corrupt(), batch_size=2, num_threads=2)
    with concurrent.futures.ThreadPoolExecutor(1) as ex:
        fut = ex.submit(lambda: list(batcher))
        with pytest.raises(RuntimeError, match="worker failed") as info:
            fut.result(timeout=60)
    assert isinstance(info.value.__cause__, ValueError)


def test_augment_banks_equal_jax(tmp_path):
    noise = make_wav_dir(str(tmp_path / "noise"), n=5, dur_s=1.5, sr=FS, seed=3, kind="noise")
    irs = make_wav_dir(str(tmp_path / "ir"), n=3, dur_s=0.25, sr=FS, seed=4, kind="ir")
    (tmp_path / "noise" / "bad.wav").write_bytes(b"not audio")
    noise.append(str(tmp_path / "noise" / "bad.wav"))
    kw = dict(fs=16000, max_noise=4)
    want = jds.build_augment_banks(noise, irs, **kw)
    got = tds.build_augment_banks(noise, irs, **kw)
    for name in ("noise", "ir", "noise_valid", "ir_valid", "ir_spec_re", "ir_spec_im"):
        g, w = getattr(got, name), np.asarray(getattr(want, name))
        assert g.device.type == "cpu", name
        np.testing.assert_array_equal(g.numpy(), w, err_msg=name)
