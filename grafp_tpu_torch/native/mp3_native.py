"""mp3 decode through the system libmpg123 and encode through libmp3lame,
both bound with ctypes (port of ``grafp_tpu.native.mp3_native``).

The fma corpora the reference trains and evaluates on are mp3, decoded
there by torchaudio's native backend (reference modules/data.py:45).
:func:`read` decodes a whole file to float32 PCM at the file's own rate
and channel count (mpg123's f32 output path, no int16 stop). A host
without libmpg123 raises :class:`NativeUnavailable`, on which
``data/audio_io.load_audio`` turns to the ``ffmpeg`` binary when one is
on PATH. :func:`write` is the LAME CBR encoder that makes the mp3
corpora of the tests and of ``scripts/torch_port_profile_input_pipeline.py``
(the JAX module's, byte for byte); a host without libmp3lame raises
:class:`NativeUnavailable`, and nothing falls back.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import os
import threading
from typing import Optional, Tuple

import numpy as np


class NativeUnavailable(RuntimeError):
    pass


_lock = threading.Lock()
_mpg123: Optional[ctypes.CDLL] = None
_lame: Optional[ctypes.CDLL] = None

# mpg123.h / fmt123.h constants (stable ABI since mpg123 1.x)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_ADD_FLAGS = 2          # enum mpg123_parms
_MPG123_FORCE_FLOAT = 0x400    # enum mpg123_param_flags

# lame.h MPEG_mode
_LAME_MODE_JOINT = 1
_LAME_MODE_MONO = 3


def _find(names) -> ctypes.CDLL:
    last: Exception = NativeUnavailable(f"none of {names} found")
    for name in names:
        try:
            return ctypes.CDLL(name)
        except OSError as e:
            last = e
    raise NativeUnavailable(str(last))


def _load_mpg123() -> ctypes.CDLL:
    global _mpg123
    with _lock:
        if _mpg123 is not None:
            return _mpg123
        found = ctypes.util.find_library("mpg123")
        lib = _find(([found] if found else [])
                    + ["libmpg123.so.0", "libmpg123.so"])
        lib.mpg123_init()  # no-op on modern versions, required on old
        lib.mpg123_new.restype = ctypes.c_void_p
        lib.mpg123_new.argtypes = [ctypes.c_char_p,
                                   ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_open.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mpg123_getformat.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_long),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int)]
        lib.mpg123_param.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                     ctypes.c_long, ctypes.c_double]
        lib.mpg123_read.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                    ctypes.c_size_t,
                                    ctypes.POINTER(ctypes.c_size_t)]
        lib.mpg123_strerror.restype = ctypes.c_char_p
        lib.mpg123_strerror.argtypes = [ctypes.c_void_p]
        lib.mpg123_close.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.argtypes = [ctypes.c_void_p]
        lib.mpg123_delete.restype = None
        _mpg123 = lib
        return lib


def _load_lame() -> ctypes.CDLL:
    global _lame
    with _lock:
        if _lame is not None:
            return _lame
        found = ctypes.util.find_library("mp3lame")
        lib = _find(([found] if found else [])
                    + ["libmp3lame.so.0", "libmp3lame.so"])
        lib.lame_init.restype = ctypes.c_void_p
        for fn in ("lame_set_in_samplerate", "lame_set_num_channels",
                   "lame_set_brate", "lame_set_quality", "lame_set_mode"):
            getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.lame_init_params.argtypes = [ctypes.c_void_p]
        lib.lame_encode_buffer.argtypes = [
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
            ctypes.c_void_p, ctypes.c_int]
        lib.lame_encode_flush.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                          ctypes.c_int]
        lib.lame_close.argtypes = [ctypes.c_void_p]
        _lame = lib
        return lib


def decoder_available() -> bool:
    try:
        _load_mpg123()
        return True
    except NativeUnavailable:
        return False


def encoder_available() -> bool:
    try:
        _load_lame()
        return True
    except NativeUnavailable:
        return False


def read(path: str) -> Tuple[np.ndarray, int]:
    """Decode an mp3 -> (float32 samples (T,) or (T, C), native rate).

    Output is forced to float32 (MPG123_FORCE_FLOAT set BEFORE open —
    a post-open mpg123_format call does not apply to the current stream
    because mpg123_getformat accepts the default s16 for it) at the
    stream's own rate and channel count; a mid-stream format change
    surfaces as an error instead of silently resampled audio.
    """
    lib = _load_mpg123()
    err = ctypes.c_int(0)
    h = lib.mpg123_new(None, ctypes.byref(err))
    if not h:
        raise NativeUnavailable(f"mpg123_new failed (err {err.value})")
    try:
        lib.mpg123_param(h, _MPG123_ADD_FLAGS, _MPG123_FORCE_FLOAT, 0.0)
        if lib.mpg123_open(h, os.fsencode(path)) != _MPG123_OK:
            raise IOError(
                f"mpg123_open({path}): "
                f"{lib.mpg123_strerror(h).decode(errors='replace')}")
        rate = ctypes.c_long(0)
        ch = ctypes.c_int(0)
        enc = ctypes.c_int(0)
        if lib.mpg123_getformat(h, ctypes.byref(rate), ctypes.byref(ch),
                                ctypes.byref(enc)) != _MPG123_OK:
            raise IOError(f"mpg123_getformat({path}) failed")
        if enc.value != _MPG123_ENC_FLOAT_32:
            raise IOError(
                f"mpg123 refused f32 output for {path} (enc {enc.value:#x})")
        bufsize = 1 << 18
        buf = ctypes.create_string_buffer(bufsize)
        done = ctypes.c_size_t(0)
        chunks = []
        while True:
            r = lib.mpg123_read(h, buf, bufsize, ctypes.byref(done))
            if done.value:
                chunks.append(buf.raw[:done.value])
            if r == _MPG123_DONE:
                break
            if r == _MPG123_NEW_FORMAT:
                raise IOError(f"mid-stream format change in {path}")
            if r != _MPG123_OK:
                raise IOError(
                    f"mpg123_read({path}): "
                    f"{lib.mpg123_strerror(h).decode(errors='replace')}")
        x = np.frombuffer(b"".join(chunks), dtype="<f4").copy()
        if ch.value > 1:
            x = x.reshape(-1, ch.value)
        return x, int(rate.value)
    finally:
        lib.mpg123_close(h)
        lib.mpg123_delete(h)


def write(path: str, x: np.ndarray, sr: int, kbps: int = 128) -> None:
    """LAME CBR mp3 encode of float32 [-1, 1] PCM, mono (T,) or (T, 1|2):
    quality 2, mono or joint stereo, each channel clipped and rounded to
    int16 first. kbps=128 is fma's nominal rate.

    An encoder for test and measurement corpora, not a gapless-safe
    transcoder: no Xing/LAME info tag is written, so a decoder cannot
    strip the ~1.7k-sample codec delay, and a decode of write()'s output
    is offset from the input by the encoder's and the decoder's delays.
    """
    lib = _load_lame()
    x = np.asarray(x, np.float32)
    if x.ndim == 1:
        n_ch, left = 1, x
        right = left
    elif x.ndim == 2 and x.shape[1] in (1, 2):
        n_ch = x.shape[1]
        left = np.ascontiguousarray(x[:, 0])
        right = np.ascontiguousarray(x[:, -1])
    else:
        raise ValueError(f"expected (T,) or (T, 1|2) PCM, got {x.shape}")
    pcm_l = np.clip(np.round(left * 32767.0), -32768, 32767).astype("<i2")
    pcm_r = np.clip(np.round(right * 32767.0), -32768, 32767).astype("<i2")
    gfp = lib.lame_init()
    if not gfp:
        raise NativeUnavailable("lame_init failed")
    try:
        lib.lame_set_in_samplerate(gfp, int(sr))
        lib.lame_set_num_channels(gfp, n_ch)
        lib.lame_set_brate(gfp, int(kbps))
        lib.lame_set_quality(gfp, 2)
        lib.lame_set_mode(
            gfp, _LAME_MODE_MONO if n_ch == 1 else _LAME_MODE_JOINT)
        if lib.lame_init_params(gfp) < 0:
            raise IOError(f"lame_init_params rejected sr={sr} ch={n_ch} "
                          f"kbps={kbps}")
        n = len(pcm_l)
        out_size = n * 5 // 4 + 7200  # lame.h's worst-case bound
        out = ctypes.create_string_buffer(out_size)
        nb = lib.lame_encode_buffer(
            gfp, pcm_l.ctypes.data, pcm_r.ctypes.data, n, out, out_size)
        if nb < 0:
            raise IOError(f"lame_encode_buffer failed ({nb})")
        with open(path, "wb") as f:
            f.write(out.raw[:nb])
            nb = lib.lame_encode_flush(gfp, out, out_size)
            if nb < 0:
                raise IOError(f"lame_encode_flush failed ({nb})")
            f.write(out.raw[:nb])
    finally:
        lib.lame_close(gfp)
