"""mp3 decode through the system libmpg123, bound with ctypes (port of
``grafp_tpu.native.mp3_native``'s decoder).

The fma corpora the reference trains and evaluates on are mp3, decoded
there by torchaudio's native backend (reference modules/data.py:45).
:func:`read` decodes a whole file to float32 PCM at the file's own rate
and channel count (mpg123's f32 output path, no int16 stop). A host
without libmpg123 raises :class:`NativeUnavailable`, on which
``data/audio_io.load_audio`` turns to the ``ffmpeg`` binary when one is
on PATH. The encoder the JAX module also binds (libmp3lame) makes test
fixtures only; the tests take it from the JAX package.
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

# mpg123.h / fmt123.h constants (stable ABI since mpg123 1.x)
_MPG123_OK = 0
_MPG123_DONE = -12
_MPG123_NEW_FORMAT = -11
_MPG123_ENC_FLOAT_32 = 0x200
_MPG123_ADD_FLAGS = 2          # enum mpg123_parms
_MPG123_FORCE_FLOAT = 0x400    # enum mpg123_param_flags


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


def decoder_available() -> bool:
    try:
        _load_mpg123()
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
