"""Zstandard decompression through the system's libzstd (``libzstd.so.1``),
bound with ctypes.

The orbax directories that JAX's ``train/checkpoint.py`` writes keep every
OCDBT node and array chunk as zstd frames, and Python 3.12 has no zstd
module.  The library is loaded at first use; where it is missing, that use
raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import threading

LIBRARY = "libzstd.so.1"
_CONTENTSIZE_UNKNOWN = (1 << 64) - 1
_ERROR_PREFIX_UNKNOWN = 10          # zstd_errors.h: the input is not a zstd frame
_ERROR_DICTIONARY_WRONG = 32

_lock = threading.Lock()
_loaded: ctypes.CDLL | None = None


class _Buffer(ctypes.Structure):
    """ZSTD_inBuffer and ZSTD_outBuffer: a pointer, its size, the position."""
    _fields_ = [("ptr", ctypes.c_void_p), ("size", ctypes.c_size_t), ("pos", ctypes.c_size_t)]


def _lib() -> ctypes.CDLL:
    """libzstd, its entry points typed before any thread can call them."""
    global _loaded
    with _lock:
        if _loaded is None:
            try:
                lib = ctypes.CDLL(LIBRARY)
            except OSError as e:
                raise RuntimeError(f"zstd: {LIBRARY} could not be loaded ({e}); the orbax "
                                   "reader needs the system's zstd library") from e
            size_t, ptr = ctypes.c_size_t, ctypes.c_void_p
            for name, restype, argtypes in (
                    ("ZSTD_createDCtx", ptr, []),
                    ("ZSTD_freeDCtx", size_t, [ptr]),
                    ("ZSTD_decompressStream", size_t,
                     [ptr, ctypes.POINTER(_Buffer), ctypes.POINTER(_Buffer)]),
                    ("ZSTD_getFrameContentSize", ctypes.c_ulonglong, [ctypes.c_char_p, size_t]),
                    ("ZSTD_isError", ctypes.c_uint, [size_t]),
                    ("ZSTD_getErrorCode", ctypes.c_int, [size_t]),
                    ("ZSTD_getErrorName", ctypes.c_char_p, [size_t])):
                fn = getattr(lib, name)
                fn.argtypes, fn.restype = argtypes, restype
            _loaded = lib
        return _loaded


def decompress(data: bytes, size_hint: int | None = None,
               max_size: int | None = None) -> bytes:
    """The content of the zstd frames in ``data`` (concatenated frames are
    joined; skippable frames are skipped; checksums are checked).
    ``size_hint`` pre-sizes the output for frames without a content size;
    past ``max_size`` bytes of output it raises.  Corrupt or truncated input,
    and frames that need a dictionary, raise ``ValueError``."""
    lib = _lib()
    data = bytes(data)
    if not data:
        raise ValueError("zstd: truncated input (0 bytes)")
    limit = None if max_size is None else max_size + 1   # one byte more tells an overrun
    cap = size_hint or 0
    if not cap:
        first = lib.ZSTD_getFrameContentSize(data, len(data))
        cap = first if first < _CONTENTSIZE_UNKNOWN - 1 else 4 * len(data)
    cap = max(1, cap if limit is None else min(cap, limit))
    out = ctypes.create_string_buffer(cap)      # ctypes.resize grows it; len() stays
    src = _Buffer(ctypes.cast(ctypes.c_char_p(data), ctypes.c_void_p), len(data), 0)
    dst = _Buffer(None, 0, 0)
    dctx = lib.ZSTD_createDCtx()
    if not dctx:
        raise MemoryError("zstd: ZSTD_createDCtx failed")
    try:
        rc = 1
        while src.pos < src.size or (rc != 0 and dst.pos == cap):
            if dst.pos == cap:
                if limit is not None and cap >= limit:
                    break
                cap = 2 * cap if limit is None else min(2 * cap, limit)
                ctypes.resize(out, cap)
            dst.ptr, dst.size = ctypes.addressof(out), cap
            before = (src.pos, dst.pos)
            rc = lib.ZSTD_decompressStream(dctx, ctypes.byref(dst), ctypes.byref(src))
            if lib.ZSTD_isError(rc):
                code = lib.ZSTD_getErrorCode(rc)
                name = lib.ZSTD_getErrorName(rc).decode(errors="replace")
                if code == _ERROR_PREFIX_UNKNOWN:
                    raise ValueError(f"zstd: not a zstd frame ({name})")
                if code == _ERROR_DICTIONARY_WRONG:
                    raise ValueError(f"zstd: the frame needs a dictionary ({name})")
                raise ValueError(f"zstd: {name}")
            if (src.pos, dst.pos) == before and dst.pos < cap:
                raise ValueError("zstd: the decoder made no progress on the input")
    finally:
        lib.ZSTD_freeDCtx(dctx)
    if limit is not None and dst.pos >= limit:
        raise ValueError(f"zstd: the output passes the limit of {max_size} bytes")
    if rc != 0:
        raise ValueError(f"zstd: truncated input (the frame ends after {len(data)} bytes)")
    return ctypes.string_at(out, dst.pos)
