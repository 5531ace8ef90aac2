"""ctypes bridge to the native FASTQ loader (native/loader/h10x_loader.c).

Compiles the shared library on first use with gcc -O3 -fopenmp (cached under
~/.cache/hash10x_jax); every public entry point falls back to the numpy parser
(io/fastq.py) when no compiler is available, so the framework never hard-depends
on a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

__all__ = ["available", "load_fastq_native"]

_SRC = Path(__file__).resolve().parent.parent.parent / "native" / "loader" / "h10x_loader.c"
_lib = None
_tried = False


def _build() -> Optional[ctypes.CDLL]:
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not _SRC.exists():
        return None
    cache = Path(os.environ.get("H10X_NATIVE_CACHE",
                                os.path.expanduser("~/.cache/hash10x_jax")))
    cache.mkdir(parents=True, exist_ok=True)
    tag = hashlib.sha256(_SRC.read_bytes()).hexdigest()[:16]
    so = cache / f"h10x_loader_{tag}.so"
    if not so.exists():
        # flag fallbacks: full (OpenMP + zlib) -> no zlib -> plain
        variants = [
            ["-O3", "-march=native", "-fopenmp", "-DH10X_HAVE_ZLIB", "-lz"],
            ["-O3", "-march=native", "-fopenmp"],
            ["-O3"],
        ]
        for flags in variants:
            try:
                subprocess.run(
                    ["gcc", "-shared", "-fPIC", "-o", str(so), str(_SRC)]
                    + flags, check=True, capture_output=True)
                break
            except Exception:
                continue
        else:
            return None
    lib = ctypes.CDLL(str(so))
    lib.h10x_count_records.restype = ctypes.c_long
    lib.h10x_count_records.argtypes = [ctypes.c_char_p, ctypes.c_long]
    lib.h10x_seq_offsets.restype = ctypes.c_long
    lib.h10x_seq_offsets.argtypes = [
        ctypes.c_char_p, ctypes.c_long,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_long]
    lib.h10x_pack.restype = ctypes.c_long
    lib.h10x_pack.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long), ctypes.POINTER(ctypes.c_long),
        ctypes.c_long, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_uint32), ctypes.POINTER(ctypes.c_uint32)]
    if hasattr(lib, "h10x_gz_read"):
        lib.h10x_gz_read.restype = ctypes.c_long
        lib.h10x_gz_read.argtypes = [ctypes.c_char_p,
                                     ctypes.POINTER(ctypes.c_void_p)]
        lib.h10x_free.restype = None
        lib.h10x_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return _lib


def available() -> bool:
    return _build() is not None


def load_fastq_native(path, bc_len: int = 16, max_len: int = 0
                      ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray,
                                          int, Optional[np.ndarray]]]:
    """FASTQ file -> (packed (N, W) u32, lengths (N,) i32, barcode keys (N,) u32,
    read_len, nmask (N, ceil(L/32)) u32 or None when the lane has no Ns).
    Returns None when the native library is unavailable (caller falls back to
    the numpy parser).  When built with zlib, .gz (and plain) inputs stream
    through native gzread into one C buffer — no Python-side decompress, no
    extra copy; otherwise .gz decompresses via the gzip module first.
    """
    lib = _build()
    if lib is None:
        return None
    p = str(path)
    native_ptr = None
    if hasattr(lib, "h10x_gz_read"):
        ptr = ctypes.c_void_p()
        n = lib.h10x_gz_read(p.encode(), ctypes.byref(ptr))
        if n < 0:
            raise OSError(f"{p}: cannot open/decompress")
        native_ptr = ptr
        buf = ctypes.cast(ptr, ctypes.c_char_p)
    elif p.endswith(".gz"):
        import gzip
        data = gzip.open(p, "rb").read()
        n = len(data)
        buf = ctypes.create_string_buffer(data, n)
    else:
        data = Path(p).read_bytes()
        n = len(data)
        buf = ctypes.create_string_buffer(data, n)
    try:
        return _parse_buffer(lib, buf, n, bc_len, max_len, p)
    finally:
        if native_ptr is not None:
            lib.h10x_free(native_ptr)


def _parse_buffer(lib, buf, n, bc_len, max_len, path):
    n_rec_est = lib.h10x_count_records(buf, n)
    if n_rec_est <= 0:
        return (np.zeros((0, 0), np.uint32), np.zeros(0, np.int32),
                np.zeros(0, np.uint32), 0, None)
    seq_off = np.zeros(n_rec_est, np.int64)
    seq_len = np.zeros(n_rec_est, np.int64)
    n_rec = lib.h10x_seq_offsets(
        buf, n,
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        seq_len.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n_rec_est)
    if n_rec < 0:
        raise ValueError(f"{path}: malformed FASTQ (record not starting with @)")
    seq_off, seq_len = seq_off[:n_rec], seq_len[:n_rec]

    read_len = max_len or max(int(seq_len.max(initial=0)) - bc_len, 0)
    words = (read_len + 15) // 16
    nwords = (read_len + 31) // 32
    packed = np.zeros((n_rec, max(words, 1)), np.uint32)
    lengths = np.zeros(n_rec, np.int32)
    barcodes = np.zeros(n_rec, np.uint32)
    nmask = np.zeros((n_rec, max(nwords, 1)), np.uint32)
    n_bad = lib.h10x_pack(
        buf,
        seq_off.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        seq_len.ctypes.data_as(ctypes.POINTER(ctypes.c_long)),
        n_rec, bc_len, read_len, max(words, 1), max(nwords, 1),
        packed.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        barcodes.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)),
        nmask.ctypes.data_as(ctypes.POINTER(ctypes.c_uint32)))
    return (packed[:, :words], lengths, barcodes, read_len,
            nmask[:, :nwords] if n_bad else None)
