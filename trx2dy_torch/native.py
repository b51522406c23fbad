"""ctypes binding of the native host library (native/src): the TM-score
engine and the a3m parser.

The port's own copy of trx2dy/native.py. It builds the unchanged
native/src/*.cc with g++ and the flags of native/Makefile into
build/native/libtrx2dy-<hash>.so at first use, never loading the committed
native/libtrx2dy.so, which belongs to the JAX package. The hash covers the
sources, the flags and the target that -march=native selects on this
host, so a library built on another CPU is never loaded. Where g++ or the
build fails every function returns None, as in JAX, and the callers take
their per-pair PyTorch path. Nothing here runs at import time.

  tmscore(pred_ca, native_ca)  (tm, rmsd) of two index-aligned (L, 3) CA
      traces;
  tmscore_matrix(coords)       all-vs-all (tm, rmsd) (M, M) matrices of
      (M, L, 3) CA traces;
  parse_a3m(path)              an (N, L) uint8 token matrix.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
SOURCES = (ROOT / "native" / "src" / "tmscore.cc",
           ROOT / "native" / "src" / "a3m.cc")
BUILD_DIR = ROOT / "build" / "native"
CXX = "g++"
CXXFLAGS = ["-O3", "-fPIC", "-std=c++17", "-Wall", "-march=native"]

_lib = None
_lib_tried = False
_lock = threading.Lock()


def library_path() -> Path:
    """build/native/libtrx2dy-<hash>.so for these sources, flags and this
    host's -march=native target (raises OSError or CalledProcessError where
    g++ cannot say what that target is)."""
    target = subprocess.run([CXX, *CXXFLAGS, "-Q", "--help=target"],
                            capture_output=True, text=True, check=True,
                            timeout=60).stdout
    h = hashlib.sha256(" ".join([CXX, *CXXFLAGS]).encode())
    h.update(target.encode())
    for src in SOURCES:
        h.update(src.read_bytes())
    return BUILD_DIR / f"libtrx2dy-{h.hexdigest()[:16]}.so"


def _build() -> Path:
    final = library_path()
    if not final.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = final.with_suffix(f".{os.getpid()}.tmp")
        subprocess.run([CXX, *CXXFLAGS, "-shared", "-o", str(tmp),
                        *map(str, SOURCES)], check=True,
                       capture_output=True, timeout=300)
        os.replace(tmp, final)   # a parallel build never sees half a file
    return final


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _lib_tried
    with _lock:
        if _lib is not None or _lib_tried:
            return _lib
        _lib_tried = True
        try:
            lib = ctypes.CDLL(str(_build()))
        except (OSError, subprocess.SubprocessError):
            return None
        dp, i = ctypes.POINTER(ctypes.c_double), ctypes.c_int
        lib.trx2dy_tmscore.restype = i
        lib.trx2dy_tmscore.argtypes = [dp, dp, i, dp, dp]
        lib.trx2dy_tmscore_matrix.restype = i
        lib.trx2dy_tmscore_matrix.argtypes = [dp, i, i, dp, dp]
        lib.trx2dy_parse_a3m.restype = i
        lib.trx2dy_parse_a3m.argtypes = [
            ctypes.c_char_p, i, ctypes.POINTER(ctypes.c_uint8), i,
            ctypes.POINTER(i)]
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _dp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))


def tmscore(pred_ca: np.ndarray, native_ca: np.ndarray
            ) -> Optional[Tuple[float, float]]:
    """(tm, rmsd) of two index-aligned (L, 3) CA traces; None if the
    library is unavailable or L < 4."""
    lib = _load()
    if lib is None:
        return None
    p = np.ascontiguousarray(pred_ca, np.float64)
    q = np.ascontiguousarray(native_ca, np.float64)
    if p.shape != q.shape or p.ndim != 2 or p.shape[1] != 3:
        raise ValueError(f"tmscore: two (L, 3) traces, got {p.shape} and "
                         f"{q.shape}")
    tm, rmsd = ctypes.c_double(), ctypes.c_double()
    if lib.trx2dy_tmscore(_dp(p), _dp(q), p.shape[0], ctypes.byref(tm),
                          ctypes.byref(rmsd)) != 0:
        return None
    return tm.value, rmsd.value


def tmscore_matrix(coords: np.ndarray
                   ) -> Optional[Tuple[np.ndarray, np.ndarray]]:
    """All-vs-all (tm, rmsd) (M, M) matrices of (M, L, 3) CA traces; None
    if the library is unavailable or L < 4."""
    lib = _load()
    if lib is None:
        return None
    c = np.ascontiguousarray(coords, np.float64)
    if c.ndim != 3 or c.shape[2] != 3:
        raise ValueError(f"tmscore_matrix: (M, L, 3) traces, got {c.shape}")
    m, n = c.shape[0], c.shape[1]
    tm, rmsd = np.zeros((m, m)), np.zeros((m, m))
    if lib.trx2dy_tmscore_matrix(_dp(c), m, n, _dp(tm), _dp(rmsd)) != 0:
        return None
    return tm, rmsd


def parse_a3m(path: str, limit: int = 20000,
              max_len: int = 8192) -> Optional[np.ndarray]:
    """The (N, L) uint8 tokens of an a3m file; None if the library is
    unavailable or the file cannot be parsed (callers fall back to
    trx2dy_torch.io.a3m.parse_a3m)."""
    lib = _load()
    if lib is None:
        return None
    out = np.zeros((limit, max_len), np.uint8)
    seq_len = ctypes.c_int()
    rows = lib.trx2dy_parse_a3m(
        path.encode(), limit,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), max_len,
        ctypes.byref(seq_len))
    if rows < 0:
        return None
    L = seq_len.value
    return out[:rows].reshape(-1)[:rows * L].reshape(rows, L).copy()
