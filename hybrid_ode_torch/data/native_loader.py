"""ctypes binding of the native CSV / windowing engine (`native/fastwindow.cpp`).

Port of `hybrid_ode_tpu/data/native_loader.py`: one-pass CSV parse and
per-subject window assembly in C++, returning flat f32 window buffers. The
library is built from the repository's `native/fastwindow.cpp` with `g++` at
first use into `hybrid_ode_torch/build/`, named by a hash of the source, the
flags and the host CPU's features (`-march=native`), so a changed source or
another CPU gets its own build. A failed build raises RuntimeError with the
compiler's message; `create_data_arrays` then takes the csv route, as the
JAX package takes its pandas route where its library is absent.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
from pathlib import Path
from typing import List, Tuple

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG.parent / "native" / "fastwindow.cpp"
_BUILD_DIR = _PKG / "build"
#: the C++ compiler and its flags (those of native/Makefile)
CXX = "g++"
CXX_FLAGS = ("-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared")


class _FwCsv(ctypes.Structure):
    _fields_ = [
        ("data", ctypes.POINTER(ctypes.c_double)),
        ("n_rows", ctypes.c_int64),
        ("n_cols", ctypes.c_int64),
        ("header", ctypes.c_char_p),
    ]


def _host_cpu() -> str:
    """The machine and its CPU's feature flags: -march=native code is for them."""
    flags = ""
    try:
        with open("/proc/cpuinfo") as f:
            flags = next((ln for ln in f if ln.startswith("flags")), "")
    except OSError:
        pass
    return platform.machine() + "\0" + flags


def build_library() -> Path:
    """Compile `native/fastwindow.cpp` unless a build of this source with these
    flags for this CPU exists; returns the library's path. Raises RuntimeError
    with the compiler's output when the build fails."""
    h = hashlib.sha256("\0".join((CXX,) + CXX_FLAGS + (_host_cpu(),)).encode() + b"\0"
                       + SOURCE.read_bytes())
    so = _BUILD_DIR / f"libfastwindow_{h.hexdigest()[:16]}.so"
    if so.exists():
        return so
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    try:
        proc = subprocess.run([CXX, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} failed: cannot run {CXX!r}: {e}") from None
    if proc.returncode != 0:
        raise RuntimeError(f"building {SOURCE.name} failed ({CXX} exit {proc.returncode}):\n"
                           f"{proc.stdout}")
    os.replace(tmp, so)
    return so


@functools.lru_cache(maxsize=None)
def _load(path: str) -> ctypes.CDLL:
    lib = ctypes.CDLL(path)
    lib.fw_parse_csv.argtypes = [ctypes.c_char_p, ctypes.POINTER(_FwCsv)]
    lib.fw_parse_csv.restype = ctypes.c_int
    lib.fw_build_windows.argtypes = [
        ctypes.POINTER(_FwCsv), ctypes.c_int64,
        ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_int64,
        ctypes.POINTER(ctypes.POINTER(ctypes.c_float)),
        ctypes.POINTER(ctypes.POINTER(ctypes.c_int64)),
    ]
    lib.fw_build_windows.restype = ctypes.c_int64
    lib.fw_free.argtypes = [ctypes.c_void_p]
    lib.fw_free_csv.argtypes = [ctypes.POINTER(_FwCsv)]
    return lib


def load_library() -> ctypes.CDLL:
    """The bound library, built first where needed."""
    return _load(str(build_library()))


def native_available() -> bool:
    """Whether the library builds (or is built) and loads on this host."""
    try:
        load_library()
    except (RuntimeError, OSError):
        return False
    return True


def parse_csv(path: str) -> Tuple[np.ndarray, List[str]]:
    """Parse a numeric CSV natively -> (column-major (n_cols, n_rows) f64,
    names). RuntimeError where the library cannot be built, OSError on a
    parse failure."""
    lib = load_library()
    csv = _FwCsv()
    rc = lib.fw_parse_csv(str(path).encode(), ctypes.byref(csv))
    if rc != 0:
        raise OSError(f"fw_parse_csv failed with code {rc} for {path}")
    try:
        names = csv.header.decode().split(",")
        arr = np.ctypeslib.as_array(csv.data, shape=(int(csv.n_cols), int(csv.n_rows))).copy()
    finally:
        lib.fw_free_csv(ctypes.byref(csv))
    return arr, names


class NotGrouped(ValueError):
    """The file's rows are not grouped by subject in ascending id order, or
    an id is not an integer: the native windows would differ from the csv
    route's, which groups by sorted key."""


def build_windows(path: str, columns: List[str], subject_col: str = "subject_id",
                  seq_len: int = 61, stride: int = 30
                  ) -> Tuple[np.ndarray, np.ndarray, List[str]]:
    """One-pass native parse and window build.

    Returns (windows (N, seq_len, len(columns)) f32, subject_ids (N,) int64,
    header names). A missing column raises KeyError, a file that is not
    grouped by subject (see `NotGrouped`) raises NotGrouped, a parse failure
    OSError."""
    lib = load_library()
    csv = _FwCsv()
    rc = lib.fw_parse_csv(str(path).encode(), ctypes.byref(csv))
    if rc != 0:
        raise OSError(f"fw_parse_csv failed with code {rc} for {path}")
    try:
        names = csv.header.decode().split(",")
        col_idx = {n: i for i, n in enumerate(names)}
        for c in [subject_col, *columns]:
            if c not in col_idx:
                raise KeyError(f"missing column {c!r}")
        n_rows = int(csv.n_rows)
        data = np.ctypeslib.as_array(csv.data, shape=(int(csv.n_cols), n_rows))
        subj = data[col_idx[subject_col]]
        if n_rows:
            runs = subj[np.concatenate([[True], subj[1:] != subj[:-1]])]
            if not (np.isfinite(runs).all() and (runs == np.floor(runs)).all()
                    and (np.diff(runs) > 0).all()):
                raise NotGrouped(f"{path}: rows are not grouped by ascending integer "
                                 f"{subject_col}")
        sel = [col_idx[c] for c in columns]
        sel_arr = (ctypes.c_int64 * len(sel))(*sel)
        wins_p = ctypes.POINTER(ctypes.c_float)()
        subs_p = ctypes.POINTER(ctypes.c_int64)()
        n_windows = lib.fw_build_windows(
            ctypes.byref(csv), col_idx[subject_col], sel_arr, len(sel),
            seq_len, stride, ctypes.byref(wins_p), ctypes.byref(subs_p),
        )
        if n_windows < 0:
            raise MemoryError("fw_build_windows allocation failed")
        if n_windows == 0:
            return np.zeros((0, seq_len, len(sel)), np.float32), np.zeros(0, np.int64), names
        wins = np.ctypeslib.as_array(wins_p, shape=(int(n_windows), seq_len, len(sel))).copy()
        subs = np.ctypeslib.as_array(subs_p, shape=(int(n_windows),)).copy()
        lib.fw_free(ctypes.cast(wins_p, ctypes.c_void_p))
        lib.fw_free(ctypes.cast(subs_p, ctypes.c_void_p))
        return wins, subs, names
    finally:
        lib.fw_free_csv(ctypes.byref(csv))
