"""ctypes bindings for the native scene cache (``native/scene_cache.cc``).

The reference loads its 20 x N_train hypothesis ``.npy`` files one by one
(data/load_scene.py:316-345). The native library reads them in a C++ thread
pool (the header pass and the payload reads) and packs them into one
SCBLOB01 blob, so that a restart of a run reads one file
(``data/scene.py::_load_hypotheses``).

The library is compiled with g++ at its first use, never at import, with the
JAX package's flags, into ``scade_tpu_torch/_build/scene_cache-<hash>.so``;
the hash covers the source and the flags, so an edited source is rebuilt.
Without g++ (or when the build fails) every function here takes its numpy
path, which reads and writes the same SCBLOB01 format: a blob written by one
path, or by the JAX package, is read by the other. Each function returns the
path it took, ``"native"`` or ``"numpy"``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "scene_cache.cc"
BUILD = Path(__file__).resolve().parents[1] / "_build"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
_MAGIC = b"SCBLOB01"

_loaded: Dict[str, ctypes.CDLL] = {}

_P_I64 = ctypes.POINTER(ctypes.c_int64)
_P_F32 = ctypes.POINTER(ctypes.c_float)
_SIGNATURES = {
    "scade_npy_count_batch": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, _P_I64,
                               ctypes.c_int], ctypes.c_int64),
    "scade_load_npy_batch": ([ctypes.POINTER(ctypes.c_char_p), ctypes.c_int64, _P_I64, _P_I64,
                              _P_F32, _P_I64, ctypes.c_int], ctypes.c_int64),
    "scade_write_blob": ([ctypes.c_char_p, _P_F32, _P_I64, ctypes.c_int64], ctypes.c_int64),
    "scade_blob_info": ([ctypes.c_char_p, _P_I64], ctypes.c_int64),
    "scade_read_blob": ([ctypes.c_char_p, _P_F32, _P_I64, ctypes.c_int64], ctypes.c_int64),
}


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(GXX_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"scene_cache-{digest}.so"


def build() -> Optional[Path]:
    """Compiles the library if it is missing. Returns its path, or None
    without g++ or the source, or when g++ fails (its output then goes to
    ``_build/scene_cache.log``). Atomic: a concurrent process never loads a
    half-written file."""
    if shutil.which("g++") is None or not SOURCE.exists():
        return None
    target = library_path()
    if target.exists():
        return target
    BUILD.mkdir(exist_ok=True)
    tmp = target.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run(["g++", *GXX_FLAGS, str(SOURCE), "-o", str(tmp)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        (BUILD / "scene_cache.log").write_text(proc.stdout + proc.stderr)
        tmp.unlink(missing_ok=True)
        return None
    os.replace(tmp, target)
    return target


def load() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed; None where it cannot be."""
    lib = _loaded.get("scene_cache")
    if lib is not None:
        return lib
    path = build()
    if path is None:
        return None
    lib = ctypes.CDLL(str(path))
    for name, (argtypes, restype) in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = argtypes, restype
    _loaded["scene_cache"] = lib
    return lib


def _i64(a: np.ndarray):
    return a.ctypes.data_as(_P_I64)


def _numpy_npy(paths: Sequence[str]) -> Tuple[List[np.ndarray], str]:
    return [np.load(p).astype(np.float32).ravel() for p in paths], "numpy"


def load_npy_batch(paths: Sequence[str], n_threads: int = 0) -> Tuple[List[np.ndarray], str]:
    """Float32 ``.npy`` files, flattened (callers reshape), read in parallel
    by the native library; serially by numpy without it or where it rejects
    a file. Returns (arrays, path taken)."""
    lib = load()
    if lib is None or not paths:
        return _numpy_npy(paths)
    n = len(paths)
    c_paths = (ctypes.c_char_p * n)(*[os.fsencode(p) for p in paths])
    capacity = np.empty(n, np.int64)
    if lib.scade_npy_count_batch(c_paths, n, _i64(capacity), n_threads):
        return _numpy_npy(paths)
    offsets = np.zeros(n, np.int64)
    np.cumsum(capacity[:-1], out=offsets[1:])
    out = np.empty(int(capacity.sum()), np.float32)
    counts = np.empty(n, np.int64)
    if lib.scade_load_npy_batch(c_paths, n, _i64(offsets), _i64(capacity),
                                out.ctypes.data_as(_P_F32), _i64(counts), n_threads):
        return _numpy_npy(paths)
    return [out[o: o + c] for o, c in zip(offsets.tolist(), counts.tolist())], "native"


def write_blob(path: str, arrays: Sequence[np.ndarray]) -> str:
    """Packs ``arrays`` into one SCBLOB01 file (layout: scene_cache.cc:15-19),
    written to a temporary file and renamed over ``path``. Returns the path
    taken."""
    flats = [np.ascontiguousarray(a, np.float32).ravel() for a in arrays]
    sizes = np.array([f.size for f in flats], np.int64)
    data = np.concatenate(flats) if flats else np.empty(0, np.float32)
    tmp = f"{path}.{os.getpid()}.tmp"
    lib = load()
    try:
        if lib is None:
            with open(tmp, "wb") as f:
                f.write(_MAGIC)
                f.write(struct.pack("<Q", len(flats)))
                index = np.stack([np.cumsum(sizes) - sizes, sizes], 1).astype("<u8")
                f.write(index.tobytes())
                f.write(data.astype("<f4").tobytes())
        elif lib.scade_write_blob(os.fsencode(tmp), data.ctypes.data_as(_P_F32), _i64(sizes),
                                  len(flats)) != 0:
            raise OSError(f"scade_write_blob failed for {tmp}")
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return "numpy" if lib is None else "native"


def read_blob(path: str) -> Tuple[List[np.ndarray], str]:
    """The arrays of an SCBLOB01 file, flattened. Raises OSError on a file
    that is not one or is cut short. Returns (arrays, path taken)."""
    lib = load()
    if lib is None:
        with open(path, "rb") as f:
            if f.read(8) != _MAGIC:
                raise OSError(f"bad blob {path}")
            (n,) = struct.unpack("<Q", f.read(8))
            index = np.frombuffer(f.read(16 * n), "<u8").reshape(n, 2)
            total = int(index[-1].sum()) if n else 0
            data = np.frombuffer(f.read(4 * total), "<f4")
        if data.size != total:
            raise OSError(f"truncated blob {path}")
        return [data[int(o): int(o) + int(s)] for o, s in index], "numpy"
    n_arrays = ctypes.c_int64(0)
    total = lib.scade_blob_info(os.fsencode(path), ctypes.byref(n_arrays))
    if total < 0:
        raise OSError(f"bad blob {path}")
    n = int(n_arrays.value)
    out = np.empty(int(total), np.float32)
    sizes = np.empty(max(n, 1), np.int64)
    if lib.scade_read_blob(os.fsencode(path), out.ctypes.data_as(_P_F32), _i64(sizes), n) != 0:
        raise OSError(f"scade_read_blob failed for {path}")
    arrays, off = [], 0
    for s in sizes[:n].tolist():
        arrays.append(out[off: off + s])
        off += s
    return arrays, "native"
