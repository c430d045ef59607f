"""Builds the CUDA sources in ``csrc/`` and loads them through ctypes.

Each ``csrc/<name>.cu`` exposes a plain C entry point that launches its
kernel on the caller's stream and returns ``cudaGetLastError()``. It is
compiled on first use, one ``nvcc`` process per source, into
``_build/<name>-<hash>.so``; the hash covers the source and the flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. Nothing
here runs at import time: the CPU tests import every module of the package
on a machine without ``nvcc``.

Each launcher counts its launches in its ``launches`` attribute, and may
keep other counters beside it (K1's ``kept``), through ``count_launch``. A
launch captured into a CUDA graph runs only when the graph replays, so it
goes to the capture's ``tally`` instead, and the caller adds that tally at
each replay (``count_replay``).
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from contextlib import contextmanager
from pathlib import Path
from typing import Dict, Iterable, List

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD = Path(__file__).with_name("_build")
SOURCES = ("fused_mlp", "fused_sampling")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers, shared memory and spills into the build log
)

_loaded: Dict[str, ctypes.CDLL] = {}
_tallies: List[list] = []


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError("nvcc not found: the port's CUDA kernels need the CUDA toolkit")


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD / f"{name}-{digest}.so"


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compiles every source in ``names`` whose library is missing, all
    ``nvcc`` processes at once. Returns the wall seconds of the whole build
    per name (0.0 for a library that was already built). The ptxas report
    goes to ``_build/<name>.log``."""
    BUILD.mkdir(exist_ok=True)
    nvcc = None
    started = {}
    t0 = time.perf_counter()
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        nvcc = nvcc or _nvcc()
        tmp = target.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, target)
    seconds = {name: 0.0 for name in names}
    failed = []
    for name, (proc, tmp, target) in started.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        (BUILD / f"{name}.log").write_text(log)
        if proc.returncode != 0:
            failed.append(f"{name}.cu (nvcc exit {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, target)  # atomic: a concurrent loader sees all or nothing
    if failed:
        raise RuntimeError("CUDA build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build([name])
        lib = ctypes.CDLL(str(path))
        _loaded[name] = lib
    return lib


def check(status: int, what: str) -> None:
    """Raises if a C entry point returned a CUDA error code."""
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")


def count_launch(launcher, counter: str = "launches") -> None:
    """Adds one to ``launcher``'s attribute ``counter``; under a CUDA graph's
    capture, where nothing runs, to the innermost open ``tally`` (or
    nowhere)."""
    if torch.cuda.is_current_stream_capturing():
        if _tallies:
            _tallies[-1].append((launcher, counter))
    else:
        setattr(launcher, counter, getattr(launcher, counter) + 1)


@contextmanager
def tally():
    """Collects the counts taken inside it, one (launcher, counter) entry
    a count: what a replay of the captured graphs adds."""
    launched: list = []
    _tallies.append(launched)
    try:
        yield launched
    finally:
        _tallies.pop()


def count_replay(launched) -> None:
    """Counts a replay of graphs whose ``tally`` was ``launched``."""
    for launcher, counter in launched:
        setattr(launcher, counter, getattr(launcher, counter) + 1)
