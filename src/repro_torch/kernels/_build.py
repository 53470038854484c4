"""Build and bind the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface. It is compiled with
``nvcc`` for ``sm_90a`` into ``build/repro_torch/<name>-<hash>.so`` at the
root of the checkout (git-ignored) at first use, and loaded with
``ctypes``. The hash covers the source and the flags, so an edited source
is rebuilt and an unchanged one is reused. The compiler's output
(``-Xptxas -v``: registers, shared memory, spills per kernel) is kept
beside the library as ``<name>-<hash>.log``.

Nothing here runs at import time: the CPU tests import every module, and
only a call on a CUDA tensor builds.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Dict, Iterable

__all__ = ["CSRC", "BUILD_DIR", "NVCC_FLAGS", "build_all", "load", "log_of"]

CSRC = Path(__file__).resolve().with_name("csrc")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = Path(home) / "bin" / "nvcc"
    if not path.exists():
        raise RuntimeError(
            f"nvcc not found on PATH or at {path}; the CUDA kernels are "
            "built from source on a machine with the CUDA toolkit")
    return str(path)


def _library(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(
        src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{digest}.so"


def log_of(name: str) -> str:
    """The compiler's output of the current build of ``name``."""
    return _library(name).with_suffix(".log").read_text()


def build_all(names: Iterable[str] | None = None) -> Dict[str, Path]:
    """Compile every named source (default: all of ``csrc/*.cu``) that has
    no up-to-date library yet, one ``nvcc`` per source, all started
    together. Raises with the compiler's output if any build fails."""
    if names is None:
        names = sorted(p.stem for p in CSRC.glob("*.cu"))
    libs = {n: _library(n) for n in names}
    todo = {n: so for n, so in libs.items() if not so.exists()}
    if todo:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        nvcc = _nvcc()
        procs = {}
        for n, so in todo.items():
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            procs[n] = (tmp, subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
        failed = []
        for n, (tmp, proc) in procs.items():
            out, _ = proc.communicate()
            libs[n].with_suffix(".log").write_text(out)
            if proc.returncode != 0:
                failed.append(f"nvcc failed for {n}.cu:\n{out}")
            else:
                os.replace(tmp, libs[n])
        if failed:
            raise RuntimeError("\n".join(failed))
    return libs


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build ``csrc/<name>.cu`` if needed and load it (once a process)."""
    return ctypes.CDLL(str(build_all([name])[name]))
