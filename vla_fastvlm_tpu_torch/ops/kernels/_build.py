"""Build and load the port's CUDA kernels.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled on its own by
``nvcc`` for Hopper (``sm_90a``) into ``build/kernels/lib<name>.so`` under the
checkout's root, at first use, then loaded with ``ctypes``. Every pointer and
the stream cross as ``c_void_p``; the stream is PyTorch's current stream.
Each C entry returns ``cudaGetLastError()`` and the wrapper raises if it is
not 0, so a refused launch never passes silently.

Nothing is built or loaded while a module is imported: the CPU tests import
every module, and this machine may have no ``nvcc``.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Sequence

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
    # Optimize a source's kernels on all cores: the sources with many
    # template instances set the build's wall time.
    "-split-compile=0",
)


class KernelLibraries:
    """Built-and-loaded kernel libraries, one per source, keyed by name, and
    their entry points with declared argument types."""

    def __init__(self) -> None:
        self._libs: Dict[str, ctypes.CDLL] = {}
        self._fns: Dict[tuple, ctypes._CFuncPtr] = {}
        self._lock = threading.Lock()

    def get(self, name: str) -> ctypes.CDLL:
        with self._lock:
            if name not in self._libs:
                build([name])
                self._libs[name] = ctypes.CDLL(str(_lib_path(name)))
            return self._libs[name]

    def entry(self, name: str, symbol: str, argtypes: Sequence, restype) -> ctypes._CFuncPtr:
        """``symbol`` of library ``name`` with ``argtypes``/``restype`` declared once."""
        key = (name, symbol)
        fn = self._fns.get(key)
        if fn is None:
            fn = getattr(self.get(name), symbol)
            fn.argtypes, fn.restype = list(argtypes), restype
            self._fns[key] = fn
        return fn


LIBRARIES = KernelLibraries()


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.is_file():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built on a machine with the CUDA toolkit")


def _stale(name: str) -> bool:
    """True when the library is missing or older than its source or a shared header."""
    lib = _lib_path(name)
    src = CSRC / f"{name}.cu"
    if not src.is_file():
        raise FileNotFoundError(src)
    if not lib.is_file():
        return True
    newest = max(p.stat().st_mtime for p in [src, *CSRC.glob("*.cuh")])
    return lib.stat().st_mtime < newest


def build(names: Iterable[str]) -> Dict[str, str]:
    """Compile every stale source in ``names``, all ``nvcc`` processes at once.

    Returns each built name's compiler output (``-Xptxas -v`` register and
    shared-memory report); raises with the compiler's output on failure.
    """
    todo = [n for n in names if _stale(n)]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in todo:
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        ))
    logs, failed = {}, []
    for name, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs[name] = out
        if proc.returncode != 0:
            failed.append(name)
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, _lib_path(name))
    if failed:
        raise RuntimeError(
            "nvcc failed for "
            + ", ".join(failed)
            + ":\n"
            + "\n".join(logs[n] for n in failed)
        )
    return logs


def launcher(name: str, symbol: str, n_pointers: int, scalar_types: Sequence) -> ctypes._CFuncPtr:
    """``symbol(ptr * n_pointers, *scalars, stream) -> int`` of library ``name``."""
    argtypes = [ctypes.c_void_p] * n_pointers + list(scalar_types) + [ctypes.c_void_p]
    return LIBRARIES.entry(name, symbol, argtypes, ctypes.c_int)


@functools.lru_cache(maxsize=None)
def smem_per_block(device_index: int) -> int:
    """Shared memory a block may opt in to on CUDA device ``device_index``."""
    import torch

    return torch.cuda.get_device_properties(device_index).shared_memory_per_block_optin


def check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what}: CUDA error {status} at launch")
