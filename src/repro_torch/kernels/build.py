"""Building a kernel's CUDA C++ source into a shared library at first use.

Each CUDA kernel of the port lives in ``csrc/<name>.cu`` behind a plain C
interface. ``KernelLibrary`` compiles it with ``nvcc`` for ``sm_90a`` into
``build/lib<name>_<hash>.so`` at the repository root (git-ignored), where
the hash is the source's and the shared headers' (``csrc/*.cuh``), so a
changed source or header builds anew and an unchanged one is reused;
then it loads the library with ``ctypes`` and lets the wrapper declare its
functions' argument types. Nothing is built when a
module is imported: the first launch on a CUDA tensor builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Callable, Optional

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the port's CUDA kernels are built on "
                       "the card's machine from src/repro_torch/csrc")


class KernelLibrary:
    """One CUDA source, built once per source version and loaded once per
    process. ``declare`` sets ``argtypes``/``restype`` on the loaded
    library. Safe to use from several threads."""

    def __init__(self, name: str, declare: Callable[[ctypes.CDLL], None]):
        self.name = name
        self.source = CSRC_DIR / f"{name}.cu"
        self._declare = declare
        self._lib: Optional[ctypes.CDLL] = None
        self._lock = threading.Lock()
        self.build_log = ""      # nvcc's -Xptxas -v report of this build

    def build(self) -> Path:
        """Compile the source unless this version is built; returns the
        library's path."""
        h = hashlib.sha256(self.source.read_bytes())
        for header in sorted(CSRC_DIR.glob("*.cuh")):
            h.update(header.read_bytes())
        digest = h.hexdigest()[:16]
        out = BUILD_DIR / f"lib{self.name}_{digest}.so"
        if out.exists():
            return out
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
        cmd = [nvcc(), "-gencode", "arch=compute_90a,code=sm_90a",
               "-std=c++17", "-O3", "-Xptxas", "-v", "-shared",
               "-Xcompiler", "-fPIC", "-o", str(tmp), str(self.source)]
        res = subprocess.run(cmd, capture_output=True, text=True)
        self.build_log = res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {self.source.name} "
                               f"({res.returncode}):\n{self.build_log}")
        os.replace(tmp, out)
        return out

    def load(self) -> ctypes.CDLL:
        with self._lock:
            if self._lib is None:
                lib = ctypes.CDLL(str(self.build()))
                self._declare(lib)
                self._lib = lib
            return self._lib
