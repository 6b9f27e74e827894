"""Build and load the port's native sources (``bigsi_tpu_torch/csrc``).

At first use, a compiler (``nvcc`` for the CUDA sources, the host C++
compiler for ``host_native.cpp``) builds a source into a shared library
with a plain C interface under ``build/bigsi_tpu_torch/`` at the root of
the checkout, and ``ctypes`` loads it.  The library's file name carries
a hash of the source and the flags, so an edited source is rebuilt and a
built one is reused.  Nothing here runs at import: the CPU tests import
every module of the package on a machine without ``nvcc``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "bigsi_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    """Path of the CUDA compiler: ``nvcc`` on PATH, else under CUDA_HOME."""
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and os.path.exists(os.path.join(CUDA_HOME, "bin", "nvcc")):
        return os.path.join(CUDA_HOME, "bin", "nvcc")
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of bigsi_tpu_torch need the CUDA "
        "toolkit (put nvcc on PATH or set CUDA_HOME)"
    )


def library_path(source: str, flags=NVCC_FLAGS) -> Path:
    text = (CSRC / source).read_bytes() + " ".join(flags).encode()
    digest = hashlib.sha256(text).hexdigest()[:16]
    return BUILD_DIR / ("%s-%s.so" % (Path(source).stem, digest))


def compile_source(source: str, out: Path, compiler: str | None = None,
                   flags=NVCC_FLAGS) -> None:
    """Compile ``csrc/<source>`` into the library ``out`` (by default
    with nvcc and NVCC_FLAGS)."""
    out.parent.mkdir(parents=True, exist_ok=True)
    compiler = compiler or nvcc()
    cmd = [compiler, *flags, "-o", str(out), str(CSRC / source)]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(
            "%s failed on %s (exit %d):\n%s"
            % (Path(compiler).name, source, proc.returncode, proc.stderr)
        )


def build(source: str, compiler: str | None = None, flags=NVCC_FLAGS) -> Path:
    """Compile ``csrc/<source>`` unless its library is already built."""
    out = library_path(source, flags)
    if out.exists():
        return out
    # a private name, then an atomic rename: concurrent builders never
    # load a half-written library
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    compile_source(source, tmp, compiler, flags)
    os.replace(tmp, out)
    return out


def load(source: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<source>``, built at first use."""
    with _lock:
        lib = _loaded.get(source)
        if lib is None:
            lib = _loaded[source] = ctypes.CDLL(str(build(source)))
        return lib
