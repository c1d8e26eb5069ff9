"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled with ``nvcc`` for ``sm_90a`` into one shared
library with a plain C interface, at first use, into ``dfgnn_tpu_torch/_build/``
(the sources are compiled on the machine with the card, never imported here).
Each wrapper module loads the library through :func:`library` and registers
the ``argtypes`` of its own functions.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas=-v")


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    return os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")


def build() -> tuple[Path, str]:
    """Compile every ``csrc/*.cu`` into one library in ``_build/``, unless built.

    The library's name carries a hash of all sources, headers and flags, so
    a stale build is never loaded.  The sources compile in parallel, one
    ``nvcc`` each; the library is linked under a temporary name and renamed,
    so a concurrent process never loads a half-written file.  Returns the
    library's path and the compiler's messages ('' when already built).
    """
    sources = sorted(CSRC.glob("*.cu"))
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cu*")):
        digest.update(path.name.encode() + path.read_bytes())
    lib = BUILD_DIR / f"libdfgnn_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return lib, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib.stem}.tmp{os.getpid()}"
    objs = [BUILD_DIR / f"{tag}.{src.stem}.o" for src in sources]
    procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    logs = [proc.communicate()[0] for proc in procs]
    tmp = BUILD_DIR / f"{tag}.so"
    try:
        for src, proc, log in zip(sources, procs, logs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed to build {src.name}:\n{log}")
        link = subprocess.run([_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc failed to link {lib.name}:\n{link.stderr}")
        os.replace(tmp, lib)
    finally:
        for path in (*objs, tmp):
            path.unlink(missing_ok=True)
    return lib, "".join(logs)


@functools.cache
def library() -> ctypes.CDLL:
    """The built library, loaded once per process."""
    lib = ctypes.CDLL(str(build()[0]))
    lib.dfgnn_cuda_error_string.argtypes = [ctypes.c_int]
    lib.dfgnn_cuda_error_string.restype = ctypes.c_char_p
    return lib


def raise_on(err: int, what: str) -> None:
    """Raises when a kernel's C entry point returned a CUDA error code."""
    if err != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + library().dfgnn_cuda_error_string(err).decode())
