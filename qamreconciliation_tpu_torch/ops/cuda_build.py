"""Build the package's CUDA sources with nvcc at first use, load with ctypes.

Each source under ``csrc/`` compiles to a shared library with a plain C
interface (no PyTorch headers, so a build takes seconds).  Libraries land in
``csrc/_build/`` keyed by a hash of the source text, the shared headers
(``csrc/*.cuh``) and the compiler flags, so an edited source or header is
rebuilt and an unchanged one is loaded as is.  Beside each library lies
ptxas's report of it (registers, shared memory and spills per kernel).
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

__all__ = ["CSRC_DIR", "BUILD_DIR", "NVCC_FLAGS", "build", "build_all",
           "load_library", "ptxas_report", "ptxas_usage", "cuda_tool",
           "sources"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = CSRC_DIR / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def cuda_tool(name: str) -> str:
    """The CUDA toolkit's ``name`` (nvcc, cuobjdump): on PATH, else under
    CUDA_HOME (default /usr/local/cuda)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    path = os.path.join(home, "bin", name)
    if not os.path.exists(path):
        raise RuntimeError(
            f"{name} not found on PATH or under CUDA_HOME; the CUDA kernels "
            "need the CUDA toolkit to build"
        )
    return path


def _nvcc() -> str:
    return cuda_tool("nvcc")


def _library_path(source: Path) -> Path:
    """The library of ``source``, keyed by its text, every ``*.cuh`` header
    beside it (a source may include any of them) and the flags."""
    h = hashlib.sha256(source.read_bytes())
    for header in sorted(source.parent.glob("*.cuh")):
        h.update(b"\0" + header.name.encode() + b"\0" + header.read_bytes())
    h.update("\0".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{source.stem}-{h.hexdigest()[:16]}.so"


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless its library exists; return its path.

    Raises RuntimeError with nvcc's output when the build fails.
    """
    source = CSRC_DIR / f"{name}.cu"
    lib = _library_path(source)
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent builder of the
    # same source never sees a half-written library
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
    os.close(fd)
    try:
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(source)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed to build {source.name} "
                f"(exit {proc.returncode}):\n{proc.stderr}{proc.stdout}"
            )
        _report_path(lib).write_text(proc.stderr + proc.stdout)
        os.replace(tmp, lib)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return lib


def sources() -> list[str]:
    """The names of the sources under ``csrc/`` (one library each)."""
    return sorted(p.stem for p in CSRC_DIR.glob("*.cu"))


def build_all(names=None) -> list[Path]:
    """Build ``names`` (default every source), one nvcc per source, all
    started together, and load each library; return their paths."""
    names = sources() if names is None else list(names)
    with concurrent.futures.ThreadPoolExecutor(len(names)) as pool:
        libs = list(pool.map(build, names))
    for name in names:
        load_library(name)
    return libs


def _report_path(lib: Path) -> Path:
    return lib.with_suffix(".ptxas.txt")


def ptxas_report(lib: Path) -> str:
    """ptxas's report of a built library (-Xptxas -v), or '' if the library
    was built without one."""
    path = _report_path(lib)
    return path.read_text() if path.exists() else ""


def ptxas_usage(report: str, key: str) -> dict:
    """``{"registers", "spill_stores", "spill_loads"}`` (bytes for the
    spills) of the kernel instance whose mangled name holds ``key`` in a
    ptxas report; raises KeyError when no instance matches."""
    lines = report.splitlines()
    for i, line in enumerate(lines):
        if "entry function" in line and key in line:
            rest = " ".join(lines[i + 1:i + 5])
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                              r"loads", rest)
            return {"registers": int(re.search(r"Used (\d+) registers",
                                               rest).group(1)),
                    "spill_stores": int(spill.group(1)),
                    "spill_loads": int(spill.group(2))}
    raise KeyError(f"no kernel instance {key!r} in the ptxas report")


@functools.lru_cache(maxsize=None)
def load_library(name: str) -> ctypes.CDLL:
    """Build (if needed) and load ``csrc/<name>.cu``'s library, once per
    process."""
    return ctypes.CDLL(str(build(name)))
