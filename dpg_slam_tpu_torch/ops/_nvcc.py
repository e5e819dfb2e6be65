"""Build of the hand-written CUDA kernels (csrc/*.cu), shared by their
wrappers.

Each source compiles with ``nvcc`` for sm_90a into a shared library with a
plain C entry point, bound with ctypes. The library is cached under
``build/kernels/`` by a hash of the source and flags, at first use. A
missing nvcc or a failed build raises. ``build_all`` starts one nvcc per
source together and waits for all of them.
"""

from __future__ import annotations

import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

__all__ = ["CSRC", "build", "build_all"]

CSRC = pathlib.Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = pathlib.Path(__file__).resolve().parents[2] / "build" / "kernels"
_NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _target(src: pathlib.Path) -> pathlib.Path:
    tag = hashlib.sha256(src.read_bytes() + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
    return _BUILD_DIR / f"{src.stem}_{tag}.so"


def build_all(sources: list[pathlib.Path]) -> list[pathlib.Path]:
    """Compile every source whose library of this exact source and flag set
    is missing, all nvcc processes at once; returns the library paths in
    the order of `sources`."""
    libs = [_target(s) for s in sources]
    jobs = []
    for src, lib in zip(sources, libs):
        if lib.exists():
            continue
        _BUILD_DIR.mkdir(parents=True, exist_ok=True)
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=_BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *_NVCC_FLAGS, "-o", tmp, str(src)]
        jobs.append((lib, tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    errors = []
    for lib, tmp, proc in jobs:
        _, stderr = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            errors.append(f"nvcc failed on {lib.name} ({proc.returncode}):\n{stderr}")
        else:
            os.replace(tmp, lib)
    if errors:
        raise RuntimeError("\n".join(errors))
    return libs


def build(src: pathlib.Path) -> pathlib.Path:
    """Compile one source (see build_all); returns its library path."""
    return build_all([src])[0]
