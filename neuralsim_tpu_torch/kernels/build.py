"""Build and load the port's CUDA kernels.

Each ``csrc/*.cu`` source compiles with ``nvcc`` into a shared library with
a plain C interface, loaded with ctypes. The build happens at first use, on
the machine with the card, into ``kernels/_build/`` (listed in .gitignore);
the library's file name carries a hash of the source, of every
``csrc/*.cuh`` header it includes and of the flags, so an edited source or
header rebuilds. A failed build raises: nothing falls back.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Tuple

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
# --split-compile=0: optimise a source's kernels on every core of the host
# (the same code and spills; nerf_mlp.cu built in 59 s against 132 s on the
# card's 8-core machine)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "--split-compile=0")
SOURCES = ("nerf_march", "nerf_mlp", "render_tile", "ngp_march")
_INCLUDE = re.compile(r'^\s*#\s*include\s+"([^"]+)"', re.M)


def nvcc_path() -> str:
    for cand in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if cand and os.path.exists(os.path.join(cand, "bin", "nvcc")):
            return os.path.join(cand, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                           "machine with the CUDA toolkit")
    return found


def headers(path: Path) -> list[Path]:
    """The ``csrc`` headers that ``path`` includes, directly or through
    another header, in the order first met."""
    found: list[Path] = []
    todo = [path]
    while todo:
        for inc in _INCLUDE.findall(todo.pop().read_text()):
            dep = CSRC / inc
            if dep.exists() and dep not in found:
                found.append(dep)
                todo.append(dep)
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes())
    for dep in headers(src):
        digest.update(dep.name.encode() + dep.read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{digest.hexdigest()[:16]}.so"


def build_all(names: Iterable[str] = SOURCES) -> Dict[str, Tuple[Path, float, str]]:
    """Compile each ``csrc/{name}.cu`` whose current build does not exist,
    one nvcc process per source, all started together.

    Returns {name: (library path, build seconds, ptxas report)}; seconds is
    0.0 and the report empty when the library was already built."""
    out: Dict[str, Tuple[Path, float, str]] = {}
    running = {}
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            out[name] = (lib, 0.0, "")
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        running[name] = (lib, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    failed = []
    for name, (lib, tmp, proc) in running.items():
        stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {name}.cu:\n{stdout}\n{stderr}")
            continue
        os.replace(tmp, lib)
        out[name] = (lib, time.perf_counter() - t0, stderr)
    if failed:
        raise RuntimeError("\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/{name}.cu`` (built at first use)."""
    path, _, _ = build_all([name])[name]
    return ctypes.CDLL(str(path))
