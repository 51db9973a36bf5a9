"""Build the host annotation library (``annotate.cc`` -> a shared library).

g++ compiles it at first use into ``native/_build/`` (listed in
.gitignore); the file name carries a hash of the source and the flags, so
an edited source rebuilds. Concurrent builders each write a file of their
own and rename it into place.
"""

from __future__ import annotations

import hashlib
import os
import subprocess
from pathlib import Path

HERE = Path(__file__).resolve().parent
SOURCE = HERE / "annotate.cc"
BUILD_DIR = HERE / "_build"
FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def library_path() -> Path:
    digest = hashlib.sha256(SOURCE.read_bytes() + " ".join(FLAGS).encode())
    return BUILD_DIR / f"libnsnative_{digest.hexdigest()[:16]}.so"


def build() -> Path:
    """The built library, compiled first when it does not exist."""
    lib = library_path()
    if lib.exists():
        return lib
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    subprocess.run(["g++", *FLAGS, "-o", str(tmp), str(SOURCE)], check=True)
    os.replace(tmp, lib)
    return lib


if __name__ == "__main__":
    print(build())
