"""Build and load the port's host C++ libraries (the RLE kernels of
eval/native.py, the image decoders of data/native_image.py).

A library is compiled with the host's C++ compiler (`$CXX`, else `g++`,
else `c++`) into `build/maskrcnn_tpu_torch/` at the repository root,
named by a hash of every file the build reads (its `.cpp` sources, which
are compiled together, and the headers they include, listed beside
them) and of its flags, on first use, and loaded with ctypes. The build
goes through a temporary file and a rename, so processes building at
once never load a partial file.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path
from typing import Sequence

_REPO = Path(__file__).resolve().parent.parent.parent
BUILD_DIR = _REPO / "build" / "maskrcnn_tpu_torch"
CXX_FLAGS = ("-O2", "-shared", "-fPIC", "-std=c++17")


def compiler() -> str:
    """The C++ compiler a build runs."""
    return os.environ.get("CXX") or shutil.which("g++") or "c++"


def library_path(stem: str, sources: Sequence[Path],
                 flags: Sequence[str] = CXX_FLAGS) -> Path:
    """Where the library of `sources` (its .cpp files and the headers
    they include) built with `flags` lives."""
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in map(Path, sources):
        digest.update(f.name.encode() + b"\0")
        digest.update(f.read_bytes())
    return BUILD_DIR / f"lib{stem}_{digest.hexdigest()[:16]}.so"


def build(sources: Sequence[Path], path: Path,
          flags: Sequence[str] = CXX_FLAGS) -> None:
    """Compile the `.cpp` files of `sources` together to `path`; raises
    OSError or subprocess.SubprocessError when the compiler fails or is
    missing."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=BUILD_DIR, suffix=".so.tmp")
    os.close(fd)
    units = [str(f) for f in sources if Path(f).suffix != ".h"]
    try:
        subprocess.run([compiler(), *flags, "-o", tmp, *units],
                       check=True, capture_output=True, timeout=300)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def load(stem: str, sources: Sequence[Path],
         flags: Sequence[str] = CXX_FLAGS) -> ctypes.CDLL:
    """The library of `sources`, built first if it is not there."""
    path = library_path(stem, sources, flags)
    if not path.exists():
        build(sources, path, flags)
    return ctypes.CDLL(str(path))
