"""Build the package's host-side C++ helpers (`csrc/*.cpp`) at first use.

Same scheme as the CUDA kernels (`ops/cuda_build.py`): each source becomes
its own shared library under `csrc/build/` (listed in `.gitignore`), named
by a digest of the source and flags so an edited source never loads a stale
build. The helpers are optional accelerators with a Python fallback, so a
missing compiler returns None instead of raising.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import subprocess

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")


def ensure_native_lib(source: str, flags=("-O3",)) -> str | None:
    """Path of the shared library built from csrc/<source>, compiling it
    when missing. None when there is no host compiler or it fails."""
    src = os.path.join(_CSRC, source)
    try:
        with open(src, "rb") as fh:
            digest = hashlib.sha256(" ".join(flags).encode() + b"\0"
                                    + fh.read()).hexdigest()[:16]
    except OSError:
        return None
    stem = os.path.splitext(source)[0]
    lib = os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so")
    if os.path.exists(lib):
        return lib
    cxx = shutil.which("g++") or shutil.which("c++")
    if cxx is None:
        return None
    tmp = f"{lib}.{os.getpid()}.tmp"
    try:
        os.makedirs(BUILD_DIR, exist_ok=True)
        subprocess.run([cxx, *flags, "-fPIC", "-shared", "-std=c++17", src,
                        "-o", tmp], check=True, capture_output=True,
                       timeout=120)
        os.replace(tmp, lib)
    except (OSError, subprocess.SubprocessError):
        return None
    return lib
