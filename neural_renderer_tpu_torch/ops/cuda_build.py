"""Build and load the package's CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` into its own shared library with
a plain C interface (no PyTorch headers, so a build takes seconds) and loaded
with `ctypes`. Libraries are built at first use into `csrc/build/` (listed in
`.gitignore`), named by a digest of their sources and flags so an edited
source never loads a stale build. `build()` starts one `nvcc` per source, all
at once.

Nothing here runs at import time: the package imports on machines without
`nvcc` or a GPU.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time

_CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc")
BUILD_DIR = os.path.join(_CSRC, "build")

# Library name -> source file. Headers (*.cuh) are shared by all of them.
SOURCES = {
    "sweep_stream": "sweep_stream.cu",
    "trace_dense": "trace_dense.cu",
    "lane_grid_forward": "lane_grid_forward.cu",
    "trace_cluster_stream": "trace_cluster_stream.cu",
    "sweep_dense": "sweep_dense.cu",
    "lane_grid_backward": "lane_grid_backward.cu",
    "fused_mlp": "fused_mlp.cu",
    "trace_dense_mxu": "trace_dense_mxu.cu",
    "sweep_stream_mxu": "sweep_stream_mxu.cu",
    "sweep_dense_mxu": "sweep_dense_mxu.cu",
    "trace_cluster_stream_mxu": "trace_cluster_stream_mxu.cu",
    "ablate_trace": "ablate_trace.cu",
    "ablate_sweep": "ablate_sweep.cu",
    "ablate_mxu_bf16": "ablate_mxu_bf16.cu",
    "sample_bounce": "sample_bounce.cu",
}

# -fmad=false: no multiply-add contraction, so the kernels round op by op
# exactly like their PyTorch twins (the trace kernels are held bit-exact).
# Kernels that want FMAs ask for them with __fmaf_rn explicitly.
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-fmad=false",
              "-Xptxas", "-v"]

_LIBS: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = os.path.join(home, "bin", "nvcc")
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (looked in $CUDA_HOME/bin and "
                           "PATH): the CUDA kernels cannot be built")
    return found


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    files = [SOURCES[name]] + sorted(
        f for f in os.listdir(_CSRC) if f.endswith(".cuh"))
    for f in files:
        with open(os.path.join(_CSRC, f), "rb") as fh:
            h.update(f.encode() + b"\0" + fh.read())
    return h.hexdigest()[:16]


def lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}-{_digest(name)}.so")


def build(names=None) -> dict:
    """Compile the named libraries (default: all) that are not built yet,
    one nvcc process per source, started together. Returns
    {name: {"seconds": s, "log": nvcc output}} for what was compiled; raises
    RuntimeError naming every library that failed."""
    names = list(SOURCES) if names is None else list(names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in names:
        out = lib_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-I", _CSRC, "-o", tmp,
               os.path.join(_CSRC, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    result, failed = {}, []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        result[name] = {"seconds": time.perf_counter() - t0, "log": log}
        if proc.returncode != 0:
            failed.append(f"{name} (rc {proc.returncode}):\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return result


def load(name: str) -> ctypes.CDLL:
    """The loaded library `name`, built first if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        path = lib_path(name)
        if not os.path.exists(path):
            build([name])
        lib = ctypes.CDLL(path)
        lib.nr_error_string.restype = ctypes.c_char_p
        lib.nr_error_string.argtypes = [ctypes.c_int]
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise when a C entry returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}: "
                           f"{lib.nr_error_string(rc).decode()}")


def check_operands(what: str, operands) -> None:
    """Raise unless every (name, tensor, dtype) is a contiguous CUDA tensor
    of that dtype: what a kernel's C entry takes."""
    for name, x, dt in operands:
        if not x.is_cuda or x.dtype != dt or not x.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous CUDA "
                             f"{dt} tensor")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream_of(t) -> ctypes.c_void_p:
    import torch
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)
