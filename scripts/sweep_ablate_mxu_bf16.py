"""Design sweep of the trace-kernel ablation's bf16 matrix kernel
(neural_renderer_tpu_torch/csrc/ablate_mxu_bf16.cu: mxu_hi3, mxu_lo) on an
NVIDIA GPU.

Builds variants of the kernel's source, each the committed one with a few
text replacements (its constants, its prefilter rule), times each on the
ablation's workload (scripts/ablate_trace_kernel_torch.py: 262,144 rays x
9,216 triangles; CUDA events, best of 3 x `reps` launches, two rounds) and
says whether its outputs equal the committed kernel's bit for bit:

  committed     the kernel as it is
  dense_rule    csrc/mt_dense.cuh's rule (two bound multiplies, four
                compares a pair) in place of the centred one
  mt1, mt2      one or two 16-ray m-tiles a warp (committed: four)
  warps2, warps8  two or eight warps a CTA (committed: four)
  ctas8, ctas16   8 or 16 CTAs a SM before slicing (committed: 48)
  chunk4        4-n-tile chunks (committed: 8)
  floor         no prefilter and no epilogue: the staging and the products
                alone (its outputs are misses; a floor, not a kernel)

Usage: python scripts/sweep_ablate_mxu_bf16.py [--reps N]
Needs a CUDA device and nvcc; the variants build into the ignored
csrc/build/variants/.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "scripts"))

import torch  # noqa: E402

from neural_renderer_tpu_torch.ops import cuda_build, trace_pallas  # noqa: E402

CSRC = os.path.join(ROOT, "neural_renderer_tpu_torch", "csrc")
CENTRED = """  const float h = fabsf(det) * BM_RULE_H;
  const float xu = __fmaf_rn(2.0f, u_num, -det);
  const float xv = __fmaf_rn(2.0f, v_num, -det);
  return (fabsf(xu) < h) & (fabsf(xv) < h);"""
DENSE = """  const float lo = fabsf(det) * DF_LO, hi = fabsf(det) * DF_HI;
  const float wu = df_signed(u_num, det), wv = df_signed(v_num, det);
  return !((wu < lo) | (wu >= hi) | (wv < lo) | (wv >= hi));"""
INCLUDE = '#include "mt_mxu.cuh"'
VARIANTS = {
    "committed": [],
    "dense_rule": [(CENTRED, DENSE),
                   (INCLUDE, '#include "mt_dense.cuh"\n' + INCLUDE)],
    "mt1": [("#define BM_MT 4 ", "#define BM_MT 1 ")],
    "mt2": [("#define BM_MT 4 ", "#define BM_MT 2 ")],
    "warps2": [("#define BM_WARPS 4 ", "#define BM_WARPS 2 ")],
    "warps8": [("#define BM_WARPS 4 ", "#define BM_WARPS 8 ")],
    "ctas8": [("#define BM_CTAS_PER_SM 48 ", "#define BM_CTAS_PER_SM 8 ")],
    "ctas16": [("#define BM_CTAS_PER_SM 48 ", "#define BM_CTAS_PER_SM 16 ")],
    "chunk4": [("#define BM_CHUNK 8 ", "#define BM_CHUNK 4 ")],
    "floor": [(CENTRED, "  return false;")],
}


def build(out_dir: str) -> dict:
    """Each variant's source written and compiled (one nvcc each, all at
    once) with the package's flags: {name: library path}."""
    with open(os.path.join(CSRC, "ablate_mxu_bf16.cu")) as f:
        src = f.read()
    os.makedirs(out_dir, exist_ok=True)
    procs = {}
    for name, edits in VARIANTS.items():
        text = src
        for old, new in edits:
            if old not in text:
                raise RuntimeError(f"{name}: the source no longer has "
                                   f"{old!r}")
            text = text.replace(old, new)
        path = os.path.join(out_dir, f"ablate_mxu_bf16_{name}.cu")
        with open(path, "w") as f:
            f.write(text)
        lib = os.path.join(out_dir, f"libablate_mxu_bf16_{name}.so")
        procs[name] = (subprocess.Popen(
            [cuda_build._nvcc(), *cuda_build.NVCC_FLAGS, "-I", CSRC, "-o",
             lib, path], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True), lib)
    libs = {}
    for name, (proc, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{log}")
        regs = [int(w) for ln in log.splitlines() if "registers" in ln
                for w in [ln.split("Used ")[1].split()[0]]]
        print(f"{name}: at most {max(regs, default=0)} registers a thread",
              flush=True)
        libs[name] = lib
    return libs


def runner(lib, o, d, tp):
    """call(passes) -> [2, N] of the library's kernel on (o, d, tp), with
    the slices and scratch its `_shape` asks for."""
    n, ttot = o.shape[1], tp.shape[1]
    slices, words = ctypes.c_int(), ctypes.c_longlong()
    cuda_build.check(lib, lib.ablate_mxu_bf16_shape(
        n, ttot, ctypes.byref(slices), ctypes.byref(words)), "shape")
    feat = torch.empty(words.value, dtype=torch.float64, device=o.device)
    part = torch.empty((slices.value if slices.value > 1 else 0, 2, n),
                       device=o.device)
    out = torch.empty((2, n), device=o.device)
    p = cuda_build.ptr

    def call(passes):
        cuda_build.check(lib, lib.ablate_mxu_bf16(
            ctypes.c_int(passes), p(o), p(d), ctypes.c_int(n), p(tp),
            ctypes.c_int(ttot), slices, p(feat), p(part), p(out),
            cuda_build.stream_of(o)), "ablate_mxu_bf16")
        return out

    return call, slices.value


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    reps = int(argv[argv.index("--reps") + 1]) if "--reps" in argv else 8
    if not torch.cuda.is_available():
        print("sweep_ablate_mxu_bf16: needs a CUDA device", file=sys.stderr)
        return 2
    import ablate_trace_kernel_torch as ablate
    print(ablate.card(), flush=True)
    libs = build(os.path.join(cuda_build.BUILD_DIR, "variants"))
    o, d, tris = ablate.trace_workload(9216, 262144, "cuda")
    tp = ablate.padded(tris, trace_pallas.TRI_TILE)
    calls = {}
    for name, path in libs.items():
        lib = ctypes.CDLL(path)
        lib.nr_error_string.restype = ctypes.c_char_p
        calls[name] = runner(lib, o, d, tp)
    ref = {p: calls["committed"][0](p).clone() for p in (3, 1)}
    for rnd in range(2):
        for name, (call, slices) in calls.items():
            line = [f"round {rnd} {name:10s} slices {slices}"]
            for passes, label in ((3, "mxu_hi3"), (1, "mxu_lo")):
                same = torch.equal(call(passes), ref[passes])
                ms = ablate.timed(lambda: call(passes), reps)
                line.append(f"{label} {ms:.4f} ms, equal {same}")
            print("  ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
