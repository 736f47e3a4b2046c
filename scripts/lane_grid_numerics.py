"""Numerics of the lane-grid backward kernel's tensor-core sums (K6).

    python scripts/lane_grid_numerics.py          # on a GPU: both parts
    python scripts/lane_grid_numerics.py --cpu    # part 2 only, on the CPU

csrc/lane_grid_backward.cu takes every sum that is rounded to bf16 or
decides a mask from mma.sync, and sums it again exactly where the interval
c +- LB_TOL x sum|products| does not decide the result. This script
measures both sides of that rule:

1. (GPU) the accumulation error of mma.sync.m16n8k16 (bf16 x bf16 -> f32)
   over K = 128, the kernels' depth: a one-warp-per-tile probe, built with
   nvcc into neural_renderer_tpu_torch/csrc/build/, sums 6 x 16,384 x 128
   dot products of bf16 operands spread over 2^-12..2^4 (every other batch
   LeakyReLU'd); prints max |c - exact| / sum|products| beside LB_TOL, the
   share of sums that are not the exact sum rounded to f32, and how many
   of PyTorch's f32 products (`torch.matmul`, cuBLAS with TF32 off) differ
   from a sequential f32 sum of the same products;
2. the re-sum rates: the share of elements whose bf16 rounding, mask or
   table contribution the LB_TOL interval around the exact sum leaves
   undecided, per layer of the forward recompute, the delta chain and
   d_enc (any of a feature's 8 corners), for the knot's 48k-step weights
   and a seeded network, with its tables x 1e3 and as initialised (the
   trainer's start), on 8,192 random rays under a random cotangent.
Needs no JAX.
"""

from __future__ import annotations

import argparse
import ctypes
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(ROOT, "neural_renderer_tpu_torch", "csrc")

PROBE = r"""
#include <stdint.h>
#include <cuda_runtime.h>
// C tile (16 x 8) of A [M, 128] x B [N, 128]^T, bf16, one warp per tile.
__global__ void probe(const uint32_t* A, const uint32_t* B, int M, int N,
                      float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, tig = lane & 3;
  const int tile = blockIdx.x * (blockDim.x / 32) + (threadIdx.x >> 5);
  const int tm = tile / (N / 8), tj = tile % (N / 8);
  if (tm * 16 >= M) return;
  float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  const uint32_t* a0 = A + (tm * 16 + g) * 64;
  const uint32_t* a1 = A + (tm * 16 + g + 8) * 64;
  const uint32_t* b0 = B + (tj * 8 + g) * 64;
  for (int kt = 0; kt < 8; ++kt) {
    const uint32_t a[4] = {a0[kt * 8 + tig], a1[kt * 8 + tig],
                           a0[kt * 8 + 4 + tig], a1[kt * 8 + 4 + tig]};
    asm volatile(
        "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
        "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
        : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0[kt * 8 + tig]),
          "r"(b0[kt * 8 + 4 + tig]));
  }
  const int r = tm * 16 + g, col = tj * 8 + tig * 2;
  out[r * N + col] = c[0];
  out[r * N + col + 1] = c[1];
  out[(r + 8) * N + col] = c[2];
  out[(r + 8) * N + col + 1] = c[3];
}
extern "C" int run(const uint32_t* A, const uint32_t* B, int M, int N,
                   float* out) {
  const int tiles = (M / 16) * (N / 8);
  probe<<<(tiles + 7) / 8, 256>>>(A, B, M, N, out);
  return (int)cudaDeviceSynchronize();
}
"""


def lb_tol() -> float:
    with open(os.path.join(CSRC, "lane_grid_backward.cu")) as f:
        m = re.search(r"#define LB_TOL ([0-9.e+-]+)f", f.read())
    return float(m.group(1))


def mma_error(torch):
    from neural_renderer_tpu_torch.ops import cuda_build
    build = cuda_build.BUILD_DIR
    os.makedirs(build, exist_ok=True)
    src = os.path.join(build, "mma_probe.cu")
    lib_path = os.path.join(build, "libmma_probe.so")
    with open(src, "w") as f:
        f.write(PROBE)
    subprocess.run([cuda_build._nvcc(), "-gencode",
                    "arch=compute_90a,code=sm_90a", "-O3", "-shared",
                    "-Xcompiler", "-fPIC", "-o", lib_path, src], check=True)
    lib = ctypes.CDLL(lib_path)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    worst = 0.0
    m, n = 16384, 128
    for batch in range(6):
        a = torch.randn(m, 128, generator=gen, device=dev) * torch.exp2(
            torch.randint(-12, 4, (m, 128), generator=gen,
                          device=dev).float())
        if batch % 2:
            a = torch.nn.functional.leaky_relu(a, 0.01)
        a = a.to(torch.bfloat16)
        b = (torch.randn(n, 128, generator=gen, device=dev) * torch.exp2(
            torch.randint(-8, 2, (n, 128), generator=gen,
                          device=dev).float())).to(torch.bfloat16)
        out = torch.empty(m, n, device=dev)
        rc = lib.run(ctypes.c_void_p(a.data_ptr()),
                     ctypes.c_void_p(b.data_ptr()), ctypes.c_int(m),
                     ctypes.c_int(n), ctypes.c_void_p(out.data_ptr()))
        if rc != 0:
            raise RuntimeError(f"probe: CUDA error {rc}")
        exact = a.double() @ b.double().T
        scale = (a.double().abs() @ b.double().abs().T).clamp_min(1e-300)
        ratio = ((out.double() - exact).abs() / scale).max().item()
        worst = max(worst, ratio)
        # The f32 matmul the twins ran before their sums were exact.
        f32 = a.float() @ b.float().T
        seq = torch.zeros_like(f32)
        for i in range(128):
            seq = seq + a[:, i:i + 1].float() * b[:, i].float()[None, :]
        print(f"batch {batch}: max |c - exact| / sum|p| = {ratio:.4g}; "
              f"c is not the rounded exact sum in "
              f"{(out != exact.float()).double().mean().item():.4f}; "
              f"torch.matmul in f32 differs from a sequential f32 sum in "
              f"{int((f32 != seq).sum())} of {f32.numel()}")
    print(f"mma.sync over K = 128: worst {worst:.4g} (log2 "
          f"{torch.log2(torch.tensor(worst)).item():.2f}); LB_TOL "
          f"{lb_tol():.4g} ({torch.cuda.get_device_name(0)})")


def resum_rates(torch, dev):
    from neural_renderer_tpu_torch.models import convert, nbvh
    from neural_renderer_tpu_torch.ops import lane_grid_kernel
    tol = lb_tol()

    def bf16(t):
        return t.to(torch.bfloat16).to(torch.float64)

    def rates(net, x, cot):
        w = [m.to(torch.float64) for m in
             lane_grid_kernel.pack_lane_weights(net)]
        h = bf16(torch.nn.functional.pad(nbvh.encode_inputs(net, x),
                                         (0, 16)))

        def act(v):
            return bf16(torch.where(v > 0, v, 0.01 * v).float())

        fwd, masks = [], []
        for wl in w[:-1]:
            a = (h @ wl.T).float()
            e = tol * (h.abs() @ wl.abs().T).float()
            open_ = (act(a - e) != act(a + e)) | ((a - e > 0) != (a + e > 0))
            fwd.append(open_.double().mean().item())
            masks.append(a > 0)
            h = act(a)
        d = bf16(cot.T)
        dl = []
        for li, wl in [(3, w[4])] + [(k - 1, w[k]) for k in (3, 2, 1)]:
            s = (d @ wl).float()
            e = tol * (d.abs() @ wl.abs()).float()

            def delta(v):
                return bf16(torch.where(masks[li], v, 0.01 * v))
            dl.append((delta(s - e) != delta(s + e)).double().mean().item())
            d = delta(s)
        feats = net.config.point_count * net.config.n_levels * 4
        s = (d @ w[0]).float()[:, :feats]
        e = tol * (d.abs() @ w[0].abs()).float()[:, :feats]
        wc = torch.rand((s.shape[0], feats, 8), device=dev,
                        generator=torch.Generator(device=dev).manual_seed(5))
        lo = ((s - e)[..., None] * wc).to(torch.bfloat16)
        hi = ((s + e)[..., None] * wc).to(torch.bfloat16)
        enc = (lo != hi).any(-1).double().mean().item()
        return fwd, dl, enc

    n = 8192
    gen = torch.Generator(device=dev).manual_seed(4)
    x = torch.rand((12, n), generator=gen, device=dev)
    cot = torch.randn((16, n), generator=gen, device=dev)
    cfg = nbvh.NbvhConfig(lane_sublanes=16, lane_entry_pack=2)
    fresh = nbvh.init_params(cfg, torch.Generator().manual_seed(0), dev)
    seeded = nbvh.init_params(cfg, torch.Generator().manual_seed(0), dev)
    with torch.no_grad():
        seeded.lane.mul_(1e3)
    knot = convert.params_from_numpy(convert.load_params_npz(os.path.join(
        ROOT, "configs", "knot", "lane_step48000.npz")), cfg, device=dev)
    print(f"LB_TOL {tol:.4g}: share of elements summed again exactly")
    for label, net in (("knot 48k-step", knot), ("seeded x1e3", seeded),
                       ("seeded, as initialised", fresh)):
        fwd, dl, enc = rates(net, x, cot)
        print(f"  {label}: forward layers "
              + ", ".join(f"{v:.4f}" for v in fwd) + "; delta layers "
              + ", ".join(f"{v:.4f}" for v in dl)
              + f"; d_enc features {enc:.4f}")


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--cpu", action="store_true",
                    help="only the re-sum rates, on the CPU")
    args = ap.parse_args()
    sys.path.insert(0, ROOT)
    import torch
    torch.set_num_threads(min(8, os.cpu_count() or 1))
    torch.backends.cuda.matmul.allow_tf32 = False
    if args.cpu:
        resum_rates(torch, torch.device("cpu"))
        return 0
    if not torch.cuda.is_available():
        print("lane_grid_numerics: no CUDA device (use --cpu for part 2)",
              file=sys.stderr)
        return 2
    mma_error(torch)
    resum_rates(torch, torch.device("cuda"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
