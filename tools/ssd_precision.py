"""How far kernel 4's (the TrIM-SSD scan's) fp32 lane lies from float64.

    python3 tools/ssd_precision.py --src <checkout>/src [--seeds 0,1,2,3]

Imports ``repro_torch`` from ``--src`` (so the same script reads the parent
commit's kernel and this one's) and, on the card with TF32 off, calls
``trim_ssd`` in fp32 at the card tests' SSD cases wider than one tile
(P 96-200, S 192-256) and at mamba2-130m's P = 64, S = 128, with B/C of
one group expanded over the heads and per head, on the tests' own seed
(crc32 of the case) and on each of ``--seeds``: inputs in
``tests/test_ssd_kernel.py``'s ranges, made with numpy.  For each it
gives max|kernel - plain| and whether ``torch.testing.assert_close`` at
2e-5 holds, max|kernel - float64| and max|plain - float64| (the plain
version, ``nn.mamba.ssd_chunked``, run in float64 on the card).

It also probes how one ``mma.sync`` m16n8k8 TF32 MMA adds its product to
an fp32 accumulator: c = +-1 plus a product of 0.75 or -0.125 units in
the last place of 1, against the CUDA cores' ``__fadd_rn``.  Truncation
shows as 1 where round to nearest gives 1 + 2^-23, and 1 - 2^-24 where it
gives 1.  The probe's source is compiled with ``nvcc`` into the checkout's
``build/``.

Prints one JSON object, ``{"card", "torch", "cases": [...], "mma":
[...]}``; exits non-zero without a card.
"""
import argparse
import ctypes
import json
import pathlib
import subprocess
import sys
import zlib

import numpy as np
import torch

CASES = [
    (1, 300, 2, 128, 128, 256), (1, 130, 3, 96, 192, 64),
    (2, 65, 2, 200, 256, 64), (1, 4096, 2, 64, 128, 256),
    (2, 100, 3, 64, 128, 64),
]

PROBE = r"""
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void mma_probe(const float* v, float* out) {
  // lane 0 holds A[0][0], B[0][0] and C[0][0]; every other element is 0
  const bool l0 = threadIdx.x == 0;
  uint32_t a[4] = {l0 ? __float_as_uint(v[0]) : 0u, 0u, 0u, 0u};
  uint32_t b[2] = {l0 ? __float_as_uint(v[1]) : 0u, 0u};
  float c[4] = {l0 ? v[2] : 0.0f, 0.0f, 0.0f, 0.0f};
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  if (l0) {
    out[0] = c[0];
    out[1] = __fadd_rn(v[2], __fmul_rn(v[0], v[1]));
  }
}

extern "C" int run_probe(const float* host_v, float* host_out) {
  float *v, *out;
  cudaMalloc(&v, 3 * sizeof(float));
  cudaMalloc(&out, 2 * sizeof(float));
  cudaMemcpy(v, host_v, 3 * sizeof(float), cudaMemcpyHostToDevice);
  mma_probe<<<1, 32>>>(v, out);
  cudaMemcpy(host_out, out, 2 * sizeof(float), cudaMemcpyDeviceToHost);
  cudaFree(v);
  cudaFree(out);
  return static_cast<int>(cudaGetLastError());
}
"""


def mma_probe(build_dir: pathlib.Path, nvcc: str) -> list:
    build_dir.mkdir(parents=True, exist_ok=True)
    src, lib = build_dir / "mma_probe.cu", build_dir / "mma_probe.so"
    src.write_text(PROBE)
    subprocess.run([nvcc, "-O3", "-arch=sm_90a", "-shared", "-Xcompiler",
                    "-fPIC", "-o", str(lib), str(src)], check=True)
    dll = ctypes.CDLL(str(lib))
    f3, f2 = ctypes.c_float * 3, ctypes.c_float * 2
    rows = []
    for c in (1.0, -1.0):
        for units in (0.75, -0.125):
            # a b = units x 2^-23, c's unit in the last place
            v, out = f3(2.0 ** -12, units * 2.0 ** -11, c), f2()
            if dll.run_probe(v, out) != 0:
                sys.exit("ssd_precision: the MMA probe failed to launch")
            exact = c + units * 2.0 ** -23
            rows.append({"c": c, "product_ulps": units, "exact": exact,
                         "mma": out[0], "fadd_rn": out[1]})
    return rows


def inputs(case, seed, shared, dev):
    B, L, H, P, S, _ = case
    rng = np.random.default_rng(seed)
    f = lambda v: torch.from_numpy(np.asarray(v, np.float32)).to(dev)
    x = f(rng.normal(size=(B, L, H * P + 8)))[..., 8:].view(B, L, H, P)
    dt = f(rng.uniform(1e-3, 0.1, (B, L, H)))
    A = f(-rng.uniform(0.3, 2, (H,)))
    G = 1 if shared else H
    Bm = f(rng.normal(size=(B, L, G, S))).expand(B, L, H, S)
    Cm = f(rng.normal(size=(B, L, G, S))).expand(B, L, H, S)
    D = f(rng.normal(size=(H,)))
    return x, dt, A, Bm, Cm, D


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to read")
    ap.add_argument("--seeds", default="0,1,2,3")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("ssd_precision: no card (torch.cuda.is_available() is "
                 "false)")
    sys.path.insert(0, args.src)
    from repro_torch.kernels import _build
    from repro_torch.kernels import trim_ssd as ks
    from repro_torch.nn.mamba import ssd_chunked

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    rows = []
    for case in CASES:
        for shared in (True, False):
            for seed in [zlib.crc32(str(case).encode())] + seeds:
                a = inputs(case, seed, shared, dev)
                got = ks.trim_ssd(*a, chunk=case[5])
                want = ks.trim_ssd_plain(*a, chunk=case[5])
                y64, _ = ssd_chunked(*(t.double() for t in a),
                                     chunk=case[5],
                                     score_dtype=torch.float64)
                try:
                    torch.testing.assert_close(got, want, rtol=2e-5,
                                               atol=2e-5)
                    ok = True
                except AssertionError:
                    ok = False
                rows.append({
                    "case": case, "shared": shared, "seed": seed,
                    "kernel_plain": (got - want).abs().max().item(),
                    "within_2e-5": ok,
                    "kernel_f64": (got.double() - y64).abs().max().item(),
                    "plain_f64": (want.double() - y64).abs().max().item(),
                    "max_abs_y": y64.abs().max().item()})
    root = pathlib.Path(args.src).resolve().parent
    print(json.dumps({
        "card": torch.cuda.get_device_name(0), "torch": torch.__version__,
        "cases": rows,
        "mma": mma_probe(root / "build" / "ssd_precision",
                         _build.find_nvcc())}))


if __name__ == "__main__":
    main()
