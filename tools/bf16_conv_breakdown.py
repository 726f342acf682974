"""Where the bf16 wgmma kernels' time goes, on the card.

    python3 tools/bf16_conv_breakdown.py [--batch 8] [--reps 20]

Builds four variants of each of the two bf16 window kernels from the
sources in ``src/repro_torch/csrc`` into ``build/breakdown/`` (one
``nvcc`` each, started together): as they are ("base"), with the A
fragments' ``ldmatrix`` loads replaced by a register op ("no_ld"), with
the ``wgmma`` products replaced by one ("no_mma"), and with both
("no_ld_no_mma": the TMA ring, the barriers, the loop and the epilogue
alone), and times each on the card at VGG-16's CL2, CL4, CL6, CL9 and
CL13 at batch ``--batch`` through the C entries the wrappers call, with
the geometry the planners give (CUDA events over ``--reps`` calls after
a warm one).  The variants compute garbage; they only time the parts.
Prints one JSON object: ``{"card": ..., "rows": {"<kernel> <layer>":
{variant: ms}}}``.  Fails if an anchor it replaces is no longer in the
sources.
"""
import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "breakdown"

# (source, the A loads, their stand-in, the products, their stand-in)
KERNELS = {
    "wgrad": ("trim_conv2d_wgrad.cu",
              "    ldsm_x4_t(af[j], wb + (wp << 7) + (((unit ^ wp) & 7) << 4));",
              "    af[j][0] = af[j][1] = af[j][2] = af[j][3] = wp + unit;",
              "    wgmma_rs_m64n64(acc[j], af[j], db + (s * 16 * 128 >> 4));",
              "    acc[j][j] += __uint_as_float(af[j][0] ^ af[j][3] ^ "
              "static_cast<uint32_t>(db));"),
    "fwd": ("trim_conv2d.cu",
            "  for (int k = 0; k < 4; ++k) ldsm_x4(af[k], row + (((2 * k + uhi)"
            " ^ sw) << 4));",
            "  for (int k = 0; k < 4; ++k) af[k][0] = af[k][1] = af[k][2] = "
            "af[k][3] = row + k + uhi + sw;",
            "  for (int k = 0; k < 4; ++k) bwc_mma<kFb>(acc, af[k], db + (k * "
            "16 * 128 >> 4));",
            "  for (int k = 0; k < 4; ++k) acc[k] += __uint_as_float(af[k][0] "
            "^ af[k][3] ^ static_cast<uint32_t>(db));"),
}
VARIANTS = ("base", "no_ld", "no_mma", "no_ld_no_mma")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    from repro_torch.core.model import VGG16_LAYERS
    from repro_torch.kernels import _build
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.kernels import trim_conv2d_vjp as vjp

    if not torch.cuda.is_available():
        sys.exit("bf16_conv_breakdown: no card")
    OUT.mkdir(parents=True, exist_ok=True)
    nvcc = _build.find_nvcc()
    procs = {}
    for name, (src, ld, ld_rep, mma, mma_rep) in KERNELS.items():
        text = (CSRC / src).read_text()
        if ld not in text or mma not in text:
            sys.exit(f"bf16_conv_breakdown: an anchor is gone from {src}")
        for v in VARIANTS:
            body = text.replace(ld, ld_rep) if "no_ld" in v else text
            body = body.replace(mma, mma_rep) if "no_mma" in v else body
            cu = OUT / f"{name}_{v}.cu"
            cu.write_text(body)
            so = OUT / f"{name}_{v}.so"
            procs[(name, v)] = (so, subprocess.Popen(
                [nvcc, *_build.NVCC_FLAGS, "-I", str(CSRC), "-o", str(so),
                 str(cu)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True))
    libs = {}
    p, i = ctypes.c_void_p, ctypes.c_int
    for key, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            sys.exit(f"bf16_conv_breakdown: nvcc failed on {key}: "
                     f"{out[-2000:]}")
        lib = ctypes.CDLL(str(so))
        if key[0] == "wgrad":
            lib.trim_conv2d_wgrad_bf16.argtypes = [p] * 4 + [i] * 17 + [p]
        else:
            lib.trim_conv2d_bf16.argtypes = [p] * 5 + [i] * 19 + [p]
        libs[key] = lib

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream

    def ms(fn) -> float:
        if fn() != 0:
            sys.exit("bf16_conv_breakdown: a launch failed")
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(args.reps):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / args.reps

    N, rows = args.batch, {}
    for l in [VGG16_LAYERS[j] for j in (1, 3, 5, 8, 12)]:
        C, F = l.M, l.N
        x = torch.randn((N, l.H_I, l.W_I, C), generator=gen,
                        device=dev).bfloat16()
        g = torch.randn((N, l.H_O, l.W_O, F), generator=gen,
                        device=dev).bfloat16()
        w = (torch.randn((3, 3, C, F), generator=gen, device=dev)
             * 0.05).bfloat16()
        out = torch.empty((N, l.H_O, l.W_O, F), device=dev,
                          dtype=torch.bfloat16)
        t = vjp.wgrad_bf16_tile(tuple(x.shape), 3, F, stride=1, padding=1)
        dw = torch.empty((3, 3, C, F), device=dev)
        ws = torch.empty((t.n_part, 3, 3, C, F), device=dev)
        t1, a1 = kern.bf16_launch_args(tuple(x.shape), 3, F, 1, 1)
        for v in VARIANTS:
            lw, lf = libs[("wgrad", v)], libs[("fwd", v)]
            rows.setdefault(f"wgrad {l.name}", {})[v] = ms(
                lambda: lw.trim_conv2d_wgrad_bf16(
                    x.data_ptr(), g.data_ptr(), dw.data_ptr(), ws.data_ptr(),
                    N, l.H_I, l.W_I, C, 3, F, l.H_O, l.W_O, 1, 1, t.path,
                    t.TH, t.TW, t.stages, t.n_split, t.cluster, t.smem_bytes,
                    stream))
            rows.setdefault(f"fwd {l.name}", {})[v] = ms(
                lambda: lf.trim_conv2d_bf16(
                    x.data_ptr(), w.data_ptr(), None, out.data_ptr(), None,
                    *a1, 0, 1, t1.smem_bytes, stream))
    print(json.dumps({"card": torch.cuda.get_device_name(0), "batch": N,
                      "rows": rows}))


if __name__ == "__main__":
    main()
