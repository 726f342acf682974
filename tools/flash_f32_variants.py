"""Time variants of kernel 5's fp32 prefill, each built from the checkout's
``csrc/flash_attention.cu`` with one text substitution set, to see what
holds the register-tiled design.

    python3 tools/flash_f32_variants.py [NAME ...] [--sass]

Builds every named variant (all of ``VARIANTS`` by default) with the
library's own ``nvcc`` flags, one process each, started together, into
``build/flash_f32_variants/<name>/``; for each, checks the fp32 lane
against ``flash_attention_plain`` at small shapes at every head dim
(rtol = atol = 2e-5; skipped for the breakdown variants, whose outputs
are wrong by design) and times the fp32 prefill with CUDA events at
granite-3-2b's q (4, 4096, 8, 4, 64) and seamless's encoder's q (4, 4096,
16, 1, 64) (5 calls), llava-next-34b's q (4, 4096, 8, 7, 128) and
gemma-7b's q (4, 4096, 16, 1, 256) (3 calls), causal but the encoder.
Variants: ``base``; the breakdown ``no_s`` / ``no_pv`` (the S = Q K^T or
O += P V loop dropped) and ``no_barrier`` (the tile barrier dropped);
``blocks2`` (two blocks an SM: 32-key tiles at D = 64, 16 at 128, at most
128 registers), ``warps4`` (4-warp blocks, two an SM, D <= 128),
``stages3`` (a 3-stage ring, D <= 128), ``rows8`` (8 rows a lane, D <=
64), ``unroll2`` / ``unroll4`` (the S and P V loops unrolled by 2 or 4
instead of fully), ``rows8_unroll2``.  Prints each variant's registers
and spills, then one JSON object ``{"card": ..., "rows": {variant: {row:
ms}}}``.  With ``--sass``, also the base build's fp32 prefill main loop
(the longest backward branch) by instruction, from ``cuobjdump -sass``.
Exits non-zero without a card.
"""
import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CSRC = ROOT / "src" / "repro_torch" / "csrc"
OUT = ROOT / "build" / "flash_f32_variants"
KEYS = "  static constexpr int kKeys = D <= 64 ? 64 : (D == 128 ? 32 : 16);\n"
WARPS = "  static constexpr int kWarps = 8;\n"
STAGES = "  static constexpr int kStages = 2;\n"
ROWS = "  static constexpr int kTR = 4;  // rows a lane: rg + 4 i\n"
BOUNDS = "__launch_bounds__(F32Tile<D>::kThreads, 1)"
S_LOOP = "#pragma unroll\n    for (int c = 0; c < kDP; c += 4) {"
PV_LOOP = "#pragma unroll\n    for (int j = 0; j < kKeys; j += 4) {"
BARRIER = "    cp_async_wait<L::kStages - 2>();\n    __syncthreads();\n"


def unroll(n):
    return [(S_LOOP, S_LOOP.replace("unroll", f"unroll {n}")),
            (PV_LOOP, PV_LOOP.replace("unroll", f"unroll {n}"))]


#: name -> [(text in the source, its replacement)]
VARIANTS = {
    "base": [],
    "no_s": [(S_LOOP, S_LOOP.replace("c < kDP", "c < 0"))],
    "no_pv": [(PV_LOOP, PV_LOOP.replace("j < kKeys", "j < 0"))],
    "no_barrier": [(BARRIER, "    cp_async_wait<L::kStages - 2>();\n")],
    "blocks2": [(KEYS, "  static constexpr int kKeys = D <= 32 ? 64 : "
                 "D == 64 ? 32 : 16;\n"),
                (BOUNDS, "__launch_bounds__(F32Tile<D>::kThreads, "
                 "D <= 128 ? 2 : 1)")],
    "warps4": [(WARPS, "  static constexpr int kWarps = D <= 128 ? 4 : 8;\n"),
               (BOUNDS, "__launch_bounds__(F32Tile<D>::kThreads, "
                "D <= 128 ? 2 : 1)")],
    "stages3": [(KEYS + STAGES, KEYS + "  static constexpr int kStages = "
                 "D <= 128 ? 3 : 2;\n")],
    "rows8": [(ROWS, "  static constexpr int kTR = D <= 64 ? 8 : 4;\n")],
    "unroll2": unroll(2),
    "unroll4": unroll(4),
    "rows8_unroll2": [(ROWS, "  static constexpr int kTR = D <= 64 ? 8 : 4;"
                       "\n")] + unroll(2),
}
BREAKDOWN = ("no_s", "no_pv", "no_barrier")
#: row -> (B, Sq, Sk, H, G, D, causal, calls)
TIMED = {"granite prefill": (4, 4096, 4096, 8, 4, 64, True, 5),
         "seamless encoder": (4, 4096, 4096, 16, 1, 64, False, 5),
         "llava prefill": (4, 4096, 4096, 8, 7, 128, True, 3),
         "gemma prefill": (4, 4096, 4096, 16, 1, 256, True, 3)}


def build(name, nvcc, flags):
    d = OUT / name
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    src = (CSRC / "flash_attention.cu").read_text()
    for old, new in VARIANTS[name]:
        if old not in src:
            raise SystemExit(f"variant {name}: {old!r} is not in the source")
        src = src.replace(old, new)
    (d / "flash_attention.cu").write_text(src)
    shutil.copy(CSRC / "hopper.cuh", d)
    proc = subprocess.run([nvcc, *flags, "-o", str(d / "lib.so"),
                           str(d / "flash_attention.cu")],
                          capture_output=True, text=True)
    if proc.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{proc.stderr[-3000:]}")
    return d / "lib.so", proc.stdout + proc.stderr


def registers(log):
    """'D=<d>: <regs>r/<spill bytes>sp' per fp32 prefill entry."""
    out, lines = [], log.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"flash_prefill_f32_kernelILi(\d+)E", line)
        if m and "Compiling entry function" in line:
            info = " ".join(lines[i + 1:i + 4])
            r = re.search(r"Used (\d+) registers", info)
            sp = max(map(int, re.findall(r"(\d+) bytes spill", info)), default=0)
            out.append(f"D={m.group(1)}: {r.group(1) if r else '?'}r/{sp}sp")
    return " ".join(out)


def sass_mix(lib, nvcc):
    """The base build's fp32 prefill main loop by instruction, per D."""
    dump = subprocess.run([str(pathlib.Path(nvcc).parent / "cuobjdump"),
                           "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    funcs, cur = {}, None
    for line in dump.splitlines():
        if "Function :" in line:
            m = re.search(r"flash_prefill_f32_kernelILi(\d+)E", line)
            cur = m.group(1) if m else None
            if cur:
                funcs[cur] = []
        elif cur:
            m = re.search(r"/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                          r"([A-Z0-9_.]+)(.*)", line)
            if m:
                funcs[cur].append((int(m.group(1), 16), m.group(2),
                                   m.group(3)))
    for D, ins in sorted(funcs.items(), key=lambda x: int(x[0])):
        loops = []
        for a, op, rest in ins:
            t = re.search(r"0x([0-9a-f]+)", rest)
            if op.startswith("BRA") and t and int(t.group(1), 16) < a:
                loops.append((int(t.group(1), 16), a))
        lo, hi = max(loops, key=lambda x: x[1] - x[0])
        ops = [op.split(".")[0] + (".128" if ".128" in op else "")
               for a, op, _ in ins if lo <= a <= hi]
        ffma = ops.count("FFMA")
        print(f"SASS fp32 prefill D={D}: main loop {len(ops)} instructions, "
              f"FFMA {ffma} ({ffma / len(ops):.3f}), LDS.128 "
              f"{ops.count('LDS.128')}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("names", nargs="*", help="variants (default: all)")
    ap.add_argument("--sass", action="store_true",
                    help="print the base build's main loop by instruction")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("flash_f32_variants: no card")
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build
    from repro_torch.kernels import flash_attention as fa

    names = args.names or list(VARIANTS)
    nvcc = _build.find_nvcc()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(
            lambda n: build(n, nvcc, _build.NVCC_FLAGS), names)))
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)

    def ms(fn, calls):
        fn()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / calls

    rows = {}
    for name, (lib_path, log) in built.items():
        lib = ctypes.CDLL(str(lib_path))
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.flash_attention_ml.argtypes = (
            [p, p, p, p, p, i, i, i] + [ll] * 16
            + [p, p, i, i, ctypes.c_float, p, p, p])
        lib.flash_attention_ml.restype = i
        lib.flash_attention_error_string.argtypes = [i]
        lib.flash_attention_error_string.restype = ctypes.c_char_p
        fa.load_library = lambda lib=lib: lib
        print(f"{name}: {registers(log)}", flush=True)
        if name not in BREAKDOWN:
            for D in fa.HEAD_DIMS:
                q = torch.randn((2, 300, 2, 4, D), generator=gen, device=dev)
                k = torch.randn((2, 300, 2, D), generator=gen, device=dev)
                v = torch.randn((2, 300, 2, D), generator=gen, device=dev)
                got = fa.flash_attention(q, k, v, causal=True)
                want = fa.flash_attention_plain(q, k, v, causal=True)
                if not torch.allclose(got, want, rtol=2e-5, atol=2e-5):
                    raise SystemExit(f"variant {name} D={D}: max|kernel - "
                                     f"plain| {(got - want).abs().max()}")
        rows[name] = {}
        for row, (B, Sq, Sk, H, G, D, causal, calls) in TIMED.items():
            q = torch.randn((B, Sq, H, G, D), generator=gen, device=dev)
            k = torch.randn((B, Sk, H, D), generator=gen, device=dev)
            v = torch.randn((B, Sk, H, D), generator=gen, device=dev)
            rows[name][row] = ms(lambda: fa.flash_attention(
                q, k, v, causal=causal), calls)
            del q, k, v
        print("  " + " ".join(f"{r} {t:.4f}" for r, t in rows[name].items()),
              flush=True)
    if args.sass and "base" in built:
        sass_mix(built["base"][0], nvcc)
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rows": rows}))


if __name__ == "__main__":
    main()
