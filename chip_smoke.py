#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # every phase; needs one sm_90 card
    python3 chip_smoke.py --kernels  # environment, build and kernel phases

Phases (any failure exits non-zero and prints no result line):

1. environment: CUDA available, compute capability (9, 0), the card's
   name and power limit from ``nvidia-smi``;
2. build: compile the CUDA kernel library from the sources in the
   checkout (``repro_torch/csrc``) and load it;
3. kernels: the TrIM conv kernel against its plain PyTorch version on the
   card, at the 13 VGG-16 conv shapes (batch 1) on the float lane
   (bias+ReLU) and the int8 lane (ReLU+requant; ReLU into raw int32 on
   the last layer), plus AlexNet CL1 (K=11, S=4, p=0) and CL2 (K=5,
   groups=2).  Float within rtol 1e-4 / atol 1e-4 * max|plain|, int8 bit
   for bit.  Per shape: kernel ms, plain ms, ``F.conv2d`` ms (cuDNN,
   TF32 off, float shapes only, a yardstick the port never calls) and the
   bound max(operations / peak, bytes / 3.35 TB/s);
4. serve float: full-width VGG-16 (224x224x3, 13 convs, 4096-4096-1000
   head, seeded random weights) through ``repro_torch.serve.Server`` with
   buckets 1,4,8 on a bursts stream: conservation, build-once, every conv
   of every flush launched on the kernel, bucketed == unbatched bit for
   bit, logits close to the oracle substrate on the card;
5. serve int8: the same on the calibrated int8 lane; features bit-equal
   to the oracle substrate on the card.

Then a ``{"kernels": [...]}`` JSON line, the ``nvidia-smi`` name/power
line, and last ``{"ok": true, "device": {...}}``.
"""
import argparse
import json
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

#: H100 SXM peaks (NVIDIA data sheet, dense): fp32 on the CUDA cores,
#: int8 on the tensor cores, and HBM3 bandwidth.
PEAK_FP32 = 67e12
PEAK_INT8 = 1979e12
PEAK_BYTES = 3.35e12
KERNEL_SOURCE = "src/repro_torch/csrc/trim_conv2d.cu"
REPLACES = "src/repro/kernels/trim_conv2d.py:283"


def fail(msg: str) -> None:
    print(f"[chip_smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def phase_environment(torch):
    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is false: this smoke needs a GPU")
    cap = torch.cuda.get_device_capability(0)
    if cap != (9, 0):
        fail(f"compute capability {cap}: the kernels are built for sm_90a")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    log(f"torch {torch.__version__} cuda {torch.version.cuda}, "
        f"{torch.cuda.get_device_name(0)}, capability {cap}")
    log(f"card: {card}")
    return card


def phase_build():
    from repro_torch.kernels import _build
    from repro_torch.kernels import trim_conv2d as kern

    t0 = time.perf_counter()
    kern.load_library()
    log(f"built+loaded {kern._LIB_NAME} in {time.perf_counter() - t0:.1f} s "
        f"(nvcc {_build.BUILD_SECONDS.get(kern._LIB_NAME, 0.0):.1f} s)")
    for line in (_build.build_log(kern._LIB_NAME, kern._SOURCES) or "")\
            .splitlines():
        if "registers" in line or "spill" in line.lower():
            log(f"ptxas: {line.strip()}")


def cuda_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn`` over ``reps`` back-to-back calls (CUDA
    events, after one warm call; inputs stay L2-resident when they fit)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def bound(macs: int, nbytes: int, integer: bool) -> dict:
    """The least time for one call: operations over the peak rate and
    bytes (each input read once, each output written once) over HBM."""
    ops_ms = 2.0 * macs / (PEAK_INT8 if integer else PEAK_FP32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms),
            "bound_by": "operations" if ops_ms >= bytes_ms else "bytes",
            "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def phase_kernels(torch, reps: int):
    import torch.nn.functional as F

    from repro_torch.core.model import ALEXNET_LAYERS, VGG16_LAYERS
    from repro_torch.engine import ExecutionPolicy
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.requant import scale_to_mult_shift
    from repro_torch.kernels.trim_conv2d import apply_epilogue

    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    kernel_pol = ExecutionPolicy(substrate="kernel")
    oracle_pol = ExecutionPolicy(substrate="oracle")
    rows = []
    cases = [("vgg16", i, l, 1) for i, l in enumerate(VGG16_LAYERS)]
    cases += [("alexnet", 0, ALEXNET_LAYERS[0], 1),
              ("alexnet", 1, ALEXNET_LAYERS[1], 2)]
    for arch, i, l, groups in cases:
        C, Cg = l.M * groups, l.M
        K, Fo, S, p = l.K, l.N, l.stride, l.padding
        H_O, W_O = l.H_O, l.W_O
        macs = H_O * W_O * Fo * K * K * Cg
        last = arch == "vgg16" and i == len(VGG16_LAYERS) - 1
        # -- float lane: bias + ReLU -----------------------------------
        x = torch.randn((1, l.H_I, l.W_I, C), generator=gen, device=dev)
        w = torch.randn((K, K, Cg, Fo), generator=gen, device=dev) \
            * (2.0 / (K * K * Cg)) ** 0.5
        b = torch.randn((Fo,), generator=gen, device=dev) * 0.1

        def run(pol, x=x, w=w, b=b):
            return ops.trim_conv2d(x, w, b, stride=S, padding=p,
                                   groups=groups, relu=True, policy=pol)

        got, want = run(kernel_pol), run(oracle_pol)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        scale = want.abs().max().item()
        if got.shape != want.shape or not torch.allclose(
                got, want, rtol=1e-4, atol=1e-4 * scale):
            fail(f"{arch} {l.name} float: max|kernel-plain| = {err:.3g} "
                 f"(max|plain| {scale:.3g})")
        x_nchw = x.permute(0, 3, 1, 2)          # channels-last view
        w_oihw = w.permute(3, 2, 0, 1).contiguous()
        nbytes = 4 * (x.numel() + w.numel() + b.numel() + got.numel())
        rows.append({
            "arch": arch, "layer": l.name, "lane": "f32",
            "epilogue": "bias+relu", "launches": groups,
            "ms": cuda_ms(torch, lambda: run(kernel_pol), reps),
            "plain_ms": cuda_ms(torch, lambda: run(oracle_pol), reps),
            "library_ms": cuda_ms(torch, lambda: F.conv2d(
                x_nchw, w_oihw, b, stride=S, padding=p, groups=groups),
                reps),
            "max_abs_err": err, **bound(macs, nbytes, integer=False)})
        # -- int8 lane: ReLU + per-channel requant (raw int32 last) ------
        xq = torch.randint(0, 256, (1, l.H_I, l.W_I, C), generator=gen,
                           device=dev, dtype=torch.uint8)
        wq = torch.randint(-127, 128, (K, K, Cg, Fo), generator=gen,
                           device=dev, dtype=torch.int8)
        psum = apply_epilogue(
            ref.conv2d(xq, wq, stride=S, padding=p, groups=groups),
            None, True, None)
        rq = None
        if not last:
            amax = psum.amax(dim=(0, 1, 2)).cpu().numpy().astype("float64")
            m, s = scale_to_mult_shift(255.0 / amax.clip(min=1.0))
            rq = (torch.as_tensor(m, device=dev), torch.as_tensor(s, device=dev))

        def runq(pol, xq=xq, wq=wq, rq=rq):
            return ops.trim_conv2d(xq, wq, None, rq, stride=S, padding=p,
                                   groups=groups, relu=True, policy=pol)

        got, want = runq(kernel_pol), runq(oracle_pol)
        torch.cuda.synchronize()
        if got.dtype != want.dtype or not torch.equal(got, want):
            diff = (got.to(torch.int64) - want.to(torch.int64)).abs().max()
            fail(f"{arch} {l.name} int8: kernel != plain (max diff {diff})")
        nbytes = (xq.numel() + wq.numel() + got.numel() * got.element_size()
                  + (0 if rq is None else 8 * Fo))
        rows.append({
            "arch": arch, "layer": l.name, "lane": "u8s8",
            "epilogue": "relu" if last else "relu+requant",
            "launches": groups,
            "ms": cuda_ms(torch, lambda: runq(kernel_pol), reps),
            "plain_ms": cuda_ms(torch, lambda: runq(oracle_pol),
                                max(1, reps // 4)),
            "library_ms": None, "max_abs_err": 0.0,
            **bound(macs, nbytes, integer=True)})
    for r in rows:
        lib = "null" if r["library_ms"] is None else f"{r['library_ms']:.4f}"
        log(f"kernel {r['arch']:7s} {r['layer']:4s} {r['lane']:4s} "
            f"{r['epilogue']:12s} ms {r['ms']:.4f} plain_ms "
            f"{r['plain_ms']:.4f} library_ms {lib} bound_ms "
            f"{r['bound_ms']:.4f} ({r['bound_by']}) err {r['max_abs_err']:.3g}")
    return rows


def _served_inputs(server):
    return [r for r in server.requests if r.status == "served"]


def phase_serve(torch, datapath: str, n_requests: int):
    """Full-width VGG-16 through the port's Server on one lane; returns
    the kernel launches counted while the stream was served."""
    import numpy as np

    from repro_torch.configs import CNN_REGISTRY
    from repro_torch.data.pipeline import SyntheticRequestStream
    from repro_torch.engine import ExecutionPolicy, execute, plan_model
    from repro_torch.kernels import trim_conv2d as kern
    from repro_torch.launch.serve_cnn import check_run
    from repro_torch.serve import ServeConfig, Server

    dev = torch.device("cuda", 0)
    cfg = CNN_REGISTRY["vgg16"]
    plan = plan_model(cfg, ExecutionPolicy())
    oracle = plan_model(cfg, ExecutionPolicy(substrate="oracle"))
    buckets = (1, 4, 8)
    conf = ServeConfig(buckets=buckets, max_delay_ms=5.0, datapath=datapath)
    dtype = "float32" if datapath == "float" else "uint8"
    stream = SyntheticRequestStream(
        hw=cfg.input_hw, channels=3, n_classes=cfg.n_classes,
        n_requests=n_requests, seed=0, process="bursts",
        burst_sizes=buckets, gap_s=0.05, dtype=dtype)
    t0 = time.perf_counter()
    params = plan.init(0, dev)
    requant = None
    if datapath == "int8":
        params, _ = plan.quantize(params)
        sample = torch.from_numpy(stream.sample_batch(4)).to(dev)
        requant = plan.calibrate_requant(params, sample)
    server = Server.from_plan(plan, params, conf, requant=requant,
                              device=dev)
    log(f"serve {datapath}: params + warm build of buckets {buckets} in "
        f"{time.perf_counter() - t0:.1f} s")
    # the images are made before serving starts: at full width making one
    # takes longer than the flush deadline, which would split every burst
    items = list(stream)
    kern.LAUNCHES = 0
    t0 = time.perf_counter()
    metrics = server.run_stream(items)
    server.close()
    wall = time.perf_counter() - t0
    launches = kern.LAUNCHES
    fails = check_run(server, metrics, n_requests, expect_all_buckets=True)
    if fails:
        fail(f"serve {datapath}: " + "; ".join(fails))
    flushes = metrics.snapshot()["totals"]["flushes"]
    if launches != flushes * len(cfg.layers):
        fail(f"serve {datapath}: {launches} kernel launches for {flushes} "
             f"flushes of {len(cfg.layers)} convs")
    served = _served_inputs(server)
    last = plan.layers[-1]  # int8: the last conv's psums, before its pool
    shape = ((cfg.n_classes,) if datapath == "float"
             else (last.tile.H_O, last.tile.W_O, last.c_out))
    for r in served:
        if r.result.shape != shape:
            fail(f"serve {datapath}: result shape {r.result.shape}")
        if datapath == "float" and not np.isfinite(r.result).all():
            fail(f"serve {datapath}: non-finite logits")
    # bucketed == unbatched, bit for bit
    for r in served:
        single = server.engine.infer(r.payload[None])[0]
        if not np.array_equal(single, r.result):
            fail(f"serve {datapath}: request {r.rid} bucketed != unbatched")
    # against the oracle substrate on the card
    first = served[:4]
    imgs = torch.from_numpy(np.stack([r.payload for r in first])).to(dev)
    got = np.stack([r.result for r in first])
    if datapath == "float":
        want = execute.serve_forward(oracle, params, imgs).cpu().numpy()
        err = float(np.abs(got - want).max())
        scale = float(np.abs(want).max())
        if not np.allclose(got, want, rtol=1e-3, atol=1e-3 * scale):
            fail(f"serve float: logits vs oracle max err {err:.3g} "
                 f"(max|logit| {scale:.3g})")
        log(f"serve float: logits vs oracle max|err| {err:.3g} "
            f"(max|logit| {scale:.3g}, tolerance rtol 1e-3, atol 1e-3*max)")
    else:
        want = execute.forward_int8(oracle, params, imgs,
                                    requant=requant).cpu().numpy()
        if not np.array_equal(got, want):
            fail("serve int8: features differ from the oracle substrate")
        log("serve int8: features bit-equal to the oracle substrate")
    snap = metrics.snapshot()
    log(f"serve {datapath}: {snap['totals']['images']}/{n_requests} served "
        f"in {flushes} flushes ({wall:.2f} s wall, p99 "
        f"{snap['totals']['p99_ms']} ms), {launches} kernel launches, "
        f"builds {sorted(set(server.engine.compile_counts.values()))}")
    for b, rec in snap["per_bucket"].items():
        log(f"serve {datapath}: bucket {b}: {rec['flushes']} flushes, "
            f"p50 {rec['p50_ms']} ms, p99 {rec['p99_ms']} ms")
    return launches


def kernel_entry(rows, lane: str, launches: int) -> dict:
    """One kernel instantiation's line entry: the sums over VGG-16's 13
    conv shapes at batch 1 (one image's conv stack)."""
    vgg = [r for r in rows if r["lane"] == lane and r["arch"] == "vgg16"]
    lib = [r["library_ms"] for r in vgg]
    return {
        "name": f"trim_conv2d_{lane}",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows
                           if r["lane"] == lane),
        "ms": sum(r["ms"] for r in vgg),
        "plain_ms": sum(r["plain_ms"] for r in vgg),
        "bound_ms": sum(r["bound_ms"] for r in vgg),
        "bound_by": ("operations" if sum(r["ops_ms"] for r in vgg)
                     >= sum(r["bytes_ms"] for r in vgg) else "bytes"),
        "library_ms": None if None in lib else sum(lib),
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--kernels", action="store_true",
                    help="stop after the kernel phase (no serving)")
    ap.add_argument("--reps", type=int, default=50,
                    help="timed launches per kernel shape")
    ap.add_argument("--requests", type=int, default=16,
                    help="requests per serve phase")
    args = ap.parse_args()

    if not (SRC / "repro_torch" / "csrc" / "trim_conv2d.cu").is_file():
        fail(f"the port's sources are not in {SRC}: run from a checkout")
    sys.path.insert(0, str(SRC))
    import torch

    card = phase_environment(torch)
    from repro_torch.engine.policy import fp32_ieee

    fp32_ieee()
    phase_build()
    rows = phase_kernels(torch, args.reps)
    if args.kernels:
        log("stopping after the kernel phase (--kernels): no result line")
        return
    launches_f32 = phase_serve(torch, "float", args.requests)
    launches_u8 = phase_serve(torch, "int8", args.requests)
    print(json.dumps({"kernels": [
        kernel_entry(rows, "f32", launches_f32),
        kernel_entry(rows, "u8s8", launches_u8)]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
