"""Quickstart tour of the PyTorch/CUDA port's public API.

  PYTHONPATH=src python examples/torch/quickstart.py               # the card
  PYTHONPATH=src python examples/torch/quickstart.py --device cpu  # CPU

1. The paper's TrIM dataflow: cycle-level slice simulation, the
   bit-faithful engine, and the analytical model (Table I numbers).
2. The TrIM conv kernel (CUDA, ``kernels/ops.py``) on the card, against
   the plain conv of ``kernels/ref.py``.
3. A tiny LM: one train step + greedy decode through the serve path
   (``launch/serve.py``; on the card the decode step is a CUDA graph).
4. The sub-8-bit MSR weight lane: 5-bit packed weights, expect-value
   compensation, and the 5/8 weight-traffic ratio.

The port of ``examples/quickstart.py``.  On the CPU (``--device cpu``)
every kernel's wrapper runs its plain PyTorch version; asked for the card
where there is none, the script exits non-zero.  Each part is a function
that returns its numbers; ``demo_lm`` takes the LM's params.
"""
import argparse
import sys

import numpy as np
import torch

from repro_torch.engine.policy import fp32_ieee, resolve_device


def demo_trim_dataflow() -> dict:
    from repro_torch.core.engine import TrimEngine, reference_conv_layer
    from repro_torch.core.model import (PAPER_ENGINE, VGG16_LAYERS,
                                        network_gops)
    from repro_torch.core.slice_sim import padding_overhead, simulate_slice

    print("=== 1. TrIM dataflow (the paper) ===")
    rng = np.random.default_rng(0)
    x = rng.integers(0, 256, (12, 12)).astype(np.int64)
    w = rng.integers(-8, 8, (3, 3))
    r = simulate_slice(x, w)
    overhead = padding_overhead(224, 224, 3)
    print(f"slice sim: {r.external_fetches} external fetches "
          f"(= padded elements, fetched ONCE), fifo_ok={r.fifo_order_ok}")
    print(f"224x224 input-fetch overhead: {100 * overhead:.2f}%  "
          "(paper: ~1.8%)")
    xs = rng.integers(0, 256, (8, 14, 14), dtype=np.uint8)
    ws = rng.integers(-128, 128, (4, 8, 3, 3)).astype(np.int8)
    out, trace = TrimEngine().run_layer(xs, ws)
    ok = bool((out == reference_conv_layer(xs, ws)).all())
    print(f"engine: int8 conv bit-exact={ok}, steps={trace.steps}, "
          f"psum accesses={trace.psum_buffer_accesses}")
    gops = network_gops(VGG16_LAYERS)
    print(f"peak: {PAPER_ENGINE.peak_gops} GOPs/s; VGG-16 sustained "
          f"{gops:.0f} GOPs/s (paper: 391)")
    return {"fetches": r.external_fetches, "fifo_ok": r.fifo_order_ok,
            "overhead": overhead, "bit_exact": ok, "steps": trace.steps,
            "psum_accesses": trace.psum_buffer_accesses,
            "peak_gops": PAPER_ENGINE.peak_gops, "vgg16_gops": gops}


def demo_kernel(device: torch.device) -> dict:
    from repro_torch.engine import ExecutionPolicy, plan_conv_layer
    from repro_torch.kernels import ref
    from repro_torch.kernels import trim_conv2d as kernel
    from repro_torch.kernels.ops import trim_conv2d

    print(f"\n=== 2. TrIM conv kernel ({device.type}) ===")
    gen = torch.Generator(device=device).manual_seed(0)
    x = torch.randn((1, 16, 16, 8), generator=gen, device=device)
    w = torch.randn((3, 3, 8, 16), generator=gen, device=device)
    # ExecutionPolicy says HOW to run (substrate / emulate_hw / tiling);
    # "kernel" runs the conv kernel's wrapper, which launches the CUDA
    # kernel on a card tensor and its plain version on a CPU tensor
    before = kernel.LAUNCHES
    out = trim_conv2d(x, w, policy=ExecutionPolicy(substrate="kernel"))
    launches = kernel.LAUNCHES - before
    err = float((out - ref.conv2d(x, w)).abs().max())
    print(f"conv2d {tuple(x.shape)} * {tuple(w.shape)} -> "
          f"{tuple(out.shape)}; max err vs the plain conv: {err:.2e}; "
          f"kernel launches: {launches}")
    plan = plan_conv_layer((16, 16), 8, 3, 16, relu=True, has_bias=True,
                           policy=ExecutionPolicy(substrate="kernel"))
    print(f"layer plan (planned once): {plan.describe()}")
    return {"shape": tuple(out.shape), "max_err": err, "launches": launches}


def demo_lm(device: torch.device, params=None) -> dict:
    """One train step of granite-3-2b's smoke config from ``params`` (its
    seed-0 init when None), then 4 greedy tokens after an 8-token prompt
    through the serve launcher's prefill and decode executables."""
    from repro_torch.configs import get_smoke
    from repro_torch.distributed import (StepConfig, make_train_state,
                                         make_train_step)
    from repro_torch.kernels import flash_attention as flash
    from repro_torch.launch.serve import (decode_executable,
                                          prefill_executable, run_decode,
                                          run_prefill)
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeEngine

    print("\n=== 3. Tiny LM: train step + decode ===")
    cfg = get_smoke("granite-3-2b")
    model = build_model(cfg)
    state = make_train_state(model, 0, device)
    if params is not None:
        state["params"] = params
    step = make_train_step(model, StepConfig(total_steps=10,
                                             warmup_steps=1))
    rng = np.random.default_rng(0)
    tokens = torch.as_tensor(rng.integers(0, cfg.vocab, (2, 33)),
                             device=device)
    flash.LAUNCHES = 0
    state, metrics = step(state, {"tokens": tokens})
    loss, gnorm = float(metrics["loss"]), float(metrics["grad_norm"])
    print(f"train step: loss={loss:.3f} grad_norm={gnorm:.3f} "
          f"(flash-attention kernel launches: {flash.LAUNCHES})")

    p = state["params"]
    eng = ServeEngine(name="quickstart", buckets=(2,), device=device)
    cache = model.init_cache(2, 16, dtype=torch.float32, device=device)
    batch = {"tokens": tokens[:, :8]}
    prefill = prefill_executable(eng, model, p, batch, cache)
    logits, cache, _ = run_prefill(prefill, p, batch, cache, device)
    tok = logits.argmax(-1)
    decode = decode_executable(eng, model, p, tok, cache, 8)
    toks, cache, _, _ = run_decode(decode, p, tok, cache, 8, 4, device)
    greedy = [int(t[0]) for t in [tok] + toks]
    print("greedy decode:", greedy)
    return {"loss": loss, "grad_norm": gnorm, "greedy": greedy,
            "flash_launches": flash.LAUNCHES}


def demo_int5() -> dict:
    from repro_torch.core.model import (PAPER_ENGINE, VGG16_LAYERS,
                                        trim_memory_accesses)
    from repro_torch.core.quant import (msr_compress, msr_operand,
                                        pack_int5, unpack_int5)

    print("\n=== 4. int5 MSR weight lane ===")
    rng = np.random.default_rng(0)
    w = rng.integers(-127, 128, (3, 3, 8, 16)).astype(np.int8)
    codes, shifts = msr_compress(w)  # sign + 4-bit MSR, t per channel
    w5, e = msr_operand(codes, shifts)  # exact w_hat == w5 << e
    packed = pack_int5(codes)  # 5 bits/weight on the wire
    assert (unpack_int5(packed, w.size) == codes.reshape(-1)).all()
    err = np.abs((np.int32(w5) << e) - w.astype(np.int32))
    print(f"packed {w.size} int8 weights into {packed.nbytes} bytes "
          f"({8 * packed.nbytes / w.size:.2f} bits/weight), "
          f"max |w_hat - w| = {int(err.max())}")
    l = VGG16_LAYERS[0]
    full = trim_memory_accesses(l, PAPER_ENGINE).weight_reads
    msr = trim_memory_accesses(l, PAPER_ENGINE, weight_bits=5).weight_reads
    print(f"{l.name} weight reads: {full:.3f}M (int8) -> {msr:.3f}M "
          "(int5, exactly 5/8)")
    return {"packed_bytes": int(packed.nbytes), "max_err": int(err.max()),
            "weight_reads": (full, msr), "ratio": msr / full}


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    try:
        dev = resolve_device(args.device)
    except RuntimeError as e:
        sys.exit(f"quickstart: {e}")
    fp32_ieee()
    demo_trim_dataflow()
    demo_kernel(dev)
    demo_lm(dev)
    demo_int5()


if __name__ == "__main__":
    main()
