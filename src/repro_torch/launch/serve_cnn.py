"""Serve the paper's CNNs through the port's bucketed Server.

  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --arch vgg16 \\
      --int8 --buckets 1,4,8 --requests 32 --device cuda --check
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --arch vgg16 \\
      --smoke --int5 --device cpu --check
  PYTHONPATH=src python -m repro_torch.launch.serve_cnn --arch vgg16 \\
      --int5 --producers 4 --check --breaker-threshold 1 \\
      --faults seed=3,worker=1,stage=2,bitflip=1,exec=2

Port of ``repro/launch/serve_cnn.py:55-265``.  Builds one
``repro_torch.serve.Server`` from a ``ServeConfig``: seeded random params
(``init_cnn``), on the integer lanes quantized (``--int8``; ``--int5``,
the MSR weight lane) and calibrated on a sample burst, one warmed
executable per bucket, then serves a deterministic
synthetic request stream (``data.pipeline.SyntheticRequestStream``)
through pad-and-bucket admission — inline (``--producers 0``,
deterministic) or through producer threads feeding the flush worker.
``--device`` defaults to ``cuda``; without a card, pass ``--device cpu``
to run the plain PyTorch path.  ``--check`` exits non-zero unless request
conservation holds (served + shed + expired + failed == submitted),
every executable was built once and, inline, every bucket flushed (on
the card each executable is a CUDA graph captured once per key, and again
after each restore of the int5 wire; the captures per key are printed and
written as ``captures``); on
failure it dumps the admission ledger (every request's terminal state and
what the fault plane fired) as JSON to stderr.  ``--substrate``,
``--emulate-hw`` and ``--tuning`` select the execution policy
(``launch.cli.execution_parent``); under ``--tuning`` each bucket plans
at its own batch with the autotuner's winners (measured on ``--device``
under ``auto``), and the metrics JSON gets each bucket's plan
(``bucket_plans``).

``--faults SPEC`` arms the seeded fault-injection plane and the
degradation ladder behind it (``build_server``): injected stage / build /
executable faults, worker crashes, int5 wire bit-flips, NaN batches and
latency spikes, recovered by bounded retries, the watchdog, the
checksummed weights' restore and the circuit breaker's lane degradation
(``--breaker-threshold``).  The metrics JSON then carries ``faults``
(the plan), ``fault_ledger`` (what fired) and ``lanes``; without
``--faults`` it carries none of them.
"""

import argparse
import json
import sys

import torch

from repro_torch.configs import CNN_REGISTRY, CNN_SMOKES
from repro_torch.data.pipeline import SyntheticRequestStream
from repro_torch.engine import plan_model
from repro_torch.engine.policy import fp32_ieee, resolve_device
from repro_torch.kernels import trim_conv2d as kernel
from repro_torch.launch.cli import (execution_parent, policy_from_args,
                                    serve_config_from_args, serving_parent)
from repro_torch.serve import Lane, PackedWire, Server


def make_stream(cfg, args, buckets):
    """The synthetic request stream for one run: the bursts process cycles
    the bucket sizes with gaps past the flush deadline, so every bucket
    flushes at least once."""
    return SyntheticRequestStream(
        hw=cfg.input_hw,
        channels=cfg.layers[0].M,
        n_classes=cfg.n_classes,
        n_requests=args.requests,
        rate_hz=args.rate,
        seed=args.seed,
        process=args.arrival,
        burst_sizes=tuple(buckets),
        gap_s=4.0 * args.max_delay_ms / 1e3,
        dtype="uint8" if (args.int8 or args.int5) else "float32",
    )


def build_server(cfg, policy, serve_config, *, seed=0, calib_batch=8,
                 device="cuda"):
    """ModelPlan -> seeded params (+ int8 or int5 quantization and
    per-channel requant calibration on a sample burst) -> a warm Server on
    ``device``.  ``device="cuda"`` without a card raises.

    With ``serve_config.faults`` armed the server also carries its
    degradation ladder: int5 serves off the checksummed ``PackedWire``
    payload with an ``int8`` fallback lane calibrated on the same sample
    from the same float master (its outputs are a native int8 server's);
    int8 falls back to ``int8-f32exact`` (the same integer sums, exact in
    fp32 channel chunks: bit-identical).  On the CPU float falls back to
    ``float-oracle``, the substrate's own plain conv; on the card the
    float ladder ends at the conv kernel's fp32 lane, since its plain
    conv is the library's (cuDNN), and a breaker trip, which does not
    tell an injected failure from a real one, must not hand the kernel's
    traffic to it.  Without faults the engine has one lane."""
    dev = resolve_device(device)
    plan = plan_model(cfg, policy)
    params = plan.init(seed, dev)
    armed = serve_config.faults is not None
    if serve_config.datapath == "float":
        fallbacks = [Lane("float-oracle", "float", params,
                          substrate="oracle")] \
            if armed and dev.type == "cpu" else None
        return Server.from_plan(plan, params, serve_config,
                                fallbacks=fallbacks, device=dev)
    sample = SyntheticRequestStream(
        hw=cfg.input_hw, channels=cfg.layers[0].M, n_classes=cfg.n_classes,
        seed=seed, dtype="uint8").sample_batch(calib_batch)
    sample = torch.from_numpy(sample).to(dev)
    if serve_config.datapath == "int5":
        qparams, _ = plan.quantize_int5(params)
        requant = plan.calibrate_requant_int5(qparams, sample)
        fallbacks = wire = None
        if armed:
            wire = PackedWire(cfg, params)
            q8, _ = plan.quantize(params)
            fallbacks = [Lane("int8", "int8", q8,
                              plan.calibrate_requant(q8, sample))]
        return Server.from_plan(plan, qparams, serve_config,
                                requant=requant, fallbacks=fallbacks,
                                wire=wire, device=dev)
    qparams, _ = plan.quantize(params)
    requant = plan.calibrate_requant(qparams, sample)
    fallbacks = [Lane("int8-f32exact", "int8", qparams, requant,
                      substrate="f32exact")] if armed else None
    return Server.from_plan(plan, qparams, serve_config, requant=requant,
                            fallbacks=fallbacks, device=dev)


def check_run(server, metrics, n_requests, *, expect_all_buckets) -> list:
    """The --check assertions; returns a list of failure strings."""
    fails = []
    tot = metrics.snapshot()["totals"]
    if tot["submitted"] != n_requests:
        fails.append(f"submitted {tot['submitted']} != offered {n_requests}")
    failed = tot.get("failed", 0)
    if tot["images"] + tot["shed"] + tot["expired"] + failed \
            != tot["submitted"]:
        fails.append(
            "conservation violated: served %d + shed %d + expired %d + "
            "failed %d != submitted %d"
            % (tot["images"], tot["shed"], tot["expired"], failed,
               tot["submitted"]))
    statuses = [r.status for r in metrics.requests]
    if any(s == "pending" for s in statuses):
        fails.append(f"{statuses.count('pending')} requests left pending")
    rids = [r.rid for r in metrics.requests]
    if len(set(rids)) != len(rids):
        fails.append("duplicate request ids")
    for r in metrics.requests:
        if r.status == "served" and r.result is None:
            fails.append(f"request {r.rid} served without a result")
            break
    if expect_all_buckets:
        for b in server.engine.buckets:
            if metrics.flushes(b) < 1:
                fails.append(f"bucket {b} never flushed")
    bad = {k: v for k, v in server.engine.compile_counts.items() if v != 1}
    if bad:
        fails.append(f"executables built more than once: {bad}")
    if not metrics.snapshot()["per_bucket"]:
        fails.append("metrics snapshot is empty")
    return fails


def main() -> None:
    ap = argparse.ArgumentParser(
        description=__doc__.split("\n")[0],
        parents=[execution_parent(CNN_REGISTRY, "vgg16"),
                 serving_parent("1,4,8")])
    ap.add_argument("--smoke", action="store_true",
                    help="tiny arch variant (CNN_SMOKES)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=64)
    ap.add_argument("--rate", type=float, default=200.0,
                    help="mean arrival rate (req/s) for poisson/uniform")
    ap.add_argument("--arrival", choices=("poisson", "uniform", "bursts"),
                    default="bursts")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", default="experiments/serve_torch/metrics.json")
    ap.add_argument("--check", action="store_true",
                    help="assert conservation, build-once and (inline) a "
                         "flush per bucket; exit non-zero on failure")
    args = ap.parse_args()

    fp32_ieee()
    dev = resolve_device(args.device)
    policy = policy_from_args(args)
    serve_config = serve_config_from_args(args)
    cfg = (CNN_SMOKES if args.smoke else CNN_REGISTRY)[args.arch]

    server = build_server(cfg, policy, serve_config, seed=args.seed,
                          device=dev)
    # Images are made before serving starts (set-up, not serving): at full
    # width making one takes longer than the flush deadline.
    items = list(make_stream(cfg, args, serve_config.buckets))
    kernel.LAUNCHES = 0
    try:
        metrics = server.run_stream(items, producers=args.producers)
    finally:
        server.close()
    launches = kernel.LAUNCHES
    snap = metrics.snapshot()
    extra = {
        "arch": cfg.name,
        "datapath": serve_config.datapath,
        "arrival": args.arrival,
        "requests": args.requests,
        "max_delay_ms": args.max_delay_ms,
        "producers": args.producers,
        "plan": list(server.engine.plan.describe(serve_config.buckets)),
        "executables": dict(server.engine.compile_counts),
        "captures": dict(server.engine.capture_counts),
        "kernel_launches": launches,
    }
    if policy.tuning != "off":
        # each bucket's plan of the served lane, with its tuned schedules
        eng = server.engine
        lane = serve_config.datapath
        extra["bucket_plans"] = {
            str(b): [lp.describe((b,)) for lp in (
                getattr(eng.bucket_plan(b), lane) if lane != "float"
                else eng.bucket_plan(b)).layers]
            for b in serve_config.buckets}
    injector = server.engine.injector
    if injector is not None:
        # the chaos schedule and what fired, so a degraded run is visible
        # in its artifact
        extra["faults"] = injector.plan.describe()
        extra["fault_ledger"] = dict(injector.fired)
        extra["lanes"] = [ln.name for ln in server.engine.lanes]
    payload = metrics.write(args.out, extra=extra, device=dev)

    tot = snap["totals"]
    mode = (f"{args.producers} producers" if args.producers
            else "inline open loop")
    print(f"[serve_cnn] {cfg.name} {serve_config.datapath} on {dev} "
          f"buckets={list(serve_config.buckets)} ({mode}) "
          f"served {tot['images']}/{tot['submitted']} "
          f"(shed {tot['shed']}, expired {tot['expired']}) in "
          f"{tot.get('wall_s', 0):.3f}s, p99 {tot['p99_ms']:.1f} ms, "
          f"{launches} conv kernel launches")
    for b, rec in snap["per_bucket"].items():
        print(f"[serve_cnn]   bucket {b:>3}: {rec['flushes']} flushes, "
              f"p99 {rec['p99_ms']:.2f} ms")
    eng = server.engine
    for key, n in eng.compile_counts.items():
        print(f"[serve_cnn]   {key}: built {n}, captured "
              f"{eng.capture_counts.get(key, 0)} (CUDA graphs: the card "
              "only; again after each wire restore)")
    print(f"[serve_cnn] wrote {args.out} ({len(json.dumps(payload))} bytes)")

    if args.check:
        fails = check_run(server, metrics, args.requests,
                          expect_all_buckets=args.producers == 0)
        if fails:
            for f in fails:
                print(f"[serve_cnn] CHECK FAILED: {f}", file=sys.stderr)
            # the admission ledger: every request's terminal state (and
            # what the fault plane fired), so a failure reads from the log
            ledger = {
                "fails": fails,
                "totals": tot,
                "requests": [
                    dict({"rid": r.rid, "status": r.status},
                         **({"error": r.error} if r.error else {}))
                    for r in sorted(metrics.requests, key=lambda r: r.rid)
                ],
            }
            if injector is not None:
                ledger["fault_ledger"] = dict(injector.fired)
            json.dump(ledger, sys.stderr, indent=1)
            print(file=sys.stderr)
            sys.exit(1)
        print("[serve_cnn] check OK: request conservation holds, every "
              "executable built exactly once"
              + ("" if args.producers else ", every bucket flushed"))


if __name__ == "__main__":
    main()
