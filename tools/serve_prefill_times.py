"""Time gemma-7b's served bf16 prefill of one checkout, and its flash
kernel's device time in it.

    python3 tools/serve_prefill_times.py --src <checkout>/src

Imports ``repro_torch`` from ``--src`` (so the same script times the
parent commit's port and this one's; its kernels build into that
checkout's ``build/``), builds full-width gemma-7b (28 layers, random bf16
weights from seed 0) and serves ``chip_smoke.py``'s batch through the
launcher's prefill executable (``launch.serve.prefill_executable`` and
``run_prefill``): 4 prompts of 4096 tokens from numpy seed 0, each prefill
into a fresh cache of 4128 positions.  After the executable's warm call it
times REPS prefills on the host clock (each ends at a device sync), then
profiles one more under ``torch.profiler``: the device time and the count
of the kernels named ``flash_`` (kernel 5's).  Prints one JSON object,
``{"card": ..., "rows": {"prefill wall": mean ms, "flash device": ms,
"flash launches": n}}``; exits non-zero without a card.
``chip_smoke.py --parent DIR`` runs it on DIR's checkout and on its own in
turns (parent, this, this, parent) beside its gemma-7b serve phase.
"""
import argparse
import json
import sys

import numpy as np
import torch

ARCH = "gemma-7b"
BATCH, PROMPT, GEN = 4, 4096, 32
#: timed prefills a turn (about 0.55 s each on an H100)
REPS = 5


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", required=True,
                    help="the src directory of the checkout to time")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        sys.exit("serve_prefill_times: no card "
                 "(torch.cuda.is_available() is false)")
    sys.path.insert(0, args.src)
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.launch.serve import prefill_executable, run_prefill
    from repro_torch.nn.models import build_model
    from repro_torch.serve import ServeEngine

    dev = torch.device("cuda", 0)
    cfg = get_config(ARCH)
    model = build_model(cfg)
    params = model.init(0, dev)
    prompts = np.random.default_rng(0).integers(0, cfg.vocab,
                                                (BATCH, PROMPT))
    batch = {"tokens": torch.as_tensor(prompts, device=dev)}

    def cache():
        return model.init_cache(BATCH, PROMPT + GEN, dtype=cfg.dtype,
                                device=dev)

    eng = ServeEngine(name=f"lm-{cfg.name}", buckets=(BATCH,), device=dev)
    prefill = prefill_executable(eng, model, params, batch, cache())
    walls = []
    for _ in range(REPS):
        logits, _, s = run_prefill(prefill, params, batch, cache(), dev)
        walls.append(s * 1e3)
    if logits.shape != (BATCH, cfg.vocab) or \
            not bool(torch.isfinite(logits).all()):
        sys.exit(f"serve_prefill_times: prefill logits "
                 f"{tuple(logits.shape)} not finite or of the wrong shape")
    c = cache()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        prefill(params, batch, c)
        torch.cuda.synchronize()
    flash = [e for e in prof.key_averages()
             if str(e.device_type).endswith("CUDA") and "flash_" in e.key]
    print(json.dumps({"card": torch.cuda.get_device_name(0), "rows": {
        "prefill wall": sum(walls) / len(walls),
        "flash device": sum(e.self_device_time_total for e in flash) / 1e3,
        "flash launches": sum(e.count for e in flash)}}))


if __name__ == "__main__":
    main()
