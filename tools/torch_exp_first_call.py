"""Whether a process's first float32 ``torch.exp`` on the CPU is off.

    python3 tools/torch_exp_first_call.py [--runs 20]

Starts ``--runs`` fresh Python processes with torch's default threads, as
many with one thread, and as many with the default threads that first
call ``torch.exp`` once on 65536 zeros (as the SSD and examples tests'
``_warm_exp`` fixtures do).  Each computes ``torch.exp`` twice on the same
float32 tensor, the decays of the SSD's plain version: the exponent of a
(1, 3, 2, 1, 64, 64) block of -U(0, 3) values, masked above the diagonal
with -1e30 as ``nn.mamba._segsum`` masks them.  It prints each call's
max|exp - float64 exp|.  A call is off where that lies past 1e-6 (a
correct float32 exp lies about 3e-8 from float64 here).  Prints one JSON
object: the torch version, the CPU capability torch dispatches to, and
per setting the processes whose first call was off, whose second call
was off, and each process's two distances.
"""
import argparse
import json
import os
import subprocess
import sys

PROBE = """
import json, sys, torch
if sys.argv[1] == "warm":
    torch.exp(torch.zeros(1 << 16))
g = torch.Generator().manual_seed(0)
x = -torch.rand(1, 3, 2, 1, 64, 64, generator=g) * 3
x = x.masked_fill(~torch.tril(torch.ones(64, 64, dtype=torch.bool)), -1e30)
a = torch.exp(x)
b = torch.exp(x)
ref = torch.exp(x.double())
print(json.dumps([float((a.double() - ref).abs().max()),
                  float((b.double() - ref).abs().max())]))
"""


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--runs", type=int, default=20)
    args = ap.parse_args()
    import torch

    out = {"torch": torch.__version__,
           "cpu_capability": torch.backends.cpu.get_cpu_capability(),
           "threads": torch.get_num_threads()}
    for label, threads, warm in (("default", None, "cold"),
                                 ("one", "1", "cold"),
                                 ("warmed", None, "warm")):
        env = dict(os.environ)
        if threads:
            env["OMP_NUM_THREADS"] = threads
        runs = []
        for _ in range(args.runs):
            proc = subprocess.run([sys.executable, "-c", PROBE, warm],
                                  env=env,
                                  capture_output=True, text=True,
                                  check=True)
            runs.append(json.loads(proc.stdout))
        out[f"{label}_threads_runs"] = {
            "first_off": sum(r[0] > 1e-6 for r in runs),
            "second_off": sum(r[1] > 1e-6 for r in runs),
            "runs": runs}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
