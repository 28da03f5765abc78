"""python3 -m gpbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once on this machine's CUDA device and
prints the result as the last line of standard output (one JSON object),
with each number compared beside its limit as the last lines of standard
error.  Exits 2, with no result: before set-up where the cell cannot be
run as written (its configuration names no known model family, a kernel
the family's reference does not compute, or traffic the family does not
serve), where there is no CUDA device or fewer than the cell asks for,
where the program cannot be imported, or where jax, jaxlib, flax or
gp_tpu were loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="gpbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)

    import torch

    from . import harness

    # one process with one host thread for torch's CPU work: the steps'
    # latencies spread far less than with a thread per core (the BO
    # cell's p95 by 3x on the card's 8-core host)
    torch.set_num_threads(1)

    _, cell, config, traffic, _ = harness.resolve(ROOT, a.workload)
    try:
        harness.family(ROOT, cell["config"], config, traffic["kind"])
    except harness.Refused as exc:
        print(f"gpbench: {exc}; no result", file=sys.stderr)
        return 2
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < cell["chips"]:
        print(f"gpbench: {a.workload} needs {cell['chips']} CUDA device(s), "
              f"this machine has {have}; no result", file=sys.stderr)
        return 2
    try:
        line = harness.run(ROOT, a.workload, a.seed, a.seconds,
                           bool(a.trace), "cuda", T_START)
    except ImportError as exc:
        print(f"gpbench: the program cannot be imported ({exc}); no result",
              file=sys.stderr)
        return 2
    bad = harness.forbidden_modules()
    if bad:
        print(f"gpbench: the run loaded {', '.join(bad)}; no result",
              file=sys.stderr)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
