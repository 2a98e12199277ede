"""Runs one cell of the port's benchmark on the card of this machine and
prints its result as the last line of standard output.

    python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell, its configuration, its traffic and
its metrics are named in ``BENCHMARK.json``. The run loads the port
(``src/repro_torch``), makes its weights and inputs from the seed, warms
up, measures for ``--seconds`` seconds, and checks what the timed path
produced against the plain reference (``bench/reference``). Without a
CUDA card, or with fewer cards than the cell asks for, it exits with 2
and prints no result.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# Top-level module names the run's process may not hold.
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list:
    """Names of ``sys.modules`` whose top-level name is forbidden, compared
    whole (``repro_torch`` is not ``repro``)."""
    return sorted({name for name in sys.modules if name.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    from bench.harness import registry, runner

    bench = registry.benchmark()
    cell = registry.cell(bench, args.workload)

    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        found = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s); found {found}",
              file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  (fails here, before any result, without the program)

    run = runner.make_run(bench, args.workload, args.seed, args.seconds, bool(args.trace),
                          torch.device("cuda", 0), T0)
    result = runner.execute(bench, run)

    leaked = forbidden_modules()
    if leaked:
        print(f"bench: the run's process holds {leaked}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
