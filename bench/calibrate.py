"""Readings that a cell's limits are set from (``bench/limits``), in one
process on the card:

    python3 bench/calibrate.py --workload <name> --seeds 1,2,... \
        [--control-seeds 1,2,3] [--faults half_batch,...] [--fault-seeds 1,2,3] \
        [--seconds 8]

For each of ``--seeds`` a whole run of the program (a short window, long
enough that a prefill run's sample finds as many finished calls as a
full window's: 8 s) gives the compared numbers of a sound run; their
largest is the lower reading.
The control is the plain reference put in the program's place and
computed in float8 (``bench/reference``, prec "fp8"), read on each of
``--control-seeds`` at the cell's own sizes; each of ``--faults`` is a
fault planted in the program's path (its kind module's ``FAULTS``), read on
``--fault-seeds`` (the control's seeds where none are given). Prints one
JSON line a reading and a summary line: by number, the lower reading, the
control's least and each fault's least.
"""

import time

T0 = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]


def _ints(s: str) -> list:
    return [int(x) for x in s.split(",") if x]


def control_numbers(run) -> dict:
    """The control's numbers on ``run``'s seed: the reference in float8
    against the reference in float32 (``run.reference``, where the seed's
    is known), judged as the program is."""
    import torch

    from bench.harness import compare

    if run.traffic["kind"] == "train":
        from bench.kinds.train import _reference_side
        from bench.harness.tokens import ZipfTokens

        data = ZipfTokens(run.sizes["vocab_size"], run.seed)
        ref = run.reference or _reference_side(run, data, "f32")
        ctl = _reference_side(run, data, "fp8")
        out = compare.train_numbers(ctl, ref)
        out.pop("_at")
        return out
    from bench.kinds.prefill import Plan, reference_logits, sample

    t = run.traffic
    plan = Plan(t, run.seed, run.sizes["vocab_size"])
    # As many finished calls as a window of the cell holds (at least one
    # cycle), for the sample to draw from.
    done = [{"c": c, "S": plan.seq_len(c), "B": t["tokens_per_call"] // plan.seq_len(c)}
            for c in range(max(len(plan.cycle), t.get("calls_per_window", 200)))]
    picked = [done[i] for i in sample(done, run.seed, t["check_tokens"])]
    logits = reference_logits(run, plan, picked, ("f32", "fp8"))
    torch.cuda.empty_cache()
    return dict(compare.served_gaps(logits["f32"], logits["fp8"].argmax(dim=-1)),
                **compare.logit_errors(logits["f32"], logits["fp8"]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=_ints, default=[])
    ap.add_argument("--control-seeds", type=_ints, default=[])
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=_ints, default=None)
    ap.add_argument("--seconds", type=float, default=8.0)
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

    import torch

    from bench.harness import registry, runner

    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    bench = registry.benchmark()
    dev = torch.device("cuda", 0)
    lines = []

    def emit(kind: str, seed: int, numbers: dict, **extra):
        rec = dict(kind=kind, seed=seed, numbers=numbers, **extra)
        lines.append(rec)
        print(json.dumps(rec), flush=True)

    refs = {}  # the reference's readings by seed (training)

    def make(seed, faults=()):
        run = runner.make_run(bench, args.workload, seed, args.seconds, False, dev,
                              time.time(), faults)
        run.reference = refs.get(seed)
        return run

    for seed in args.seeds:
        run = make(seed)
        out = registry.kind(run.traffic["kind"]).execute(run)
        refs[seed] = out.ref
        emit("program", seed, out.numbers, detail=out.detail)
        torch.cuda.empty_cache()
    for seed in args.control_seeds:
        emit("control", seed, control_numbers(make(seed)))
        torch.cuda.empty_cache()
    for fault in [f for f in args.faults.split(",") if f]:
        for seed in args.control_seeds if args.fault_seeds is None else args.fault_seeds:
            run = make(seed, (fault,))
            out = registry.kind(run.traffic["kind"]).execute(run)
            emit(fault, seed, out.numbers)
            torch.cuda.empty_cache()

    summary = {}
    for kind in sorted({r["kind"] for r in lines}):
        rows = [r["numbers"] for r in lines if r["kind"] == kind]
        keys = [k for k in rows[0] if not k.startswith("_")]
        pick = max if kind == "program" else min
        summary[kind] = {k: pick(r[k] for r in rows) for k in keys}
    print(json.dumps({"summary": summary, "workload": args.workload,
                      "card": torch.cuda.get_device_name(0)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
