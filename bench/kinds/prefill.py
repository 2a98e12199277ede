"""Traffic kind "prefill": back-to-back calls of the port's prefill step
(``repro_torch.runtime.steps.build_prefill_step``), a closed loop of one
client, each call a block of prompts of one length and a fixed number of
tokens, synced and timed on its own from the copy of its prompts to the
host's read of its served tokens (the greedy next token of each prompt).

The lengths come in cycles that hold each length a fixed number of times
(``cycle``), shuffled per cycle from the seed, so that every seed gives
the same work in another order. Set-up warms each length once.

Once the window has closed and the program's weights are freed, a
sample of the finished calls drawn from the seed, the longest length in
it, is run through the reference. Each served token's reference logit is
held against the reference's best, and each prompt's last-position
logits, as the program returned them, against the reference's.
"""

from __future__ import annotations

import gc
import time

import numpy as np
import torch
from torch.profiler import record_function

from bench.harness import compare, weights
from bench.harness.context import Outcome, Run
from bench.harness.tokens import ZipfTokens
from bench.harness.trace import Tracer

FAULTS = ("half_batch", "token_altered")

# Call indices of the warm-up's prompts: apart from the window's.
WARM_INDEX = 1 << 40


class Plan:
    """Call ``c``'s prompt length, rows and ids."""

    def __init__(self, traffic: dict, seed: int, vocab: int):
        self.tokens_per_call = traffic["tokens_per_call"]
        self.cycle = [S for S, n in zip(traffic["seq_lens"], traffic["cycle"]) for _ in range(n)]
        self.seed = seed
        self.data = ZipfTokens(vocab, seed)
        self._orders: dict = {}

    def seq_len(self, c: int) -> int:
        n = len(self.cycle)
        cyc = c // n
        if cyc not in self._orders:
            rng = np.random.default_rng([self.seed, cyc, 7])
            self._orders[cyc] = rng.permutation(self.cycle)
        return int(self._orders[cyc][c % n])

    def prompts(self, c: int, S: int | None = None) -> np.ndarray:
        S = S or self.seq_len(c)
        return self.data.batch(c, self.tokens_per_call // S, S)["tokens"]


def _program(run: Run):
    from repro_torch.models.lm import build_model
    from repro_torch.runtime.steps import build_prefill_step

    from bench.kinds.train import _model_config

    model = build_model(_model_config(run.sizes))
    params = weights.make(run.sizes, run.seed, run.device, torch.bfloat16)
    prefill = build_prefill_step(model)

    def call(tokens: torch.Tensor) -> tuple[torch.Tensor, float, torch.Tensor]:
        """(the served token of each prompt; the host's clock when the
        prefill call returned, before the sync; the last-position logits
        [B, V] the call returned), on the host."""
        if "half_batch" in run.faults:
            rows = (tokens.shape[0] + 1) // 2
            logits = prefill(params, {"tokens": tokens[:rows]})
            logits = torch.cat([logits, torch.zeros((tokens.shape[0] - rows,) + logits.shape[1:],
                                                    dtype=logits.dtype, device=logits.device)])
        else:
            logits = prefill(params, {"tokens": tokens})
        enqueued = time.time()
        last = logits[:, -1]
        if "token_altered" in run.faults:  # the first prompt's answer, shifted by one token
            last = torch.cat([last[:1].roll(1, dims=-1), last[1:]])
        served = last.argmax(dim=-1)
        return served.cpu(), enqueued, last.cpu()

    return params, call


def sample(done: list, seed: int, min_tokens: int) -> list:
    """Indices into ``done`` (finished calls, {"S", "B"}): one call of each
    length, the longest first, then calls of the shortest length (the most
    prompts a call, for the reference's time) until the served tokens reach
    ``min_tokens``; each drawn from the seed."""
    rng = np.random.default_rng([seed, 11])
    lens = sorted({d["S"] for d in done}, reverse=True)
    pick = [int(rng.choice([i for i, d in enumerate(done) if d["S"] == S])) for S in lens]
    count = sum(done[i]["B"] for i in pick)
    for i in rng.permutation(len(done)):
        if count >= min_tokens:
            break
        if done[i]["S"] == lens[-1] and int(i) not in pick:
            pick.append(int(i))
            count += done[i]["B"]
    return pick


def reference_logits(run: Run, plan: Plan, calls: list, precs=("f32",)) -> dict:
    """{prec: [N, V]} last-position reference logits of ``calls``' prompts,
    from weights made again from the seed."""
    from bench.reference.prefill import last_logits

    leaves = {path: weights.make_leaf(run.sizes, run.seed, i, run.device, torch.bfloat16)
              for i, (path, _, _) in enumerate(weights.leaf_specs(run.sizes))}
    prompts = [torch.from_numpy(plan.prompts(d["c"], d["S"])) for d in calls]
    out = last_logits(run.sizes, leaves, prompts, precs)
    return {p: torch.cat(v) for p, v in out.items()}


def execute(run: Run) -> Outcome:
    t = run.traffic
    plan = Plan(t, run.seed, run.sizes["vocab_size"])
    params, call = _program(run)
    for i, S in enumerate(t["seq_lens"]):
        call(torch.from_numpy(plan.prompts(WARM_INDEX + i, S)).to(run.device))
    run.sync()

    tracer = Tracer(run.sync)
    items = []
    w0 = time.time()
    setup_s = w0 - run.t0

    def one(traced: bool, kept: bool = True):
        c = len(items)
        S = plan.seq_len(c)
        with record_function("bench.feed"):
            host = torch.from_numpy(plan.prompts(c, S))
        a = time.time()
        tokens = host.to(run.device)
        served, e, logits = call(tokens)
        z = time.time()
        if kept:
            items.append({"c": c, "S": S, "B": host.shape[0], "tokens": host.numel(),
                          "enqueue_s": e - a, "latency_s": z - a, "served": served,
                          "logits": logits, "traced": traced})

    while time.time() - w0 < run.seconds:
        one(False)
    window_s = time.time() - w0
    if run.trace:  # after the timed part, so that the profiler's start falls outside it
        with tracer.window():
            for _ in range(t["trace_calls"]):
                one(True)
        with tracer.host_window():
            for _ in range(t["host_trace_calls"]):
                one(False, kept=False)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0

    picked = [items[i] for i in sample(items, run.seed, t["check_tokens"])]
    logits = torch.cat([d["logits"] for d in picked])
    for d in items:
        del d["logits"]
    del params, call
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()
    r0 = time.time()
    ref = reference_logits(run, plan, picked)["f32"]
    ref_s = time.time() - r0
    served = torch.cat([d["served"] for d in picked])
    numbers = dict(compare.served_gaps(ref, served), **compare.logit_errors(ref, logits))
    timed = [d for d in items if not d["traced"]]
    lat = np.array([d["latency_s"] for d in timed])
    return Outcome(
        attempted=len(items), failed=0,
        e2e={"setup_s": setup_s,
             "prefill_tokens_per_s": sum(d["tokens"] for d in timed) / window_s,
             "prefill_p95_ms": float(np.percentile(lat, 95)) * 1e3},
        reading={"kind": "prefill", "sizes": run.sizes, "items": items, "window_s": window_s,
                 "trace": tracer.trace, "host_trace": tracer.host_trace, "peak_bytes": peak},
        numbers=numbers, peak_bytes=peak,
        detail={"checked_calls": len(picked), "checked_tokens": int(served.numel()),
                "reference_s": ref_s})
