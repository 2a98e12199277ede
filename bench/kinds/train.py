"""Traffic kind "train": back-to-back steps of the port's training step
(``repro_torch.runtime.steps.build_train_step``), each on fresh rows.

Set-up builds the one train state and step, and drives them through the
first ``check_steps`` steps (which also warm up every shape); the window
then goes on with the same objects. The reference follows those first
steps once the window has closed and the program's state is freed:
each step's loss, each slice's gradient as the optimizer got it (its
first moment after step 1, over 1 - b1), and each slice's change after
the last of them.
"""

from __future__ import annotations

import dataclasses
import gc
import math
import time

import torch
from torch.profiler import record_function

from bench.harness import compare, weights
from bench.harness.context import Outcome, Run
from bench.harness.tokens import ZipfTokens
from bench.harness.trace import Tracer

# Faults a test or the calibration may plant in the program's path.
FAULTS = ("state_unchanged", "half_batch", "labels_unshifted")


def _feed(run: Run, data: ZipfTokens, index: int) -> dict:
    t = run.traffic
    b = data.batch(index, t["batch"], t["seq_len"])
    return {k: torch.from_numpy(v).to(run.device) for k, v in b.items()}


def _model_config(sizes: dict):
    from repro_torch.models.config import ModelConfig

    names = {f.name for f in dataclasses.fields(ModelConfig)}
    return ModelConfig(**{k: v for k, v in sizes.items() if k in names})


def _program(run: Run):
    """(train state, step function) of the port, with any planted fault."""
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime import steps

    model = build_model(_model_config(run.sizes))
    params = weights.make(run.sizes, run.seed, run.device, torch.float32)
    state = steps.TrainState(params=params, opt=adamw_init(params))
    opt = AdamWConfig(**run.traffic["optimizer"])
    n_micro = run.traffic["n_micro"]
    if "labels_unshifted" in run.faults:
        loss = model.loss
        model = dataclasses.replace(model, loss=lambda p, b: loss(p, dict(b, labels=b["tokens"])))
    if "half_batch" in run.faults:
        half = steps.build_train_step(model, opt, n_micro=1)

        def step(state, batch):
            rows = batch["tokens"].shape[0] // 2
            return half(state, {k: v[:rows] for k, v in batch.items()})
    else:
        step = steps.build_train_step(model, opt, n_micro=n_micro)
    if "state_unchanged" in run.faults:
        inner = step

        def step(state, batch, _inner=inner):
            real = steps.adamw_update
            steps.adamw_update = lambda cfg, p, g, s: (p, s, {"grad_norm": torch.zeros(()),
                                                              "lr": torch.zeros(())})
            try:
                return _inner(state, batch)
            finally:
                steps.adamw_update = real
    return state, step


def _leaf_path(sizes: dict, i: int) -> tuple:
    return weights.leaf_specs(sizes)[i][0]


def _program_side(run: Run, state, step, data) -> tuple[dict, object]:
    """The first steps through the window's own call and feed, and what
    the comparison reads of them."""
    sizes, b1 = run.sizes, run.traffic["optimizer"]["b1"]
    out = {"loss": []}
    for i in range(run.traffic["check_steps"]):
        state, met = step(state, _feed(run, data, i))
        out["loss"].append(float(met["loss"]))
        if i == 0:
            m = state.opt["m"]
            out["grad"] = {k: v / (1 - b1) for k, v in weights.slice_norms(
                sizes, lambda j: weights.get(m, _leaf_path(sizes, j))).items()}
    p = state.params
    out["change"] = weights.slice_norms(
        sizes, lambda j: weights.get(p, _leaf_path(sizes, j)),
        lambda j, t: t - weights.make_leaf(sizes, run.seed, j, run.device, torch.float32))
    return out, state


def _reference_side(run: Run, data, prec: str = "f32") -> dict:
    """The reference's readings of the same first steps from the same
    weights, made again from the seed."""
    from bench.reference.train import Trainer

    sizes, t = run.sizes, run.traffic
    specs = weights.leaf_specs(sizes)
    trainer = Trainer(sizes, specs,
                      lambda j: weights.make_leaf(sizes, run.seed, j, run.device, torch.float32),
                      prec)
    names = {(i, layer): name for name, i, layer in weights.slices(sizes)}
    per = t["batch"] // t["n_micro"]
    out = {"loss": []}
    for i in range(t["check_steps"]):
        b = _feed(run, data, i)
        mbs = [{k: v[j * per:(j + 1) * per] for k, v in b.items()} for j in range(t["n_micro"])]
        loss, gnorms = trainer.train_step(mbs, t["optimizer"])
        out["loss"].append(loss)
        if i == 0:
            out["grad"] = {names[k]: v for k, v in gnorms.items()}
    out["change"] = {}
    with torch.no_grad():
        for j in range(len(specs)):
            p0 = weights.make_leaf(sizes, run.seed, j, run.device, torch.float32)
            for (i, layer), p in trainer.params.items():
                if i == j:
                    d = p - (p0 if layer is None else p0[layer])
                    out["change"][names[(i, layer)]] = float(torch.linalg.vector_norm(d))
            del p0
    return out


def _free() -> None:
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.empty_cache()


def execute(run: Run) -> Outcome:
    t = run.traffic
    data = ZipfTokens(run.sizes["vocab_size"], run.seed)
    state, step = _program(run)
    prog, state = _program_side(run, state, step, data)
    run.sync()

    tokens_per_step = t["batch"] * t["seq_len"]
    tracer = Tracer(run.sync)
    items, failed = [], 0
    k = t["check_steps"]
    w0 = time.time()
    setup_s = w0 - run.t0

    def one(traced: bool, kept: bool = True):
        nonlocal state, k, failed
        a = time.time()
        with record_function("bench.feed"):
            batch = _feed(run, data, k)
        c = time.time()
        state, met = step(state, batch)
        e = time.time()
        loss = float(met["loss"])
        z = time.time()
        k += 1
        if not kept:
            return
        failed += not math.isfinite(loss)
        items.append({"B": t["batch"], "S": t["seq_len"], "tokens": tokens_per_step,
                      "enqueue_s": e - c, "latency_s": z - a, "traced": traced})

    while time.time() - w0 < run.seconds:
        one(False)
    window_s = time.time() - w0
    if run.trace:  # after the timed part, so that the profiler's start falls outside it
        with tracer.window():
            for _ in range(t["trace_steps"]):
                one(True)
        with tracer.host_window():
            for _ in range(t["host_trace_steps"]):
                one(False, kept=False)
    peak = torch.cuda.max_memory_allocated() if torch.cuda.is_available() else 0

    del state, step
    _free()
    r0 = time.time()
    ref = run.reference or _reference_side(run, data)
    ref_s = time.time() - r0
    numbers = compare.train_numbers(prog, ref)
    detail = {"at": numbers.pop("_at"), "program_loss": prog["loss"],
              "reference_loss": ref["loss"], "reference_s": ref_s}
    timed = sum(not i["traced"] for i in items)
    return Outcome(
        attempted=len(items), failed=failed,
        e2e={"setup_s": setup_s, "train_tokens_per_s": timed * tokens_per_step / window_s},
        reading={"kind": "train", "sizes": run.sizes, "items": items, "window_s": window_s,
                 "trace": tracer.trace, "host_trace": tracer.host_trace, "peak_bytes": peak,
                 "n_micro": t["n_micro"]},
        numbers=numbers, peak_bytes=peak, detail=detail, ref=ref)
