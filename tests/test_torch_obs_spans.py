"""The program spans and the dropped-pair counter of the port's training
step and MoE layer (``repro_torch.obs.trace.installed`` / ``current``),
on the CPU with smoke configs: the values with a tracer installed equal
those without, the spans nest as the phases do, they reach
``torch.profiler`` as ``record_function`` events, and the counter equals
a NumPy recount of the pairs over the capacity."""

import collections
import dataclasses

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.configs import smoke_config
from repro_torch.models import moe as tmoe
from repro_torch.models.lm import build_model
from repro_torch.obs import NULL_TRACER, Tracer, current, installed, prometheus_exposition
from repro_torch.optim.adamw import AdamWConfig, tree_leaves
from repro_torch.optim.grad import accumulate_grads
from repro_torch.runtime.steps import build_prefill_step, build_train_step, make_train_state

TRAIN_SPANS = {"train.step", "train.forward", "train.backward", "grad.scale", "optim.clip",
               "optim.adamw", "lm.period", "lm.loss_chunk", "lm.recompute"}
MOE_SPANS = {"moe.route", "moe.aux", "moe.dispatch", "moe.experts", "moe.combine"}


def _cfg(arch: str, cf: float | None = None):
    cfg = smoke_config(arch)
    return cfg if cf is None else dataclasses.replace(cfg, capacity_factor=cf)


def _batch(cfg, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int64))
            for k in ("tokens", "labels")}


def _train(cfg, tracer=None, n_micro=2):
    """(state, metrics) after one step from seed 0, under ``tracer``."""
    model = build_model(cfg)
    step = build_train_step(model, AdamWConfig(warmup_steps=1, total_steps=10), n_micro=n_micro)
    state = make_train_state(model, 0, device="cpu")
    if tracer is None:
        return step(state, _batch(cfg))
    with installed(tracer):
        return step(state, _batch(cfg))


def _paths(tr: Tracer) -> collections.Counter:
    """How often each span opened, by its path of names from the root."""
    out = collections.Counter()
    for sp in tr.spans:
        names = [sp.name]
        while sp.parent >= 0:
            sp = tr.spans[sp.parent]
            names.append(sp.name)
        out["/".join(reversed(names))] += 1
    return out


def test_nothing_installed_is_the_null_tracer():
    assert current() is NULL_TRACER
    assert current().span("train.step") is NULL_TRACER.span("lm.period")


def test_installed_restores_the_previous_tracer_after_an_exception():
    outer, inner = Tracer(), Tracer()
    with installed(outer):
        with pytest.raises(RuntimeError):
            with installed(inner):
                assert current() is inner
                raise RuntimeError("inside")
        assert current() is outer
    assert current() is NULL_TRACER


@pytest.mark.parametrize("arch,cf", [("phi3_mini_3_8b", None), ("phi3_5_moe_42b", 0.5)])
def test_train_step_equal_with_and_without_a_tracer(arch, cf):
    """The state and the metrics after a step; the MoE case drops pairs."""
    cfg = _cfg(arch, cf)
    want_state, want = _train(cfg)
    got_state, got = _train(cfg, Tracer())
    for k in ("loss", "grad_norm", "lr"):
        assert torch.equal(got[k], want[k]), k
    for a, b in zip(tree_leaves((got_state.params, got_state.opt["m"], got_state.opt["v"])),
                    tree_leaves((want_state.params, want_state.opt["m"], want_state.opt["v"]))):
        assert torch.equal(a, b)
    assert torch.equal(got_state.opt["step"], want_state.opt["step"])


@pytest.mark.parametrize("arch,cf", [("phi3_mini_3_8b", None), ("phi3_5_moe_42b", 0.5)])
def test_gradients_equal_with_and_without_a_tracer(arch, cf):
    cfg = _cfg(arch, cf)
    model = build_model(cfg)
    batch = _batch(cfg)
    mbs = [{k: v[i:i + 1] for k, v in batch.items()} for i in range(2)]

    def grads():
        params = model.init(0, device="cpu")
        for t in tree_leaves(params):
            t.requires_grad_(True)
        loss, g = accumulate_grads(model.loss, params, mbs)
        return loss, tree_leaves(g)

    want_loss, want = grads()
    with installed(Tracer()):
        got_loss, got = grads()
    assert torch.equal(got_loss, want_loss)
    assert len(got) == len(want)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_train_spans_nest_as_the_phases():
    """``train.step`` holds each micro-batch's forward and backward, the
    gradient scale, the clip and AdamW; the forward holds the periods and
    the loss chunks, with the MoE phases in each period; the backward holds
    the recompute of each period and each loss chunk."""
    cfg = _cfg("phi3_5_moe_42b", 0.5)
    tr = Tracer()
    _train(cfg, tr, n_micro=2)
    paths = _paths(tr)
    periods = cfg.n_layers  # one layer a period
    chunks = 1  # S 32 is one loss chunk
    fwd, bwd = "train.step/train.forward", "train.step/train.backward/lm.recompute"
    want = {"train.step": 1, "train.step/train.forward": 2, "train.step/train.backward": 2,
            "train.step/grad.scale": 1, "train.step/optim.clip": 1, "train.step/optim.adamw": 1,
            f"{fwd}/lm.period": 2 * periods, f"{fwd}/lm.loss_chunk": 2 * chunks,
            "train.step/train.backward/lm.recompute": 2 * (periods + chunks),
            f"{bwd}/lm.period": 2 * periods, f"{bwd}/lm.loss_chunk": 2 * chunks}
    for name in sorted(MOE_SPANS):
        want[f"{fwd}/lm.period/{name}"] = 2 * periods
        want[f"{bwd}/lm.period/{name}"] = 2 * periods
    assert dict(paths) == want
    assert all(sp.duration >= 0 for sp in tr.spans)


def test_prefill_spans_and_values():
    cfg = _cfg("phi3_5_moe_42b", 0.5)
    model = build_model(cfg)
    params = model.init(0, device="cpu", dtype=torch.bfloat16)
    prefill = build_prefill_step(model)
    batch = {"tokens": _batch(cfg)["tokens"]}
    want = prefill(params, batch)
    tr = Tracer()
    with installed(tr):
        got = prefill(params, batch)
    assert torch.equal(got, want)
    want_paths = {"prefill.step": 1, "prefill.step/lm.period": cfg.n_layers}
    want_paths.update({f"prefill.step/lm.period/{n}": cfg.n_layers for n in MOE_SPANS})
    assert dict(_paths(tr)) == want_paths


def test_spans_reach_the_profiler_only_with_a_tracer_installed():
    """Under ``torch.profiler`` (CPU) each span is a ``record_function``
    event of its name, once per opening; with nothing installed there is
    none."""
    cfg = _cfg("phi3_5_moe_42b", 0.5)
    spans = TRAIN_SPANS | MOE_SPANS
    tr = Tracer()
    with profile(activities=[ProfilerActivity.CPU]) as prof, installed(tr):
        _train(cfg)
    events = collections.Counter(e.name for e in prof.events() if e.name in spans)
    assert events == collections.Counter(sp.name for sp in tr.spans)
    assert set(events) == spans
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(cfg)
    assert not [e.name for e in prof.events() if e.name in spans]


@pytest.mark.parametrize("cf,binds", [(0.5, True), (1.0, True), (8.0, False)])
def test_dropped_pairs_equal_a_numpy_recount(cf, binds):
    """``moe.dropped_pairs``: each expert's pairs beyond ``capacity()``,
    from the routing's expert ids; ``moe.pairs``: T x k."""
    E, k, d, B, S = 4, 2, 32, 2, 24
    gen = torch.Generator().manual_seed(3)
    params = tmoe.init_moe(gen, d, 48, E)
    x = torch.randn((B, S, d), generator=gen)
    tr = Tracer()
    with torch.no_grad():
        want, _ = tmoe.moe_ffn(params, x, E, k, capacity_factor=cf)
        with installed(tr):
            got, _ = tmoe.moe_ffn(params, x, E, k, capacity_factor=cf)
        _, _, experts = tmoe._route(x.reshape(B * S, d), params["router"]["w"], k, True)
    assert torch.equal(got, want)
    cap = tmoe.capacity(B * S, k, E, cf)
    counts = np.bincount(experts.numpy().ravel(), minlength=E)
    dropped = int(np.maximum(counts - cap, 0).sum())
    assert (dropped > 0) == binds
    assert isinstance(tr.counters[tmoe.DROPPED_PAIRS], torch.Tensor)
    assert tr.counter(tmoe.DROPPED_PAIRS) == dropped
    assert tr.counter(tmoe.PAIRS) == B * S * k
    assert [sp.name for sp in tr.spans] == ["moe.route", "moe.aux", "moe.dispatch",
                                            "moe.experts", "moe.combine"]


def test_device_counter_sums_on_its_device_and_reads_as_a_float():
    tr = Tracer()
    tr.count("pairs", torch.tensor(3))
    tr.count("pairs", torch.tensor(4))
    tr.count("host")
    assert tr.counters["pairs"].dtype == torch.int64
    assert tr.counter("pairs") == 7.0 and tr.counter("host") == 1.0
    assert tr.counter("never") == 0.0
    assert "pairs 7\n" in prometheus_exposition(tr)
    NULL_TRACER.count("pairs", torch.tensor(1))  # a no-op


def test_mesh_route_opens_the_moe_spans_and_counts_no_pairs():
    """On a one-rank gloo mesh the MoE layer takes ``_sharded_moe``: the
    step equals the untraced one on the mesh, its MoE phases open the same
    spans, and no pair is counted."""
    import torch.distributed as dist

    from repro_torch.distribution import sharding as TS
    from repro_torch.launch.mesh import make_local_mesh
    from repro_torch.models.layers import activation_sharding

    started = not dist.is_initialized()
    mesh = make_local_mesh(device="cpu")
    try:
        cfg = _cfg("phi3_5_moe_42b", 0.5)
        model = build_model(cfg, compute_dtype=torch.float32)
        step = build_train_step(model, AdamWConfig(warmup_steps=1, total_steps=10))
        batch = _batch(cfg, S=16)

        def run(tracer):
            with activation_sharding(TS.activation_rules(mesh)), installed(tracer):
                state = make_train_state(model, 0, device="cpu")
                state = TS.distribute(state, TS.state_sharding(state, mesh))
                state, met = step(state, TS.distribute(batch, TS.batch_sharding(batch, mesh)))
            return TS.gather(state), met

        (want_state, want), tr = run(NULL_TRACER), Tracer()
        got_state, got = run(tr)
    finally:
        if started:
            dist.destroy_process_group()
    assert torch.equal(got["loss"], want["loss"])
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got_state.params),
                                                 tree_leaves(want_state.params)))
    names = collections.Counter(sp.name for sp in tr.spans)
    assert all(names[n] == 2 * cfg.n_layers for n in MOE_SPANS)
    assert not tr.counters
