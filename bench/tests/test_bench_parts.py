"""The harness's parts at a size the CPU holds: the traffic, the FLOP
counts, the weights' layout, the trace's reductions and each per-layer
reader on a small recorded profile, and the import rules."""

import ast
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from bench.harness import flops, kernels, readings, registry, trace, weights
from bench.harness.tokens import ZipfTokens
from bench.kinds.prefill import Plan

BENCH = Path(__file__).resolve().parents[1]
SEED = 3_000_000_019  # more than 32 signed bits hold


def test_tokens_follow_the_seed():
    a, b, c = ZipfTokens(1000, SEED), ZipfTokens(1000, SEED), ZipfTokens(1000, SEED + 1)
    x, y, z = a.batch(3, 4, 64), b.batch(3, 4, 64), c.batch(3, 4, 64)
    assert np.array_equal(x["tokens"], y["tokens"]) and np.array_equal(x["labels"], y["labels"])
    assert not np.array_equal(x["tokens"], z["tokens"])
    assert not np.array_equal(x["tokens"], a.batch(4, 4, 64)["tokens"])
    assert np.array_equal(x["tokens"][:, 1:], x["labels"][:, :-1])
    assert x["tokens"].dtype == np.int32 and x["tokens"].max() < 1000


def test_prefill_plan_gives_every_seed_the_same_work():
    t = registry.traffic("prefill-mix")
    p, q, r = Plan(t, SEED, 500), Plan(t, SEED, 500), Plan(t, SEED + 1, 500)
    n = len(p.cycle)
    assert n == sum(t["cycle"])
    lens = [p.seq_len(c) for c in range(3 * n)]
    assert lens == [q.seq_len(c) for c in range(3 * n)]
    assert lens != [r.seq_len(c) for c in range(3 * n)]
    for k in range(3):
        cyc = lens[k * n:(k + 1) * n]
        assert sorted(cyc) == sorted([r.seq_len(c) for c in range(k * n, (k + 1) * n)])
        assert {S: cyc.count(S) for S in t["seq_lens"]} == dict(zip(t["seq_lens"], t["cycle"]))
    for c in range(n):
        S = p.seq_len(c)
        assert p.prompts(c).shape == (t["tokens_per_call"] // S, S)


def test_flops_by_hand():
    assert flops.pairs(4, 4, True) == 10 and flops.pairs(4, 4, False) == 16
    assert flops.pairs(5, 3, True) == 6 + 2 * 3
    # B 2, S 8, H 3, D 4, causal: 36 pairs, 4 * 2 * 3 * 4 flops each.
    assert flops.flash_flops(2, 8, 8, 3, 4, True) == 36 * 96
    bwd = flops.flash_backward_flops(2, 8, 8, 3, 4, True)
    assert bwd == {"fwd": 36 * 96, "delta": 2 * 2 * 8 * 3 * 4, "dkdv": 2 * 36 * 96,
                   "dq": 36 * 96 * 3 // 2}
    m = {"d_model": 8, "n_layers": 2, "head_dim": 2, "n_heads": 4, "n_kv_heads": 2,
         "d_ff": 16, "vocab_size": 10}
    attn = 8 * 2 * (4 * 2 + 2 * 2)  # wq + wo, wk + wv
    mlp = 3 * 8 * 16
    assert flops.active_params(m) == 2 * (attn + mlp) + 80
    moe = dict(m, n_experts=4, experts_per_token=2)
    assert flops.active_params(moe) == 2 * (attn + 2 * mlp + 32) + 80
    att = 2 * flops.flash_flops(3, 16, 16, 4, 2, True)
    assert flops.train_step_flops(m, 3, 16) == 6 * (2 * (attn + mlp) + 80) * 48 + 3.5 * att
    assert flops.prefill_flops(m, 3, 16) == 2 * 2 * (attn + mlp) * 48 + 2 * 80 * 3 + att
    b = flops.flash_bounds(1, 4096, 32, 32, 96)
    assert b["fwd"] == pytest.approx(flops.flash_flops(1, 4096, 4096, 32, 96, True) / 989e12)


def test_weights_match_the_ports_layout():
    from repro_torch.models.config import ModelConfig
    from repro_torch.models.lm import build_model

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(shapes(v) for v in t)
        return tuple(t.shape)

    for experts in (0, 4):
        kw = dict(name="t", family="moe" if experts else "dense", n_layers=2, d_model=32,
                  n_heads=4, n_kv_heads=2, d_ff=48, vocab_size=64, n_experts=experts,
                  experts_per_token=2 if experts else 0)
        port = build_model(ModelConfig(**kw)).init(0, device="cpu")
        ours = weights.make(dict(kw, head_dim=8), SEED, "cpu", torch.float32)
        assert shapes(port) == shapes(ours)
        again = weights.make_leaf(dict(kw, head_dim=8), SEED, 4, "cpu", torch.float32)
        assert torch.equal(again, weights.get(ours, weights.leaf_specs(dict(kw, head_dim=8))[4][0]))


def _trace() -> trace.Trace:
    # Two traced steps over [0, 10] s: a GEMM, an elementwise kernel and two
    # attention kernels; the host syncs in [6, 8] and feeds in [9, 10].
    dev = [("void nvjet_hsh_128x256(...)", 0.0, 2.0), ("void flash_fwd_bf16<96>(...)", 2.0, 1.0),
           ("void flash_bwd_dq_bf16<96>(...)", 3.0, 1.0),
           ("void at::native::vectorized_elementwise_kernel<4>(...)", 4.0, 2.0),
           ("sm90_xmma_gemm_bf16bf16", 8.0, 1.0), ("late", 11.0, 1.0)]
    host = [("cudaStreamSynchronize", 6.0, 2.0), ("bench.feed", 9.0, 1.0),
            ("aten::mm", 8.0, 1.0)]
    return trace.Trace(device=dev, host=host, lo=0.0, hi=10.0)


def test_trace_reductions():
    tr = _trace()
    assert trace.busy_s(tr) == pytest.approx(7.0)
    assert trace.top_ops(tr)[0] == ["void nvjet_hsh_128x256(...)", 2.0]
    assert dict(map(tuple, trace.idle_gaps(tr))) == {"cudaStreamSynchronize": 2.0,
                                                     "bench.feed": 1.0}
    assert [kernels.kind(n) for n, _, _ in tr.device[:5]] == [
        "gemm", "attention", "attention", "other", "gemm"]
    assert kernels.attention_kind("void flash_bwd_dkdv_bf16<96>(...)") == "dkdv"
    assert kernels.attention_kind("flash_bwd_delta_kernel") == "delta"
    assert kernels.attention_kind(
        "void (anonymous namespace)::tc::flash_fwd_bf16<96>(CUtensorMap_st, Params)") == "fwd"
    assert kernels.kind("void (anonymous namespace)::tc::flash_bwd_dq_bf16<96>(int)") == "attention"


def _reading(kind: str) -> dict:
    m = registry.port_sizes(registry.config(registry.benchmark(), "phi3-mini-3.8b"))
    items = [{"B": 2, "S": 4096, "tokens": 8192, "enqueue_s": e, "latency_s": 1.0,
              "traced": i in (1, 2)} for i, e in enumerate((0.1, 0.3, 0.2, 0.4))]
    return {"kind": kind, "sizes": m, "items": items, "window_s": 4.0, "trace": _trace(),
            "peak_bytes": 3 * 2**30, "n_micro": 2}


def test_readers_on_a_recorded_profile():
    r = _reading("train")
    read = lambda name, rd=r: registry.reader(name)(rd)  # noqa: E731
    assert read("train_gemm_ms") == pytest.approx(1e3 * 3.0 / 2)
    assert read("train_eltwise_ms") == pytest.approx(1e3 * 2.0 / 2)
    assert read("train_idle_pct") == pytest.approx(30.0)
    assert read("train_enqueue_ms") == pytest.approx(250.0)
    assert read("train_peak_gib") == pytest.approx(3.0)
    step = flops.train_step_flops(r["sizes"], 2, 4096)
    assert read("train_mfu_pct") == pytest.approx(100 * 2 * step / 4.0 / 989e12)
    b = flops.flash_bounds(1, 4096, 32, 32, 96)
    assert read("flash_fwd_bwd_roofline") == pytest.approx(100 * (b["fwd_lse"] + b["dq"]) / 2.0)
    for name in ("prefill_gemm_ms", "prefill_other_ms", "flash_fwd_roofline", "prefill_idle_pct",
                 "prefill_mfu_pct", "prefill_enqueue_ms"):
        assert read(name) is None
    p = _reading("prefill")
    assert registry.reader("prefill_other_ms")(p) == pytest.approx(1e3)
    fwd = flops.flash_bounds(2, 4096, 32, 32, 96)["fwd"]
    assert registry.reader("flash_fwd_roofline")(p) == pytest.approx(100 * 2 * 32 * fwd / 2.0)
    assert registry.reader("train_gemm_ms")(p) is None
    p["trace"] = None
    assert registry.reader("prefill_gemm_ms")(p) is None


def test_readers_read_nothing_without_attention():
    r = _reading("train")
    r["trace"] = trace.Trace(device=[("void nvjet(...)", 0.0, 1.0)], host=[], lo=0.0, hi=2.0)
    assert readings.attention_roofline_pct(r, "train") is None


FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _imports(path: Path) -> set:
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            out.add(node.module)
    return out


def test_nothing_imports_jax_or_the_jax_package():
    files = list(BENCH.rglob("*.py"))
    assert files
    for f in files:
        tops = {name.split(".", 1)[0] for name in _imports(f)}
        assert not tops & FORBIDDEN, (f, tops & FORBIDDEN)


def test_the_reference_imports_nothing_of_the_program():
    for f in (BENCH / "reference").rglob("*.py"):
        tops = {name.split(".", 1)[0] for name in _imports(f)}
        assert not tops & (FORBIDDEN | {"repro_torch"}), f
        assert all(name.startswith("bench.reference") or "." not in name
                   or name.split(".", 1)[0] == "torch"
                   for name in _imports(f) if name.startswith("bench")), f


def test_forbidden_modules_compares_whole_names(monkeypatch):
    import sys

    from bench import run

    monkeypatch.setitem(sys.modules, "repro_torch_like", sys)
    assert run.forbidden_modules() == [n for n in run.forbidden_modules()
                                       if n.split(".", 1)[0] in FORBIDDEN]
    assert "repro_torch_like" not in run.forbidden_modules()
    monkeypatch.setitem(sys.modules, "repro.core", sys)
    assert "repro.core" in run.forbidden_modules()


def test_served_gaps():
    from bench.harness.compare import served_gaps, worst_leaf_gap

    ref = torch.tensor([[0.0, 1.0, 3.0, 2.0], [5.0, 0.0, 0.0, 1.0]])
    assert served_gaps(ref, torch.tensor([2, 0])) == {"gap": 0.0, "gap_mean": 0.0,
                                                      "gap_share": 0.0}
    std = ref[0].std().item()
    got = served_gaps(ref, torch.tensor([3, 0]))
    assert got["gap"] == pytest.approx(1.0 / std) and got["gap_share"] == 0.5
    assert got["gap_mean"] == pytest.approx(0.5 / std)
    gap, at = worst_leaf_gap({"a": 1.0, "b": 2.2, "c": 0.0}, {"a": 1.0, "b": 2.0, "c": 1e-9})
    assert at == "b" and gap == pytest.approx(0.1)
    assert math.isclose(worst_leaf_gap({"a": 0.0}, {"a": 2.0})[0], 1.0)


def test_logit_errors():
    from bench.harness.compare import logit_errors

    ref = torch.tensor([[0.0, 1.0, 3.0, 2.0], [5.0, 0.0, 0.0, 1.0], [1.0, 2.0, 3.0, 4.0]])
    assert logit_errors(ref, ref.to(torch.bfloat16)) == {"logit_err": 0.0, "logit_err_mean": 0.0,
                                                         "logit_err_max": 0.0}
    moved = ref.clone()
    moved[1] += torch.tensor([1.0, -1.0, 1.0, -1.0])
    got = logit_errors(ref, moved)
    assert got["logit_err"] == 0.0
    assert got["logit_err_max"] == pytest.approx(1.0 / ref[1].std().item())
    assert got["logit_err_mean"] == pytest.approx(got["logit_err_max"] / 3)


def test_tracer_passes():
    """The first pass records no host operation and measures its window on
    the host's clock; the second records the host's operations inside its
    window mark."""
    tracer = trace.Tracer(lambda: None)
    x = torch.ones(64, 64)
    with tracer.window():
        (x @ x).sum()
    with tracer.host_window():
        (x @ x).sum()
    assert tracer.trace.host == [] and tracer.trace.window_s > 0
    host = tracer.host_trace
    assert host.hi > host.lo and any(name == "aten::mm" for name, _, _ in host.host)
