"""The hybrid (Jamba) cell at a size the CPU holds: whole runs through
``runner.execute`` (the result's line, ``correct`` true, each planted fault
turning it false), the weights' layout
against the port's, the flop counts by hand, the readers on a recorded
reading, and the refusal of a program that has no Mamba-1 mixer."""

import json
import math

import pytest
import torch

from bench.harness import compare, hybrid_flops, hybrid_weights, registry, runner, trace
from bench.kinds import hybrid_prefill

CELL = "jamba2mini-prefill-mix"
SEED = 2**31 + 7


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def tiny_config(bench: dict, **port) -> dict:
    """The cell's configuration with every width cut and one period of
    layers: d 64, 4 heads (2 KV) of 16, d_ff 96, 4 experts, dt rank 8."""
    cfg = registry.config(bench, registry.cell(bench, CELL)["config"])
    return dict(cfg, hidden_size=64, intermediate_size=96, num_attention_heads=4,
                num_key_value_heads=2, num_hidden_layers=8, vocab_size=256,
                port=dict(cfg["port"], n_experts=4, ssm_dt_rank=8, **port))


def tiny_run(bench: dict, trace_on: bool = False, faults=(), seconds: float = 0.3, **port):
    t = registry.traffic(registry.cell(bench, CELL)["traffic"])
    t = dict(t, tokens_per_call=256, seq_lens=[32, 64, 128, 256], check_tokens=12, trace_calls=4)
    return runner.make_run(bench, CELL, SEED, seconds, trace_on, torch.device("cpu"), 0.0,
                           faults, cfg=tiny_config(bench, **port), traffic=t)


@pytest.mark.parametrize("trace_on", [False, True])
def test_result_line(bench, trace_on):
    result = runner.execute(bench, tiny_run(bench, trace_on))
    assert result["correct"] is True, result["checks"]
    keys = list(result)
    assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert keys[-1] == "checks" and set(result["checks"]) == set(compare.limits(CELL))
    names = {m["name"] for m in registry.metrics_for(bench, CELL, trace_on)}
    if trace_on:
        assert set(result["metrics"]) <= names and "hybrid_prefill_mfu_pct" in result["metrics"]
        assert {"busy_s", "window_s"} <= set(result["device"])
        assert result["detail"]["kernel_scans_per_call"] == 0  # the CPU takes the plain loop
    else:
        assert set(result["metrics"]) == names == {"setup_s", "prefill_tokens_per_s",
                                                   "prefill_p95_ms"}
    json.dumps(result)


def test_host_pass_is_one_call_a_length(bench):
    """A traced run's host pass makes one call of each length, whatever the
    seed draws, and weights each as the traffic's cycle does."""
    run = tiny_run(bench, True)
    out = hybrid_prefill.execute(run)
    spans = out.reading["spans"]
    names = [f"{hybrid_prefill.CALL_SPAN}{S}" for S in run.traffic["seq_lens"]]
    assert sorted(spans["device_s"]) == sorted(names) and spans["calls"] == 4
    assert spans["weights"] == dict(zip(names, run.traffic["cycle"]))
    assert out.detail["kernel_scans_per_call"] == 0  # the CPU takes the plain loop


@pytest.mark.parametrize("fault", hybrid_prefill.FAULTS)
def test_a_fault_is_not_correct(bench, fault):
    """Each planted fault at the tiny size, on this file's seed: the median
    row's logit error sees half a batch and half a context, the mean
    served-token gap one shifted answer a call."""
    result = runner.execute(bench, tiny_run(bench, faults=(fault,)))
    assert result["correct"] is False, result["checks"]


def test_a_program_without_mamba1_is_refused(bench):
    """A program that builds Mamba-2-style SSD layers under this
    configuration's name (one that does not know ``ssm_kind``) stops at
    set-up, before any weight is made."""
    with pytest.raises(RuntimeError, match="no Mamba-1 mixer"):
        runner.execute(bench, tiny_run(bench, ssm_kind="ssd", ssm_heads=4, ssm_chunk=16))


def test_weights_match_the_ports_layout(bench):
    from bench.kinds.train import _model_config
    from repro_torch.models.lm import build_model

    def shapes(t):
        if isinstance(t, dict):
            return {k: shapes(v) for k, v in t.items()}
        if isinstance(t, (tuple, list)):
            return tuple(shapes(v) for v in t)
        return tuple(t.shape)

    for layers in (8, 16):
        m = registry.port_sizes(dict(tiny_config(bench), num_hidden_layers=layers))
        port = build_model(_model_config(m)).init(0, device="cpu")
        ours = hybrid_weights.make(m, SEED, "cpu", torch.float32)
        assert shapes(port) == shapes(ours)
        specs = hybrid_weights.leaf_specs(m)
        for i in (5, len(specs) - 1):
            again = hybrid_weights.make_leaf(m, SEED, i, "cpu", torch.float32)
            assert torch.equal(again, hybrid_weights.get(ours, specs[i][0]))
        dt_bias = next(i for i, s in enumerate(specs) if s[0][-1] == "dt_bias")
        dt = torch.nn.functional.softplus(hybrid_weights.make_leaf(m, SEED, dt_bias, "cpu",
                                                                   torch.float32))
        assert 1e-3 * 0.999 <= float(dt.min()) and float(dt.max()) <= 0.1 * 1.001


def test_flops_by_hand(bench):
    m = registry.port_sizes(tiny_config(bench))
    d, di, N, R, ff, V = 64, 128, 16, 8, 96, 256
    mamba = d * 2 * di + di * (R + 2 * N) + R * di + di * d
    attn = d * 16 * (4 * 2 + 2 * 2)
    mlp, moe = 3 * d * ff, 2 * 3 * d * ff + d * 4
    assert hybrid_flops.active_params(m) == 7 * mamba + attn + 4 * mlp + 4 * moe + V * d
    assert hybrid_flops.mamba_layers(m) == 7
    causal = 4 * 3 * 4 * 16 * (32 * 33 // 2)
    assert hybrid_flops.prefill_flops(m, 3, 32) == \
        2 * (hybrid_flops.active_params(m) - V * d) * 96 + 2 * V * d * 3 + causal
    full = registry.port_sizes(registry.config(bench, "jamba2-mini-l16"))
    per_token = hybrid_flops.prefill_flops(full, 16, 512) / 8192
    assert 11.5e9 < per_token < 11.8e9  # about 11.6 GFLOP a token, the cell's count
    bound = hybrid_flops.scan_bound_s(full, 16, 512)
    assert bound == pytest.approx(2 * 8192 * (4 * 8192 + 32) / 3.35e12)
    assert bound > 6 * 8192 * 8192 * 16 / 67e12


def _reading(bench: dict) -> dict:
    m = registry.port_sizes(registry.config(bench, "jamba2-mini-l16"))
    items = [{"B": 16, "S": 512, "tokens": 8192, "enqueue_s": 0.05, "latency_s": 0.25,
              "traced": i >= 2} for i in range(4)]
    dev = [("void (anonymous namespace)::selective_scan_fwd<__nv_bfloat16>(ScanArgs)", 0.0, 0.01),
           ("nvjet_tst_320x128_64x3_1x2_h_bz_coopB_NNT", 0.01, 0.2),
           ("void at::native::elementwise_kernel<128, 4>(...)", 0.21, 0.05)]
    return {"kind": "prefill", "sizes": m, "items": items, "window_s": 0.5,
            "trace": trace.Trace(device=dev, host=[], lo=0.0, hi=0.3), "host_trace": None,
            "peak_bytes": 0,
            "spans": {"device_s": {"bench.call.S512": {"": 0.3, "mamba.mixer": 0.1},
                                   "bench.call.S4096": {"": 0.1, "mamba.mixer": 0.0}},
                      "weights": {"bench.call.S512": 8, "bench.call.S4096": 2}, "calls": 2}}


def test_readers_on_a_recorded_reading(bench):
    r = _reading(bench)
    read = lambda name: registry.reader(name)(r)  # noqa: E731
    m = r["sizes"]
    flops = 2 * hybrid_flops.prefill_flops(m, 16, 512)
    assert read("hybrid_prefill_mfu_pct") == pytest.approx(100 * flops / 0.5 / 989e12)
    need = 2 * 14 * hybrid_flops.scan_bound_s(m, 16, 512)
    assert read("selective_scan_roofline") == pytest.approx(100 * need / 0.01)
    # each call weighted by its length's calls a cycle
    assert read("prefill_mamba_pct") == pytest.approx(100 * (8 * 0.1) / (8 * 0.3 + 2 * 0.1))
    assert read("prefill_gemm_ms") == pytest.approx(1e3 * 0.2 / 2)
    assert read("prefill_other_ms") == pytest.approx(1e3 * 0.06 / 2)
    assert read("prefill_idle_pct") == pytest.approx(100 * (1 - 0.26 / 0.3))
    assert read("prefill_enqueue_ms") == pytest.approx(50.0)
    assert math.isfinite(read("hybrid_prefill_mfu_pct"))
    for name in ("selective_scan_roofline", "prefill_mamba_pct"):
        blank = dict(r, trace=trace.Trace(device=[], host=[], lo=0.0, hi=0.3), spans=None)
        assert registry.reader(name)(blank) is None
    other = dict(r, sizes=registry.port_sizes(registry.config(bench, "phi3.5-moe-42b-l16")))
    for name in ("hybrid_prefill_mfu_pct", "selective_scan_roofline"):
        assert registry.reader(name)(other) is None


def test_reference_against_the_port(bench):
    """The plain reference and the port in float32 compute give the same
    prefill logits at the tiny size."""
    from bench.kinds.train import _model_config
    from bench.reference.hybrid import last_logits
    from repro_torch.models.lm import build_model

    m = registry.port_sizes(tiny_config(bench))
    model = build_model(_model_config(m), compute_dtype=torch.float32)
    leaves = {p: hybrid_weights.make_leaf(m, SEED, i, "cpu", torch.float32)
              for i, (p, _, _) in enumerate(hybrid_weights.leaf_specs(m))}
    params = hybrid_weights.tree(m, leaves)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, m["vocab_size"], (B, S), generator=gen)
               for B, S in ((3, 40), (1, 96))]
    ref = last_logits(m, leaves, prompts)["f32"]
    with torch.no_grad():
        for t, r in zip(prompts, ref):
            got = model.prefill(params, t)[:, -1]
            assert torch.allclose(got, r, rtol=1e-4, atol=1e-4), (got - r).abs().max()
