"""The port's gradient-sync planner (``distribution/plan.py``) and trace
exporters (``obs/export.py``, ``obs/report.py``) against the JAX package.

Every comparison is exact. ``backward_profile`` is compared with
``chip_flops`` passed explicitly (the two packages' defaults name
different chips). The exporters are compared on a synthetic tracer and on
a traced greedy-list serve; wall-clock readings differ between two runs,
so the reference's are copied onto the port's records by index before
export: every span's ``t0``/``t1`` and every event's ``t``. The serve's
Prometheus text is compared line by line except for the two registry
entries that hold wall-clock readings, the ``serve_wall`` counter and the
``epoch_latency`` series.
"""

import dataclasses
import json
import sys
from pathlib import Path

import numpy as np
import pytest

import repro.obs as RO
import repro.obs.report as RR
import repro.online as RON
import repro_torch.obs as TO
import repro_torch.obs.report as TR
import repro_torch.online as TON
from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distribution import plan as tplan

TOOLS = str(Path(__file__).resolve().parents[1] / "tools")
WALL_CLOCK_METRICS = ("serve_wall", "epoch_latency")


def _rplan():
    # tests/test_analysis_and_plan.py imports jax at its top; the planner
    # itself is NumPy, so it is imported here, inside the tests.
    from repro.distribution import plan

    return plan


# ---------------------------------------------------------------------------
# distribution/plan.py
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCH_IDS)
@pytest.mark.parametrize("chip_flops,groups", [(197e12, 8), (989e12, 5)])
def test_backward_profile_equal(arch, chip_flops, groups):
    from repro.configs import get_config as rget

    rp = _rplan()
    a = rp.backward_profile(rget(arch), tokens_per_device=4096,
                            chip_flops=chip_flops, groups=groups)
    b = tplan.backward_profile(get_config(arch), tokens_per_device=4096,
                               chip_flops=chip_flops, groups=groups)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and np.array_equal(x, y)


def test_backward_profile_default_is_the_h100_rate():
    cfg = get_config("llama3_2_3b")
    a = tplan.backward_profile(cfg, tokens_per_device=4096)
    b = tplan.backward_profile(cfg, tokens_per_device=4096, chip_flops=989e12)
    assert all(np.array_equal(x, y) for x, y in zip(a, b))


def _same_plan(a, b):
    assert a.t_optimal == b.t_optimal
    assert a.t_greedy == b.t_greedy
    assert a.t_serial == b.t_serial
    assert a.proved_optimal == b.proved_optimal
    np.testing.assert_array_equal(a.channel_of_bucket, b.channel_of_bucket)
    for f in ("rack", "start", "chan", "tstart"):
        np.testing.assert_array_equal(getattr(a.schedule, f), getattr(b.schedule, f))


# tests/test_analysis_and_plan.py:72-107's inputs.
PLAN_CASES = [
    ([0.5, 0.4, 0.6, 0.3], [4e9, 3e9, 5e9, 2e9], {}),
    ([0.01] * 4, [10e9] * 4, dict(ici_share=5e9, aux_channels=0)),
    ([0.01] * 4, [10e9] * 4, dict(ici_share=5e9, aux_channels=3, aux_rate=5e9)),
]


@pytest.mark.parametrize("secs,nbytes,link", PLAN_CASES)
def test_plan_gradient_schedule_equal(secs, nbytes, link):
    rp = _rplan()
    g_secs, g_bytes = np.asarray(secs), np.asarray(nbytes)
    a = rp.plan_gradient_schedule(g_secs, g_bytes, rp.LinkSpec(**link), time_limit=5.0)
    b = tplan.plan_gradient_schedule(g_secs, g_bytes, tplan.LinkSpec(**link), time_limit=5.0)
    _same_plan(a, b)


@pytest.mark.parametrize("kw", [{}, dict(compute_slowdown=2.0), dict(degraded_aux=0),
                                dict(compute_slowdown=1.6, degraded_aux=1)])
def test_replan_equal(kw):
    rp = _rplan()
    g_secs, g_bytes = np.full(4, 0.5), np.full(4, 2e9)
    _same_plan(rp.replan(g_secs, g_bytes, rp.LinkSpec(), **kw),
               tplan.replan(g_secs, g_bytes, tplan.LinkSpec(), **kw))


def test_replan_equal_at_a_models_width():
    """examples/schedule_cluster.py's re-plan: llama3.2-3b, 4096 tokens."""
    rp = _rplan()
    g_secs, g_bytes = tplan.backward_profile(get_config("llama3_2_3b"), 4096,
                                             chip_flops=989e12)
    for kw in ({}, dict(compute_slowdown=1.6, degraded_aux=1)):
        a = rp.replan(g_secs, g_bytes, rp.LinkSpec(), **kw)
        b = tplan.replan(g_secs, g_bytes, tplan.LinkSpec(), **kw)
        _same_plan(a, b)
        assert b.t_optimal <= b.t_greedy + 1e-9 and b.t_optimal <= b.t_serial + 1e-9


# ---------------------------------------------------------------------------
# obs/export.py on a synthetic tracer (tests/test_obs.py:137-200's records)
# ---------------------------------------------------------------------------


def _fill(O, ON, case):
    tr = O.Tracer()
    if case == "structure":
        with tr.span("epoch", epoch=0):
            tr.event("fleet_solve", n_candidates=np.int64(12), gain=float("nan"))
        tr.job(7, "arrival", 10.0, family="mapreduce")
        tr.job(7, "admit", 12.5, backfilled=np.bool_(False))
        tr.job(7, "complete", 20.0, makespan=7.5)
    elif case == "open_span":
        tr.span("never_exited")
    elif case == "metrics":
        tr.count("serve_epochs", 14)
        tr.gauge("slo_attainment", 0.75, tier="gold")
        tr.gauge("slo_attainment", 1.0, tier="bronze")
        for v in (1.0, 2.0, 3.0, 4.0):
            tr.observe("epoch_latency", v)
        tr.observe("queueing_delay", 9.0, tenant="t0")
    elif case == "empty_series":
        tr.adopt_series("jct", ON.StreamingSeries())
    return tr


def _copy_wall_clock(ref, port):
    """The reference's span t0/t1 and event t onto the port's records."""
    assert len(ref.spans) == len(port.spans) and len(ref.events) == len(port.events)
    for a, b in zip(ref.spans, port.spans):
        assert a.name == b.name
        b.t0, b.t1 = a.t0, a.t1
    port.events[:] = [dataclasses.replace(b, t=a.t) for a, b in zip(ref.events, port.events)]


@pytest.mark.parametrize("case", ["structure", "open_span", "metrics", "empty_series"])
def test_exporters_equal_on_synthetic_tracer(case):
    ref, port = _fill(RO, RON, case), _fill(TO, TON, case)
    _copy_wall_clock(ref, port)
    a, b = RO.chrome_trace_events(ref), TO.chrome_trace_events(port)
    assert a == b
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    assert RO.prometheus_exposition(ref) == TO.prometheus_exposition(port)


# ---------------------------------------------------------------------------
# Exporters and report on a traced greedy-list serve (tests/test_obs.py:291)
# ---------------------------------------------------------------------------


def _serve(ON, O, **kw):
    tr = O.Tracer()
    res = ON.OnlineScheduler(4, 2, window=4.0, policy="greedy_list", seed=11,
                             track_epoch_latency=True, tracer=tr, **kw).serve(
        ON.poisson_arrivals(11, rate=1 / 8, n_jobs=10, n_racks=4, n_wireless=2))
    return tr, res


@pytest.fixture(scope="module")
def traced(tmp_path_factory):
    ref, ref_res = _serve(RON, RO)
    port, port_res = _serve(TON, TO, device="cpu")
    _copy_wall_clock(ref, port)
    d = tmp_path_factory.mktemp("traces")
    RO.write_chrome_trace(ref, d / "ref.json")
    TO.write_chrome_trace(port, d / "port.json")
    return dict(ref=ref, port=port, ref_res=ref_res, port_res=port_res,
                ref_path=d / "ref.json", port_path=d / "port.json")


def test_serve_trace_documents_equal(traced):
    assert RO.chrome_trace_events(traced["ref"]) == TO.chrome_trace_events(traced["port"])
    ref_doc = json.loads(traced["ref_path"].read_text())
    port_doc = json.loads(traced["port_path"].read_text())
    assert ref_doc == port_doc
    assert TR.load_trace(traced["port_path"]) == RR.load_trace(traced["ref_path"])


def test_serve_prometheus_equal_apart_from_wall_clock(traced):
    def lines(text):
        return [ln for ln in text.splitlines()
                if not any(w in ln for w in WALL_CLOCK_METRICS)]

    a = RO.prometheus_exposition(traced["ref"])
    b = TO.prometheus_exposition(traced["port"])
    assert lines(a) == lines(b)
    assert len(lines(b)) < len(b.splitlines())  # the wall-clock lines exist


def test_serve_report_equal(traced):
    trace = TR.load_trace(traced["port_path"])
    ref_trace = RR.load_trace(traced["ref_path"])
    assert TR.report_dict(trace, top=3) == RR.report_dict(ref_trace, top=3)
    job = TR.job_table(trace, top=1)[0]["job_id"]
    assert TR.report_dict(trace, top=5, job=job) == RR.report_dict(ref_trace, top=5, job=job)
    assert TR.render_report(trace, top=3, job=job) == RR.render_report(ref_trace, top=3, job=job)
    rows = TR.epoch_breakdown(trace)
    assert len(rows) == traced["port_res"].n_epochs
    assert TR.commit_latency_total(trace) == pytest.approx(
        sum(traced["ref_res"].epoch_commit_latency), rel=0.01)  # tests/test_obs.py:306


def test_trace_report_tool_reads_the_ports_trace(traced, capsys):
    sys.path.insert(0, TOOLS)
    try:
        import trace_report
    finally:
        sys.path.pop(0)
    trace = TR.load_trace(traced["port_path"])
    job = TR.job_table(trace, top=1)[0]["job_id"]
    assert trace_report.main([str(traced["port_path"]), "--top", "3", "--job", str(job)]) == 0
    out = capsys.readouterr().out
    assert out == TR.render_report(trace, top=3, job=job) + "\n"
    assert "per-epoch latency breakdown" in out
