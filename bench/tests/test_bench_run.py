"""Whole runs with the look for a card skipped, at a size the CPU holds:
the result's line, the traced run's reading, and ``correct`` coming out
false with the timed path broken underneath (each fault the cell can
have) and with the control in the program's place. The cells' own limits
(``bench/limits``) judge; the command itself refuses to run without a
card."""

import json
import subprocess
import sys

import pytest
import torch

from bench.harness import compare, registry, runner
from bench.tests import tiny

TRAIN, MOE, DENSE = "phi3mini-train-s4k", "phi35moe-prefill-mix", "phi3mini-prefill-mix"


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


@pytest.mark.parametrize("cell", [TRAIN, DENSE, MOE])
def test_result_line(bench, cell):
    for trace in (False, True):
        result = runner.execute(bench, tiny.run(bench, cell, trace=trace))
        keys = list(result)
        assert keys[:5] == ["correct", "attempted", "failed", "metrics", "device"]
        assert keys[-1] == "checks"
        assert set(result["checks"]) == set(compare.limits(cell))
        assert all(set(c) == {"value", "limit"} for c in result["checks"].values())
        assert result["attempted"] >= 1 and result["failed"] == 0
        names = {m["name"] for m in registry.metrics_for(bench, cell, trace)}
        if trace:
            assert set(result["metrics"]) <= names
            assert {"busy_s", "window_s"} <= set(result["device"])
            assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
        else:
            assert set(result["metrics"]) == names
        json.dumps(result)


def test_a_sound_run_is_correct(bench):
    """The dense prefill at this size within its cell's limit. (A tiny
    training run's slices, two layers after two steps, read nearer the
    training limits than the cell's own do: the reference test holds the
    training step there instead.)"""
    assert runner.execute(bench, tiny.run(bench, DENSE))["correct"] is True


# The MoE cell compares the median row's logit error, which one answer
# shifted a call leaves unmoved; no number that sees that fault also
# stands three times apart from the float8 control there, since routing
# near-ties spread single rows' errors in sound runs (PERF.md). The dense
# cell, on the same prefill path, catches it.
FAULTS = [(TRAIN, "state_unchanged"), (TRAIN, "half_batch"), (TRAIN, "labels_unshifted"),
          (DENSE, "half_batch"), (DENSE, "token_altered"), (MOE, "half_batch")]


@pytest.mark.parametrize("cell,fault", FAULTS)
def test_a_fault_is_not_correct(bench, cell, fault):
    result = runner.execute(bench, tiny.run(bench, cell, faults=(fault,)))
    assert result["correct"] is False, result["checks"]


@pytest.mark.parametrize("cell", [TRAIN, DENSE, MOE])
def test_the_control_stands_apart(bench, cell, monkeypatch):
    """The control (bench/calibrate.py: the reference in float8 in the
    program's place) at a size a test run holds. The cells' limits are set
    from the control's readings on the card at the cells' own sizes; here,
    where fewer layers and tokens lower every reading, the control reads at
    least three times what the program does on the same seeds, in one of
    the numbers the cell's limits compare."""
    from bench.calibrate import control_numbers

    if cell != TRAIN:  # enough width and vocabulary for the logits' ranks to mean much
        monkeypatch.setitem(tiny.CUT, "hidden_size", 256)
        monkeypatch.setitem(tiny.CUT, "num_hidden_layers", 4)
        monkeypatch.setitem(tiny.CUT, "vocab_size", 8192)
    seeds = (1, 2, 3)
    program, control = [], []
    for seed in seeds:
        run = tiny.run(bench, cell, seed=seed)
        program.append(registry.kind(run.traffic["kind"]).execute(run).numbers)
        run = tiny.run(bench, cell, seed=seed)
        run.traffic["calls_per_window"] = 20
        control.append(control_numbers(run))
    names = compare.limits(cell)
    apart = {k: min(c[k] for c in control) / max(max(p[k] for p in program), 1e-12)
             for k in names}
    assert max(apart.values()) >= 3, (apart, program, control)


def test_the_command_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is here: the command would run")
    done = subprocess.run([sys.executable, "bench/run.py", "--workload", TRAIN, "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=registry.ROOT,
                          capture_output=True, text=True, timeout=120)
    assert done.returncode == 2 and done.stdout == ""
    assert "CUDA" in done.stderr


@pytest.mark.cuda
def test_a_cell_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    done = subprocess.run([sys.executable, "bench/run.py", "--workload", DENSE, "--seed",
                           str(2**31 + 99), "--seconds", "3", "--trace", "1"], cwd=registry.ROOT,
                          capture_output=True, text=True, timeout=600)
    assert done.returncode == 0, done.stderr[-2000:]
    result = json.loads(done.stdout.strip().splitlines()[-1])
    assert result["correct"] is True and result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
