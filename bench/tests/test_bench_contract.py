"""BENCHMARK.json against the rules of its format, and the files it names."""

import json
import re
import shutil

import pytest

from bench.harness import registry
from bench.tests import tiny

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
LINE = re.compile(r"^[^\n\t]{1,200}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


def test_top_level_keys(bench):
    assert set(bench) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= bench["run_seconds"] <= 51 and isinstance(bench["run_seconds"], int)
    assert all(LINE.match(w) for w in bench["command"]) and len(bench["command"]) <= 32
    for p in bench["paths"]:
        assert re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) and not p.startswith("/")
        assert ".." not in p.split("/") and not p.endswith("_torch")
    assert len((registry.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_units(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
                assert e["better"] in ("lower", "higher")
                assert e["source"] in SOURCES
            for key in ("why", "layer", "source"):
                if key in e:
                    assert LINE.match(e[key]), e[key]
    assert len(names) == len(set(names))
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])


def test_entry_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"


def test_every_cell_has_its_files(bench):
    pairs = set()
    for w in bench["workloads"]:
        assert (w["config"], w["traffic"]) not in pairs
        pairs.add((w["config"], w["traffic"]))
        cfg = registry.config(bench, w["config"])
        assert cfg["name"] == w["config"]
        traffic = registry.traffic(w["traffic"])
        assert (registry.ROOT / "bench" / "kinds" / f"{traffic['kind']}.py").exists()
        assert (registry.ROOT / "bench" / "limits" / f"{w['name']}.json").exists()
    files = [c["file"] for c in bench["configs"]]
    assert len(files) == len(set(files))
    assert all(f.startswith(bench["paths"][0] + "/") for f in files)
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}


def test_reduced_lists_the_changed_keys(bench):
    """A configuration's file keeps every published key; a changed one is in
    ``reduced``, with the published value under ``published``."""
    for c in bench["configs"]:
        cfg = registry.config(bench, c["name"])
        assert cfg["reduced"] == c["reduced"]
        assert set(cfg.get("published", {})) == set(c["reduced"])
        assert cfg["source"] == c["source"]


def test_per_layer_metrics_move_what_their_cells_report(bench):
    for m in bench["per_layer"]:
        assert (registry.ROOT / "bench" / "metrics" / f"{m['name']}.py").exists()
        moved = next(e for e in bench["end_to_end"] if e["name"] == m["moves"])
        for cell in m["workloads"]:
            registry.cell(bench, cell)
            assert "workloads" not in moved or cell in moved["workloads"]
    for w in bench["workloads"]:
        e2e = registry.metrics_for(bench, w["name"], False)
        assert {"setup_s"} < {m["name"] for m in e2e}
        assert registry.metrics_for(bench, w["name"], True)


def test_a_cell_is_added_by_files_and_entries(bench, tmp_path, monkeypatch):
    """A new traffic mix, limits and cell in a copy of the checkout run
    through the harness unchanged."""
    root = tmp_path / "checkout"
    shutil.copytree(registry.ROOT / "bench", root / "bench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    traffic = dict(tiny.traffic(bench, "phi3mini-prefill-mix"), seq_lens=[64, 128], cycle=[1, 1])
    (root / "bench" / "traffic" / "prefill-pair.json").write_text(json.dumps(traffic))
    (root / "bench" / "limits" / "phi3mini-prefill-pair.json").write_text(
        json.dumps({"gap": {"limit": 1.0}}))
    new = json.loads(json.dumps(bench))
    new["workloads"].append({"name": "phi3mini-prefill-pair", "config": "phi3-mini-3.8b",
                             "traffic": "prefill-pair", "chips": 1, "why": "a test"})
    for m in new["end_to_end"] + new["per_layer"]:
        if "phi3mini-prefill-mix" in m.get("workloads", []):
            m["workloads"].append("phi3mini-prefill-pair")
    (root / "BENCHMARK.json").write_text(json.dumps(new))
    monkeypatch.setattr(registry, "ROOT", root)

    from bench.harness import runner
    import torch

    fresh = registry.benchmark()
    run = runner.make_run(fresh, "phi3mini-prefill-pair", 5, 0.2, False, torch.device("cpu"),
                          0.0, cfg=tiny.config(fresh, "phi3mini-prefill-mix"))
    assert run.traffic["seq_lens"] == [64, 128]
    result = runner.execute(fresh, run)
    assert set(result["metrics"]) == {"setup_s", "prefill_tokens_per_s", "prefill_p95_ms"}
    assert result["correct"] is True
