"""Everything a run needs, found by name: ``BENCHMARK.json`` at the
checkout's root, a configuration's file (``configs`` entry), a traffic
mix (``bench/traffic/<name>.json``), its module (``bench/kinds/<kind>.py``)
and a per-layer metric's reader (``bench/metrics/<name>.py``). A cell,
a configuration or a metric is added by adding files and entries."""

from __future__ import annotations

import importlib
import json
from pathlib import Path

# The checkout's root (a test may point it at a copy).
ROOT = Path(__file__).resolve().parents[2]

# A published (Hugging Face) configuration's keys, as the port names them.
HF_TO_PORT = {
    "num_hidden_layers": "n_layers",
    "hidden_size": "d_model",
    "num_attention_heads": "n_heads",
    "num_key_value_heads": "n_kv_heads",
    "intermediate_size": "d_ff",
    "vocab_size": "vocab_size",
    "rope_theta": "rope_theta",
    "rms_norm_eps": "norm_eps",
    "num_local_experts": "n_experts",
    "num_experts_per_tok": "experts_per_token",
    "tie_word_embeddings": "tie_embeddings",
}


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(bench: dict, name: str) -> dict:
    for c in bench["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(ROOT / "bench" / "traffic" / f"{name}.json")


def kind(name: str):
    """The module of a traffic kind (``execute(run)``, ``FAULTS``)."""
    return importlib.import_module(f"bench.kinds.{name}")


def reader(metric: str):
    """The ``read(reading)`` function of a per-layer metric."""
    return importlib.import_module(f"bench.metrics.{metric}").read


def port_sizes(cfg: dict) -> dict:
    """The port's ``ModelConfig`` fields of a configuration file: its
    published keys mapped to the port's names, then its ``port`` block."""
    out = {HF_TO_PORT[k]: v for k, v in cfg.items() if k in HF_TO_PORT}
    out.update(cfg.get("port", {}))
    out["name"] = cfg["name"]
    out.setdefault("head_dim", out["d_model"] // out["n_heads"])
    return out


def metrics_for(bench: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of ``cell_name`` reports: its end-to-end metrics
    with ``trace`` 0, its per-layer metrics with ``trace`` 1. An entry
    without ``workloads`` holds for every cell that reports what it moves."""
    e2e = [m for m in bench["end_to_end"]
           if "workloads" not in m or cell_name in m["workloads"]]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}

    def holds(m: dict) -> bool:
        return cell_name in m["workloads"] if "workloads" in m else m["moves"] in names

    return [m for m in bench["per_layer"] if holds(m)]
