"""The cells at a size the CPU holds: the same files, every width cut."""

import torch

from bench.harness import registry, runner

CUT = {"hidden_size": 64, "intermediate_size": 96, "num_attention_heads": 4,
       "num_hidden_layers": 2, "vocab_size": 256}


def config(bench: dict, cell: str) -> dict:
    cfg = registry.config(bench, registry.cell(bench, cell)["config"])
    extra = {"num_key_value_heads": 2, "num_local_experts": 4} if "num_local_experts" in cfg \
        else {"num_key_value_heads": 4}
    return dict(cfg, **CUT, **extra)


def traffic(bench: dict, cell: str) -> dict:
    t = registry.traffic(registry.cell(bench, cell)["traffic"])
    if t["kind"] == "train":
        return dict(t, seq_len=64, trace_steps=1)
    return dict(t, tokens_per_call=256, seq_lens=[32, 64, 128, 256], check_tokens=12,
                trace_calls=4)


def run(bench: dict, cell: str, seed: int = 2**31 + 7, trace: bool = False, faults=(),
        seconds: float = 0.2):
    return runner.make_run(bench, cell, seed, seconds, trace, torch.device("cpu"), 0.0,
                           faults, cfg=config(bench, cell), traffic=traffic(bench, cell))
