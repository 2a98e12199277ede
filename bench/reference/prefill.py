"""The reference's prefill: each prompt's last-position logits, layer by
layer over all the prompts together, so that one layer's float32 weights
are held at a time."""

from __future__ import annotations

import torch

from bench.reference.model import (
    F32, layer, layer_weights, matmul, no_tf32, rms_norm, rope_tables,
)


@torch.no_grad()
def last_logits(m: dict, leaves: dict, prompts: list, precs: tuple = ("f32",)) -> dict:
    """{prec: [logits [B, V] float32 of each prompt block]} of the prompt
    blocks ``prompts`` ([B, S] token ids each), from ``leaves``: the
    weights by path (``bench.harness.weights``), in any type."""
    no_tf32()
    eps = m.get("norm_eps", 1e-5)
    table = leaves[("embed", "table")]
    tables = {}
    for t in prompts:
        S = t.shape[1]
        if S not in tables:
            tables[S] = rope_tables(S, m["head_dim"], m["rope_theta"], table.device)
    hs = {p: [table[t.to(table.device).long()].to(F32) for t in prompts] for p in precs}
    for i in range(m["n_layers"]):
        w = layer_weights(leaves, i)
        for p in precs:
            hs[p] = [layer(h, w, m, *tables[h.shape[1]], p) for h in hs[p]]
        del w
    norm = leaves[("norm", "scale")].to(F32)
    out = leaves[("out", "table")].to(F32)
    return {p: [matmul(rms_norm(h[:, -1], norm, eps), out.T, p) for h in hs[p]] for p in precs}
