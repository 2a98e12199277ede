"""A hybrid (Jamba) cell's prefill model flops over the window's time, as
a share of the H100's bf16 peak: 2 x the active matmul parameters x
tokens (Mamba-1's projections, attention's on its layers, the MLP or the
router and two experts), the causal attention's forward on the attention
layers, and the head at one position a row (``bench.harness.hybrid_flops``)."""

from bench.harness import hybrid_flops


def read(r: dict) -> float | None:
    items = [i for i in r.get("items", []) if not i["traced"]]
    if r.get("kind") != "prefill" or r["sizes"].get("ssm_kind") != "mamba1" or not items:
        return None
    total = sum(hybrid_flops.prefill_flops(r["sizes"], i["B"], i["S"]) for i in items)
    return 100.0 * total / r["window_s"] / hybrid_flops.BF16_OPS_PER_S
