"""The port's selective-scan kernel (``selective_scan_fwd``, found by
name) in a hybrid prefill: every Mamba-1 layer's least time at each
traced call's shape (``bench.harness.hybrid_flops.scan_bound_s``: the
larger of its bytes and its float32 operations, both lower bounds) over
the kernel's device time."""

from bench.harness import hybrid_flops, kernels

KERNEL = "selective_scan_fwd"


def read(r: dict) -> float | None:
    if r.get("kind") != "prefill" or r.get("trace") is None \
            or r["sizes"].get("ssm_kind") != "mamba1":
        return None
    items = [i for i in r["items"] if i["traced"]]
    busy = sum(d for n, _, d in r["trace"].clipped() if kernels._bare(n).startswith(KERNEL))
    if not items or not busy:
        return None
    m = r["sizes"]
    need = sum(hybrid_flops.mamba_layers(m) * hybrid_flops.scan_bound_s(m, i["B"], i["S"])
               for i in items)
    return 100.0 * need / busy
