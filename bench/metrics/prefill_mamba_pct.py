"""The share of a hybrid prefill's device time in the program's Mamba-1
mixers: over the traced run's second pass (host and device, the program's
tracer installed, one call of each length), the device time of the
operations launched inside a ``mamba.mixer`` span over the device time of
all of them, each call weighted by its length's calls a cycle of the
traffic, so that the share is a whole cycle's and not the seed's draw."""


def read(r: dict) -> float | None:
    spans = r.get("spans") if r.get("kind") == "prefill" else None
    if not spans:
        return None
    w, by_call = spans["weights"], spans["device_s"]
    total = sum(w[c] * s[""] for c, s in by_call.items())
    if not total:
        return None
    return 100.0 * sum(w[c] * s["mamba.mixer"] for c, s in by_call.items()) / total
