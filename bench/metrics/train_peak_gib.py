"""The training run's peak of allocated device memory, in GiB."""


def read(r: dict) -> float | None:
    if r.get("kind") != "train" or not r.get("peak_bytes"):
        return None
    return r["peak_bytes"] / 2**30
