"""The numbers that decide ``correct``, each the program's reading against
the plain reference's (``bench/reference``), and the limits they are held
to (``bench/limits/<workload>.json``)."""

from __future__ import annotations

import json
import statistics

from bench.harness import registry

# A leaf whose reference gradient is under this share of the median leaf's
# moves under AdamW by round-off alone; its change is not compared.
ROUND_OFF_SHARE = 1e-3


def limits(workload: str) -> dict:
    with open(registry.ROOT / "bench" / "limits" / f"{workload}.json") as f:
        return json.load(f)


def loss_gap(prog: list, ref: list) -> float:
    """The largest relative gap of a step's loss."""
    return max(abs(p - r) / abs(r) for p, r in zip(prog, ref, strict=True))


def round_off_leaves(ref_grad: dict) -> set:
    """Slices whose reference gradient norm is under ROUND_OFF_SHARE of the
    median slice's."""
    med = statistics.median(ref_grad.values())
    return {k for k, v in ref_grad.items() if v < ROUND_OFF_SHARE * med}


def worst_leaf_gap(prog: dict, ref: dict, skip: set = frozenset()) -> tuple[float, str]:
    """The largest gap between the program's and the reference's norm of a
    slice, over the reference's norm of that slice or of the median slice,
    whichever is larger; and the slice it is in."""
    keys = [k for k in ref if k not in skip]
    med = statistics.median(ref[k] for k in keys)
    worst, at = -1.0, ""
    for k in keys:
        gap = abs(prog[k] - ref[k]) / max(ref[k], med)
        if gap > worst:
            worst, at = gap, k
    return worst, at


def train_numbers(prog: dict, ref: dict) -> dict:
    """A training cell's numbers (each side's dict: ``loss`` a list by
    step, ``grad`` and ``change`` norms by slice): ``loss`` the first
    step's relative gap (the forward at equal weights), ``loss_steps`` the
    largest over the steps, ``grad`` and ``change`` the worst slice's."""
    skip = round_off_leaves(ref["grad"])
    grad, grad_at = worst_leaf_gap(prog["grad"], ref["grad"])
    change, change_at = worst_leaf_gap(prog["change"], ref["change"], skip)
    return {"loss": loss_gap(prog["loss"][:1], ref["loss"][:1]),
            "loss_steps": loss_gap(prog["loss"], ref["loss"]), "grad": grad, "change": change,
            "_at": {"grad": grad_at, "change": change_at, "skipped": sorted(skip)}}


def served_gaps(ref_logits, served) -> dict:
    """How far each served token's reference logit lies below the
    reference's best at its position, in standard deviations of the
    reference's logits there (``ref_logits`` [N, V] float32, ``served``
    [N] token ids): ``gap`` the widest, ``gap_mean`` the mean over the N
    tokens, ``gap_share`` the share of tokens that are not the
    reference's best."""
    best = ref_logits.max(dim=-1).values
    got = ref_logits.gather(-1, served.reshape(-1, 1).long().to(ref_logits.device))[:, 0]
    gaps = (best - got) / ref_logits.std(dim=-1)
    return {"gap": float(gaps.max()), "gap_mean": float(gaps.mean()),
            "gap_share": float((gaps > 0).float().mean())}


def logit_errors(ref_logits, logits) -> dict:
    """How far each row of the program's last-position logits (``logits``
    [N, V], as the program returned them) lies from the reference's
    (``ref_logits`` [N, V] float32): the root mean square of their
    difference over the standard deviation of the reference's row.
    ``logit_err`` the median row's, ``logit_err_mean`` the mean,
    ``logit_err_max`` the widest."""
    err = (logits.to(ref_logits.device).float() - ref_logits).pow(2).mean(dim=-1).sqrt()
    err = err / ref_logits.std(dim=-1)
    return {"logit_err": float(err.quantile(0.5)), "logit_err_mean": float(err.mean()),
            "logit_err_max": float(err.max())}


def judge(numbers: dict, lim: dict) -> tuple[bool, dict]:
    """(every number within its limit, {name: {value, limit}})."""
    checks = {k: {"value": numbers[k], "limit": lim[k]["limit"]} for k in lim}
    ok = all(c["value"] <= c["limit"] for c in checks.values())
    return ok, checks
