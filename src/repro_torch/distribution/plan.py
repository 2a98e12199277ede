# Ported from src/repro/distribution/plan.py; imports retargeted to repro_torch,
# and backward_profile's chip_flops defaults to the H100's bf16 rate.
"""Paper-solver-driven communication planning for the training loop.

This is the beyond-paper integration (DESIGN.md §2): the hybrid-DCN joint
scheduler plans the BACKWARD-PASS gradient-reduction schedule of a multi-pod
training step.

Mapping (per DESIGN.md):
  * tasks 0..L-1  = per-layer-group backward compute (chained, one "rack" =
                    the pod's compute — unary, so they serialize exactly as
                    the backward pass does);
  * task L        = the optimizer step, placed on a second "rack" so every
                    gradient edge is forced cross-rack (i.e. actually uses
                    the network, as cross-pod reductions do);
  * edge (i, L)   = layer-group i's gradient bucket, bytes = bucket size;
  * wired channel = the step's reserved ICI share (always present);
  * wireless k    = reconfigurable auxiliary channels (OCS circuits / DCN
                    overlay paths provisioned for this job's reduction).

Solving the restricted OP (fixed placement -> exact channels + sequencing via
the Giffler–Thompson level) yields the overlap schedule: which buckets
reduce on which channel, in what order, overlapped with remaining backward
compute. ``replan`` re-solves with degraded rates — the straggler-mitigation
hook used by the elastic runtime.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.bnb import solve_fixed_assignment
from repro_torch.core.dag import DagJob
from repro_torch.core.instance import CH_WIRED, ProblemInstance
from repro_torch.core.simulator import simulate
from repro_torch.models.config import ModelConfig, layer_kinds

__all__ = ["LinkSpec", "PlanResult", "backward_profile", "plan_gradient_schedule", "replan"]


@dataclasses.dataclass(frozen=True)
class LinkSpec:
    """Per-pod network rates, bytes/second: modelled link rates that set
    the planning problem, not measurements of any machine."""

    ici_share: float = 10e9      # reserved ICI share for cross-pod reduction
    aux_channels: int = 2        # reconfigurable OCS/DCN channels |K|
    aux_rate: float = 4e9        # per aux channel


@dataclasses.dataclass
class PlanResult:
    t_optimal: float       # joint schedule (paper's method)
    t_greedy: float        # greedy earliest-finish channel overlap
    t_serial: float        # no overlap: all reductions after backward, wired only
    schedule: object       # repro_torch.core Schedule for the optimal plan
    channel_of_bucket: np.ndarray  # 0 = ICI share, >=2: aux channel id
    proved_optimal: bool

    @property
    def gain_vs_serial(self) -> float:
        return 1.0 - self.t_optimal / self.t_serial

    @property
    def gain_vs_greedy(self) -> float:
        return 1.0 - self.t_optimal / self.t_greedy


def backward_profile(
    cfg: ModelConfig,
    tokens_per_device: int,
    chip_flops: float = 989e12,  # NVIDIA H100 SXM dense bf16 peak (data sheet)
    groups: int = 8,
    mfu: float = 0.4,
) -> tuple[np.ndarray, np.ndarray]:
    """(compute_seconds[groups], grad_bytes[groups]) for one device's
    backward pass, grouping layers into ``groups`` reduction buckets."""
    kinds = layer_kinds(cfg)
    d, ff = cfg.d_model, cfg.d_ff
    per_layer_params = []
    for mixer, ffn in kinds:
        p = 0.0
        if mixer in ("attn", "attn_cross", "cross"):
            p += d * cfg.n_heads * cfg.head_dim * 2 + 2 * d * cfg.n_kv_heads * cfg.head_dim
            if mixer == "attn_cross":
                p *= 2
        else:  # recurrent mixers, approximate with their projections
            p += 2 * d * cfg.d_inner + cfg.d_inner * d
        if ffn == "mlp":
            p += 3 * d * ff
        elif ffn == "moe":
            p += 3 * d * ff * cfg.experts_per_token  # active compute
        per_layer_params.append(p)
    per_layer_params = np.asarray(per_layer_params)
    # backward ~ 4·P·tokens flops (2x forward), at assumed MFU
    secs = 4.0 * per_layer_params * tokens_per_device / (chip_flops * mfu)
    # gradient bytes: full parameters (incl. all experts), bf16-compressed
    grad_bytes = []
    for (mixer, ffn), p in zip(kinds, per_layer_params):
        full = p if ffn != "moe" else p / max(cfg.experts_per_token, 1) * cfg.n_experts
        grad_bytes.append(2.0 * full)
    grad_bytes = np.asarray(grad_bytes)
    # bucket into groups (backward order: last layer first)
    groups = min(groups, len(kinds))  # never emit empty (zero-byte) buckets
    idx = np.array_split(np.arange(len(kinds))[::-1], groups)
    g_secs = np.asarray([secs[i].sum() for i in idx])
    g_bytes = np.asarray([grad_bytes[i].sum() for i in idx])
    return g_secs, g_bytes


def _build_instance(
    g_secs: np.ndarray, g_bytes: np.ndarray, link: LinkSpec
) -> tuple[ProblemInstance, np.ndarray]:
    L = len(g_secs)
    # tasks: 0..L-1 backward groups (chained), L = optimizer step (tiny).
    p = np.concatenate([g_secs, [1e-6]])
    edges = []
    d = []
    for i in range(L - 1):
        edges.append((i, i + 1))   # backward chain, zero-size local edge
        d.append(0.0)
    for i in range(L):
        edges.append((i, L))       # gradient bucket -> optimizer
        d.append(g_bytes[i])
    job = DagJob(p=p, edges=np.asarray(edges), d=np.asarray(d), name="backward")
    inst = ProblemInstance(
        job=job,
        n_racks=2,
        n_wireless=link.aux_channels,
        wired_rate=link.ici_share,
        wireless_rate=link.aux_rate,
        local_delay=0.0,
    )
    rack = np.asarray([0] * L + [1], dtype=np.int64)
    return inst, rack


def plan_gradient_schedule(
    g_secs: np.ndarray,
    g_bytes: np.ndarray,
    link: LinkSpec = LinkSpec(),
    time_limit: float = 10.0,
) -> PlanResult:
    inst, rack = _build_instance(g_secs, g_bytes, link)
    L = len(g_secs)

    # Serial baseline: no overlap, single wired channel.
    t_serial = float(np.sum(g_secs) + np.sum(g_bytes) / link.ici_share)

    # Greedy overlap (earliest-finish channel, list order).
    greedy = simulate(inst, rack, use_wireless=link.aux_channels > 0)
    t_greedy = greedy.makespan

    # Paper's optimal joint schedule (fixed placement level).
    res = solve_fixed_assignment(inst, rack, time_limit=time_limit)
    sched = res.schedule
    chan = np.full(L, CH_WIRED, dtype=np.int64)
    for e in range(inst.job.n_edges):
        u, v = inst.job.edges[e]
        if v == L and inst.job.d[e] > 0:
            chan[int(u)] = sched.chan[e]
    return PlanResult(
        t_optimal=sched.makespan,
        t_greedy=t_greedy,
        t_serial=t_serial,
        schedule=sched,
        channel_of_bucket=chan,
        proved_optimal=res.proved_optimal,
    )


def replan(
    g_secs: np.ndarray,
    g_bytes: np.ndarray,
    link: LinkSpec = LinkSpec(),
    compute_slowdown: float = 1.0,
    degraded_aux: int | None = None,
    time_limit: float = 10.0,
) -> PlanResult:
    """Straggler / failure mitigation: re-plan with degraded resources.

    compute_slowdown > 1 models a slow pod (all compute stretched);
    degraded_aux drops auxiliary channels (OCS circuit loss).
    """
    link2 = LinkSpec(
        ici_share=link.ici_share,
        aux_channels=link.aux_channels if degraded_aux is None else degraded_aux,
        aux_rate=link.aux_rate,
    )
    return plan_gradient_schedule(
        g_secs * compute_slowdown, g_bytes, link2, time_limit=time_limit
    )
