# Ported from src/repro/core/milp.py; imports retargeted to repro_torch.
"""The linearized reformulation RP of the joint scheduling MINLP (paper §IV).

Variable blocks (flattened into one decision vector):

  x[v,i]    binary   task v assigned to rack i                     — (1)
  xt[v,i]   cont.    "time-product" auxiliary x̃_vi ∈ [0, Tmax]     — (12)
  y[e,k]    binary   edge e on channel k ∈ {b, c} ∪ K              — (11)
  yt[e,k]   cont.    auxiliary ỹ_ek ∈ [0, Tmax]                    — (13)
  psi[p,i]  binary   ψ: tasks of unordered pair p both on rack i   — (14),(16)
  sigma[o]  binary   σ: ordered task pair (v,v'), v starts no later — (18)
  chi[q,k]  binary   χ: unordered edge pair q contends on k∈{b}∪K  — (15),(17)
  phi[o]    binary   φ: ordered edge pair (e,e'), e transfers first — (20),(22)
  Cmax      cont.    makespan                                       — objective

Start times are recovered as S_v = Σ_i x̃_vi and S_e = Σ_k ỹ_ek (§IV-D).

Documented paper deviations (see DESIGN.md §8 "Risks"):
  * (12)/(13) as literally printed allow x̃_vi ≤ 1-ε slack on UNASSIGNED racks.
    This is harmless (it only translates recovered start times within the
    feasible region; any optimal solution of the tight model remains optimal)
    but numerically messy, so the default binding is the tight big-M
    x̃_vi ≤ Tmax·x_vi. ``paper_exact_binding=True`` reproduces (12)/(13)
    verbatim; tests assert both variants reach the same optimum.
  * (20) prints σ_ee' where the flow-precedence indicator φ_ee' (defined in
    §IV-C for transfer starts) is meant; (22) prints ỹ_eb for Σ_k ỹ_ek. We
    define ONE φ family on total transfer starts S_e — this is exactly the
    paper's own definition of φ ("if the data on e begins to transfer no
    later than the data on e', φ_ee' = 1") and makes (21)/(23) consistent.
  * (25)'s printed LHS/RHS both end in Σ_i x̃_vi; the intended constraint is
    S_(uv) + duration(uv) ≤ S_v. (24)'s printed LHS uses x̃_vi where the
    producer u is meant: S_u + p_u ≤ S_(uv).
  * RP's printed bound chain "T_min ≥ Σ_i x̃_vi + p_v" would force all tasks
    to finish before T_min; the intended constraints are C_max ≥ S_v + p_v
    and T_min ≤ C_max ≤ T_max.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import scipy.sparse as sp

from repro_torch.core import bounds as bounds_mod
from repro_torch.core.dag import DagJob
from repro_torch.core.instance import CH_LOCAL, CH_WIRED, ProblemInstance

__all__ = ["RPModel", "VarMap", "build_rp", "extract_schedule"]

EPS = 0.1  # the paper's ε for strict-precedence reformulation


@dataclasses.dataclass(frozen=True)
class VarMap:
    """Offsets of each variable block in the flat decision vector."""

    n: int
    M: int
    m: int
    C: int  # channels incl. b (0) and c (1)
    n_pairs_v: int
    n_pairs_e: int

    @property
    def contend_channels(self) -> int:
        """Channels that can contend: {b} ∪ K (local never contends)."""
        return self.C - 1

    # Block offsets -------------------------------------------------------
    @property
    def off_x(self) -> int:
        return 0

    @property
    def off_xt(self) -> int:
        return self.off_x + self.n * self.M

    @property
    def off_y(self) -> int:
        return self.off_xt + self.n * self.M

    @property
    def off_yt(self) -> int:
        return self.off_y + self.m * self.C

    @property
    def off_psi(self) -> int:
        return self.off_yt + self.m * self.C

    @property
    def off_sigma(self) -> int:
        return self.off_psi + self.n_pairs_v * self.M

    @property
    def off_chi(self) -> int:
        return self.off_sigma + self.n * (self.n - 1)

    @property
    def off_phi(self) -> int:
        return self.off_chi + self.n_pairs_e * self.contend_channels

    @property
    def off_cmax(self) -> int:
        return self.off_phi + self.m * (self.m - 1)

    @property
    def n_vars(self) -> int:
        return self.off_cmax + 1

    # Index helpers -------------------------------------------------------
    def x(self, v: int, i: int) -> int:
        return self.off_x + v * self.M + i

    def xt(self, v: int, i: int) -> int:
        return self.off_xt + v * self.M + i

    def y(self, e: int, k: int) -> int:
        return self.off_y + e * self.C + k

    def yt(self, e: int, k: int) -> int:
        return self.off_yt + e * self.C + k

    def pair_v(self, v: int, vp: int) -> int:
        """Unordered task-pair index, v < vp."""
        a, b = (v, vp) if v < vp else (vp, v)
        # index of (a,b) in lexicographic unordered enumeration
        return a * self.n - a * (a + 1) // 2 + (b - a - 1)

    def psi(self, v: int, vp: int, i: int) -> int:
        return self.off_psi + self.pair_v(v, vp) * self.M + i

    def sigma(self, v: int, vp: int) -> int:
        """Ordered pair (v, vp), v != vp."""
        idx = v * (self.n - 1) + (vp if vp < v else vp - 1)
        return self.off_sigma + idx

    def pair_e(self, e: int, ep: int) -> int:
        a, b = (e, ep) if e < ep else (ep, e)
        return a * self.m - a * (a + 1) // 2 + (b - a - 1)

    def chi(self, e: int, ep: int, k: int) -> int:
        """k indexes contention channels: 0 = wired b, 1.. = wireless."""
        return self.off_chi + self.pair_e(e, ep) * self.contend_channels + k

    def phi(self, e: int, ep: int) -> int:
        idx = e * (self.m - 1) + (ep if ep < e else ep - 1)
        return self.off_phi + idx

    def cmax(self) -> int:
        return self.off_cmax


@dataclasses.dataclass
class RPModel:
    """Assembled MILP: min c'z s.t. A_ub z <= b_ub, A_eq z == b_eq."""

    vm: VarMap
    c: np.ndarray
    A_ub: sp.csr_matrix
    b_ub: np.ndarray
    A_eq: sp.csr_matrix
    b_eq: np.ndarray
    lb: np.ndarray
    ub: np.ndarray
    integrality: np.ndarray
    tmax: float
    tmin: float
    inst: ProblemInstance


class _Rows:
    """Incremental sparse row builder."""

    def __init__(self, n_vars: int) -> None:
        self.n_vars = n_vars
        self.data: list[float] = []
        self.rows: list[int] = []
        self.cols: list[int] = []
        self.rhs: list[float] = []
        self.nrows = 0

    def add(self, coeffs: list[tuple[int, float]], rhs: float) -> None:
        for col, val in coeffs:
            self.rows.append(self.nrows)
            self.cols.append(col)
            self.data.append(val)
        self.rhs.append(rhs)
        self.nrows += 1

    def matrix(self) -> tuple[sp.csr_matrix, np.ndarray]:
        a = sp.csr_matrix(
            (self.data, (self.rows, self.cols)),
            shape=(self.nrows, self.n_vars),
        )
        return a, np.asarray(self.rhs, dtype=np.float64)


def build_rp(
    inst: ProblemInstance,
    tmax: float | None = None,
    tmin: float | None = None,
    paper_exact_binding: bool = False,
    feasibility_only: bool = False,
) -> RPModel:
    """Assemble RP for ``inst``.

    Args:
      tmax: big-M / horizon; defaults to the §IV-A upper bound. The §IV-D
        bisection passes the shrunk ℓ here.
      tmin: lower bound on C_max; defaults to Algorithm 1.
      paper_exact_binding: use (12)/(13) verbatim instead of the tight big-M.
      feasibility_only: zero objective (the FP subproblem of §IV-D).
    """
    job: DagJob = inst.job
    n, M, m = job.n_tasks, inst.n_racks, job.n_edges
    C = inst.n_channels
    if tmax is None:
        tmax = bounds_mod.upper_bound(inst)
    if tmin is None:
        tmin = bounds_mod.lower_bound(inst)
    tmax = float(max(tmax, tmin))

    vm = VarMap(
        n=n, M=M, m=m, C=C,
        n_pairs_v=n * (n - 1) // 2,
        n_pairs_e=m * (m - 1) // 2,
    )
    q = inst.q_wired
    qw = inst.q_wireless
    r = inst.r_local

    ub_rows = _Rows(vm.n_vars)
    eq_rows = _Rows(vm.n_vars)

    def S_task(v: int, sign: float = 1.0) -> list[tuple[int, float]]:
        return [(vm.xt(v, i), sign) for i in range(M)]

    def S_edge(e: int, sign: float = 1.0) -> list[tuple[int, float]]:
        return [(vm.yt(e, k), sign) for k in range(C)]

    # (1) Σ_i x_vi = 1
    for v in range(n):
        eq_rows.add([(vm.x(v, i), 1.0) for i in range(M)], 1.0)
    # (11) Σ_k y_ek = 1
    for e in range(m):
        eq_rows.add([(vm.y(e, k), 1.0) for k in range(C)], 1.0)

    # (12)/(13) time-product bindings.
    if paper_exact_binding:
        # x̃_vi - 1 ≤ x_vi·Tmax - (1 - x_vi)·ε   ⇔   x̃ - (Tmax+ε)x ≤ 1 - ε
        for v in range(n):
            for i in range(M):
                ub_rows.add(
                    [(vm.xt(v, i), 1.0), (vm.x(v, i), -(tmax + EPS))], 1.0 - EPS
                )
        for e in range(m):
            for k in range(C):
                ub_rows.add(
                    [(vm.yt(e, k), 1.0), (vm.y(e, k), -(tmax + EPS))], 1.0 - EPS
                )
    else:
        for v in range(n):
            for i in range(M):
                ub_rows.add([(vm.xt(v, i), 1.0), (vm.x(v, i), -tmax)], 0.0)
        for e in range(m):
            for k in range(C):
                ub_rows.add([(vm.yt(e, k), 1.0), (vm.y(e, k), -tmax)], 0.0)

    # (16) ψ AND-link: 0 ≤ x_vi + x_v'i - 2ψ ≤ 1
    for v in range(n):
        for vp in range(v + 1, n):
            for i in range(M):
                xv, xvp, ps = vm.x(v, i), vm.x(vp, i), vm.psi(v, vp, i)
                ub_rows.add([(xv, 1.0), (xvp, 1.0), (ps, -2.0)], 1.0)
                ub_rows.add([(xv, -1.0), (xvp, -1.0), (ps, 2.0)], 0.0)
            # (14) Σ_i ψ ≤ 1
            ub_rows.add([(vm.psi(v, vp, i), 1.0) for i in range(M)], 1.0)

    # (17) χ AND-link over contention channels {b} ∪ K; (15) Σ_k χ ≤ 1.
    # Contention channel c-index mapping: 0 ↔ CH_WIRED, 1.. ↔ wireless 2..
    def chan_of_contend(kc: int) -> int:
        return CH_WIRED if kc == 0 else kc + 1

    for e in range(m):
        for ep in range(e + 1, m):
            for kc in range(vm.contend_channels):
                k = chan_of_contend(kc)
                ye, yep, ch = vm.y(e, k), vm.y(ep, k), vm.chi(e, ep, kc)
                ub_rows.add([(ye, 1.0), (yep, 1.0), (ch, -2.0)], 1.0)
                ub_rows.add([(ye, -1.0), (yep, -1.0), (ch, 2.0)], 0.0)
            ub_rows.add(
                [(vm.chi(e, ep, kc), 1.0) for kc in range(vm.contend_channels)],
                1.0,
            )

    # (18) σ definition: S_v' - S_v ≤ Tmax·σ - ε(1-σ)
    #   ⇔ S_v' - S_v - (Tmax+ε)σ ≤ -ε
    # (19) rack non-overlap: S_v + p_v - S_v' ≤ Tmax(2 - σ_vv' - Σψ)
    for v in range(n):
        for vp in range(n):
            if v == vp:
                continue
            ub_rows.add(
                S_task(vp) + S_task(v, -1.0) + [(vm.sigma(v, vp), -(tmax + EPS))],
                -EPS,
            )
            coeffs = (
                S_task(v)
                + S_task(vp, -1.0)
                + [(vm.sigma(v, vp), tmax)]
                + [(vm.psi(v, vp, i), tmax) for i in range(M)]
            )
            ub_rows.add(coeffs, 2.0 * tmax - float(job.p[v]))

    # (20)-(23) flow precedence + channel non-overlap.
    for e in range(m):
        for ep in range(m):
            if e == ep:
                continue
            # φ definition on total transfer starts.
            ub_rows.add(
                S_edge(ep) + S_edge(e, -1.0) + [(vm.phi(e, ep), -(tmax + EPS))],
                -EPS,
            )
            # (21) wired: S_e + q_e - S_e' ≤ Tmax(2 - φ - χ_b)
            ub_rows.add(
                S_edge(e)
                + S_edge(ep, -1.0)
                + [(vm.phi(e, ep), tmax), (vm.chi(e, ep, 0), tmax)],
                2.0 * tmax - float(q[e]),
            )
            # (23) wireless: S_e + q̌_e - S_e' ≤ Tmax(2 - φ - Σ_K χ_k)
            if vm.contend_channels > 1:
                ub_rows.add(
                    S_edge(e)
                    + S_edge(ep, -1.0)
                    + [(vm.phi(e, ep), tmax)]
                    + [
                        (vm.chi(e, ep, kc), tmax)
                        for kc in range(1, vm.contend_channels)
                    ],
                    2.0 * tmax - float(qw[e]),
                )

    # (24)-(25) precedence chaining through transfers.
    for e in range(m):
        u, v = int(job.edges[e, 0]), int(job.edges[e, 1])
        # S_u + p_u ≤ S_e
        ub_rows.add(S_task(u) + S_edge(e, -1.0), -float(job.p[u]))
        # S_e + q_e·y_eb + q̌_e·Σ_K y_ek + r_e·y_ec ≤ S_v
        coeffs = S_edge(e) + S_task(v, -1.0)
        coeffs.append((vm.y(e, CH_WIRED), float(q[e])))
        coeffs.append((vm.y(e, CH_LOCAL), float(r[e])))
        for k in range(2, C):
            coeffs.append((vm.y(e, k), float(qw[e])))
        ub_rows.add(coeffs, 0.0)
        # (26) Σ_i ψ_uvi = y_(uv),c
        eq_rows.add(
            [(vm.psi(u, v, i), 1.0) for i in range(M)]
            + [(vm.y(e, CH_LOCAL), -1.0)],
            0.0,
        )

    # C_max ≥ S_v + p_v
    for v in range(n):
        ub_rows.add(S_task(v) + [(vm.cmax(), -1.0)], -float(job.p[v]))

    # Bounds and integrality ------------------------------------------------
    lb = np.zeros(vm.n_vars)
    ub = np.ones(vm.n_vars)
    integrality = np.ones(vm.n_vars)  # 1 = integer
    for blk_off, blk_len in (
        (vm.off_xt, n * M),
        (vm.off_yt, m * C),
    ):
        ub[blk_off : blk_off + blk_len] = tmax
        integrality[blk_off : blk_off + blk_len] = 0
    lb[vm.cmax()] = tmin
    ub[vm.cmax()] = tmax
    integrality[vm.cmax()] = 0

    c = np.zeros(vm.n_vars)
    if not feasibility_only:
        c[vm.cmax()] = 1.0

    A_ub, b_ub = ub_rows.matrix()
    A_eq, b_eq = eq_rows.matrix()
    return RPModel(
        vm=vm, c=c, A_ub=A_ub, b_ub=b_ub, A_eq=A_eq, b_eq=b_eq,
        lb=lb, ub=ub, integrality=integrality,
        tmax=tmax, tmin=tmin, inst=inst,
    )


def extract_schedule(model: RPModel, z: np.ndarray):
    """Recover the OP decision vectors from an RP solution vector.

    s_v = Σ_i x̃_vi, s_(u,v) = Σ_k ỹ_ek (paper §IV-D); rack/channel from the
    one-hot binaries.
    """
    from repro_torch.core.schedule import Schedule

    vm = model.vm
    n, M, m, C = vm.n, vm.M, vm.m, vm.C
    x = z[vm.off_x : vm.off_x + n * M].reshape(n, M)
    xt = z[vm.off_xt : vm.off_xt + n * M].reshape(n, M)
    y = z[vm.off_y : vm.off_y + m * C].reshape(m, C)
    yt = z[vm.off_yt : vm.off_yt + m * C].reshape(m, C)
    rack = np.argmax(x, axis=1).astype(np.int64)
    chan = np.argmax(y, axis=1).astype(np.int64) if m else np.zeros(0, np.int64)
    start = xt.sum(axis=1)
    tstart = yt.sum(axis=1) if m else np.zeros(0)
    return Schedule.build(model.inst, rack, start, chan, tstart)
