# Copied from src/repro/core/instance.py; imports retargeted to repro_torch.
"""Problem instance: a job plus the hybrid-DCN resource environment.

Paper §II: M racks connected by (a) wired links with guaranteed per-flow
bandwidth B_s, shared as a single logical channel ``b`` (constraint (8) forbids
any two concurrent wired flows), (b) |K| orthogonal wireless subchannels of
bandwidth B each, and (c) local (same-rack) transfer with delay r_(u,v) —
modelled in §IV-B as the infinite-capacity *virtual channel* ``c``.

Channel index convention used throughout the codebase:
  CH_WIRED = 0   (channel "b")
  CH_LOCAL = 1   (virtual channel "c", no contention)
  2 .. K+1       (wireless subchannels)

Reconfigurable topology (the reachability layer)
------------------------------------------------
The paper fixes which racks can reach the wireless subchannels; the
:class:`Topology` abstraction makes that reachability itself part of the
model — a per-(rack, subchannel) boolean mask plus transceiver degree
limits and a reconfiguration delay δ ("Scheduling Opportunistic Links in
Two-Tiered Reconfigurable Datacenters" regime). ``ProblemInstance.topology
= None`` is the paper's all-ones mask and keeps every solver path
bit-identical to the topology-free code; a restricted mask forces edges
between racks with no common reachable subchannel onto the wired channel.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.dag import DagJob

__all__ = [
    "ProblemInstance",
    "Topology",
    "CH_WIRED",
    "CH_LOCAL",
    "first_wireless",
]

CH_WIRED = 0
CH_LOCAL = 1


def first_wireless() -> int:
    return 2


@dataclasses.dataclass(frozen=True)
class Topology:
    """Reconfigurable wireless reachability: which racks see which
    subchannels, how many links a transceiver can hold, and the cost of
    changing the configuration.

    Attributes:
      reach: bool[n_racks, n_wireless]; ``reach[i, k]`` iff rack i's
        transceivers can use subchannel k. A cross-rack edge may use
        subchannel k only when BOTH endpoint racks reach k; a rack pair
        with no common subchannel is wired-only.
      degree: max subchannels a single rack may be configured onto
        (transceiver count); ``None`` = unbounded. Only constrains
        *matching* construction (:meth:`match`) — a given ``reach`` mask
        is always taken at face value.
      channel_degree: max racks configurable onto one subchannel;
        ``None`` = unbounded. Same scope as ``degree``.
      delta: reconfiguration delay δ — the time a subchannel is unusable
        after its rack set changes (charged by the online timeline as a
        busy interval).
    """

    reach: np.ndarray
    degree: int | None = None
    channel_degree: int | None = None
    delta: float = 0.0

    def __post_init__(self):
        r = np.ascontiguousarray(np.asarray(self.reach, dtype=bool))
        if r.ndim != 2:
            raise ValueError("Topology.reach must be [n_racks, n_wireless]")
        object.__setattr__(self, "reach", r)
        if self.degree is not None and self.degree < 0:
            raise ValueError("Topology.degree must be >= 0")
        if self.channel_degree is not None and self.channel_degree < 0:
            raise ValueError("Topology.channel_degree must be >= 0")
        if self.delta < 0:
            raise ValueError("Topology.delta must be >= 0")

    @property
    def n_racks(self) -> int:
        return self.reach.shape[0]

    @property
    def n_wireless(self) -> int:
        return self.reach.shape[1]

    @property
    def is_all_ones(self) -> bool:
        """True iff this mask never restricts a pick (the paper's model)."""
        return bool(self.reach.all())

    @staticmethod
    def all_ones(
        n_racks: int, n_wireless: int, *, delta: float = 0.0
    ) -> "Topology":
        return Topology(
            reach=np.ones((n_racks, n_wireless), dtype=bool), delta=delta
        )

    def pair_reach(self) -> np.ndarray:
        """bool[n_racks, n_racks, n_wireless]: both endpoints reach k."""
        return self.reach[:, None, :] & self.reach[None, :, :]

    def pair_connected(self) -> np.ndarray:
        """bool[n_racks, n_racks]: the pair shares >= 1 subchannel (the
        wireless-eligibility matrix; diagonal is irrelevant — same-rack
        edges are local)."""
        return self.pair_reach().any(axis=2)

    def edge_channels(self, rack_u: int, rack_v: int) -> np.ndarray:
        """Subchannel indices (0-based, NOT offset by ``first_wireless``)
        usable by an edge placed on ``(rack_u, rack_v)``."""
        return np.nonzero(self.reach[rack_u] & self.reach[rack_v])[0]

    def restrict(
        self, racks: np.ndarray, subchannels: np.ndarray
    ) -> "Topology":
        """The induced topology on a rack subset × subchannel subset (the
        residual-view projection used by the online timeline)."""
        racks = np.asarray(racks, dtype=np.int64)
        subchannels = np.asarray(subchannels, dtype=np.int64)
        return dataclasses.replace(
            self, reach=self.reach[np.ix_(racks, subchannels)]
        )

    def match(
        self,
        weight: np.ndarray,
        *,
        feasible: np.ndarray | None = None,
        keep: np.ndarray | None = None,
    ) -> np.ndarray:
        """Greedy weighted b-matching: configure (rack, subchannel) links
        by descending rack weight under the degree limits.

        ``weight``: float[n_racks] demand weight per rack (e.g. the epoch
        batch's wireless transfer volume landing on that rack). Links of
        zero-or-negative weight racks are never configured. ``feasible``
        optionally masks out links (e.g. outaged ones) on top of
        ``reach``. ``keep`` optionally pins links that must stay
        configured (e.g. links of subchannels mid-transfer, which the
        online timeline cannot reconfigure); pinned links are installed
        first and count toward the degree limits. Returns the configured
        bool[n_racks, n_wireless] mask — a subset of
        ``(reach & feasible) | keep``. Deterministic: ties break on
        (rack, subchannel) index.
        """
        weight = np.asarray(weight, dtype=np.float64)
        if weight.shape != (self.n_racks,):
            raise ValueError("weight must be [n_racks]")
        allowed = self.reach if feasible is None else (self.reach & feasible)
        out = np.zeros_like(self.reach)
        rack_deg = np.zeros(self.n_racks, dtype=np.int64)
        chan_deg = np.zeros(self.n_wireless, dtype=np.int64)
        if keep is not None:
            keep = np.asarray(keep, dtype=bool)
            out |= keep
            rack_deg += keep.sum(axis=1)
            chan_deg += keep.sum(axis=0)
            allowed = allowed & ~keep
        order = sorted(
            (
                (i, k)
                for i in range(self.n_racks)
                for k in range(self.n_wireless)
                if allowed[i, k] and weight[i] > 0.0
            ),
            key=lambda ik: (-weight[ik[0]], ik[0], ik[1]),
        )
        for i, k in order:
            if self.degree is not None and rack_deg[i] >= self.degree:
                continue
            if (
                self.channel_degree is not None
                and chan_deg[k] >= self.channel_degree
            ):
                continue
            out[i, k] = True
            rack_deg[i] += 1
            chan_deg[k] += 1
        return out


@dataclasses.dataclass(frozen=True)
class ProblemInstance:
    """A scheduling instance.

    Attributes:
      job: the DAG job.
      n_racks: M, number of feasible racks.
      n_wireless: |K|, number of orthogonal wireless subchannels.
      wired_rate: B_s (data units / time unit).
      wireless_rate: B.
      local_delay: r_(u,v); either a scalar applied to all edges or a
        per-edge array. The paper's experiments use symmetric 10 Gbps rates
        and local transfers that are effectively free (in-rack disk/memory).
      topology: optional :class:`Topology` reachability mask over
        ``[n_racks, n_wireless]``. ``None`` (the default) is the paper's
        model — every rack reaches every subchannel — and keeps all solver
        paths bit-identical to the pre-topology code.
    """

    job: DagJob
    n_racks: int
    n_wireless: int = 1
    wired_rate: float = 1.0
    wireless_rate: float = 1.0
    local_delay: float | np.ndarray = 0.0
    topology: Topology | None = None

    def __post_init__(self):
        t = self.topology
        if t is not None and t.reach.shape != (self.n_racks, self.n_wireless):
            raise ValueError(
                f"topology.reach shape {t.reach.shape} != "
                f"({self.n_racks}, {self.n_wireless})"
            )

    @property
    def reach_mask(self) -> np.ndarray:
        """Effective bool[n_racks, n_wireless] reachability (all-ones when
        ``topology`` is None)."""
        if self.topology is None:
            return np.ones((self.n_racks, self.n_wireless), dtype=bool)
        return self.topology.reach

    @property
    def n_channels(self) -> int:
        """Total channels in the generalized model: {b, c} ∪ K."""
        return 2 + self.n_wireless

    @property
    def q_wired(self) -> np.ndarray:
        """q_(u,v) = d / B_s  (paper §II)."""
        return self.job.d / self.wired_rate

    @property
    def q_wireless(self) -> np.ndarray:
        """q̌_(u,v) = d / B."""
        return self.job.d / self.wireless_rate

    @property
    def r_local(self) -> np.ndarray:
        r = np.asarray(self.local_delay, dtype=np.float64)
        if r.ndim == 0:
            return np.full(self.job.n_edges, float(r))
        if r.shape != (self.job.n_edges,):
            raise ValueError("local_delay must be scalar or per-edge")
        return r

    def duration_on(self, chan: np.ndarray) -> np.ndarray:
        """Per-edge transfer duration under a channel assignment vector.

        chan[e] uses the module-level convention (0 wired, 1 local, >=2
        wireless).
        """
        chan = np.asarray(chan)
        dur = np.where(
            chan == CH_WIRED,
            self.q_wired,
            np.where(chan == CH_LOCAL, self.r_local, self.q_wireless),
        )
        return dur

    def durations_matrix(self) -> np.ndarray:
        """float64[n_edges, n_channels] duration of edge e on channel c."""
        m = np.empty((self.job.n_edges, self.n_channels), dtype=np.float64)
        m[:, CH_WIRED] = self.q_wired
        m[:, CH_LOCAL] = self.r_local
        m[:, 2:] = self.q_wireless[:, None]
        return m
