"""State carried across from the JAX package.

The scheduler has no weights: its state is the problem instance (the
:class:`DagJob`, the resource environment and the optional
:class:`Topology`) plus warm-start seed pools, which are plain integer
arrays already. These two functions move an instance through a dict of
plain numpy arrays and scalars, so that an instance of either package can
be rebuilt in the other without one importing the other.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.dag import DagJob
from repro_torch.core.instance import ProblemInstance, Topology

__all__ = ["instance_to_arrays", "instance_from_arrays"]


def instance_to_arrays(inst) -> dict:
    """Plain-numpy view of a ``ProblemInstance`` of either package: ``p``,
    ``edges``, ``d``, ``name``, ``n_racks``, ``n_wireless``, ``wired_rate``,
    ``wireless_rate``, ``local_delay`` and, when the instance has a
    topology, ``reach``, ``degree``, ``channel_degree`` and ``delta``."""
    job = inst.job
    out = {
        "p": np.array(job.p, dtype=np.float64),
        "edges": np.array(job.edges, dtype=np.int64),
        "d": np.array(job.d, dtype=np.float64),
        "name": str(job.name),
        "n_racks": int(inst.n_racks),
        "n_wireless": int(inst.n_wireless),
        "wired_rate": float(inst.wired_rate),
        "wireless_rate": float(inst.wireless_rate),
        "local_delay": np.array(inst.local_delay, dtype=np.float64),
    }
    topo = inst.topology
    if topo is not None:
        out.update(
            reach=np.array(topo.reach, dtype=bool),
            degree=topo.degree,
            channel_degree=topo.channel_degree,
            delta=float(topo.delta),
        )
    return out


def instance_from_arrays(d: dict) -> ProblemInstance:
    """Rebuild a port ``ProblemInstance`` from :func:`instance_to_arrays`'s
    dict. A 0-d ``local_delay`` becomes the scalar it was."""
    local = np.asarray(d.get("local_delay", 0.0), dtype=np.float64)
    topology = None
    if d.get("reach") is not None:
        topology = Topology(
            reach=np.asarray(d["reach"], dtype=bool),
            degree=None if d.get("degree") is None else int(d["degree"]),
            channel_degree=(
                None if d.get("channel_degree") is None else int(d["channel_degree"])
            ),
            delta=float(d.get("delta", 0.0)),
        )
    return ProblemInstance(
        job=DagJob(
            p=np.asarray(d["p"], dtype=np.float64),
            edges=np.asarray(d["edges"], dtype=np.int64),
            d=np.asarray(d["d"], dtype=np.float64),
            name=str(d.get("name", "job")),
        ),
        n_racks=int(d["n_racks"]),
        n_wireless=int(d.get("n_wireless", 1)),
        wired_rate=float(d.get("wired_rate", 1.0)),
        wireless_rate=float(d.get("wireless_rate", 1.0)),
        local_delay=float(local) if local.ndim == 0 else local,
        topology=topology,
    )
