"""Device meshes (counterpart of ``repro.launch.mesh``).

JAX's ``Mesh`` becomes torch's ``DeviceMesh`` with the same axis names:
``("data", "model")`` for one pod, ``("pod", "data", "model")`` for two.
A mesh is made by a function, never at import, and needs a process group:
one rank per device. :func:`ensure_process_group` starts a group of one
process where none exists, so that a single card (or the CPU, when it is
asked for) runs the mesh path on a 1 x 1 mesh; a run over several ranks
starts its group itself (``torch.distributed.init_process_group`` with its
own address, world size and rank) before it asks for a mesh.

The production shapes are those of the JAX package: a pod of 16 x 16
devices, two pods 2 x 16 x 16. Where the world is smaller than the mesh
the functions raise, as the JAX package's do; the dry run builds the
production mesh under a fake process group of 256 or 512 ranks
(``torch.testing._internal.distributed.fake_pg.FakeStore``).
"""

from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.device import resolve_device
from repro_torch.models.config import ModelConfig, layer_kinds

__all__ = ["ensure_process_group", "make_production_mesh", "make_local_mesh",
           "check_mesh_arch", "MESH_MIXERS", "MESH_FFNS"]


def ensure_process_group(device=None) -> None:
    """Start a process group of one rank where none exists: NCCL for the
    card (``device=None``), gloo when ``device="cpu"`` is asked for. Its
    store is an in-process ``HashStore``: no port is opened. An existing
    group (several ranks, or a fake one) is left as it is."""
    dev = resolve_device(device)
    if dist.is_initialized():
        return
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)


def _mesh(dev: torch.device, shape: tuple[int, ...], axes: tuple[str, ...]) -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` over the first ranks of the world."""
    n = 1
    for s in shape:
        n *= s
    if dist.get_world_size() == n:
        return init_device_mesh(dev.type, shape, mesh_dim_names=axes)
    return DeviceMesh(dev.type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device=None) -> DeviceMesh:
    """(16, 16) over ("data", "model"), or (2, 16, 16) over ("pod", "data",
    "model") with ``multi_pod``; ``device=None`` is the CUDA card."""
    dev = resolve_device(device)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    n = 1
    for s in shape:
        n *= s
    ensure_process_group(dev)
    have = dist.get_world_size()
    if have < n:
        raise RuntimeError(
            f"need {n} devices for the production mesh, have {have}; "
            "the dry run builds it under a fake process group of "
            f"{n} ranks (torch.testing._internal.distributed.fake_pg.FakeStore)"
        )
    return _mesh(dev, shape, axes)


def make_local_mesh(model: int = 1, device=None) -> DeviceMesh:
    """(1, ``model``) over ("data", "model") on the first ``model`` ranks:
    one card, or the CPU when ``device="cpu"`` is asked for."""
    dev = resolve_device(device)
    ensure_process_group(dev)
    have = dist.get_world_size()
    if have < model:
        raise RuntimeError(f"need {model} devices for a (1, {model}) mesh, have {have}")
    return _mesh(dev, (1, model), ("data", "model"))


# The layer kinds whose mesh route is held against the JAX package's
# sharded step (tests/test_torch_mesh.py, tests/test_torch_mesh_families.py)
# and against the route without a mesh (tests/test_torch_mesh_families_serve.py).
MESH_MIXERS = frozenset({"attn", "attn_cross", "cross", "mamba", "mlstm", "slstm"})
MESH_FFNS = frozenset({"mlp", "moe", "none"})


def check_mesh_arch(cfg: ModelConfig) -> None:
    """Raise ``NotImplementedError`` if a layer of ``cfg`` is of a kind
    (mixer, FFN) that no test holds under a mesh. Every kind of the ten
    configs is held: the dense decoders, the expert routing (MoE), the
    SSD and xLSTM scans, and the encoder and cross-attention layers (an
    encoder layer is self-attention and a SwiGLU MLP)."""
    bad = sorted(k for k in set(layer_kinds(cfg))
                 if k[0] not in MESH_MIXERS or k[1] not in MESH_FFNS)
    if bad:
        raise NotImplementedError(
            f"{cfg.name} ({cfg.family}): layers {bad} have not been checked under a mesh")
