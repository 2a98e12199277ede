"""Weights made by the benchmark from the seed, on the device, in the
layout the port's models take (``repro_torch.models.lm``: nested dicts,
the layers of each period position stacked along a leading repeat axis),
at the scales of the port's own ``init``.

Each leaf has a ``torch.Generator`` of its own, seeded from (seed, the
leaf's index): a leaf is one call (a few for the largest), and any leaf
can be made again alone, as the reference and the comparison of the
parameters' change need it. The program and the reference get the same
values; neither makes them.
"""

from __future__ import annotations

import math

import torch

_MASK = (1 << 63) - 1
# Largest number of elements one generator call fills.
_CALL_ELEMENTS = 1 << 31


def leaf_specs(m: dict) -> list[tuple[tuple, tuple, float | None]]:
    """(path, shape, normal scale or None for ones) of every leaf, in a
    fixed order. ``m``: the port's sizes (``registry.port_sizes``). Every
    layer is attention then an MLP, or a MoE where the model has experts,
    so the period is one layer and every stacked leaf has ``n_layers``
    repeats."""
    d, L, V = m["d_model"], m["n_layers"], m["vocab_size"]
    H, KV, hd, ff = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    E = m.get("n_experts", 0)
    lay = ("layers", 0)
    specs = [
        (("embed", "table"), (V, d), 0.02),
        (("norm", "scale"), (d,), None),
        (("out", "table"), (V, d), 0.02),
        (lay + ("mixer", "norm", "scale"), (L, d), None),
        (lay + ("mixer", "attn", "wq", "w"), (L, d, H * hd), 1 / math.sqrt(d)),
        (lay + ("mixer", "attn", "wk", "w"), (L, d, KV * hd), 1 / math.sqrt(d)),
        (lay + ("mixer", "attn", "wv", "w"), (L, d, KV * hd), 1 / math.sqrt(d)),
        (lay + ("mixer", "attn", "wo", "w"), (L, H * hd, d), 1 / math.sqrt(H * hd)),
        (lay + ("ffn", "norm", "scale"), (L, d), None),
    ]
    if E:
        specs += [
            (lay + ("ffn", "moe", "router", "w"), (L, d, E), 0.02),
            (lay + ("ffn", "moe", "wi"), (L, E, d, ff), 1 / math.sqrt(d)),
            (lay + ("ffn", "moe", "wg"), (L, E, d, ff), 1 / math.sqrt(d)),
            (lay + ("ffn", "moe", "wo"), (L, E, ff, d), 1 / math.sqrt(ff)),
        ]
    else:
        specs += [
            (lay + ("ffn", "mlp", "wi", "w"), (L, d, ff), 1 / math.sqrt(d)),
            (lay + ("ffn", "mlp", "wg", "w"), (L, d, ff), 1 / math.sqrt(d)),
            (lay + ("ffn", "mlp", "wo", "w"), (L, ff, d), 1 / math.sqrt(ff)),
        ]
    return specs


def leaf_seed(seed: int, index: int) -> int:
    return (int(seed) * 0x9E3779B97F4A7C15 + (index + 1) * 0xBF58476D1CE4E5B9) & _MASK


def make_leaf(m: dict, seed: int, index: int, device, dtype) -> torch.Tensor:
    """Leaf ``index`` of :func:`leaf_specs`, made on ``device`` in ``dtype``."""
    _, shape, scale = leaf_specs(m)[index]
    t = torch.empty(shape, dtype=dtype, device=device)
    if scale is None:
        return t.fill_(1.0)
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    rows = t.reshape(shape[0], -1)
    step = max(1, _CALL_ELEMENTS // rows.shape[1])
    for r in range(0, shape[0], step):
        rows[r:r + step].normal_(0.0, scale, generator=gen)
    return t


def _put(tree: dict, path: tuple, value) -> None:
    node = tree
    for key in path[:-1]:
        if isinstance(key, int):
            node = node[key]
        else:
            node = node.setdefault(key, [{}] if key == "layers" else {})
    node[path[-1]] = value


def make(m: dict, seed: int, device, dtype) -> dict:
    """The whole parameter tree, every leaf from :func:`make_leaf`."""
    tree: dict = {}
    for i, (path, _, _) in enumerate(leaf_specs(m)):
        _put(tree, path, make_leaf(m, seed, i, device, dtype))
    tree["layers"] = tuple(tree["layers"])
    return tree


def get(tree: dict, path: tuple):
    node = tree
    for key in path:
        node = node[key]
    return node


def slices(m: dict) -> list[tuple[str, int, int | None]]:
    """The units a comparison goes by: (name, leaf index, layer or None),
    each stacked leaf taken layer by layer."""
    out = []
    for i, (path, shape, _) in enumerate(leaf_specs(m)):
        name = ".".join(str(p) for p in path if p != 0)
        if path[0] == "layers":
            out += [(f"{name}[{layer}]", i, layer) for layer in range(shape[0])]
        else:
            out.append((name, i, None))
    return out


def slice_norms(m: dict, leaf_of, fn=None) -> dict[str, float]:
    """The float32 norm of every slice of :func:`slices`: ``leaf_of(index)``
    gives the leaf, ``fn`` (optional) maps (index, leaf) to the tensor whose
    norm is taken. Norms are read to the host leaf by leaf."""
    out = {}
    by_leaf: dict[int, list] = {}
    for name, i, layer in slices(m):
        by_leaf.setdefault(i, []).append((name, layer))
    for i, units in by_leaf.items():
        t = leaf_of(i)
        if fn is not None:
            t = fn(i, t)
        if units[0][1] is None:
            norms = torch.linalg.vector_norm(t.float()).reshape(1)
        else:
            norms = torch.stack([torch.linalg.vector_norm(t[j].float()) for j in range(t.shape[0])])
        for (name, _), v in zip(units, norms.tolist()):
            out[name] = v
        del t
    return out
