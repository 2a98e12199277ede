"""Weights of a hybrid (Jamba) decoder made by the benchmark from the seed,
on the device, in the layout the port's models take
(``repro_torch.models.lm.build_model``): the layers of each position of
the layer pattern's period stacked along a leading repeat axis, a Mamba-1
mixer under ``("mixer", "mamba")``, attention under ``("mixer", "attn")``.

A period position's kinds follow the configuration's pattern (port
names): attention where ``i % attn_every == attn_offset`` and Mamba-1
elsewhere, a mixture of experts where ``i % moe_every == moe_offset`` and
a SwiGLU MLP elsewhere. The period is the smallest that repeats the
pattern and divides the depth, as the port groups it.

Scales are the port's (``bench.harness.weights``: 1/sqrt(fan_in) normal
draws, 0.02 for the router and the tables, ones for the norms), and the
Mamba-1 mixer's decay and step take Mamba's published init: ``A_log[c] =
log(1..N)`` on every channel, ``D`` ones, the conv's bias zeros, and
``dt_bias`` the inverse softplus of a dt drawn log-uniform in [1e-3, 1e-1]
from the leaf's own generator. Each leaf has a generator seeded from
(seed, the leaf's index), as in ``bench.harness.weights``.
"""

from __future__ import annotations

import math

import torch

from bench.harness.weights import _CALL_ELEMENTS, get, leaf_seed

__all__ = ["get", "layer_kinds", "leaf_specs", "make", "make_leaf", "period", "tree"]

# Mamba's dt range at init.
DT_MIN, DT_MAX = 1e-3, 1e-1


def layer_kinds(m: dict) -> list[tuple[str, str]]:
    """(mixer, ffn) of every layer: "attn" or "mamba1", "moe" or "mlp"."""
    out = []
    for i in range(m["n_layers"]):
        mixer = "attn" if i % m["attn_every"] == m["attn_offset"] else "mamba1"
        ffn = "moe" if m.get("n_experts") and i % m["moe_every"] == m["moe_offset"] else "mlp"
        out.append((mixer, ffn))
    return out


def period(m: dict) -> int:
    """The smallest p that divides the depth with kinds[i] == kinds[i % p]."""
    kinds = layer_kinds(m)
    n = len(kinds)
    return next(p for p in range(1, n + 1)
                if n % p == 0 and all(kinds[i] == kinds[i % p] for i in range(n)))


def leaf_specs(m: dict) -> list[tuple[tuple, tuple, object]]:
    """(path, shape, init) of every leaf in a fixed order; init is a normal
    scale, "ones", "zeros", "a_log" or "dt_bias". ``m``: the port's sizes
    (``registry.port_sizes``)."""
    d, V = m["d_model"], m["vocab_size"]
    H, KV, hd, ff = m["n_heads"], m["n_kv_heads"], m["head_dim"], m["d_ff"]
    E = m.get("n_experts", 0)
    di = m["ssm_expand"] * d
    N, K = m["ssm_state_dim"], m["ssm_conv_dim"]
    R = m["ssm_dt_rank"]
    P = period(m)
    L = m["n_layers"] // P
    specs = [(("embed", "table"), (V, d), 0.02), (("norm", "scale"), (d,), "ones")]
    if not m.get("tie_embeddings"):
        specs.append((("out", "table"), (V, d), 0.02))
    for j, (mixer, ffn) in enumerate(layer_kinds(m)[:P]):
        lay = ("layers", j)
        specs.append((lay + ("mixer", "norm", "scale"), (L, d), "ones"))
        if mixer == "attn":
            at = lay + ("mixer", "attn")
            specs += [
                (at + ("wq", "w"), (L, d, H * hd), 1 / math.sqrt(d)),
                (at + ("wk", "w"), (L, d, KV * hd), 1 / math.sqrt(d)),
                (at + ("wv", "w"), (L, d, KV * hd), 1 / math.sqrt(d)),
                (at + ("wo", "w"), (L, H * hd, d), 1 / math.sqrt(H * hd)),
            ]
        else:
            mb = lay + ("mixer", "mamba")
            specs += [
                (mb + ("in_proj", "w"), (L, d, 2 * di), 1 / math.sqrt(d)),
                (mb + ("conv_w",), (L, K, di), 1 / math.sqrt(K)),
                (mb + ("conv_b",), (L, di), "zeros"),
                (mb + ("x_proj", "w"), (L, di, R + 2 * N), 1 / math.sqrt(di)),
                (mb + ("dt_norm", "scale"), (L, R), "ones"),
                (mb + ("b_norm", "scale"), (L, N), "ones"),
                (mb + ("c_norm", "scale"), (L, N), "ones"),
                (mb + ("dt_proj", "w"), (L, R, di), 1 / math.sqrt(R)),
                (mb + ("dt_bias",), (L, di), "dt_bias"),
                (mb + ("A_log",), (L, di, N), "a_log"),
                (mb + ("D",), (L, di), "ones"),
                (mb + ("out_proj", "w"), (L, di, d), 1 / math.sqrt(di)),
            ]
        specs.append((lay + ("ffn", "norm", "scale"), (L, d), "ones"))
        if ffn == "moe":
            mo = lay + ("ffn", "moe")
            specs += [
                (mo + ("router", "w"), (L, d, E), 0.02),
                (mo + ("wi",), (L, E, d, ff), 1 / math.sqrt(d)),
                (mo + ("wg",), (L, E, d, ff), 1 / math.sqrt(d)),
                (mo + ("wo",), (L, E, ff, d), 1 / math.sqrt(ff)),
            ]
        else:
            ml = lay + ("ffn", "mlp")
            specs += [
                (ml + ("wi", "w"), (L, d, ff), 1 / math.sqrt(d)),
                (ml + ("wg", "w"), (L, d, ff), 1 / math.sqrt(d)),
                (ml + ("wo", "w"), (L, ff, d), 1 / math.sqrt(ff)),
            ]
    return specs


def make_leaf(m: dict, seed: int, index: int, device, dtype) -> torch.Tensor:
    """Leaf ``index`` of :func:`leaf_specs`, made on ``device`` in ``dtype``."""
    _, shape, init = leaf_specs(m)[index]
    if init == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    if init == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if init == "a_log":
        n = torch.arange(1, shape[-1] + 1, dtype=torch.float32, device=device)
        return torch.log(n).expand(shape).to(dtype).contiguous()
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    if init == "dt_bias":
        u = torch.rand(shape, generator=gen, dtype=torch.float32, device=device)
        lo, hi = math.log(DT_MIN), math.log(DT_MAX)
        dt = torch.exp(lo + (hi - lo) * u)
        return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
    t = torch.empty(shape, dtype=dtype, device=device)
    rows = t.reshape(shape[0], -1)
    step = max(1, _CALL_ELEMENTS // rows.shape[1])
    for r in range(0, shape[0], step):
        rows[r:r + step].normal_(0.0, init, generator=gen)
    return t


def tree(m: dict, leaves: dict) -> dict:
    """The parameter tree of ``leaves``, the leaves of :func:`leaf_specs`
    by path."""
    out: dict = {"layers": [{} for _ in range(period(m))]}
    for path, leaf in leaves.items():
        node = out
        for key in path[:-1]:
            node = node[key] if isinstance(key, int) else node.setdefault(key, {})
        node[path[-1]] = leaf
    out["layers"] = tuple(out["layers"])
    return out


def make(m: dict, seed: int, device, dtype) -> dict:
    """The whole parameter tree, every leaf from :func:`make_leaf`."""
    return tree(m, {path: make_leaf(m, seed, i, device, dtype)
                    for i, (path, _, _) in enumerate(leaf_specs(m))})
