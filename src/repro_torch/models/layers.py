"""Core neural layers: RMSNorm, RoPE, GQA attention, SwiGLU (counterpart
of ``repro.models.layers``).

Conventions kept from the JAX package:
  * Params are nested dicts of tensors; every layer has init_*/apply_*.
  * Compute runs in the activation's dtype (bf16 when serving) with fp32
    softmax and norm statistics; the rounding points are the JAX
    package's: ``rms_norm`` sums in fp32 and rounds only the inverse RMS,
    ``apply_rope`` works in fp32 and casts back, ``linear`` casts the
    weight to the activation's type.
  * The inner attention is the port's kernels: a whole sequence (any S,
    one token of self-attention included) goes through
    :func:`repro_torch.models.flash.flash_attention`, decode through
    :func:`repro_torch.kernels.ops.decode_attention`. Neither repeats the
    KV heads: the kernels fold the G group heads themselves. The JAX
    package's plain ``_sdpa`` has no counterpart: the flash kernel takes
    its one-token self-attention case, and the decode kernel its
    ``kv_len`` case and its one-token cross-attention case (one query
    row over all T rows of the memory, ``kv_len = T``).

Activation sharding is injected, as in the JAX package, through
:func:`shard` hooks that consult the rules installed by
:func:`activation_sharding` (``repro_torch.distribution.sharding.
activation_rules``): on a DTensor, ``shard`` redistributes to the rule's
placements, the counterpart of ``with_sharding_constraint``; on a plain
tensor (no mesh) it does nothing. The kernels never see a DTensor: under
a mesh they run on each rank's local shard (``models/flash.py`` for the
flash route, :func:`decode_attention` for the decode route).
"""

from __future__ import annotations

import contextlib
import functools
import math
import threading
from typing import Any

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
from torch.distributed.tensor.experimental import implicit_replication

from repro_torch.distribution.sharding import PartitionSpec, fit_spec, placements, shard_index
from repro_torch.kernels import ops
from repro_torch.models.flash import flash_attention

__all__ = [
    "shard",
    "rule_placements",
    "split_heads",
    "merge_heads",
    "row_placements",
    "local_placements",
    "to_local",
    "placed_grad",
    "activation_sharding",
    "under_current_rules",
    "rms_norm",
    "init_rms_norm",
    "init_linear",
    "linear",
    "rope_tables",
    "apply_rope",
    "init_attention",
    "attention",
    "decode_attention",
    "init_mlp",
    "mlp_swiglu",
    "init_embedding",
    "embed",
    "unembed",
]

Params = dict[str, Any]

_TLS = threading.local()


def _rules() -> dict[str, Any]:
    return getattr(_TLS, "rules", None) or {}


@contextlib.contextmanager
def activation_sharding(rules: dict[str, Any]):
    """Install logical-activation -> NamedSharding rules for this thread
    (``repro_torch.distribution.sharding.activation_rules``).

    Non-empty rules mean a mesh run, and there a plain tensor that meets a
    DTensor is taken as replicated (``implicit_replication``): the model's
    own constants (RoPE tables, zeros, the default label mask) hold their
    full value on every rank. The JAX package's ``with mesh:`` gives its
    constants the same standing."""
    with _installed(rules), implicit_replication() if rules else contextlib.nullcontext():
        yield


@contextlib.contextmanager
def _installed(rules: dict[str, Any]):
    """``rules`` as this thread's activation rules (``implicit_replication``
    is a process-wide switch, left as it is)."""
    old = getattr(_TLS, "rules", None)
    _TLS.rules = rules
    try:
        yield
    finally:
        _TLS.rules = old


def under_current_rules(fn):
    """``fn``, run under this thread's activation rules whichever thread
    calls it. A checkpointed function's recompute runs on autograd's
    thread for a CUDA tensor's backward, where the rules installed here
    are not, so its ``shard`` hooks would change nothing there: the
    recomputed activations would be placed otherwise than the forward's,
    and a local-shard function (the MoE dispatch's ``act_expert`` buffer)
    would meet a placement it does not take."""
    rules = _rules()

    def run(*args):
        with _installed(rules):
            return fn(*args)

    return run


def shard(x: torch.Tensor, name: str) -> torch.Tensor:
    """Redistribute the DTensor ``x`` to the ambient rule for the logical
    activation ``name``.

    The rule degrades per dimension: a mesh axis whose extent does not
    divide the dimension is dropped (``layers.py:59-90`` of the JAX
    package). A rank mismatch, a missing rule or a plain tensor leaves
    ``x`` as it is.
    """
    pl = rule_placements(name, tuple(x.shape)) if isinstance(x, DTensor) else None
    if pl is None:
        return x
    return x.redistribute(_rules()[name].mesh, pl)


def rule_placements(name: str, shape: tuple) -> tuple | None:
    """The placements that the ambient rule for ``name`` gives a tensor of
    ``shape`` (as :func:`shard` places it), or None where ``shard`` leaves
    the tensor as it is (no rule, or a rank mismatch)."""
    sh = _rules().get(name)
    if sh is None:
        return None
    parts = list(sh.spec) + [None] * (len(shape) - len(sh.spec))
    if len(parts) != len(shape):
        return None
    return placements(sh.mesh, fit_spec(sh.mesh, shape, PartitionSpec(*parts)))


def _replicated_local(x: torch.Tensor) -> torch.Tensor:
    """The full value of ``x`` on this rank: a DTensor is replicated first
    (a differentiable ``to_local``), a plain tensor is returned as it is."""
    if not isinstance(x, DTensor):
        return x
    return x.redistribute(x.device_mesh, [Replicate()] * x.device_mesh.ndim).to_local()


def row_placements(x: DTensor) -> list:
    """``x``'s batch split kept (the mesh dims that shard dim 0), every
    other mesh dim replicated: the placements under which each rank holds
    whole rows of its own batch shard."""
    return [p if p.is_shard(0) else Replicate() for p in x.placements]


def local_placements(rows: list, split: dict[int, int] | None = None) -> tuple[list, list]:
    """For a value that every rank holds in full and uses only for its own
    rows (``rows``, from :func:`row_placements`) and, on the mesh dims of
    ``split`` (mesh dim -> tensor dim), only for its own slice of that
    tensor dim: (the placements to take its local copy under, the
    placements of that copy's gradient). The gradient is a ``Partial`` sum
    over the mesh dims that split the batch (each rank's rows add their
    share), the slice's ``Shard`` over the dims of ``split``, and
    ``Replicate`` over the others, where every rank repeats the same work
    (declaring those ``Partial`` would count the gradient once a rank)."""
    split = split or {}
    fwd = [Shard(split[i]) if i in split else Replicate() for i in range(len(rows))]
    grad = [Shard(split[i]) if i in split else Partial() if p.is_shard(0) else Replicate()
            for i, p in enumerate(rows)]
    return fwd, grad


def to_local(t: torch.Tensor, fwd: list, grad: list | None = None) -> torch.Tensor:
    """This rank's local tensor of ``t`` placed as ``fwd``, its gradient
    declared as ``grad`` (the default: ``fwd``'s, right when each rank's
    local result is its own shard or a repeat of the same work); a plain
    tensor as it is."""
    if not isinstance(t, DTensor):
        return t
    return t.redistribute(t.device_mesh, fwd).to_local(grad_placements=grad)


def _merged(a, b):
    """The placement that DTensor's ``stack`` gives two of its inputs on
    one mesh dim: a ``Partial`` follows a ``Shard``, a ``Replicate``
    follows either, two different ``Shard``s meet in ``Replicate``."""
    if a == b:
        return a
    if a.is_partial():
        return b if b.is_shard() else Replicate() if b.is_partial() else a
    if a.is_shard():
        return Replicate() if b.is_shard() else a
    return b


class _PlacedGrad(torch.autograd.Function):
    """The identity on a repeat's slice of a stacked leaf, whose backward
    redistributes the slice's gradient to the slice's placements. A
    gradient that is ``Partial`` over several mesh dims is reduced in the
    order ``unbind``'s backward would have taken: first to the placements
    that ``stack`` merges from the repeats' gradients seen so far
    (``seen``, shared by the repeats of one leaf), then to the slice's."""

    @staticmethod
    def forward(ctx, t, seen):
        ctx.mesh, ctx.placements, ctx.seen = t.device_mesh, tuple(t.placements), seen
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        if isinstance(g, DTensor):
            ctx.seen.append(tuple(g.placements))
            follow = tuple(functools.reduce(lambda f, p: [_merged(a, b) for a, b in zip(f, p)],
                                            ctx.seen))
            for pl in (follow, ctx.placements):
                if tuple(g.placements) != pl:
                    g = g.redistribute(ctx.mesh, pl)
        return g, None


def placed_grad(t: torch.Tensor, seen: list) -> torch.Tensor:
    """``t``, a repeat's slice of a stacked leaf, its gradient redistributed
    to ``t``'s own placements as it arrives (a reduce-scatter of DTensor's
    ``Partial`` sums), as the reference's SPMD program reduces a gradient
    into its operand's sharding; ``seen`` is shared by the repeats of the
    leaf (:class:`_PlacedGrad`). A plain tensor, or one without a
    gradient, as it is."""
    if not (isinstance(t, DTensor) and t.requires_grad and torch.is_grad_enabled()):
        return t
    return _PlacedGrad.apply(t, seen)


def split_heads(t: torch.Tensor, shape: tuple) -> torch.Tensor:
    """``t.reshape(shape)``, ``shape`` ending (heads, head_dim). A DTensor
    whose last dim is split over mesh dims that do not divide the heads
    (24 heads over 'model' 16) is first gathered over those dims: DTensor
    cannot cut a split dim into heads a rank would hold a part of. The
    JAX package's partitioner makes the same move where it must."""
    if isinstance(t, DTensor):
        last, n, mesh = t.ndim - 1, shape[-2], t.device_mesh
        split = [i for i, p in enumerate(t.placements) if p.is_shard(last)]
        if n % math.prod(mesh.size(i) for i in split):
            t = t.redistribute(mesh, [Replicate() if i in split else p
                                      for i, p in enumerate(t.placements)])
    return t.reshape(shape)


class _MergeHeads(torch.autograd.Function):
    """[..., heads, head_dim] -> [..., heads * head_dim], whose backward
    cuts the gradient into heads through :func:`split_heads` (a plain view
    would fail on a DTensor gradient split where the heads are not)."""

    @staticmethod
    def forward(ctx, x):
        ctx.shape = tuple(x.shape)
        return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])

    @staticmethod
    def backward(ctx, g):
        return split_heads(g, ctx.shape)


def merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[..., heads, head_dim] -> [..., heads * head_dim] (a reshape; see
    :class:`_MergeHeads` for its gradient)."""
    if isinstance(x, DTensor) and torch.is_grad_enabled() and x.requires_grad:
        return _MergeHeads.apply(x)
    return x.reshape(*x.shape[:-2], x.shape[-2] * x.shape[-1])


def _all_reduce(t: torch.Tensor, op: str, mesh, dims: list) -> torch.Tensor:
    """``t`` reduced (``"sum"`` or ``"max"``) over the mesh dims ``dims``,
    by functional collectives (a dry run counts them)."""
    from torch.distributed import _functional_collectives as funcol

    for i in dims:
        t = funcol.all_reduce(t, op, (mesh, i))
    return funcol.wait_tensor(t) if dims else t


def _placed_cache_write(cache: torch.Tensor, row: torch.Tensor, pos: int) -> torch.Tensor:
    """Write the new row ``row`` [B, 1, KV, D] at ``pos`` into each rank's
    own shard of ``cache`` [B, T, KV, D] (a plain tensor, or a DTensor
    split over B, T and D as ``cache_sharding`` places it), in place, and
    return this rank's storage. The row is redistributed to the cache's
    placement of (B, KV, D) first; where T is split only the rank whose T
    range holds ``pos`` writes, at ``pos`` less its offset. Nothing is
    written into a gathered temporary: later steps would read stale rows."""
    if not isinstance(cache, DTensor):
        cache[:, pos] = row[:, 0].to(cache.dtype)
        return cache
    mesh, pl = cache.device_mesh, cache.placements
    if any(p.is_shard(2) or p.is_partial() for p in pl):
        raise NotImplementedError(
            f"decode_attention writes into a cache split over B, T and D only; this one is "
            f"placed {tuple(pl)}")
    local = cache.to_local()
    row = row.redistribute(mesh, [Replicate() if p.is_shard(1) else p for p in pl]).to_local()
    T_loc = local.shape[1]
    lo = shard_index(mesh, pl, 1) * T_loc
    if lo <= pos < lo + T_loc:
        local[:, pos - lo] = row[:, 0].to(local.dtype)
    return local


def _on_card(t: torch.Tensor) -> bool:
    return t.device.type == "cuda"


def _placed_attention(q: DTensor, ck: DTensor, cv: DTensor, kv_len: int) -> DTensor:
    """One query token per row [B, 1, H, D] against the placed cache [B, T,
    KV, D] over its first ``kv_len`` rows, on each rank's shards: the
    decode kernel on the local storage where it holds whole D and T;
    otherwise the work that partitioning the JAX package's ``_sdpa``
    (``src/repro/models/layers.py:188``) over those splits gives: partial
    scores over the local D, summed over the mesh dims that split D (an
    all-reduce); where T is split, the softmax's max and sum reduced over
    the mesh dims that split T, and P·V on the local D summed over them
    (all-reduces). Returns [B, H, D] split as the cache's B and D."""
    mesh, pl = ck.device_mesh, ck.placements
    # A split over a mesh dim of one rank splits nothing.
    t_dims = [i for i, p in enumerate(pl) if p.is_shard(1) and mesh.size(i) > 1]
    d_dims = [i for i, p in enumerate(pl) if p.is_shard(3) and mesh.size(i) > 1]
    B, _, H, D = q.shape
    q_pl = [Replicate() if p.is_shard(1) else p for p in pl]  # B and D as the cache's
    ql = q.redistribute(mesh, q_pl).to_local()
    kl, vl = ck.to_local(), cv.to_local()
    out_pl = [Shard(2) if p.is_shard(3) else Replicate() if p.is_shard(1) else p for p in pl]
    if not t_dims and not d_dims:
        out = ops.decode_attention(ql.reshape(ql.shape[0], H, D), kl.to(ql.dtype),
                                   vl.to(ql.dtype), kv_len)
        return DTensor.from_local(out, mesh, out_pl, run_check=False)
    if _on_card(kl):
        raise NotImplementedError(
            "no decode kernel takes a cache split over its head dimension or its rows yet; "
            "the card runs a cache split over the batch only")
    Bl, Tl, KV, Dl = kl.shape
    f32 = torch.float32
    qg = ql.reshape(Bl, KV, H // KV, Dl).to(f32)
    s = torch.einsum("bkgd,btkd->bkgt", qg, kl.to(f32)) / math.sqrt(D)
    s = _all_reduce(s, "sum", mesh, d_dims)
    lo = shard_index(mesh, pl, 1) * Tl
    valid = torch.arange(lo, lo + Tl, device=s.device) < kv_len
    s = torch.where(valid, s, s.new_tensor(-1e30))
    m = _all_reduce(s.amax(dim=-1), "max", mesh, t_dims)
    p = torch.exp(s - m[..., None])
    l = _all_reduce(p.sum(dim=-1), "sum", mesh, t_dims)  # noqa: E741
    o = _all_reduce(torch.einsum("bkgt,btkd->bkgd", p, vl.to(f32)), "sum", mesh, t_dims)
    o = (o / l[..., None]).reshape(Bl, H, Dl).to(ql.dtype)
    return DTensor.from_local(o, mesh, out_pl, run_check=False)


def _normal(gen: torch.Generator, shape, scale: float, dtype) -> torch.Tensor:
    """float32 normal draws times ``scale``, then cast to ``dtype``: the
    same values as an fp32 init cast once."""
    x = torch.randn(shape, generator=gen, device=gen.device, dtype=torch.float32)
    return (x * scale).to(dtype)


# --------------------------------------------------------------------------
# Norms / projections
# --------------------------------------------------------------------------

def init_rms_norm(d: int, device=None, dtype=torch.float32) -> Params:
    return {"scale": torch.ones((d,), dtype=dtype, device=device)}


def rms_norm(params: Params, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """RMSNorm with fp32 statistics; only the per-token inverse RMS is
    rounded back to the compute dtype (``layers.py:111-115``)."""
    xf = x.to(torch.float32)
    var = (xf * xf).sum(dim=-1) / x.shape[-1]
    inv = torch.rsqrt(var + eps).to(x.dtype)
    return x * inv[..., None] * params["scale"].to(x.dtype)


def init_linear(
    gen: torch.Generator, d_in: int, d_out: int, bias: bool = False,
    scale: float | None = None, dtype=torch.float32,
) -> Params:
    if scale is None:
        scale = 1.0 / math.sqrt(d_in)
    p: Params = {"w": _normal(gen, (d_in, d_out), scale, dtype)}
    if bias:
        p["b"] = torch.zeros((d_out,), dtype=dtype, device=gen.device)
    return p


def linear(params: Params, x: torch.Tensor) -> torch.Tensor:
    y = x @ params["w"].to(x.dtype)
    if "b" in params:
        y = y + params["b"].to(x.dtype)
    return y


# --------------------------------------------------------------------------
# RoPE
# --------------------------------------------------------------------------

def rope_tables(
    positions: torch.Tensor, head_dim: int, theta: float
) -> tuple[torch.Tensor, torch.Tensor]:
    """cos/sin tables [..., head_dim//2] for integer positions."""
    half = head_dim // 2
    exps = torch.arange(0, half, dtype=torch.float32, device=positions.device) / half
    # A Python-scalar base: a device tensor made from theta here would be a
    # blocking host-to-device copy (a stream sync) on every layer and step.
    freqs = 1.0 / torch.pow(theta, exps)
    ang = positions.to(torch.float32)[..., None] * freqs
    return torch.cos(ang), torch.sin(ang)


def apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor) -> torch.Tensor:
    """x: [..., S, H, D]; cos/sin: [..., S, D//2] broadcast over heads."""
    half = x.shape[-1] // 2
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    c = cos[..., None, :]
    s = sin[..., None, :]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).to(x.dtype)


# --------------------------------------------------------------------------
# Attention (GQA, causal/full)
# --------------------------------------------------------------------------

def init_attention(
    gen: torch.Generator,
    d_model: int,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    qkv_bias: bool = False,
    dtype=torch.float32,
) -> Params:
    return {
        "wq": init_linear(gen, d_model, n_heads * head_dim, bias=qkv_bias, dtype=dtype),
        "wk": init_linear(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, dtype=dtype),
        "wv": init_linear(gen, d_model, n_kv_heads * head_dim, bias=qkv_bias, dtype=dtype),
        "wo": init_linear(gen, n_heads * head_dim, d_model, dtype=dtype),
    }


def attention(
    params: Params,
    x: torch.Tensor,        # [B, S, d_model]
    cos: torch.Tensor,
    sin: torch.Tensor,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    causal: bool = True,
    kv_input: torch.Tensor | None = None,  # cross-attention source [B, T, d]
    use_rope: bool = True,
) -> torch.Tensor:
    """Attention over the whole sequence (training forward / prefill).

    With ``kv_input`` the keys and values are projected from it
    (cross-attention): no RoPE on either side and no causal mask
    (``layers.py:220-263`` of the JAX package). One query token against a
    memory goes through the decode kernel with ``kv_len = T``."""
    B, S, _ = x.shape
    src = x if kv_input is None else kv_input
    T = src.shape[1]
    q = split_heads(linear(params["wq"], x), (B, S, n_heads, head_dim))
    k = split_heads(linear(params["wk"], src), (B, T, n_kv_heads, head_dim))
    v = split_heads(linear(params["wv"], src), (B, T, n_kv_heads, head_dim))
    if use_rope and kv_input is None:
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    q = shard(q, "act_heads")
    if S == 1 and kv_input is not None:
        # Under a mesh the kernel runs on each rank's full copy.
        out = ops.decode_attention(_replicated_local(q).reshape(B, n_heads, head_dim),
                                   _replicated_local(k), _replicated_local(v), T)[:, None]
        if isinstance(q, DTensor):
            out = DTensor.from_local(out, q.device_mesh, [Replicate()] * q.device_mesh.ndim,
                                     run_check=False)
    else:
        out = flash_attention(q, k, v, causal and kv_input is None)
    return linear(params["wo"], merge_heads(out))


def decode_attention(
    params: Params,
    x: torch.Tensor,        # [B, 1, d_model]
    pos: int,               # current position
    cache_k: torch.Tensor,  # [B, T_max, KV, D]
    cache_v: torch.Tensor,
    rope_theta: float,
    n_heads: int,
    n_kv_heads: int,
    head_dim: int,
    rope: bool = True,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Single-token attention against a KV cache; returns (out, k', v').
    With ``rope`` off the query and the new key take no rotation (a model
    without positional encoding, as Jamba).

    Unlike the JAX package, which returns new cache arrays, the new K/V
    row is written into ``cache_k`` / ``cache_v`` in place (they are
    returned for the same call shape): a functional update would copy the
    whole cache every layer and step.

    Under a mesh (``x`` and the cache DTensors) the projections run as
    DTensor operations. A replicated cache (the serving launcher's, as the
    JAX launcher places none) takes the new row in each rank's full copy,
    and the kernel runs on it. A cache placed by ``cache_sharding`` (the
    dry run's: batch over the data axes, D over 'model', T over 'data'
    where the batch is 1) takes the row in each rank's own shard
    (:func:`_placed_cache_write`), and the attention runs on the local
    shards (:func:`_placed_attention`); its output enters ``wo`` split
    over the batch as the cache is."""
    B = x.shape[0]
    q = split_heads(linear(params["wq"], x), (B, 1, n_heads, head_dim))
    if rope:
        positions = torch.arange(pos, pos + 1, device=x.device)
        cos, sin = rope_tables(positions, head_dim, rope_theta)
        q = apply_rope(q, cos[None], sin[None])
    k_new = split_heads(linear(params["wk"], x), (B, 1, n_kv_heads, head_dim))
    v_new = split_heads(linear(params["wv"], x), (B, 1, n_kv_heads, head_dim))
    if rope:
        k_new = apply_rope(k_new, cos[None], sin[None])
    if isinstance(cache_k, DTensor):
        for cache, row in ((cache_k, k_new), (cache_v, v_new)):
            _placed_cache_write(cache, row, pos)
        out = _placed_attention(q, cache_k, cache_v, pos + 1)
        mesh = out.device_mesh
        out = out.redistribute(mesh, [p if p.is_shard(0) else Replicate() for p in out.placements])
    else:
        _placed_cache_write(cache_k, k_new, pos)
        _placed_cache_write(cache_v, v_new, pos)
        out = ops.decode_attention(
            q.reshape(B, n_heads, head_dim), cache_k.to(q.dtype), cache_v.to(q.dtype), pos + 1)
    out = out.reshape(B, 1, n_heads * head_dim)
    return linear(params["wo"], out), cache_k, cache_v


# --------------------------------------------------------------------------
# SwiGLU MLP
# --------------------------------------------------------------------------

def init_mlp(gen: torch.Generator, d_model: int, d_ff: int, dtype=torch.float32) -> Params:
    return {
        "wi": init_linear(gen, d_model, d_ff, dtype=dtype),
        "wg": init_linear(gen, d_model, d_ff, dtype=dtype),
        "wo": init_linear(gen, d_ff, d_model, dtype=dtype),
    }


def mlp_swiglu(params: Params, x: torch.Tensor) -> torch.Tensor:
    h = F.silu(linear(params["wg"], x)) * linear(params["wi"], x)
    h = shard(h, "act_ffn")
    return linear(params["wo"], h)


# --------------------------------------------------------------------------
# Embedding
# --------------------------------------------------------------------------

def init_embedding(gen: torch.Generator, vocab: int, d_model: int, dtype=torch.float32) -> Params:
    return {"table": _normal(gen, (vocab, d_model), 0.02, dtype)}


def embed(params: Params, tokens: torch.Tensor, dtype) -> torch.Tensor:
    # Gather, then cast: the same values as the JAX package's cast of the
    # whole table followed by the gather, without the table-sized copy.
    if isinstance(params["table"], DTensor):
        return _sharded_embed(params["table"], tokens).to(dtype)
    return params["table"][tokens].to(dtype)


def _sharded_embed(table: DTensor, tokens: torch.Tensor) -> DTensor:
    """``table[tokens]`` of a DTensor table, written out on the local
    shards: the table keeps its split over the vocabulary and is gathered
    along d; each rank looks up the tokens that fall in its rows and zeros
    the others; the partial rows are summed over the vocabulary's mesh
    dims. (DTensor's own strategy for the indexing's backward, an
    ``index_put``, fails on a table split this way in torch 2.11.)"""
    mesh = table.device_mesh
    if not isinstance(tokens, DTensor):
        tokens = DTensor.from_local(tokens, mesh, [Replicate()] * mesh.ndim, run_check=False)
    vocab = [p.is_shard(0) for p in table.placements]
    rows = [Replicate() if v or not p.is_shard(0) else p
            for v, p in zip(vocab, tokens.placements)]  # the batch split, kept
    # Each rank's gradient of its rows covers its own tokens only: a partial
    # sum over the mesh dims that split the batch.
    local = table.redistribute(mesh, [Shard(0) if v else Replicate() for v in vocab]).to_local(
        grad_placements=[Shard(0) if v else Partial() if r.is_shard(0) else Replicate()
                         for v, r in zip(vocab, rows)])
    n = local.shape[0]
    idx = tokens.redistribute(mesh, rows).to_local().long()
    idx = idx - shard_index(mesh, table.placements, 0) * n
    hit = (idx >= 0) & (idx < n)
    got = local[torch.where(hit, idx, 0)] * hit[..., None].to(local.dtype)
    partial = [Partial() if v else r for v, r in zip(vocab, rows)]
    return DTensor.from_local(got, mesh, partial, run_check=False).redistribute(mesh, rows)


def unembed(params: Params, x: torch.Tensor) -> torch.Tensor:
    return x @ params["table"].to(x.dtype).T
