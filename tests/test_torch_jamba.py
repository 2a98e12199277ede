"""AI21-Jamba2-Mini's block in the port against the benchmark's plain
reference (``bench/reference/hybrid.py``, float32, written from the
published equations) on seeded random weights at a small size: d 64, one
period of 8 layers (Mamba-1 on 7, attention without RoPE at 4, the MoE of
4 experts top-2 unnormalised on odd layers), d_state 16, dt rank 8.

Tolerances, each relative to the reference's own spread (its standard
deviation over the compared rows):
  * 1e-5 for the Mamba-1 mixer alone and 1e-4 for the whole stack, both
    in float32: the two sides compute the same float32 arithmetic in
    another order (the conv's taps, the scan's products), about 1e-6 a
    mixer, which the stack's 8 layers and the head grow about tenfold;
  * the decode test replaces the attention cache's bfloat16 K/V rows (the
    serving cache's type) by float32 ones, so that it too holds 1e-4; with
    the bfloat16 rows a few positions move by 0.4 of the spread, where a
    rounded hidden state flips a token's top-2 experts (the gates are not
    renormalised, so a flip moves the output a whole expert's worth).
A scan whose state is rounded to bfloat16 each step misses the mixer's
tolerance by orders of magnitude (``test_a_bfloat16_state_fails``).

The prompts are 48 tokens long with each channel's step dt drawn in
[0.05, 0.2], so that even the slowest decay (A = -1) falls by e^-2.4 or
more over the prompt: the decode steps depend on a state that has both
forgotten its start and carried the prompt, and a dropped or mis-carried
state shows.
"""

from __future__ import annotations

import math
import sys
from pathlib import Path

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from bench.harness import hybrid_weights  # noqa: E402
from bench.reference import hybrid  # noqa: E402
from repro_torch.kernels import ref, selective_scan as scan_op  # noqa: E402
from repro_torch.models import ssm  # noqa: E402
from repro_torch.models.config import ModelConfig, layer_kinds, layer_period  # noqa: E402
from repro_torch.models.lm import build_model  # noqa: E402

SEED = 2**31 + 11
SIZES = dict(name="jamba2-mini-tiny", family="hybrid", n_layers=8, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=96, vocab_size=256, n_experts=4,
             experts_per_token=2, moe_every=2, moe_offset=1, attn_every=8, attn_offset=4,
             ssm_kind="mamba1", ssm_dt_rank=8, ssm_state_dim=16, ssm_conv_dim=4, ssm_expand=2,
             rope=False, router_normalize=False, norm_eps=1e-6, capacity_factor=8.0)
CFG = ModelConfig(**SIZES)
MIXER_TOL = 1e-5
STACK_TOL = 1e-4
PROMPT = 48


@pytest.fixture(scope="module")
def weights():
    """(leaves by path, the port's tree of the same tensors), float32, each
    channel's dt_bias the inverse softplus of a dt in [0.05, 0.2]."""
    leaves = {p: hybrid_weights.make_leaf(SIZES, SEED, i, "cpu", torch.float32)
              for i, (p, _, _) in enumerate(hybrid_weights.leaf_specs(SIZES))}
    gen = torch.Generator().manual_seed(7)
    for p, t in leaves.items():
        if p[-1] == "dt_bias":
            dt = 0.05 + 0.15 * torch.rand(t.shape, generator=gen)
            leaves[p] = dt + torch.log(-torch.expm1(-dt))
    return leaves, hybrid_weights.tree(SIZES, leaves)


@pytest.fixture(scope="module")
def tokens():
    return torch.randint(0, SIZES["vocab_size"], (2, PROMPT), generator=torch.Generator()
                         .manual_seed(3))


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    """The largest |got - want| of a row over the row's standard deviation."""
    return float(((got - want).abs().amax(-1) / want.std(-1)).max())


def _mixer_inputs(weights):
    leaves, params = weights
    assert layer_kinds(CFG)[0][0] == "mamba1"
    port = {k: v[0] for k, v in _flat(params["layers"][0]["mixer"]["mamba"]).items()}
    h = torch.randn(2, PROMPT, SIZES["d_model"], generator=torch.Generator().manual_seed(5))
    return _nest(port), hybrid.layer_weights(leaves, SIZES, 0), h


def _flat(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flat(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def _nest(flat):
    out: dict = {}
    for path, v in flat.items():
        node = out
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v
    return out


def test_layer_pattern():
    kinds = layer_kinds(CFG)
    assert [m for m, _ in kinds] == ["mamba1"] * 4 + ["attn"] + ["mamba1"] * 3
    assert [f for _, f in kinds] == ["mlp", "moe"] * 4
    assert layer_period(CFG) == 8 and kinds == hybrid.layer_kinds(SIZES)
    assert CFG.dt_rank == 8 and ModelConfig(**dict(vars(CFG), ssm_dt_rank=0)).dt_rank == 4


def test_published_config_is_the_benchmarks():
    """The port's AI21-Jamba2-Mini (``configs/ai21_jamba2_mini.py``, 32
    layers) is the benchmark's configuration but for its depth."""
    import dataclasses
    import json

    from bench.harness import registry
    from repro_torch.configs import get_config

    with open(ROOT / "bench" / "configs" / "jamba2-mini-l16.json") as f:
        cell = registry.port_sizes(json.load(f))
    ours = dataclasses.asdict(get_config("ai21-jamba2-mini"))
    assert ours["n_layers"] == 32 and cell["n_layers"] == 16
    assert {k: ours[k] for k in cell if k not in ("name", "n_layers")} == \
        {k: v for k, v in cell.items() if k not in ("name", "n_layers")}


def test_mixer_matches_the_reference(weights):
    port, w, h = _mixer_inputs(weights)
    with torch.no_grad():
        got = ssm.mamba1_forward(port, CFG, h)
    want = hybrid.mamba1(h, w, SIZES, "f32")
    assert _rel(got, want) < MIXER_TOL


def test_mixer_decode_matches_the_reference(weights):
    port, w, h = _mixer_inputs(weights)
    state = ssm.mamba1_init_state(CFG, 2)
    with torch.no_grad():
        got = []
        for t in range(PROMPT):
            y, state = ssm.mamba1_decode_step(port, CFG, h[:, t:t + 1], state)
            got.append(y)
    assert _rel(torch.cat(got, 1), hybrid.mamba1(h, w, SIZES, "f32")) < MIXER_TOL


def test_a_bfloat16_state_fails(weights, monkeypatch):
    """The mixer's tolerance catches a scan that keeps its state in
    bfloat16: the plain loop with the state rounded each step."""

    def bf16_state(x, dt, z, Bm, Cm, A_log, D, dt_bias):
        A = -torch.exp(A_log)
        delta = torch.nn.functional.softplus(dt + dt_bias)
        s = torch.zeros(x.shape[0], x.shape[2], A.shape[1])
        ys = []
        for t in range(x.shape[1]):
            d = delta[:, t, :, None]
            s = (torch.exp(d * A) * s + d * x[:, t, :, None] * Bm[:, t, None, :]).bfloat16().float()
            ys.append((s * Cm[:, t, None, :]).sum(-1))
        return (torch.stack(ys, 1) + D * x) * torch.nn.functional.silu(z)

    port, w, h = _mixer_inputs(weights)
    monkeypatch.setattr(ssm, "selective_scan", bf16_state)
    with torch.no_grad():
        got = ssm.mamba1_forward(port, CFG, h)
    assert _rel(got, hybrid.mamba1(h, w, SIZES, "f32")) > 10 * MIXER_TOL


def test_prefill_logits_match_the_reference(weights, tokens):
    leaves, params = weights
    model = build_model(CFG, compute_dtype=torch.float32)
    want = hybrid.logits(SIZES, leaves, tokens)
    with torch.no_grad():
        assert _rel(model.prefill(params, tokens)[:, -1], want[:, -1]) < STACK_TOL
        assert _rel(model.forward(params, tokens)[0], want) < STACK_TOL


def test_prefill_then_decode_match_the_reference(weights, tokens):
    """The prefill step's logits, then every position decoded through the
    cache (attention's K/V rows in float32, module docstring), against the
    reference's full forward over the prompt and 8 tokens after it."""
    leaves, params = weights
    model = build_model(CFG, compute_dtype=torch.float32)
    more = torch.randint(0, SIZES["vocab_size"], (2, 8), generator=torch.Generator().manual_seed(4))
    seq = torch.cat([tokens, more], 1)
    want = hybrid.logits(SIZES, leaves, seq)
    with torch.no_grad():
        assert _rel(model.prefill(params, tokens)[:, -1], want[:, PROMPT - 1]) < STACK_TOL
        cache = model.init_cache(2, seq.shape[1], device="cpu")
        cache["layers"] = tuple({k: v.float() if k in ("k", "v") else v for k, v in c.items()}
                                for c in cache["layers"])
        got = []
        for t in range(seq.shape[1]):
            logits, cache = model.decode_step(params, cache, seq[:, t])
            got.append(logits)
    assert cache["layers"][0]["ssm"].dtype == torch.float32
    assert _rel(torch.cat(got, 1), want) < STACK_TOL


def test_operator_cpu_route():
    """The operator's CPU route is the plain loop, and the plain loop is
    the reference's recurrence; its fake route gives shapes, its FLOP
    formula 6 a (token, channel, state), and nothing launches."""
    gen = torch.Generator().manual_seed(9)
    B, S, di, N = 2, 40, 128, 16
    x, dt, z = (torch.randn(B, S, di, generator=gen) for _ in range(3))
    Bm, Cm = (torch.randn(B, S, N, generator=gen) for _ in range(2))
    A_log = torch.log(torch.rand(di, N, generator=gen) * 4 + 0.5)
    D, dt_bias = torch.randn(di, generator=gen), torch.randn(di, generator=gen) - 3
    args = (x, dt, z, Bm, Cm, A_log, D, dt_bias)
    before = dict(scan_op.launches)
    with FlopCounterMode(display=False) as fc:
        got = scan_op.selective_scan(*args)
    assert fc.get_total_flops() == 6 * B * S * di * N
    assert torch.equal(got, ref.ref_selective_scan(*args))
    delta = torch.nn.functional.softplus(dt + dt_bias)
    want = (hybrid.scan(x, delta, -torch.exp(A_log), Bm, Cm) + D * x) * torch.nn.functional.silu(z)
    assert _rel(got, want) < MIXER_TOL
    assert scan_op.launches == before

    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode() as mode:
        fake = scan_op.selective_scan(*(mode.from_tensor(t) for t in args))
    assert fake.shape == (B, S, di) and fake.dtype == torch.float32


def test_refusals():
    x = torch.zeros(1, 4, 64)
    with pytest.raises(ValueError):
        scan_op.selective_scan(x, x, x, torch.zeros(1, 4, 16), torch.zeros(1, 5, 16),
                               torch.zeros(64, 16), torch.zeros(64), torch.zeros(64))
    with pytest.raises(TypeError):
        scan_op.selective_scan(x, x.bfloat16(), x, torch.zeros(1, 4, 16), torch.zeros(1, 4, 16),
                               torch.zeros(64, 16), torch.zeros(64), torch.zeros(64))
    with pytest.raises(ValueError, match="ssm_kind"):
        ModelConfig(**dict(vars(CFG), ssm_kind="mamba3"))


def test_training_raises(weights, tokens):
    """The scan is forward only: a loss that needs the mixer's gradient
    stops in the forward pass rather than train on a gradient autograd
    would drop."""
    _, params = weights
    model = build_model(CFG, compute_dtype=torch.float32)
    w = params["layers"][0]["mixer"]["mamba"]["in_proj"]["w"].detach().clone().requires_grad_()
    mixer = dict(params["layers"][0]["mixer"]["mamba"], in_proj={"w": w})
    layers = (dict(params["layers"][0], mixer=dict(params["layers"][0]["mixer"], mamba=mixer)),
              *params["layers"][1:])
    with pytest.raises(NotImplementedError, match="forward only"):
        model.loss(dict(params, layers=layers), {"tokens": tokens, "labels": tokens})


@pytest.fixture(scope="module")
def local_mesh():
    """A (1, 1) mesh over a one-rank gloo group (an in-process store), the
    group destroyed after this module's tests if they started it."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_local_mesh

    started = not dist.is_initialized()
    yield make_local_mesh(device="cpu")
    if started:
        dist.destroy_process_group()


def test_no_mesh_route(weights, local_mesh):
    from torch.distributed.tensor import DTensor, Replicate

    port, _, h = _mixer_inputs(weights)
    u = DTensor.from_local(h, local_mesh, [Replicate()] * local_mesh.ndim)
    with pytest.raises(NotImplementedError, match="mesh route"):
        ssm.mamba1_forward(port, CFG, u)
    model = build_model(CFG, compute_dtype=torch.float32)
    cache = model.init_cache(2, 4, device="cpu")
    from repro_torch.models import lm

    with pytest.raises(NotImplementedError, match="mesh route"):
        lm._recurrent_decode("mamba1", port, CFG, u[:, :1], cache["layers"][0], 0)


@pytest.mark.cuda
@pytest.mark.parametrize("B,S", [(2, 4096), (16, 512), (3, 77)])
def test_kernel_on_the_card(B, S):
    """The kernel against the plain loop on the card at d_inner 8,192 (the
    cell's shapes, and a ragged one), from the same bfloat16 inputs: the
    kernel rounds its float32 result once to bfloat16 (half an ulp, 2^-9
    of the value) and takes its decays by ex2.approx (2 ulp of float32),
    so each element is within 2^-8 of the loop's float32 value plus 1e-3
    of the output's spread; float32 inputs at B 2, S 300 within 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(B * 1000 + S)
    di, N = 8192, 16
    xz = torch.randn(B, S, 2 * di, generator=gen, device=dev).bfloat16()
    x, z = xz[..., :di].contiguous(), xz[..., di:]  # z a strided view, as the mixer passes it
    dt = torch.randn(B, S, di, generator=gen, device=dev).bfloat16()
    Bm, Cm = (torch.randn(B, S, N, generator=gen, device=dev).bfloat16() for _ in range(2))
    A_log = torch.log(torch.arange(1, N + 1, device=dev, dtype=torch.float32)).expand(di, N)
    D = torch.ones(di, device=dev)
    u = torch.rand(di, generator=gen, device=dev)
    dt0 = torch.exp(math.log(1e-3) + u * math.log(100.0))
    dt_bias = dt0 + torch.log(-torch.expm1(-dt0))
    n = scan_op.launches["selective_scan"]
    got = scan_op.selective_scan(x, dt, z, Bm, Cm, A_log, D, dt_bias)
    torch.cuda.synchronize()
    assert scan_op.launches["selective_scan"] == n + 1
    want = ref.ref_selective_scan(x.float(), dt.float(), z.float(), Bm.float(), Cm.float(),
                                  A_log, D, dt_bias)
    err = (got.float() - want).abs()
    assert bool((err <= 2.0**-8 * want.abs() + 1e-3 * want.std()).all()), float(err.max())
    if (B, S) == (2, 4096):
        x32, dt32, z32 = (t[:, :300].float().contiguous() for t in (x, dt, xz[..., di:]))
        got32 = scan_op.selective_scan(x32, dt32, z32, Bm[:, :300].float(), Cm[:, :300].float(),
                                       A_log, D, dt_bias)
        want32 = ref.ref_selective_scan(x32, dt32, z32, Bm[:, :300].float(),
                                        Cm[:, :300].float(), A_log, D, dt_bias)
        assert _rel(got32, want32) < 1e-4
