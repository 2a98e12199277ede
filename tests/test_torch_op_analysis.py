"""The port's per-device op analyzer (``repro_torch.launch.op_analysis``)
against the JAX package's HLO analyzer, and the kernel operators' fake
implementations and FLOP formulas.

The loop cases mirror ``tests/test_analysis_and_plan.py:17-53``: where the
reference compiles a ``lax.scan`` and multiplies its trip count, the port
runs a Python loop, counted once an iteration, and both count the same
FLOPs. The per-device case runs on a fake world of 256 ranks in a
subprocess (a process holds one process group)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils.flop_counter import FlopCounterMode

from repro_torch.kernels import attention, ref
from repro_torch.launch.op_analysis import OpCost, analyze_ops, flop_counter_total

SRC = Path(__file__).resolve().parents[1] / "src"


def _jax_flops(fn, *shapes) -> float:
    import jax
    import jax.numpy as jnp

    from repro.launch.hlo_analysis import analyze_hlo

    args = [jnp.ones(s) for s in shapes]
    return analyze_hlo(jax.jit(fn).lower(*args).compile().as_text()).flops


def test_analyzer_counts_a_python_loop_once_an_iteration():
    import jax

    def f(x):
        for _ in range(10):
            x = x @ x
        return x

    def fj(x):
        y, _ = jax.lax.scan(lambda c, _: (c @ c, None), x, None, length=10)
        return y

    cost, _ = analyze_ops(f, torch.ones((64, 64)))
    assert cost.flops == 10 * 2 * 64**3
    assert cost.flops == _jax_flops(fj, (64, 64))


def test_analyzer_nested_loops():
    import jax

    def g(x):
        for _ in range(3):
            for _ in range(5):
                x = x @ x
        return x

    def gj(x):
        def outer(c, _):
            c2, _ = jax.lax.scan(lambda c2, _: (c2 @ c2, None), c, None, length=5)
            return c2, None
        y, _ = jax.lax.scan(outer, x, None, length=3)
        return y

    cost, _ = analyze_ops(g, torch.ones((32, 32)))
    assert cost.flops == 15 * 2 * 32**3
    assert cost.flops == _jax_flops(gj, (32, 32))


def test_analyzer_counts_hbm_and_no_collectives_on_1_device():
    import jax

    cost, out = analyze_ops(lambda x, w: torch.relu(x @ w), torch.ones((128, 256)),
                            torch.ones((256, 64)))
    assert out.shape == (128, 64)
    assert cost.flops == 2 * 128 * 256 * 64
    assert cost.flops == _jax_flops(lambda x, w: jax.nn.relu(x @ w), (128, 256), (256, 64))
    # The matmul's output and operands, and relu's output written and read.
    assert cost.hbm_bytes == 4 * (128 * 64 + 128 * 256 + 256 * 64) + 2 * 4 * 128 * 64
    assert cost.total_collective_bytes == 0.0


def test_op_cost_adds_and_scales():
    a = OpCost(flops=1.0, hbm_bytes=2.0, collective_bytes={"all-reduce": 3.0},
               kernel_calls={"flash_fwd": 1.0})
    a += OpCost(flops=1.0, collective_bytes={"all-reduce": 1.0, "all-gather": 2.0})
    assert (a.flops, a.hbm_bytes, a.total_collective_bytes) == (2.0, 2.0, 6.0)
    b = a.scaled(2.0)
    assert b.collective_bytes == {"all-reduce": 8.0, "all-gather": 4.0}
    assert b.kernel_calls == {"flash_fwd": 2.0}


_PER_DEVICE = """
import json, sys, torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.distributed.tensor import DTensor, Replicate, Shard
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.launch.op_analysis import analyze_ops, flop_counter_total

fake_world(256)
mesh = make_production_mesh(device="cpu")
with FakeTensorMode():
    # x [256, 4096] (Shard(0), Replicate()), w [4096, 4096] (Replicate(), Shard(0)):
    # each rank holds x [16, 4096] and w [256, 4096].
    x = DTensor.from_local(torch.empty(16, 4096), mesh, [Shard(0), Replicate()], run_check=False)
    w = DTensor.from_local(torch.empty(256, 4096), mesh, [Replicate(), Shard(0)], run_check=False)
    step = lambda: (x @ w).redistribute(mesh, [Shard(0), Replicate()])
    cost, y = analyze_ops(step)
    total = flop_counter_total(lambda: x @ w)
print(json.dumps(dict(flops=cost.flops, coll=cost.collective_bytes, total=total,
                      local=list(y.to_local().shape))))
"""


def test_analyzer_counts_the_local_op_of_a_dtensor():
    """The per-device trap: a dispatch mode sees a DTensor matmul at its
    global shapes; the analyzer counts the local [16, 256] @ [256, 4096]
    one and the all-reduce of its [16, 4096] partial sums, while
    ``FlopCounterMode`` counts the global op, every rank's work."""
    env = dict(os.environ, PYTHONPATH=str(SRC))
    env.pop("XLA_FLAGS", None)
    out = subprocess.run([sys.executable, "-c", _PER_DEVICE], env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["flops"] == 2 * 16 * 256 * 4096
    assert got["coll"] == {"all-reduce": 16 * 4096 * 4}
    assert got["total"] == 256 * got["flops"] == 2 * 256 * 4096 * 4096
    assert got["local"] == [16, 4096]


def _inputs(rng, B=2, S=5, T=7, H=4, KV=2, D=16):
    f = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    q, k, v, do = f(B, S, H, D), f(B, T, KV, D), f(B, T, KV, D), f(B, S, H, D)
    return q, k, v, do


@pytest.mark.parametrize("causal", [True, False])
def test_flop_counter_counts_each_kernel_operator_by_its_formula(causal):
    rng = np.random.default_rng(0)
    q, k, v, do = _inputs(rng)
    o, lse = attention.flash_attention(q, k, v, causal, return_lse=True)
    calls = {
        "flash_fwd": (lambda: attention.flash_attention(q, k, v, causal),
                      attention.flash_flops(q, k, causal)),
        "flash_fwd_lse": (lambda: attention.flash_attention(q, k, v, causal, return_lse=True),
                          attention.backward_flops(q, k, causal)["flash_attention_lse"]),
        "flash_bwd": (lambda: attention.flash_attention_bwd(q, k, v, o, lse, do, causal),
                      sum(attention.backward_flops(q, k, causal)[n] for n in (
                          "flash_bwd_delta", "flash_bwd_dkdv", "flash_bwd_dq"))),
        "decode_int": (lambda: attention.decode_attention(q[:, 0], k, v, 3),
                       4 * 2 * 4 * 16 * 3),
        "decode_tensor": (lambda: attention.decode_attention(q[:, 0], k, v, torch.tensor([3, 5])),
                          4 * 2 * 4 * 16 * 7),
    }
    for name, (fn, want) in calls.items():
        with FlopCounterMode(display=False) as fc:
            fn()
        assert fc.get_total_flops() == want, name
        cost, _ = analyze_ops(fn)
        assert cost.flops == want, name
    # The causal triangle: query s meets keys 0..s (S 5 <= T 7).
    pairs = 15 if causal else 35
    assert attention.flash_flops(q, k, causal) == 4 * 2 * 4 * 16 * pairs
    # Clipped at T when S > T.
    assert attention.flash_flops((1, 9, 1, 1), (1, 4, 1, 1), True) == 4 * (10 + 5 * 4)


def test_fake_implementations_give_the_plain_versions_shapes_and_dtypes():
    rng = np.random.default_rng(1)
    for dt in (torch.float32, torch.bfloat16):
        q, k, v, do = (t.to(dt) for t in _inputs(rng))
        o, lse = ref.ref_flash_attention(q, k, v, True, return_lse=True)
        delta = ref.ref_flash_bwd_delta(o, do)
        plain = {
            "fwd": ref.ref_flash_attention(q, k, v, True),
            "fwd_lse": (o, lse),
            "delta": delta,
            "dkdv": ref.ref_flash_bwd_dkdv(q, k, v, do, lse, delta),
            "dq": ref.ref_flash_bwd_dq(q, k, v, do, lse, delta),
            "decode": ref.ref_decode_attention(q[:, 0], k, v, 3),
        }
        mode = FakeTensorMode()
        fq, fk, fv, fdo, fo, flse, fdelta = (mode.from_tensor(t) for t in (q, k, v, do, o, lse, delta))
        with mode:
            fake = {
                "fwd": attention.flash_attention(fq, fk, fv),
                "fwd_lse": attention.flash_attention(fq, fk, fv, return_lse=True),
                "delta": attention.flash_bwd_delta(fo, fdo),
                "dkdv": attention.flash_bwd_dkdv(fq, fk, fv, fdo, flse, fdelta),
                "dq": attention.flash_bwd_dq(fq, fk, fv, fdo, flse, fdelta),
                "decode": attention.decode_attention(fq[:, 0], fk, fv, 3),
            }
        for name, want in plain.items():
            got = fake[name]
            want, got = (want, got) if isinstance(want, tuple) else ((want,), (got,))
            for a, b in zip(want, got):
                assert (tuple(a.shape), a.dtype) == (tuple(b.shape), b.dtype), (name, dt)


@pytest.mark.parametrize("S", [48, 256])
def test_traced_slstm_loop_counts_as_the_whole_loop(S):
    """In the dry run's trace (``dryrun.traced_loops``, fake tensors) the
    sLSTM time loop is traced one step and counted S times (forward, and
    the backward's weight, input and carry gradients, and autograd's S - 1
    sums of the steps' full-size gradients of the gate inputs): the same
    FLOPs as the loop run step by step on real tensors, HBM bytes within
    2% (the shared elementwise ops of the step's backward are counted for
    both of its gradient parts; measured +0.9% at S 48, +0.3% at S 256),
    and the peak memory within 10%: the S steps' saved tensors are held as
    one allocation through the backward, whose per-step temporaries the
    trace has once (measured +1.4% at S 48, -2.7% at S 256, -3.4% at S
    1,024; +15% at S 6, where the first step, which saves less, weighs)."""
    from torch.distributed._tools.mem_tracker import MemTracker

    from repro_torch.launch import dryrun
    from repro_torch.models import ssm

    d, B = 32, 2
    rng = np.random.default_rng(2)
    w = torch.from_numpy(rng.standard_normal((d, 4 * d)).astype(np.float32))
    gx = torch.from_numpy(rng.standard_normal((B, S, 4 * d)).astype(np.float32)).to(torch.bfloat16)

    def step(w, gx):
        hs, carry = ssm._slstm_scan({"w": w}, gx)
        (hs.float().sum() + carry[0].sum()).backward()
        return hs

    def run(w, gx):
        mt = MemTracker()
        mt.track_external(w, gx)
        with mt:
            cost, out = analyze_ops(step, w, gx)
        return cost, out, sum(snap["Total"] for snap in mt.get_tracker_snapshot("peak").values())

    real, _, real_peak = run(w.clone().requires_grad_(), gx.clone().requires_grad_())
    mode = FakeTensorMode()
    fw, fgx = (mode.from_tensor(t).requires_grad_() for t in (w, gx))
    with mode, dryrun.traced_loops():
        fake, out, fake_peak = run(fw, fgx)
    assert ssm._slstm_scan.__name__ == "_slstm_scan"  # the loop is back
    assert tuple(out.shape) == (B, S, d) and tuple(fgx.grad.shape) == (B, S, 4 * d)
    assert fake.flops == real.flops == 2 * B * d * 4 * d * (S + S + S - 1)
    assert abs(fake.hbm_bytes - real.hbm_bytes) <= 0.02 * real.hbm_bytes
    assert abs(fake_peak - real_peak) <= 0.10 * real_peak, (fake_peak, real_peak)
