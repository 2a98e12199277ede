"""End-to-end training run on the PyTorch port: ~100M-parameter
llama-family model trained for a few hundred steps on the synthetic
pipeline, with checkpointing and the scheduler-planned gradient-reduction
schedule printed up front. The twin of ``examples/train_e2e.py``, with its
defaults; it calls ``repro_torch`` only. On the card the attention runs in
the flash forward kernel with its log-sum-exp and the three backward
kernels.

Run:  PYTHONPATH=src python examples/torch_train_e2e.py [--steps 300] [--dim 256]
      PYTHONPATH=src python examples/torch_train_e2e.py --device cpu --steps 3

The default is a reduced width; pass --dim 768 --layers 12 for the full
~100M configuration. ``--compute-dtype float32`` trains in float32
compute (bf16 by default, as the original).

Checkpoints: a checkpoint written after step s carries the label s + 1,
the number of steps done (the port's rule), and a run over a directory
that holds one resumes with the next step; it repeats none. (The
original labels it s, and its resumed run repeats step s.)
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile
import time

import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.distribution.plan import LinkSpec, backward_profile, plan_gradient_schedule
from repro_torch.models.lm import build_model, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.steps import build_train_step, make_train_state


def main(argv: list[str] | None = None) -> dict:
    """Train, print as the original does, and return the numbers: the
    step the run started at, each step's loss, grad norm and lr, the
    parameter count and the reduction plan's gain."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--dim", type=int, default=256)
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--ckpt-dir", type=str,
                    default=os.path.join(tempfile.gettempdir(), "repro_torch_e2e_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--compute-dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = dataclasses.replace(
        get_config("llama3_2_3b"),
        n_layers=args.layers,
        d_model=args.dim,
        n_heads=max(4, args.dim // 64),
        n_kv_heads=max(2, args.dim // 128),
        head_dim=64,
        d_ff=args.dim * 4,
        vocab_size=4096,
    )
    model = build_model(cfg, compute_dtype=getattr(torch, args.compute_dtype))
    state = make_train_state(model, 0, device=dev)
    n_params = count_params(state.params)
    print(f"model: {cfg.n_layers}L d={cfg.d_model} params={n_params:,}")

    # Paper-solver communication plan for this model's backward pass.
    g_secs, g_bytes = backward_profile(cfg, tokens_per_device=args.batch * args.seq)
    plan = plan_gradient_schedule(g_secs, g_bytes, LinkSpec(), time_limit=3.0)
    print(
        f"reduction plan: {100 * plan.gain_vs_serial:.1f}% faster than serial, "
        f"buckets->channels {plan.channel_of_bucket.tolist()} "
        f"(proved={plan.proved_optimal})"
    )

    data = make_pipeline(
        DataConfig(vocab_size=cfg.vocab_size, global_batch=args.batch, seq_len=args.seq)
    )
    opt = AdamWConfig(
        lr_peak=3e-3, lr_min=3e-4, warmup_steps=20, total_steps=args.steps
    )
    step = build_train_step(model, opt, n_micro=2)

    start = 0
    if ckpt.latest_step(args.ckpt_dir) is not None:
        state, start = ckpt.restore(args.ckpt_dir, state)
        print(f"resumed from checkpoint at step {start}")

    metrics = []
    t0 = time.perf_counter()
    for s in range(start, args.steps):
        batch = {k: torch.from_numpy(v).to(dev) for k, v in data.batch_for_step(s).items()}
        state, m = step(state, batch)
        m = {k: float(v) for k, v in m.items()}
        metrics.append(m)
        if s % 20 == 0 or s == args.steps - 1:
            dt = time.perf_counter() - t0
            print(
                f"step {s:4d}  loss={m['loss']:.4f}  "
                f"gnorm={m['grad_norm']:.3f}  "
                f"lr={m['lr']:.2e}  [{dt:.1f}s]"
            )
        if s and s % args.ckpt_every == 0:
            ckpt.save(args.ckpt_dir, s + 1, state)
            print(f"checkpointed step {s} (label {s + 1}: the steps done)")
    print("done.")
    return dict(start=start, metrics=metrics, n_params=n_params,
                plan_gain=plan.gain_vs_serial, wall_s=time.perf_counter() - t0, state=state)


if __name__ == "__main__":
    main()
