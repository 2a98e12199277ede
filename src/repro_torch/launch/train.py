"""Training launcher for one card (counterpart of ``repro.launch.train``).

  python -m repro_torch.launch.train --arch llama3.2-3b --steps 100          # smoke config
  python -m repro_torch.launch.train --arch llama3.2-3b --no-smoke \\
      --global-batch 8 --seq 1024 --n-micro 2 --steps 4                     # full width

It builds the training program the JAX launcher builds, on one device:
  * the scheduler-planned gradient-reduction schedule
    (``backward_profile`` / ``plan_gradient_schedule``), logged as the
    JAX launcher logs it;
  * float32 master weights from ``--seed``, AdamW with
    ``AdamWConfig(total_steps=--steps)``, ``--n-micro`` micro-batches and
    optional bf16 gradient compression (``--compress-grads``);
  * deterministic restartable data from ``repro_torch.data.pipeline``;
  * checkpoint/restart through ``repro_torch.checkpoint.ckpt`` every
    ``--ckpt-every`` steps into ``--ckpt-dir``, resumed automatically.

There is no mesh and no ``NamedSharding``: the multi-device stack
(``distribution/sharding.py``, ``launch/mesh.py``) is ROADMAP Queue 1
item 9. It runs on the CUDA card; a CPU run must be asked for with
``--device cpu``. ``--smoke`` (the default) trains the reduced config,
``--no-smoke`` the published widths.

Checkpoints are labelled with the number of steps done (the AdamW step
count), and a resumed run starts at that step. (The JAX launcher labels a
checkpoint with the index of the step it has just run and resumes at that
index, so its resumed run repeats that step.)
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch.checkpoint import ckpt
from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.device import resolve_device
from repro_torch.distribution.plan import LinkSpec, backward_profile, plan_gradient_schedule
from repro_torch.models.config import ModelConfig
from repro_torch.models.lm import build_model, count_params
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.runtime.steps import TrainState, build_train_step, make_train_state

__all__ = ["TrainResult", "data_config", "batch_to", "plan_log", "train", "parse_args", "main"]


@dataclasses.dataclass
class TrainResult:
    state: TrainState
    start: int                                # the step the run started at (after resume)
    metrics: list[dict[str, float]]           # loss, grad_norm, lr per step run, in order
    step_s: list[float] = dataclasses.field(default_factory=list)  # host wall per step


def data_config(cfg: ModelConfig, global_batch: int, seq: int, seed: int = 0) -> DataConfig:
    """The JAX launcher's pipeline settings: frames as long as the sequence
    for an encoder-decoder model, the patches for a cross-attention one."""
    return DataConfig(
        vocab_size=cfg.vocab_size,
        global_batch=global_batch,
        seq_len=seq,
        seed=seed,
        memory_len=seq if cfg.n_enc_layers else (cfg.n_patches if cfg.cross_attn_every else 0),
        d_model=cfg.d_model,
    )


def batch_to(batch: dict[str, np.ndarray], device) -> dict[str, torch.Tensor]:
    """A pipeline batch as tensors on ``device`` (tokens and labels int32)."""
    return {k: torch.from_numpy(v).to(device) for k, v in batch.items()}


def plan_log(cfg: ModelConfig, tokens_per_device: int, time_limit: float = 2.0) -> str:
    """The gradient-reduction plan line the JAX launcher prints."""
    g_secs, g_bytes = backward_profile(cfg, tokens_per_device=tokens_per_device)
    plan = plan_gradient_schedule(g_secs, g_bytes, LinkSpec(), time_limit=time_limit)
    return (f"reduction plan: gain_vs_serial={100 * plan.gain_vs_serial:.1f}% "
            f"channels={plan.channel_of_bucket.tolist()}")


def _metrics(m: dict[str, Any]) -> dict[str, float]:
    return {k: float(v) for k, v in m.items()}


def train(
    arch: str = "llama3.2-3b",
    steps: int = 100,
    global_batch: int = 8,
    seq: int = 64,
    n_micro: int = 2,
    smoke: bool = True,
    ckpt_dir: str | None = None,
    ckpt_every: int = 50,
    compress_grads: bool = False,
    seed: int = 0,
    device=None,
    log=print,
    opt_cfg: AdamWConfig | None = None,
) -> TrainResult:
    """Train ``arch`` for steps [start, ``steps``) and return the state and
    each step's metrics; ``start`` is 0, or the step of the latest
    checkpoint in ``ckpt_dir``. ``opt_cfg`` defaults to the JAX launcher's
    ``AdamWConfig(total_steps=steps)``."""
    dev = resolve_device(device)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    log(f"device: {dev}")
    model = build_model(cfg)
    opt_cfg = opt_cfg or AdamWConfig(total_steps=steps)
    step_fn = build_train_step(model, opt_cfg, n_micro=n_micro, compress_grads=compress_grads)
    log(plan_log(cfg, global_batch * seq))

    state = make_train_state(model, seed, device=dev, compress=compress_grads)
    log(f"params: {count_params(state.params):,}")
    data = make_pipeline(data_config(cfg, global_batch, seq))
    start = 0
    if ckpt_dir and ckpt.latest_step(ckpt_dir) is not None:
        state, start = ckpt.restore(ckpt_dir, state)
        log(f"resumed at step {start}")

    metrics, step_s = [], []
    for s in range(start, steps):
        batch = batch_to(data.batch_for_step(s), dev)
        t = time.perf_counter()
        state, m = step_fn(state, batch)
        m = _metrics(m)  # reads the device: the step has ended
        step_s.append(time.perf_counter() - t)
        metrics.append(m)
        if s % 10 == 0 or s == steps - 1:
            log(f"step {s:5d} loss={m['loss']:.4f} gnorm={m['grad_norm']:.3f}")
        if ckpt_dir and s and s % ckpt_every == 0:
            ckpt.save(ckpt_dir, s + 1, state)
    return TrainResult(state=state, start=start, metrics=metrics, step_s=step_s)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default="llama3.2-3b")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--n-micro", type=int, default=2)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="reduced config (default); --no-smoke for the published widths")
    ap.add_argument("--ckpt-dir", type=str, default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> TrainResult:
    args = parse_args(argv)
    return train(args.arch, args.steps, args.global_batch, args.seq, args.n_micro,
                 args.smoke, args.ckpt_dir, args.ckpt_every, args.compress_grads,
                 args.seed, args.device)


if __name__ == "__main__":
    main()
