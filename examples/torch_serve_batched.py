"""Batched serving on the PyTorch port: prefill a batch of prompts, then
decode with the KV cache through the serve step — the path the
decode_32k/long_500k dry-run cells trace at production scale. The twin of
``examples/serve_batched.py``, with its defaults; it calls ``repro_torch``
only.

As the original, the prompts go into the cache through serve steps
(teacher forcing) and the generated tokens follow greedily, each step one
launch of the decode attention kernel a layer on the card. The port's
prefill step (``build_prefill_step``: the flash attention kernel) also runs
the prompts once, and its last-position logits are held against the last
prompt decode step's. The weights are the smoke config's from seed 0, in
bf16 (the port casts serving weights once; the original casts them at
each use, to the same values).

Run:  PYTHONPATH=src python examples/torch_serve_batched.py            # on the card
      PYTHONPATH=src python examples/torch_serve_batched.py --device cpu
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import smoke_config
from repro_torch.device import resolve_device
from repro_torch.models.lm import build_model
from repro_torch.runtime.steps import build_prefill_step, build_serve_step


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv: list[str] | None = None, params=None) -> dict:
    """Print the serve and return its numbers: the prompts and generated
    tokens, the last prompt step's logits, the prefill's gap to them and
    the decode rate. ``params`` (a parameter tree on the device) replaces
    the seed-0 weights."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = smoke_config("llama3_2_3b")
    model = build_model(cfg)
    if params is None:
        params = model.init(0, device=dev, dtype=torch.bfloat16)

    B, prompt_len, gen_len = 4, 16, 24
    rng = np.random.default_rng(0)
    prompts = torch.from_numpy(
        rng.integers(0, cfg.vocab_size, (B, prompt_len)).astype(np.int32)).to(dev)

    # Prefill: run the prompt through the cache via decode steps (teacher
    # forcing); the production prefill step runs beside it below.
    cache = model.init_cache(B, prompt_len + gen_len + 1, device=dev)
    serve_step = build_serve_step(model)
    for t in range(prompt_len):
        logits, cache = serve_step(params, cache, prompts[:, t])
    last = logits[:, 0].float()
    prefill = build_prefill_step(model)(params, {"tokens": prompts})[:, 0].float()
    gap = float((prefill - last).abs().max())

    tokens = [torch.argmax(logits[:, 0], dim=-1).to(torch.int32)]
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(gen_len - 1):
        logits, cache = serve_step(params, cache, tokens[-1])
        tokens.append(torch.argmax(logits[:, 0], dim=-1).to(torch.int32))
    out = torch.stack(tokens, dim=1).cpu().numpy()
    dt = time.perf_counter() - t0
    print(f"prompts  : {prompts.cpu().numpy()[:, :8]}...")
    print(f"generated: {out}")
    print(f"prefill  : last-position logits within {gap:.4f} of the last prompt decode step's")
    print(
        f"{B} sequences x {gen_len} tokens in {dt:.2f}s "
        f"({B * gen_len / dt:.1f} tok/s on {dev.type}, batched KV-cache decode)"
    )
    return dict(prompts=prompts.cpu().numpy(), tokens=out, last_logits=last.cpu().numpy(),
                prefill_gap=gap, decode_s=dt, tok_s=B * gen_len / dt)


if __name__ == "__main__":
    main()
