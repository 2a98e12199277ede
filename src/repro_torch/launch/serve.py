"""Serving launcher: batched KV-cache decode of a language model
(counterpart of ``repro.launch.serve``).

  python -m repro_torch.launch.serve --arch llama3.2-3b --batch 4 --gen 32
  python -m repro_torch.launch.serve --arch llama3.2-3b --no-smoke   # full width

It builds the model with random weights from ``--seed``, held in bf16
from load time, runs the production prefill step on the prompts, then
decodes the prompts into the KV cache through the serve step and
generates greedily, and prints tokens/s. As in the JAX launcher, the
prompts reach the cache through the decode loop, so the first token
waits for the prompt decode; the prefill step fills no cache, and its
last-position logits check the decode loop's. It runs on the CUDA card; a CPU
run must be asked for with ``--device cpu``. ``--smoke`` (the default)
serves the reduced config; ``--no-smoke`` the published widths.

An encoder-decoder model (``n_enc_layers``) serves over random frames
[B, prompt, d], a cross-attention model over random patches [B, 16, d],
both drawn from the seed's generator before the prompts, as the JAX
launcher draws them (``launch/serve.py:40-52``): the prefill step takes
the raw memory, the cache the encoded one.

Under a mesh (``serve_model(mesh=...)``; the production mesh when the
process group has 256 ranks or more, as the JAX launcher picks it) the
activation rules are installed (``launch/serve.py:34-38`` of the JAX
package) and the parameters, prompts, memory and cache (the K/V rows, the
SSD and xLSTM decode states, the encoded memory) are replicated DTensors:
the JAX launcher places none of them. The results come back as plain
tensors. ``launch.mesh.check_mesh_arch`` refuses a layer kind that no
test holds under a mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor

from repro_torch.checkpoint.ckpt import flatten_with_paths, unflatten
from repro_torch.configs import get_config, smoke_config
from repro_torch.device import resolve_device
from repro_torch.distribution.sharding import (
    NamedSharding,
    PartitionSpec,
    activation_rules,
    distribute,
)
from repro_torch.launch.mesh import check_mesh_arch, make_production_mesh
from repro_torch.models.layers import activation_sharding
from repro_torch.models.lm import Model, build_model
from repro_torch.runtime.steps import build_prefill_step, build_serve_step

__all__ = ["ServeResult", "serve", "serve_model", "parse_args", "main"]


@dataclasses.dataclass
class ServeResult:
    tokens: torch.Tensor          # [B, gen] greedy tokens
    prefill_logits: torch.Tensor  # [B, 1, V] of the prefill step
    prompt_logits: torch.Tensor   # [B, 1, V] of the decode loop at the last prompt token
    all_finite: bool              # every logit of every step was finite
    prefill_s: float              # one prefill step (the second call; the first warms up)
    prompt_s: float               # decoding the prompts through the serve step
    gen_s: float                  # the gen - 1 timed generation steps
    batch: int
    prompt_len: int
    gen: int
    peak_bytes: int | None        # device peak during the serve (CUDA only)

    @property
    def prefill_tok_s(self) -> float:
        return self.batch * self.prompt_len / self.prefill_s

    @property
    def prompt_tok_s(self) -> float:
        return self.batch * self.prompt_len / self.prompt_s

    @property
    def first_token_s(self) -> float:
        """Time to the first generated token: on this path the prompts are
        decoded into the cache one serve step at a time, and the first
        token is the argmax of the last of those steps. The prefill step
        fills no cache; its logits only check the decode loop's."""
        return self.prompt_s

    @property
    def decode_tok_s(self) -> float:
        return self.batch * (self.gen - 1) / self.gen_s if self.gen > 1 else float("nan")

    @property
    def ms_per_step(self) -> float:
        return 1e3 * self.gen_s / (self.gen - 1) if self.gen > 1 else float("nan")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _replicated(tree, mesh):
    """``tree``'s tensors as DTensors replicated over ``mesh``."""
    shards = unflatten(tree, iter([NamedSharding(mesh, PartitionSpec())
                                   for _ in flatten_with_paths(tree)]))
    return distribute(tree, shards)


def _plain(t):
    return t.full_tensor() if isinstance(t, DTensor) else t


def serve_model(model: Model, params, prompts: torch.Tensor, gen: int,
                memory: torch.Tensor | None = None, mesh=None) -> ServeResult:
    """Prefill, then decode ``prompts`` [B, P] into a fresh cache and
    generate ``gen`` tokens greedily; every phase timed on the host clock
    ending in a device sync. ``memory`` is the raw frames or patches
    [B, T, d] of a model that cross-attends: the prefill step takes it as
    it is, the cache takes it encoded (the encoder runs inside the prompt
    decode's time, before its first step). ``mesh`` (a ``DeviceMesh``)
    serves on replicated DTensors under the activation rules."""
    if gen < 1:
        raise ValueError(f"gen must be >= 1, got {gen}")
    if mesh is None:
        return _serve(model, params, prompts, gen, memory, None)
    check_mesh_arch(model.cfg)
    with activation_sharding(activation_rules(mesh)):
        params, prompts, memory = _replicated((params, prompts, memory), mesh)
        return _serve(model, params, prompts, gen, memory, mesh)


def _serve(model: Model, params, prompts, gen: int, memory, mesh) -> ServeResult:
    B, P = prompts.shape
    dev = prompts.device
    prefill = build_prefill_step(model)
    step = build_serve_step(model)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)

    batch = {"tokens": prompts, "memory": memory}
    prefill(params, batch)  # warm-up
    _sync(dev)
    t = time.perf_counter()
    prefill_logits = prefill(params, batch)
    _sync(dev)
    prefill_s = time.perf_counter() - t

    finite = torch.isfinite(prefill_logits).all()
    t = time.perf_counter()
    if memory is not None and model.encode is not None:
        with torch.no_grad():
            memory = model.encode(params, memory)
    cache = model.init_cache(B, P + gen + 1, device=dev, memory=memory)
    if mesh is not None:
        cache = _replicated(cache, mesh)
    for i in range(P):
        logits, cache = step(params, cache, prompts[:, i])
        finite = finite & torch.isfinite(logits).all()
    _sync(dev)
    prompt_s = time.perf_counter() - t
    prompt_logits = logits

    outs = [logits[:, 0].argmax(dim=-1)]
    t = time.perf_counter()
    for _ in range(gen - 1):
        logits, cache = step(params, cache, outs[-1])
        finite = finite & torch.isfinite(logits).all()
        outs.append(logits[:, 0].argmax(dim=-1))
    _sync(dev)
    gen_s = time.perf_counter() - t
    return ServeResult(
        tokens=_plain(torch.stack(outs, dim=1)),
        prefill_logits=_plain(prefill_logits),
        prompt_logits=_plain(prompt_logits),
        all_finite=bool(_plain(finite)),
        prefill_s=prefill_s,
        prompt_s=prompt_s,
        gen_s=gen_s,
        batch=B,
        prompt_len=P,
        gen=gen,
        peak_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None,
    )


def serve(
    arch: str = "llama3.2-3b",
    batch: int = 4,
    prompt: int = 16,
    gen: int = 32,
    smoke: bool = True,
    seed: int = 0,
    device=None,
    mesh=None,
) -> ServeResult:
    """Serve ``batch`` random prompts of ``prompt`` tokens (numpy, from
    ``seed``) with weights drawn from ``seed`` and held in bf16; frames
    or patches first where the model cross-attends. Without ``mesh``, a
    process group of 256 ranks or more serves on the production mesh."""
    dev = resolve_device(device)
    if mesh is None and dist.is_initialized() and dist.get_world_size() >= 256:
        mesh = make_production_mesh(device=dev)
    cfg = smoke_config(arch) if smoke else get_config(arch)
    model = build_model(cfg)
    params = model.init(seed, device=dev, dtype=torch.bfloat16)
    rng = np.random.default_rng(seed)
    memory = None
    if cfg.n_enc_layers or cfg.cross_attn_every:
        T = prompt if cfg.n_enc_layers else 16
        memory = torch.from_numpy(
            rng.standard_normal((batch, T, cfg.d_model)).astype(np.float32)).to(dev)
    prompts = torch.from_numpy(rng.integers(0, cfg.vocab_size, (batch, prompt))).to(dev)
    return serve_model(model, params, prompts, gen, memory=memory, mesh=mesh)


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", type=str, default="llama3.2-3b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=16)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction, default=True,
                    help="reduced config (default); --no-smoke for the published widths")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", type=str, default=None,
                    help="default: the CUDA card; 'cpu' must be asked for")
    return ap.parse_args(argv)


def main(argv: list[str] | None = None) -> ServeResult:
    args = parse_args(argv)
    res = serve(args.arch, args.batch, args.prompt, args.gen, args.smoke,
                args.seed, args.device)
    B, P = res.batch, res.prompt_len
    print(f"prefill {B}x{P} tokens: {res.prefill_s:.4f} s ({res.prefill_tok_s:.1f} tok/s)")
    print(f"decoded {B}x{P} prompt tokens: {res.prompt_s:.4f} s "
          f"({res.prompt_tok_s:.1f} tok/s; the time to the first token)")
    print(f"generated {B}x{res.gen} tokens ({res.decode_tok_s:.1f} tok/s, "
          f"{res.ms_per_step:.3f} ms/step)")
    if res.peak_bytes is not None:
        print(f"peak device memory {res.peak_bytes / 2**30:.2f} GiB")
    print(res.tokens.cpu().numpy())
    return res


if __name__ == "__main__":
    main()
