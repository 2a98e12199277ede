"""The reference's training: the first steps of the program's training
step, followed from the same weights on the same batches, in plain
PyTorch: the mean next-token cross-entropy over the micro-batches, the
gradients summed over them and divided by their number, then AdamW with
decoupled weight decay, clipping by the global norm, and a linear warm-up
into a cosine schedule. Every layer is recomputed in the backward pass,
so only its input is kept."""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from bench.reference.model import LAYER_LEAVES, F32, layer, matmul, no_tf32, rms_norm, rope_tables

# Positions of one block of the loss's logits.
LOSS_CHUNK = 512


def lr_at(opt: dict, step: int) -> float:
    """The learning rate of step ``step`` (1 at the first update)."""
    if step < opt["warmup_steps"]:
        return opt["lr_peak"] * step / max(opt["warmup_steps"], 1)
    frac = min(max((step - opt["warmup_steps"])
                   / max(opt["total_steps"] - opt["warmup_steps"], 1), 0.0), 1.0)
    return opt["lr_min"] + 0.5 * (opt["lr_peak"] - opt["lr_min"]) * (1 + math.cos(math.pi * frac))


class Trainer:
    """The parameters as one float32 tensor a slice (a layer of a stacked
    leaf, or a whole other leaf), keyed by (leaf index, layer or None)."""

    def __init__(self, m: dict, specs: list, leaf, prec: str = "f32"):
        """``specs``: (path, shape, scale) of each leaf; ``leaf(i)``: leaf
        ``i``'s initial values, made when needed."""
        self.m, self.prec = m, prec
        self.params = {}
        self.paths = {}
        for i, (path, _, _) in enumerate(specs):
            t = leaf(i).to(F32)
            if path[0] == "layers":
                for j, s in enumerate(torch.unbind(t, 0)):
                    self.params[(i, j)] = s.clone().requires_grad_(True)
                self.paths[i] = path[2:]
            else:
                self.params[(i, None)] = t.requires_grad_(True)
                self.paths[i] = path
        self.m1 = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.m2 = {k: torch.zeros_like(p) for k, p in self.params.items()}
        self.step = 0

    def _top(self, path: tuple) -> torch.Tensor:
        i = next(i for i, p in self.paths.items() if p == path)
        return self.params[(i, None)]

    def _layer(self, j: int) -> list:
        return [(LAYER_LEAVES[p], self.params[(i, j)])
                for i, p in self.paths.items() if (i, j) in self.params]

    def loss(self, tokens: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
        m, prec = self.m, self.prec
        eps = m.get("norm_eps", 1e-5)
        S = tokens.shape[1]
        cos, sin = rope_tables(S, m["head_dim"], m["rope_theta"], tokens.device)
        x = self._top(("embed", "table"))[tokens.long()]
        for j in range(m["n_layers"]):
            names, ws = zip(*self._layer(j))

            def run(x, *ws, names=names):
                return layer(x, dict(zip(names, ws)), m, cos, sin, prec)

            x = checkpoint(run, x, *ws, use_reentrant=False)
        h = rms_norm(x, self._top(("norm", "scale")), eps)
        out = self._top(("out", "table"))

        def ce(hc, lc):
            lg = matmul(hc, out.T, prec)
            return (torch.logsumexp(lg, dim=-1) - lg.gather(-1, lc[..., None])[..., 0]).sum()

        total = sum(checkpoint(ce, h[:, c:c + LOSS_CHUNK], labels[:, c:c + LOSS_CHUNK].long(),
                               use_reentrant=False) for c in range(0, S, LOSS_CHUNK))
        return total / labels.numel()

    def train_step(self, micro_batches: list, opt: dict) -> tuple[float, dict]:
        """One step; returns (loss, the norm of each slice's clipped gradient)."""
        no_tf32()
        total = 0.0
        for mb in micro_batches:
            loss = self.loss(mb["tokens"], mb["labels"])
            loss.backward()
            total += float(loss.detach())
        n = len(micro_batches)
        self.step += 1
        with torch.no_grad():
            grads = {k: p.grad.div_(n) for k, p in self.params.items()}
            for p in self.params.values():
                p.grad = None
            norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads.values()))
            scale = min(1.0, opt["clip_norm"] / max(norm, 1e-12))
            lr = lr_at(opt, self.step)
            b1, b2 = opt["b1"], opt["b2"]
            c1, c2 = 1 - b1 ** self.step, 1 - b2 ** self.step
            for k, p in self.params.items():
                g = grads[k].mul_(scale)
                self.m1[k].mul_(b1).add_(g, alpha=1 - b1)
                self.m2[k].mul_(b2).addcmul_(g, g, value=1 - b2)
                upd = (self.m1[k] / c1) / (torch.sqrt(self.m2[k] / c2) + opt["eps"])
                p.sub_(lr * (upd + opt["weight_decay"] * p))
            norms = {k: float(torch.linalg.vector_norm(g)) for k, g in grads.items()}
        return total / n, norms
