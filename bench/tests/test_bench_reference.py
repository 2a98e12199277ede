"""The plain reference against the port at a size the CPU holds, compared
here and not inside the reference: the port in float32 compute gives the
same prefill logits and the same first training steps."""

import dataclasses

import pytest
import torch

from bench.harness import registry, weights
from bench.kinds.train import _model_config
from bench.reference.prefill import last_logits
from bench.reference.train import Trainer
from bench.tests import tiny

SEED = 2**31 + 3


@pytest.fixture(scope="module")
def bench():
    return registry.benchmark()


@pytest.mark.parametrize("cell", ["phi3mini-prefill-mix", "phi35moe-prefill-mix"])
def test_prefill_logits(bench, cell):
    from repro_torch.models.lm import build_model

    m = registry.port_sizes(tiny.config(bench, cell))
    model = build_model(_model_config(m), compute_dtype=torch.float32)
    params = weights.make(m, SEED, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(1)
    prompts = [torch.randint(0, m["vocab_size"], (B, S), generator=gen)
               for B, S in ((3, 40), (1, 128))]
    leaves = {p: weights.make_leaf(m, SEED, i, "cpu", torch.float32)
              for i, (p, _, _) in enumerate(weights.leaf_specs(m))}
    ref = last_logits(m, leaves, prompts)["f32"]
    with torch.no_grad():
        for t, r in zip(prompts, ref):
            got = model.prefill(params, t)[:, -1]
            assert torch.allclose(got, r, rtol=1e-4, atol=1e-4), (got - r).abs().max()


def test_training_steps(bench):
    from repro_torch.models.lm import build_model
    from repro_torch.optim.adamw import AdamWConfig, adamw_init
    from repro_torch.runtime.steps import TrainState, build_train_step

    cell = "phi3mini-train-s4k"
    m = registry.port_sizes(tiny.config(bench, cell))
    t = tiny.traffic(bench, cell)
    model = build_model(_model_config(m), compute_dtype=torch.float32)
    params = weights.make(m, SEED, "cpu", torch.float32)
    state = TrainState(params=params, opt=adamw_init(params))
    opt = dict(t["optimizer"], warmup_steps=2)
    step = build_train_step(model, AdamWConfig(**opt), n_micro=2)
    specs = weights.leaf_specs(m)
    trainer = Trainer(m, specs, lambda j: weights.make_leaf(m, SEED, j, "cpu", torch.float32))
    gen = torch.Generator().manual_seed(2)
    names = {(i, layer): n for n, i, layer in weights.slices(m)}
    for k in range(3):  # warm-up, then the cosine schedule
        toks = torch.randint(0, m["vocab_size"], (2, 33), generator=gen)
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        state, met = step(state, batch)
        loss, gnorms = trainer.train_step(
            [{kk: v[j:j + 1] for kk, v in batch.items()} for j in range(2)], opt)
        assert float(met["loss"]) == pytest.approx(loss, rel=1e-5)
        if k == 0:
            port = weights.slice_norms(m, lambda j: weights.get(state.opt["m"], specs[j][0]))
            for key, v in gnorms.items():
                assert port[names[key]] / (1 - opt["b1"]) == pytest.approx(v, rel=1e-4, abs=1e-7)
    for (i, layer), p in trainer.params.items():
        got = weights.get(state.params, specs[i][0])
        got = got if layer is None else got[layer]
        assert torch.allclose(got, p.detach(), rtol=1e-5, atol=1e-6), names[(i, layer)]
    assert dataclasses.is_dataclass(state)
