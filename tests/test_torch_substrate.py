"""Port substrate: the optimizer, gradient utilities, data pipeline and
checkpoints (the cases of ``tests/test_substrate.py`` on the port's
modules), plus the same pipeline batches bit for bit in both packages and
checkpoints that cross between them in both directions."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as j_ckpt
from repro.configs import smoke_config as j_smoke_config
from repro.data.pipeline import DataConfig as JDataConfig
from repro.data.pipeline import make_pipeline as j_make_pipeline
from repro.models.lm import build_model as j_build_model
from repro.optim.adamw import AdamWConfig as JAdamWConfig
from repro.optim.adamw import cosine_schedule as j_cosine_schedule
from repro.runtime.steps import TrainState as JTrainState
from repro.runtime.steps import make_train_state as j_make_train_state
from repro_torch.checkpoint import ckpt
from repro_torch.configs import smoke_config
from repro_torch.data.pipeline import DataConfig, make_pipeline
from repro_torch.interop import train_state_from_arrays, train_state_to_arrays
from repro_torch.models.lm import build_model
from repro_torch.optim.adamw import (
    SLICE_ELEMENTS,
    AdamWConfig,
    adamw_init,
    adamw_update,
    cosine_schedule,
    global_norm,
    tree_leaves,
)
from repro_torch.optim.grad import accumulate_grads, compress_bf16, decompress_bf16
from repro_torch.runtime.steps import TrainState, make_train_state


def test_adamw_converges_quadratic():
    cfg = AdamWConfig(lr_peak=0.1, lr_min=0.01, warmup_steps=5, total_steps=200,
                      weight_decay=0.0, clip_norm=10.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw_init(params)
    for _ in range(150):
        grads = {"w": 2 * params["w"]}
        params, state, _ = adamw_update(cfg, params, grads, state)
    assert float((params["w"] ** 2).sum()) < 1e-2
    assert int(state["step"]) == 150


def test_cosine_schedule_shape():
    cfg = AdamWConfig(lr_peak=1.0, lr_min=0.1, warmup_steps=10, total_steps=100)
    lrs = [float(cosine_schedule(cfg, s)) for s in (0, 5, 10, 55, 100)]
    assert lrs[0] == 0.0
    assert lrs[1] == pytest.approx(0.5)
    assert lrs[2] == pytest.approx(1.0)
    assert 0.1 < lrs[3] < 1.0
    assert lrs[4] == pytest.approx(0.1, abs=1e-6)


def test_cosine_schedule_equals_reference():
    """float32 on both sides: the same numbers within 1e-6 relative at
    every step (PyTorch's and XLA's float32 cos differ in the last bit at
    some arguments; the warmup steps are exact)."""
    cfg = dict(lr_peak=3e-4, lr_min=3e-5, warmup_steps=7, total_steps=50)
    for s in range(0, 60, 3):
        got = float(cosine_schedule(AdamWConfig(**cfg), s))
        want = float(j_cosine_schedule(JAdamWConfig(**cfg), jnp.asarray(s, jnp.int32)))
        assert got == pytest.approx(want, rel=1e-6, abs=0)
        assert s >= 7 or got == want


def test_grad_clipping_applied():
    cfg = AdamWConfig(clip_norm=1e-3, weight_decay=0.0)
    params = {"w": torch.ones(4)}
    state = adamw_init(params)
    before = params["w"].clone()
    p2, _, metrics = adamw_update(cfg, params, {"w": torch.full((4,), 1e6)}, state)
    assert float(metrics["grad_norm"]) == pytest.approx(2e6, rel=1e-3)
    assert float((p2["w"] - before).abs().max()) < 1.0


def test_sliced_update_equals_whole_leaf_update(monkeypatch):
    """A leaf larger than SLICE_ELEMENTS is updated slice by slice along
    its leading axis; the update is elementwise, so the values equal the
    whole-leaf update bit for bit."""
    import repro_torch.optim.adamw as adamw

    rng = np.random.default_rng(0)
    shape = (5, 3, 7)
    p0 = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    g = torch.from_numpy(rng.standard_normal(shape).astype(np.float32))
    cfg = AdamWConfig(warmup_steps=1)
    results = []
    for limit in (SLICE_ELEMENTS, 21, 40):  # whole, one repeat a slice, one a slice
        monkeypatch.setattr(adamw, "SLICE_ELEMENTS", limit)
        params = {"w": p0.clone()}
        state = adamw_init(params)
        for _ in range(2):
            params, state, _ = adamw_update(cfg, params, {"w": g}, state)
        results.append((params["w"], state["m"]["w"], state["v"]["w"]))
    for other in results[1:]:
        assert all(torch.equal(a, b) for a, b in zip(results[0], other))


def test_global_norm_over_a_tree():
    tree = {"a": torch.full((3,), 2.0), "b": (torch.ones(2, 2), None)}
    assert float(global_norm(tree)) == pytest.approx(np.sqrt(12.0 + 4.0))
    assert [t.shape for t in tree_leaves(tree)] == [(3,), (2, 2)]


def test_accumulate_grads_matches_full_batch():
    rng = np.random.default_rng(0)
    w = torch.from_numpy(rng.standard_normal((8, 4)).astype(np.float32)).requires_grad_()
    xs = torch.from_numpy(rng.standard_normal((16, 8)).astype(np.float32))
    ys = torch.from_numpy(rng.standard_normal((16, 4)).astype(np.float32))

    def loss(params, batch):
        return torch.mean((batch["x"] @ params - batch["y"]) ** 2)

    full_loss = loss(w, {"x": xs, "y": ys})
    (full_grad,) = torch.autograd.grad(full_loss, (w,))
    micro = [{"x": xs[i * 4:(i + 1) * 4], "y": ys[i * 4:(i + 1) * 4]} for i in range(4)]
    acc_loss, acc_grad = accumulate_grads(loss, w, micro)
    np.testing.assert_allclose(float(acc_loss), float(full_loss.detach()), rtol=1e-6)
    np.testing.assert_allclose(acc_grad.numpy(), full_grad.numpy(), rtol=1e-5, atol=1e-6)


def test_bf16_compression_error_feedback():
    g = {"w": torch.tensor([1.0 + 1e-4, -2.0 - 3e-4])}
    c1, r1 = compress_bf16(g)
    assert c1["w"].dtype == torch.bfloat16
    # residual keeps exactly what bf16 dropped
    np.testing.assert_allclose((c1["w"].float() + r1["w"]).numpy(), g["w"].numpy(), atol=1e-7)
    # next round re-injects the residual
    c2, _ = compress_bf16(g, r1)
    total = decompress_bf16(c1)["w"] + decompress_bf16(c2)["w"]
    np.testing.assert_allclose(total.numpy(), (2 * g["w"]).numpy(), atol=2e-3)


def test_data_pipeline_deterministic_and_restartable():
    cfg = DataConfig(vocab_size=100, global_batch=8, seq_len=16, seed=3)
    b1 = make_pipeline(cfg).batch_for_step(17)
    b2 = make_pipeline(cfg).batch_for_step(17)  # fresh pipeline, same step => same batch
    np.testing.assert_array_equal(b1["tokens"], b2["tokens"])
    assert b1["tokens"].shape == (8, 16)
    np.testing.assert_array_equal(b1["tokens"][:, 1:], b1["labels"][:, :-1])


def test_data_host_sharding_partitions():
    p = make_pipeline(DataConfig(vocab_size=50, global_batch=8, seq_len=4))
    b = p.batch_for_step(0)
    shards = [p.host_shard(b, h, 4) for h in range(4)]
    np.testing.assert_array_equal(np.concatenate([s["tokens"] for s in shards], axis=0), b["tokens"])


@pytest.mark.parametrize("memory_len,d_model", [(0, 0), (16, 32)])
def test_pipeline_batches_equal_reference_bit_for_bit(memory_len, d_model):
    """The same batches as the JAX package's pipeline at every step, with
    and without the stub memory embeddings."""
    kw = dict(vocab_size=1000, global_batch=4, seq_len=33, seed=5,
              memory_len=memory_len, d_model=d_model)
    mine, ref = make_pipeline(DataConfig(**kw)), j_make_pipeline(JDataConfig(**kw))
    for step in (0, 1, 17, 1 << 12):
        a, b = mine.batch_for_step(step), ref.batch_for_step(step)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k])


def test_checkpoint_roundtrip_and_latest(tmp_path):
    tree = {"a": np.arange(12, dtype=np.float32).reshape(3, 4),
            "b": {"c": np.asarray(7, dtype=np.int32)}}
    d = str(tmp_path / "ck")
    ckpt.save(d, 10, tree)
    restored, step = ckpt.restore(d, {"a": tree["a"] * 0, "b": {"c": tree["b"]["c"] * 0}})
    assert step == 10
    np.testing.assert_array_equal(restored["a"], tree["a"])
    np.testing.assert_array_equal(restored["b"]["c"], tree["b"]["c"])
    ckpt.save(d, 20, {"a": tree["a"] + 1, "b": {"c": tree["b"]["c"] + 1}})
    _, step = ckpt.restore(d, tree)
    assert step == 20 and ckpt.latest_step(d) == 20


def test_checkpoint_multihost_stripes(tmp_path):
    tree = {"a": np.ones((4,)), "b": np.zeros((2,)), "c": np.full((3,), 5.0)}
    d = str(tmp_path / "ck")
    for h in range(2):
        ckpt.save(d, 1, tree, host_id=h, n_hosts=2)
    restored, _ = ckpt.restore(d, {k: np.zeros_like(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_array_equal(restored[k], tree[k])


def test_checkpoint_incomplete_rejected(tmp_path):
    tree = {"a": np.ones((4,)), "b": np.zeros((2,))}
    d = str(tmp_path / "ck")
    ckpt.save(d, 1, tree, host_id=0, n_hosts=2)  # missing shard 1
    with pytest.raises(IOError):
        ckpt.restore(d, tree)


def test_checkpoint_restores_tensors_in_their_type(tmp_path):
    """A tensor leaf comes back as a tensor of the like-tree leaf's type
    (a bf16 tensor through float32, exactly); the restored train state is
    torch.equal to the saved one."""
    model = build_model(smoke_config("qwen1_5_4b"))
    state = make_train_state(model, 3, device="cpu", compress=True)
    state.opt["step"] += 5
    state.params["norm"]["scale"] = state.params["norm"]["scale"].to(torch.bfloat16) * 1.5
    d = str(tmp_path / "ck")
    ckpt.save(d, 5, state)
    like = make_train_state(model, 4, device="cpu", compress=True)
    like.params["norm"]["scale"] = like.params["norm"]["scale"].to(torch.bfloat16)
    got, step = ckpt.restore(d, like)
    assert step == 5 and isinstance(got, TrainState)
    for a, b in zip(tree_leaves([got.params, got.opt, got.residual]),
                    tree_leaves([state.params, state.opt, state.residual])):
        assert a.dtype == b.dtype and torch.equal(a, b)


def _jax_state():
    jm = j_build_model(j_smoke_config("llama3_2_3b"))
    js = j_make_train_state(jm, jax.random.PRNGKey(0), compress=True)
    rng = np.random.default_rng(2)
    bump = lambda a: a + rng.standard_normal(a.shape).astype(np.float32)  # noqa: E731
    return JTrainState(
        params=jax.tree.map(np.asarray, js.params),
        opt={"m": jax.tree.map(lambda a: bump(np.asarray(a)), js.opt["m"]),
             "v": jax.tree.map(lambda a: np.abs(bump(np.asarray(a))), js.opt["v"]),
             "step": np.asarray(9, np.int32)},
        residual=jax.tree.map(lambda a: bump(np.asarray(a)), js.residual),
    )


def test_checkpoints_cross_between_packages(tmp_path):
    """A train state written by the JAX package restores in the port, and
    one written by the port restores in the JAX package: same leaf order
    and paths, every leaf equal; only the treedef string differs."""
    js = _jax_state()
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    j_ckpt.save(jd, 9, js)
    like = make_train_state(build_model(smoke_config("llama3_2_3b")), 1, device="cpu",
                            compress=True)
    got, step = ckpt.restore(jd, like)
    assert step == 9 and int(got.opt["step"]) == 9
    want = train_state_from_arrays(js, device="cpu")
    for a, b in zip(tree_leaves([got.params, got.opt, got.residual]),
                    tree_leaves([want.params, want.opt, want.residual])):
        assert torch.equal(a, b)

    ckpt.save(td, 9, want)
    back, step = j_ckpt.restore(td, jax.tree.map(np.zeros_like, js))
    assert step == 9
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        assert np.array_equal(a, b)
    import json
    import os
    meta = [json.load(open(os.path.join(d, "step_00000009", "meta.json"))) for d in (jd, td)]
    assert meta[0]["paths"] == meta[1]["paths"] and meta[0]["n_leaves"] == meta[1]["n_leaves"]


def test_train_state_interop_round_trip():
    js = _jax_state()
    back = train_state_to_arrays(train_state_from_arrays(js, device="cpu"))
    for a, b in zip(jax.tree.leaves(JTrainState(**back)), jax.tree.leaves(js)):
        assert a.dtype == b.dtype and np.array_equal(a, b)
