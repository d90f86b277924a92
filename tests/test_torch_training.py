"""The port's training substrate (`repro_torch.training`,
`repro_torch.models.losses`, the transformer's `loss_fn`) against the
JAX package's, on the CPU.

Inputs come from numpy seeds; weights are the JAX package's
(`init_params(..., PRNGKey(n))`) carried over by `params_from_numpy`,
on the reduced configs of `tests/test_models_smoke.py`. The port's
attention takes its plain version here (`device="cpu"`), so autograd
differentiates `attention_ref`. Tolerances, each stated at its test:

- AdamW, the schedules, clipping and the global norm: the same float32
  operations in the same order, 1e-6 relative (XLA's and PyTorch's
  `pow` and `sqrt` may differ by an ulp).
- Gradient compression: bit for bit.
- Checkpoints: byte for byte (blobs and manifests).
- The loss and every gradient leaf in float32: 1e-4 of each leaf's own
  scale (sums in other orders; measured 2e-6).
- The train loop over 5 steps in float32: losses within 1e-4.
"""

import hashlib
import json
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.storage as j_storage
import repro.training as j_training
import repro.training.grad_compress as j_gc
import repro.training.train_loop as j_loop
import repro_torch.storage as t_storage
import repro_torch.training as t_training
import repro_torch.training.grad_compress as t_gc
import repro_torch.training.train_loop as t_loop
from repro.configs import get_config as jax_get_config
from repro.models import NULL_RULES
from repro.models import blocks as j_blocks
from repro.models import build_model as jax_build_model
from repro.models import init_params as jax_init_params
from repro.models.losses import chunked_cross_entropy as jax_ce
from repro.models.losses import set_bf16_grad_barrier as jax_barrier
from repro_torch.configs import get_config
from repro_torch.models import build_model, params_from_numpy
from repro_torch.models.common import tree_leaves
from repro_torch.models.convert import tensor_from_numpy
from repro_torch.models.losses import (chunked_cross_entropy,
                                       set_bf16_grad_barrier)


def _np(x):
    return np.asarray(x.float() if x.dtype == torch.bfloat16 else x)


def _tree(rng, bf16=True):
    """A parameter-like tree: matrices (decayed), vectors and a scalar-ish
    leaf (not decayed), bf16 or float32."""
    dt = jnp.bfloat16 if bf16 else jnp.float32
    return {"embed": jnp.asarray(rng.normal(0, 1, (16, 8)), dt),
            "layers": {"w": jnp.asarray(rng.normal(0, 0.2, (2, 8, 8)), dt),
                       "ln": jnp.asarray(rng.normal(1, 0.1, (2, 8)), dt)},
            "bias": jnp.asarray(rng.normal(0, 1, (3,)), jnp.float32)}


def _grads(rng, tree, scale):
    return jax.tree.map(lambda p: jnp.asarray(
        rng.normal(0, scale, p.shape), p.dtype), tree)


def _to_port(tree):
    return jax.tree.map(lambda a: tensor_from_numpy(np.asarray(a), "cpu"),
                        tree)


# ---------------------------------------------------------------- AdamW
@pytest.mark.parametrize("schedule", ["cosine", "linear", "constant"])
def test_schedule_lr_matches_jax(schedule):
    cfg = j_training.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                     total_steps=100, schedule=schedule)
    tcfg = t_training.OptimizerConfig(lr=1e-3, warmup_steps=10,
                                      total_steps=100, schedule=schedule)
    for step in [0, 1, 5, 10, 11, 50, 99, 100, 150]:
        want = float(j_training.schedule_lr(cfg, jnp.int32(step)))
        got = float(t_training.schedule_lr(tcfg, torch.tensor(step)))
        assert got == pytest.approx(want, rel=1e-6), step


@pytest.mark.parametrize("bf16", [True, False])
@pytest.mark.parametrize("grad_scale", [0.01, 10.0])    # clip off / on
def test_adamw_update_matches_jax_over_steps(bf16, grad_scale):
    """Four steps of the reference update on a tree of bf16 (or float32)
    weights: decay only on ndim >= 2, clipping by the global norm when
    it exceeds clip_norm, float32 moments. Moments and float32 weights
    within 1e-5 relative (an ulp or two after four steps); bf16 weights
    within one ulp."""
    rng = np.random.default_rng(0)
    params = _tree(rng, bf16)
    cfg = j_training.OptimizerConfig(lr=1e-2, warmup_steps=2,
                                     total_steps=10, weight_decay=0.1)
    tcfg = t_training.OptimizerConfig(lr=1e-2, warmup_steps=2,
                                      total_steps=10, weight_decay=0.1)
    jstate = j_training.init_opt_state(params)
    tparams = _to_port(params)
    tstate = t_training.init_opt_state(tparams)
    assert tstate["step"].dtype == torch.int32
    for _ in range(4):
        grads = _grads(rng, params, grad_scale)
        want_norm = float(j_training.global_norm(grads))
        got_norm = float(t_training.global_norm(_to_port(grads)))
        assert got_norm == pytest.approx(want_norm, rel=1e-6)
        params, jstate, jm = j_training.adamw_update(params, grads, jstate,
                                                     cfg)
        tparams, tstate, tm = t_training.adamw_update(
            tparams, _to_port(grads), tstate, tcfg)
        assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-6)
        assert float(tm["grad_norm"]) == pytest.approx(
            float(jm["grad_norm"]), rel=1e-6)
    assert int(tstate["step"]) == int(jstate["step"]) == 4
    for name in ("m", "v"):
        for a, b in zip(jax.tree.leaves(jstate[name]),
                        tree_leaves(tstate[name])):
            assert b.dtype == torch.float32
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-5,
                                       atol=1e-12)
    for a, b in zip(jax.tree.leaves(params), tree_leaves(tparams)):
        assert str(b.dtype).removeprefix("torch.") == a.dtype.name
        a32 = np.asarray(a, np.float32)
        ulp = 2**-7 if b.dtype == torch.bfloat16 else 1e-6
        np.testing.assert_allclose(_np(b), a32, rtol=ulp, atol=1e-7)


def test_adamw_without_clipping_or_decay_and_updates_in_place():
    rng = np.random.default_rng(1)
    params = _tree(rng, False)
    cfg = j_training.OptimizerConfig(clip_norm=0.0, weight_decay=0.0)
    tcfg = t_training.OptimizerConfig(clip_norm=0.0, weight_decay=0.0)
    grads = _grads(rng, params, 5.0)
    want, _, _ = j_training.adamw_update(params, grads,
                                         j_training.init_opt_state(params),
                                         cfg)
    tparams = _to_port(params)
    before = tree_leaves(tparams)
    got, _, _ = t_training.adamw_update(tparams, _to_port(grads),
                                        t_training.init_opt_state(tparams),
                                        tcfg)
    assert all(a is b for a, b in zip(before, tree_leaves(got)))
    for a, b in zip(jax.tree.leaves(want), tree_leaves(got)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6)


# ----------------------------------------------------- grad compression
def test_grad_compression_matches_jax_bit_for_bit():
    rng = np.random.default_rng(2)
    params = _tree(rng, True)
    grads = _grads(rng, params, 1.0)
    tg = _to_port(grads)
    for a, b in zip(jax.tree.leaves(j_gc.bf16_compress(grads)),
                    tree_leaves(t_gc.bf16_compress(tg))):
        assert b.dtype == torch.bfloat16
        assert np.array_equal(b.view(torch.int16).numpy(),
                              np.asarray(a).view(np.int16))
    jq, js = j_gc.int8_compress(grads)
    tq, ts = t_gc.int8_compress(tg)
    for a, b in zip(jax.tree.leaves(jq), tree_leaves(tq)):
        assert b.dtype == torch.int8 and np.array_equal(b.numpy(),
                                                        np.asarray(a))
    for a, b in zip(jax.tree.leaves(js), tree_leaves(ts)):
        assert float(b) == float(a)
    for a, b in zip(jax.tree.leaves(j_gc.int8_decompress(jq, js)),
                    tree_leaves(t_gc.int8_decompress(tq, ts))):
        assert np.array_equal(b.numpy(), np.asarray(a))
    jres, tres = j_gc.init_residual(params), t_gc.init_residual(_to_port(
        params))
    for _ in range(3):
        grads = _grads(rng, params, 1.0)
        jd, jres = j_gc.ef_compress_step(grads, jres)
        td, tres = t_gc.ef_compress_step(_to_port(grads), tres)
        for a, b in zip(jax.tree.leaves(jd) + jax.tree.leaves(jres),
                        tree_leaves(td) + tree_leaves(tres)):
            assert b.dtype == torch.float32
            assert np.array_equal(b.numpy(), np.asarray(a))


# ---------------------------------------------------------- checkpoints
def _state(rng):
    params = _tree(rng, True)
    return {"params": params, "opt": j_training.init_opt_state(params)}


def _blobs(store):
    return {n: store.get(n) for n in store.list("")}


def test_checkpoints_are_byte_identical_and_restore_across_packages():
    """The same tree saved by each package: the same blob names and bytes
    (manifest included); each package restores the other's."""
    rng = np.random.default_rng(3)
    state = _state(rng)
    state["opt"]["m"] = _grads(rng, state["params"], 1.0)
    state["opt"]["m"] = jax.tree.map(lambda x: x.astype(jnp.float32),
                                     state["opt"]["m"])
    js, ts = j_storage.InMemoryBlobStore(), t_storage.InMemoryBlobStore()
    j_training.CheckpointManager(js).save(7, state, extra_metadata={"a": 1})
    tstate = _to_port(state)
    t_training.CheckpointManager(ts).save(7, tstate, extra_metadata={"a": 1})
    assert _blobs(ts) == _blobs(js)
    manifest = json.loads(ts.get("ckpt/step-0000000007/MANIFEST.json"))
    assert [e["name"] for e in manifest["leaves"]][:2] == ["opt/m/bias",
                                                          "opt/m/embed"]
    # JAX-written → port
    got, man = t_training.CheckpointManager(js_as_port(js)).restore(tstate)
    assert man["step"] == 7
    for a, b in zip(tree_leaves(tstate), tree_leaves(got)):
        assert b.dtype == a.dtype and torch.equal(b, a)
    # port-written → JAX
    want, _ = j_training.CheckpointManager(ts_as_jax(ts)).restore(state)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(want)):
        assert b.dtype == np.asarray(a).dtype
        assert np.array_equal(np.asarray(b), np.asarray(a))


def js_as_port(store):
    out = t_storage.InMemoryBlobStore()
    for name, data in _blobs(store).items():
        out.put(name, data)
    return out


def ts_as_jax(store):
    out = j_storage.InMemoryBlobStore()
    for name, data in _blobs(store).items():
        out.put(name, data)
    return out


def test_keep_last_k_corruption_and_missing_leaves():
    rng = np.random.default_rng(4)
    tstate = _to_port(_state(rng))
    store = t_storage.InMemoryBlobStore()
    mgr = t_training.CheckpointManager(store, t_training.CheckpointConfig(
        keep_last_k=2))
    with pytest.raises(FileNotFoundError):
        mgr.restore(tstate)
    for step in (1, 2, 3, 4):
        mgr.save(step, tstate)
    assert mgr.all_steps() == [3, 4] and mgr.latest_step() == 4
    blob = "ckpt/step-0000000004/params/embed.npy"
    data = bytearray(store.get(blob))
    data[0] ^= 1
    store.put(blob, bytes(data))
    with pytest.raises(IOError, match="corruption"):
        mgr.restore(tstate)
    restored, _ = mgr.restore(tstate, step=3)
    assert torch.equal(restored["params"]["embed"], tstate["params"]["embed"])
    with pytest.raises(KeyError, match="missing leaves"):
        mgr.restore({**tstate, "extra": torch.zeros(2)}, step=3)
    # a manifest-less step (a crash mid-save) is not a checkpoint
    store.put("ckpt/step-0000000009/params/embed.npy", b"partial")
    assert mgr.latest_step() == 4


def test_async_save_snapshots_before_the_next_update():
    """blocking=False persists on a thread from a snapshot taken on the
    caller's thread: updating the tensors in place right after `save`
    does not reach the checkpoint."""
    rng = np.random.default_rng(5)
    tstate = _to_port(_state(rng))
    want = {n: t.clone() for n, t in zip(range(99), tree_leaves(tstate))}

    class SlowStore(t_storage.InMemoryBlobStore):
        def __init__(self):
            super().__init__()
            self.gate = threading.Event()

        def put(self, name, data):
            self.gate.wait(5)
            super().put(name, data)

    store = SlowStore()
    mgr = t_training.CheckpointManager(store)
    mgr.save(1, tstate, blocking=False)
    for t in tree_leaves(tstate):
        t.add_(1)
    store.gate.set()
    mgr.wait()
    restored, _ = mgr.restore(tstate)
    for i, t in enumerate(tree_leaves(restored)):
        assert torch.equal(t, want[i])


def test_restore_through_simcloud_is_one_round():
    rng = np.random.default_rng(6)
    tstate = _to_port(_state(rng))
    store = t_storage.InMemoryBlobStore()
    mgr = t_training.CheckpointManager(store)
    mgr.save(2, tstate)
    cloud = t_storage.SimCloudStore(store, seed=0)
    restored, _ = mgr.restore(tstate, cloud=cloud)
    for a, b in zip(tree_leaves(tstate), tree_leaves(restored)):
        assert torch.equal(a, b)
    jstore = ts_as_jax(store)
    _, jstats = j_storage.SimCloudStore(jstore, seed=0).fetch_batch(
        [j_storage.RangeRequest(n) for n in jstore.list("ckpt/") if
         not n.endswith("MANIFEST.json")])
    _, tstats = cloud.fetch_batch([t_storage.RangeRequest(n) for n in
                                   store.list("ckpt/")
                                   if not n.endswith("MANIFEST.json")])
    assert tstats.n_requests == jstats.n_requests == len(tree_leaves(tstate))
    assert tstats.bytes_fetched == jstats.bytes_fetched


# ------------------------------------------------------------- the loss
def _ce_inputs(rng, B, S, D, V, dtype):
    x = rng.normal(0, 1, (B, S, D)).astype(np.float32)
    w = rng.normal(0, 0.3, (V, D)).astype(np.float32)
    labels = rng.integers(0, V, (B, S)).astype(np.int32)
    labels[0, : S // 3] = -1
    labels[1, -2:] = -1
    return (jnp.asarray(x, dtype), jnp.asarray(w, dtype),
            jnp.asarray(labels))


@pytest.mark.parametrize("barrier", [False, True])
@pytest.mark.parametrize("S,chunk", [(24, 32), (32, 32), (96, 32)])
def test_chunked_cross_entropy_value_and_grads_match_jax(S, chunk, barrier):
    """The chunked CE and its gradients against `jax.value_and_grad`, at
    S <= chunk and S = n · chunk, with ignored labels. float32 inputs
    without the bf16 barrier (1e-5 relative); bf16 inputs with it, where
    both sides round the logits' gradient to bf16 before the products
    (1e-5 on the loss, 2e-2 of each gradient's scale: products in bf16
    summed in another order)."""
    rng = np.random.default_rng(7)
    dtype = jnp.bfloat16 if barrier else jnp.float32
    x, w, labels = _ce_inputs(rng, 2, S, 16, 50, dtype)
    jax_barrier(barrier)
    set_bf16_grad_barrier(barrier)
    try:
        jl, (jdx, jdw) = jax.value_and_grad(
            lambda x_, w_: jax_ce(x_, labels, w_, NULL_RULES, chunk=chunk),
            argnums=(0, 1))(x, w)
        tx, tw = (tensor_from_numpy(np.asarray(a), "cpu").requires_grad_()
                  for a in (x, w))
        tl = chunked_cross_entropy(tx, torch.from_numpy(np.asarray(labels)),
                                   tw, chunk=chunk)
        tdx, tdw = torch.autograd.grad(tl, (tx, tw))
    finally:
        jax_barrier(False)
        set_bf16_grad_barrier(False)
    assert tl.dtype == torch.float32
    assert float(tl.detach()) == pytest.approx(float(jl), rel=1e-5)
    tol = 2e-2 if barrier else 1e-5
    for g, j in ((tdx, jdx), (tdw, jdw)):
        assert g.dtype == (torch.bfloat16 if barrier else torch.float32)
        j = np.asarray(j, np.float32)
        assert np.abs(_np(g) - j).max() <= tol * np.abs(j).max()


def test_chunked_cross_entropy_refuses_a_ragged_sequence():
    x, w, labels = (torch.zeros(1, 40, 4), torch.zeros(7, 4),
                    torch.zeros(1, 40, dtype=torch.int32))
    with pytest.raises(ValueError, match="multiple"):
        chunked_cross_entropy(x, labels, w, chunk=32)


# sequence length by arch. RWKV-6 at 32: at 64 tokens the reduced
# model's random decays make its float32 gradient ill-conditioned, and
# both packages' float32 gradients stand 4e-4 to 8e-4 of a leaf's scale
# from the same model run in float64 (at 32 tokens, 6e-6 each)
LOSS_ARCHS = {"qwen3-32b": 64, "mixtral-8x22b": 128, "qwen2-vl-72b": 64,
              "rwkv6-3b": 32, "jamba-v0.1-52b": 64}


def _train_batch(cfg, rng, B, S):
    batch = {}
    if cfg.kind == "vlm":
        s_img = S // 4
        ids = np.zeros((B, S, 3), np.int32)
        ids[:, :s_img, 1] = np.arange(s_img) // 4
        ids[:, :s_img, 2] = np.arange(s_img) % 4
        ids[:, s_img:] = (np.arange(S - s_img) + 4)[None, :, None]
        batch["patches"] = rng.normal(0, 1, (B, s_img, cfg.d_model)).astype(
            np.float32)
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S - s_img)).astype(
            np.int32)
        batch["positions"] = ids
    else:
        batch["tokens"] = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
    labels[0, :5] = -1
    batch["labels"] = labels
    return batch


@pytest.mark.parametrize("chunked", [False, True])
@pytest.mark.parametrize("arch", list(LOSS_ARCHS))
def test_loss_fn_and_every_gradient_match_jax(arch, chunked):
    """`loss_fn` and the gradient of every parameter leaf against
    `jax.value_and_grad` in float32: the dense model, the MoE with its
    sliding window (S = 128 past the window of the reduced config), the
    VLM (patches and M-RoPE ids), RWKV-6 (the plain wkv, autograd
    against JAX's autodiff of `wkv_chunked`) and Jamba with its MoE
    slots (the plain fused scan and attention), each with remat (per
    layer; per period for Jamba); 1e-4 of each leaf's scale. `chunked`
    cuts the CE into chunks of 32 (of S / 2 below 64 tokens)."""
    jcfg = jax_get_config(arch, reduced=True)
    tcfg = get_config(arch, reduced=True)
    if chunked:
        chunk = min(32, LOSS_ARCHS[arch] // 2)
        jcfg, tcfg = jcfg.with_(ce_chunk=chunk), tcfg.with_(ce_chunk=chunk)
    assert tcfg.remat != "none"
    jmodel = jax_build_model(jcfg)
    jparams = jax.tree.map(lambda x: x.astype(jnp.float32),
                           jax_init_params(jmodel.param_desc(),
                                           jax.random.PRNGKey(1)))
    batch = _train_batch(jcfg, np.random.default_rng(8), 2, LOSS_ARCHS[arch])
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, NULL_RULES))(
        jparams)
    model = build_model(tcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = model.loss_fn(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    for a, g in zip(jleaves, grads):
        a = np.asarray(a)
        scale = max(float(np.abs(a).max()), 1e-12)
        assert float(np.abs(g.numpy() - a).max()) <= 1e-4 * scale


def _encdec_batch(cfg, rng, B=2, S=24, S_enc=40):
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    labels = toks[:, 1:].copy()
    labels[0, :3] = -1
    return {"frames": rng.normal(0, 1, (B, S_enc, cfg.d_model)).astype(
        np.float32), "tokens": toks[:, :-1], "labels": labels}


def _leaf_errs(jgrads, grads) -> list[float]:
    out = []
    for a, g in zip(jax.tree.leaves(jgrads), grads):
        a = np.asarray(a, np.float32)
        scale = max(float(np.abs(a).max()), 1e-12)
        out.append(float(np.abs(g.float().numpy() - a).max()) / scale)
    return out


def test_encdec_loss_and_gradients_match_jax_in_bf16():
    """The whole encoder-decoder loss (encode with remat, the decoder's
    causal and cross attention, the CE) and every leaf's gradient
    against `jax.value_and_grad`, bf16 weights on both sides (JAX's
    encoder takes only bf16, ROADMAP queue 3): the loss within the bf16
    tolerance, 2e-2 relative, and each leaf's ||g - g_jax|| within 5e-2
    of ||g_jax||, the bound `chip_smoke.py` holds bf16 gradients to
    (GRAD_LEAF_TOL): bf16 roundings at other places (measured 2.9e-2 at
    most; the largest single entry 4.3e-2 of its leaf's scale)."""
    jcfg = jax_get_config("seamless-m4t-medium", reduced=True)
    jmodel = jax_build_model(jcfg)
    jparams = jax_init_params(jmodel.param_desc(), jax.random.PRNGKey(1))
    batch = _encdec_batch(jcfg, np.random.default_rng(3))
    jl, jg = jax.value_and_grad(lambda p: jmodel.loss_fn(
        p, {k: jnp.asarray(v) for k, v in batch.items()}, NULL_RULES))(
        jparams)
    model = build_model(get_config("seamless-m4t-medium", reduced=True))
    assert model.cfg.remat != "none"
    params = params_from_numpy(jax.tree.map(np.asarray, jparams), "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = model.loss_fn(params, {k: torch.from_numpy(v)
                                  for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    assert all(g.dtype == leaf.dtype for g, leaf in zip(grads, leaves))
    assert float(loss.detach()) == pytest.approx(float(jl), rel=2e-2)
    norm_errs = []
    for a, g in zip(jax.tree.leaves(jg), grads):
        a = torch.from_numpy(np.asarray(a, np.float32))
        norm_errs.append(float((g.float() - a).norm() / a.norm()))
    assert max(norm_errs) <= 5e-2


@pytest.mark.parametrize("chunked", [False, True])
def test_encdec_decoder_loss_and_gradients_match_jax_in_float32(chunked):
    """The decoder half of the loss in float32, given JAX's (bf16)
    encoder output as the memory: `decoder_loss` against
    `jax.value_and_grad` of the JAX loss's decoder scan (its
    `_dec_layer` under remat, the final norm, the CE; the encoder's
    layers bf16 and its final norm float32, as in
    `tests/test_torch_models.py`), the loss within
    1e-5 relative and every decoder, embedding and head leaf within 1e-4
    of its scale."""
    from repro.models.common import maybe_remat
    jcfg = jax_get_config("seamless-m4t-medium", reduced=True)
    tcfg = get_config("seamless-m4t-medium", reduced=True)
    if chunked:
        jcfg, tcfg = jcfg.with_(ce_chunk=8), tcfg.with_(ce_chunk=8)
    jmodel = jax_build_model(jcfg)
    jparams = jax_init_params(jmodel.param_desc(), jax.random.PRNGKey(2))
    batch = _encdec_batch(jcfg, np.random.default_rng(4))
    dec = {k: jax.tree.map(lambda x: x.astype(jnp.float32), v)
           for k, v in jparams.items() if k != "enc_layers"}
    memory = jax.jit(lambda p, f: jmodel.encode(p, f, NULL_RULES))(
        dict(dec, enc_layers=jparams["enc_layers"]),
        jnp.asarray(batch["frames"]))          # float32 after ln_enc
    assert memory.dtype == jnp.float32
    del dec["ln_enc"]                          # the decoder's leaves only

    def jloss(p):
        x = jnp.take(p["embed"], jnp.asarray(batch["tokens"]), axis=0)
        positions = jnp.arange(x.shape[1], dtype=jnp.int32)
        cos, sin = j_blocks.rope_cos_sin(positions, jcfg.dh, jcfg.rope_theta)

        def body(carry, lp):
            return jmodel._dec_layer(carry, lp, memory, cos, sin, positions,
                                     NULL_RULES), None
        x, _ = jax.lax.scan(maybe_remat(body, jcfg.remat), x,
                            p["dec_layers"])
        x = j_blocks.rms_norm(x, p["ln_dec"], jcfg.norm_eps)
        return jax_ce(x, jnp.asarray(batch["labels"]), p["lm_head"],
                      NULL_RULES, chunk=jcfg.ce_chunk)

    jl, jg = jax.value_and_grad(jloss)(dec)
    model = build_model(tcfg)
    params = params_from_numpy(jax.tree.map(np.asarray, dec), "cpu")
    leaves = tree_leaves(params)
    for leaf in leaves:
        leaf.requires_grad_(True)
    loss = model.decoder_loss(params, torch.from_numpy(np.array(memory)),
                              {k: torch.from_numpy(batch[k])
                               for k in ("tokens", "labels")})
    grads = torch.autograd.grad(loss, leaves)
    assert float(loss.detach()) == pytest.approx(float(jl), rel=1e-5)
    assert len(jax.tree.leaves(jg)) == len(grads)
    assert max(_leaf_errs(jg, grads)) <= 1e-4


def test_rwkv_hybrid_and_encdec_losses_still_raise():
    """The three losses that once raised are finite float32 scalars on
    seeded weights and batches."""
    from repro_torch.models import init_params
    rng = np.random.default_rng(0)
    for arch in ("rwkv6-3b", "jamba-v0.1-52b", "seamless-m4t-medium"):
        model = build_model(get_config(arch, reduced=True))
        params = init_params(model.param_desc(),
                             torch.Generator().manual_seed(0), "cpu")
        toks = torch.from_numpy(rng.integers(
            0, model.cfg.vocab, (2, 17)).astype(np.int32))
        batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if arch == "seamless-m4t-medium":
            batch["frames"] = torch.from_numpy(rng.normal(0, 1, (
                2, 8, model.cfg.d_model)).astype(np.float32))
        loss = model.loss_fn(params, batch)
        assert loss.shape == () and loss.dtype == torch.float32, arch
        assert torch.isfinite(loss), arch


@pytest.mark.parametrize("arch", ["qwen3-32b", "rwkv6-3b", "jamba-v0.1-52b",
                                  "seamless-m4t-medium"])
def test_remat_checkpoints_only_when_a_gradient_can_reach_the_weights(
        monkeypatch, arch):
    """`models.common.remat`, which all four losses use: with weights that
    need a gradient, one `torch.utils.checkpoint` a layer (a period for
    Jamba, the encoder's and decoder's layers for the encoder-decoder);
    with gradients enabled but no weight needing one, as a server calls
    it, none, and the same loss bit for bit; the encoder-decoder's
    `encode` likewise."""
    from repro_torch.models import common, init_params
    calls = []

    def counted(fn, *args, **kwargs):
        calls.append(fn)
        return torch.utils.checkpoint.checkpoint(fn, *args, **kwargs)
    monkeypatch.setattr(common, "checkpoint", counted)
    cfg = get_config(arch, reduced=True)
    assert cfg.remat != "none"
    model = build_model(cfg)
    params = init_params(model.param_desc(),
                         torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(3)
    toks = torch.from_numpy(rng.integers(0, cfg.vocab, (2, 17))
                            .astype(np.int32))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    want = cfg.n_layers
    if arch == "jamba-v0.1-52b":
        want = cfg.n_layers // cfg.attn_every
    if arch == "seamless-m4t-medium":
        batch["frames"] = torch.from_numpy(rng.normal(0, 1, (
            2, 8, cfg.d_model)).astype(np.float32))
        want = cfg.n_layers + (cfg.n_dec_layers or cfg.n_layers)
        model.encode(params, batch["frames"])
        assert calls == []
    plain = model.loss_fn(params, batch)
    assert calls == []
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    loss = model.loss_fn(params, batch)
    assert len(calls) == want
    assert torch.equal(loss.detach(), plain)


# ------------------------------------------------------- the train loop
class Batches:
    """Seeded numpy batches, the same for both packages."""

    def __init__(self, vocab, B=2, S=32, seed=9):
        self.vocab, self.B, self.S, self.seed = vocab, B, S, seed

    def batch(self, step):
        rng = np.random.default_rng(self.seed * 1000 + step)
        toks = rng.integers(0, self.vocab, (self.B, self.S + 1)).astype(
            np.int32)
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}

    def batches(self, start, n):
        for step in range(start, start + n):
            yield step, self.batch(step)


def _jax_float32_params(cfg, seed=2):
    jmodel = jax_build_model(cfg)
    return jmodel, jax.tree.map(lambda x: x.astype(jnp.float32),
                                jax_init_params(jmodel.param_desc(),
                                                jax.random.PRNGKey(seed)))


def test_run_matches_the_jax_loop_over_five_steps():
    """`run` (eager step, AdamW in place, checkpoints every 2 steps)
    against the JAX loop (jitted step) on the reduced qwen3-32b in
    float32: the loss at every step within 1e-4, the gradient norms
    within 1e-3, the checkpointed steps the same."""
    cfg = jax_get_config("qwen3-32b", reduced=True)
    jmodel, jparams = _jax_float32_params(cfg)
    arrays = jax.tree.map(np.array, jparams)      # the JAX step donates them
    loader = Batches(cfg.vocab)
    opt = dict(lr=1e-3, warmup_steps=2, total_steps=5)
    loop = dict(total_steps=5, checkpoint_every=2, log_every=1,
                async_checkpoint=False)
    jckpt = j_training.CheckpointManager(j_storage.InMemoryBlobStore())
    _, jlog = j_loop.run(jmodel, jparams, loader, jckpt,
                         j_loop.TrainLoopConfig(**loop),
                         j_training.OptimizerConfig(**opt), NULL_RULES)
    model = build_model(get_config("qwen3-32b", reduced=True))
    params = params_from_numpy(arrays, "cpu")
    tckpt = t_training.CheckpointManager(t_storage.InMemoryBlobStore())
    _, tlog = t_loop.run(model, params, loader, tckpt,
                         t_loop.TrainLoopConfig(**loop),
                         t_training.OptimizerConfig(**opt))
    assert tlog.steps == jlog.steps == [1, 2, 3, 4, 5]
    np.testing.assert_allclose(tlog.losses, jlog.losses, rtol=1e-4)
    np.testing.assert_allclose(tlog.grad_norms, jlog.grad_norms, rtol=1e-3)
    assert tckpt.all_steps() == jckpt.all_steps() == [2, 4]
    assert len(tlog.seconds) == 5


def test_kill_and_resume_is_bitwise_on_the_cpu():
    """A run stopped after its checkpoint at step 3 and started again from
    fresh parameters resumes there and ends with the uninterrupted run's
    losses and parameters, bit for bit."""
    cfg = get_config("qwen3-32b", reduced=True)
    model = build_model(cfg)
    loader = Batches(cfg.vocab, seed=4)
    opt = t_training.OptimizerConfig(lr=1e-3, warmup_steps=1, total_steps=6)
    loop = dict(checkpoint_every=3, log_every=1, async_checkpoint=True)

    def fresh(seed):
        from repro_torch.models import init_params
        return init_params(model.param_desc(),
                           torch.Generator().manual_seed(seed), "cpu")

    whole, wlog = t_loop.run(model, fresh(0), loader, None,
                             t_loop.TrainLoopConfig(total_steps=6, **loop),
                             opt)
    store = t_storage.InMemoryBlobStore()
    ckpt = t_training.CheckpointManager(store)
    _, first = t_loop.run(model, fresh(0), loader, ckpt,
                          t_loop.TrainLoopConfig(total_steps=3, **loop), opt)
    state, second = t_loop.run(model, fresh(1), loader, ckpt,
                               t_loop.TrainLoopConfig(total_steps=6, **loop),
                               opt)
    assert second.resumed_from == 3 and second.steps == [4, 5, 6]
    assert first.losses + second.losses == wlog.losses
    for a, b in zip(tree_leaves(whole), tree_leaves(state)):
        assert torch.equal(a, b)
    manifest = json.loads(store.get("ckpt/step-0000000006/MANIFEST.json"))
    entry = next(e for e in manifest["leaves"] if e["name"] ==
                 "params/embed")
    assert hashlib.sha256(store.get(entry["blob"])).hexdigest()[:16] == \
        entry["sha"]
