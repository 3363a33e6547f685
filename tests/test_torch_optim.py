"""The port's training substrates against the reference: AdamW
(``repro_torch.optim.adamw``), gradient compression
(``repro_torch.core.grad_compress``), ``SyntheticLM`` and
``uci_style_suite`` (``repro_torch.data.pipeline``), checkpoints
(``repro_torch.checkpoint.ckpt``, restored across the two packages), and
the ``Trainer`` (``repro_torch.runtime.trainer``) on
tests/test_system.py's TINY model.

Tolerances: AdamW's f32 leaves and moments within 1e-6 (relative and
absolute) over 20 steps, its bf16 leaves within one bf16 ulp; the
learning rate within 1e-6 (a few f32 ulps: the two packages' cosines); codebooks within 1e-5 and the assignment
indices equal; checkpoints bit for bit; the TINY Trainer's losses within
1e-4 of the reference Trainer's over 25 steps; crash and resume within the
reference's 1e-5; the straggler median within one 16-bit quantum of the
reference's (bit for bit under the exact power-of-two scale, see
tests/_torch_ref.py).
"""

import dataclasses
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import _auto_scale_exact, ref_init_params
from repro.checkpoint import ckpt as ckpt_ref
from repro.core import bitserial as bitserial_ref
from repro.core import quantizer as quantizer_ref
from repro.core import grad_compress as gc_ref
from repro.data import pipeline as pipe_ref
from repro.models import transformer as tfm_ref
from repro.models.config import ModelConfig
from repro.optim import adamw as adamw_ref
from repro.runtime.trainer import Trainer as TrainerRef
from repro.runtime.trainer import TrainerConfig as TrainerConfigRef
from repro_torch import bridge
from repro_torch.checkpoint import ckpt
from repro_torch.core import bitserial, grad_compress as gc, quantizer
from repro_torch.core import tree
from repro_torch.data import pipeline as pipe
from repro_torch.launch import steps
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.optim import adamw
from repro_torch.runtime.trainer import Trainer, TrainerConfig

T = torch.from_numpy
_TINY = dict(name="tiny", family="dense", n_layers=2, d_model=64, n_heads=4,
             n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
             pad_vocab_multiple=16, dtype="float32")
TINY, TINY_T = ModelConfig(**_TINY), ModelConfigT(**_TINY)


def _bf16_np(t):
    return t.float().numpy()


# ---------------------------------------------------------------------------
# AdamW
# ---------------------------------------------------------------------------


def _opt_tree(rng):
    """A tree with f32 and bf16 leaves (and a 0-d one), numpy f32."""
    w = rng.normal(size=(8, 16)).astype(np.float32)
    b = [rng.normal(size=(16,)).astype(np.float32), np.float32(rng.normal())]
    # keys in sorted order: tree.leaves and jax.tree.leaves then agree
    return {"b": b, "h": rng.normal(size=(4, 4, 3)).astype(np.float32),
            "w": w}


BF16_KEYS = ("h",)


def test_adamw_update_matches_over_20_steps():
    """20 updates of a tree with f32 and bf16 leaves, large gradients
    (clipped) and small ones, against the reference's: parameters, both
    moments, the step, the learning rate and the gradient norm."""
    cfg = adamw_ref.AdamWConfig(lr=1e-2, warmup_steps=5, total_steps=30,
                                clip_norm=1.0, weight_decay=0.1)
    cfg_t = adamw.AdamWConfig(**dataclasses.asdict(cfg))
    rng = np.random.default_rng(0)
    p0 = _opt_tree(rng)
    pj = {k: (jnp.asarray(v, jnp.bfloat16) if k in BF16_KEYS
              else jax.tree.map(jnp.asarray, v)) for k, v in p0.items()}
    # the port writes its parameters in place, and jnp.asarray may alias
    # an aligned numpy buffer on the CPU: the port gets copies, so its
    # write cannot reach the reference's inputs while its jit still runs
    pt = {k: (T(v).to(torch.bfloat16) if k in BF16_KEYS
              else tree.map_(lambda a: torch.tensor(a), v))
          for k, v in p0.items()}
    sj, st = adamw_ref.init(pj), adamw.init(pt)
    upd = jax.jit(lambda g, s, p: adamw_ref.update(g, s, p, cfg))
    for i in range(20):
        scale = 10.0 if i % 3 == 0 else 0.01
        g = jax.tree.map(lambda a: (rng.normal(size=np.shape(a)) * scale
                                    ).astype(np.float32), p0)
        gj = {k: (jnp.asarray(v, jnp.bfloat16) if k in BF16_KEYS
                  else jax.tree.map(jnp.asarray, v)) for k, v in g.items()}
        gt = {k: (T(v).to(torch.bfloat16) if k in BF16_KEYS
                  else tree.map_(lambda a: torch.as_tensor(a), v))
              for k, v in g.items()}
        pj, sj, mj = upd(gj, sj, pj)
        pt, st, mt = adamw.update(gt, st, pt, cfg_t)
        assert int(st.step) == int(sj.step) == i + 1
        np.testing.assert_allclose(float(mt["lr"]), float(mj["lr"]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(float(mt["grad_norm"]),
                                   float(mj["grad_norm"]), rtol=1e-6)
        for a, b in zip(jax.tree.leaves(sj.m) + jax.tree.leaves(sj.v),
                        tree.leaves(st.m) + tree.leaves(st.v)):
            np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-6,
                                       atol=1e-6)
        for k in p0:
            for a, b in zip(jax.tree.leaves(pj[k]), tree.leaves(pt[k])):
                assert b.dtype == (torch.bfloat16 if k in BF16_KEYS
                                   else torch.float32)
                want = np.asarray(a, np.float32)
                if k in BF16_KEYS:      # one bf16 ulp: 2^-7 of the value
                    np.testing.assert_allclose(_bf16_np(b), want,
                                               rtol=2 ** -7, atol=0)
                else:
                    np.testing.assert_allclose(b.numpy(), want, rtol=1e-6,
                                               atol=1e-6)


def test_opt_state_bridge_round_trip():
    """The reference's AdamW state after one update of TINY's parameters
    crosses to the port (f32 moments in the port's layout, a 0-d int32
    step) and back bit for bit."""
    p0 = ref_init_params(TINY)
    rng = np.random.default_rng(6)
    g = jax.tree.map(lambda a: jnp.asarray(
        rng.normal(size=a.shape).astype(np.float32)), p0)
    cfg = adamw_ref.AdamWConfig()
    _, state, _ = jax.jit(lambda g, s, p: adamw_ref.update(g, s, p, cfg))(
        g, adamw_ref.init(p0), p0)
    state = jax.tree.map(np.asarray, tuple(state))
    st = bridge.opt_state_from_numpy(state, TINY_T, "cpu")
    assert isinstance(st, adamw.OptState)
    assert st.step.dtype == torch.int32 and int(st.step) == 1
    assert all(t.dtype == torch.float32 for t in tree.leaves(st.m))
    back = bridge.opt_state_to_numpy(st, TINY_T)
    for want, got in zip(state, back):
        a = jax.tree_util.tree_flatten_with_path(want)[0]
        b = dict(jax.tree_util.tree_flatten_with_path(got)[0])
        assert len(a) == len(b)
        for kp, x in a:
            assert b[kp].dtype == x.dtype and np.array_equal(b[kp], x), kp


def test_schedule_and_clip_match():
    """``schedule`` over warmup, decay and past the end, and
    ``clip_by_global_norm`` (the reference's substrate test's numbers)."""
    cfg = adamw_ref.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    cfg_t = adamw.AdamWConfig(lr=1.0, warmup_steps=10, total_steps=100)
    for s in range(0, 120, 7):
        np.testing.assert_allclose(
            float(adamw.schedule(cfg_t, torch.tensor(s))),
            float(adamw_ref.schedule(cfg, jnp.int32(s))), rtol=1e-6, atol=0)
    assert float(adamw.schedule(cfg_t, torch.tensor(0))) == 0.0
    assert float(adamw.schedule(cfg_t, torch.tensor(10))) == pytest.approx(1.0)
    g = {"v": [torch.ones(3, 2)], "w": torch.full((4,), 100.0)}
    clipped, norm = adamw.clip_by_global_norm(g, 1.0)
    cj, nj = adamw_ref.clip_by_global_norm(
        {"v": [jnp.ones((3, 2))], "w": jnp.full((4,), 100.0)}, 1.0)
    np.testing.assert_allclose(float(norm), float(nj), rtol=1e-7)
    for a, b in zip(jax.tree.leaves(cj), tree.leaves(clipped)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=1e-7)
    assert float(torch.linalg.norm(torch.cat(
        [x.reshape(-1) for x in tree.leaves(clipped)]))) == pytest.approx(1.0)


def test_adamw_quadratic_convergence():
    """The reference's substrate test on the port: 150 steps of AdamW
    drive sum(w^2) to w ~ 0."""
    cfg = adamw.AdamWConfig(lr=0.1, warmup_steps=0, total_steps=200,
                            weight_decay=0.0)
    params = {"w": torch.tensor([5.0, -3.0])}
    state = adamw.init(params)
    for _ in range(150):
        params, state, _ = adamw.update({"w": 2 * params["w"]}, state,
                                        params, cfg)
    assert float(params["w"].abs().max()) < 0.1


# ---------------------------------------------------------------------------
# Gradient compression
# ---------------------------------------------------------------------------


def test_grad_compress_codebook_and_indices_match(monkeypatch):
    """The 1-D codebook fit within 1e-5 of the reference's, and the
    chunked assignment (chunks of 37 elements here) equal to the
    reference's (n, k) argmin on the same codebook, index for index;
    ties go to the lower index."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=(64, 64)).astype(np.float32)
    cfg = gc.CompressConfig(k=16, iters=12)
    cfg_r = gc_ref.CompressConfig(k=16, iters=12)
    idx_r, cents_r = jax.jit(lambda x: gc_ref.quantize_tensor(x, cfg_r))(g)
    cents = gc._fit_codebook_1d(T(g).reshape(-1), 16, 12, 4096)
    np.testing.assert_allclose(cents.numpy(), np.asarray(cents_r),
                               rtol=1e-5, atol=1e-5)
    monkeypatch.setattr(gc, "ARGMIN_CHUNK", 37)
    got = gc._nearest(T(g).reshape(-1), T(np.array(cents_r)))
    np.testing.assert_array_equal(got.reshape(64, 64).numpy(),
                                  np.asarray(idx_r))
    # ties: 0.5 is as far from 0 as from 1, and goes to entry 0
    tie = gc._nearest(torch.tensor([0.5, -2.0, 1.5]),
                      torch.tensor([0.0, 1.0, 2.0]))
    assert tie.tolist() == [0, 0, 1]
    idx, cents_t = gc.quantize_tensor(T(g), cfg)
    assert idx.dtype == torch.uint8 and idx.shape == (64, 64)
    np.testing.assert_array_equal(
        gc.dequantize_tensor(idx, cents_t).numpy(),
        cents_t.numpy()[idx.numpy().astype(np.int64)])


def test_grad_compress_roundtrip_error_small():
    """tests/test_substrates.py's bound on the port."""
    g = T(np.random.default_rng(0).normal(size=(64, 64)).astype(np.float32))
    g_hat, err = gc.compress_decompress(g, gc.CompressConfig(k=16, iters=12))
    assert float(err.norm() / g.norm()) < 0.25
    np.testing.assert_allclose((g_hat + err).numpy(), g.numpy(), atol=1e-6)


def test_grad_compress_error_feedback_reduces_bias():
    """tests/test_substrates.py's error-feedback test on the port, and
    each round equal to the reference's ``apply_ef`` within 1e-5."""
    rng = np.random.default_rng(1)
    cfg = gc.CompressConfig(k=4, iters=8)
    cfg_r = gc_ref.CompressConfig(k=4, iters=8)
    g = rng.normal(size=(32, 64)).astype(np.float32)
    grads, grads_r = {"w": T(g)}, {"w": jnp.asarray(g)}
    ef, ef_r = gc.init_ef(grads), gc_ref.init_ef(grads_r)
    ef_step = jax.jit(lambda gr, e: gc_ref.apply_ef(gr, e, cfg_r))
    acc_plain = torch.zeros_like(grads["w"])
    acc_ef = torch.zeros_like(grads["w"])
    for _ in range(20):
        gh, _ = gc.compress_decompress(grads["w"], cfg)
        acc_plain += gh
        ghe, ef = gc.apply_ef(grads, ef, cfg)
        ghe_r, ef_r = ef_step(grads_r, ef_r)
        np.testing.assert_allclose(ghe["w"].numpy(), np.asarray(ghe_r["w"]),
                                   rtol=1e-5, atol=1e-5)
        acc_ef += ghe["w"]
    bias_plain = float(torch.linalg.norm(acc_plain / 20 - grads["w"]))
    bias_ef = float(torch.linalg.norm(acc_ef / 20 - grads["w"]))
    assert bias_ef < bias_plain * 0.5, (bias_ef, bias_plain)


def test_grad_compress_transform_and_wire_bytes():
    """``make_grad_transform`` leaves small tensors alone and keeps
    dtypes, on a tree and on one tensor; ``wire_bytes`` equals the
    reference's; with ``axis_name="pod"`` (the cross-pod reduction's
    axis) the transform of a tree equals the reference's."""
    tree_t = {"w": torch.zeros((1024, 64)), "s": [torch.ones(10)]}
    r = gc.wire_bytes(tree_t, gc.CompressConfig())
    r_ref = gc_ref.wire_bytes({"w": jnp.zeros((1024, 64)),
                               "s": [jnp.ones(10)]},
                              gc_ref.CompressConfig())
    assert r == r_ref and r["ratio"] > 7.0
    tf = gc.make_grad_transform(gc.CompressConfig())
    g = T(np.random.default_rng(2).normal(size=(40, 40)).astype(np.float32))
    out = tf({"a": g.to(torch.bfloat16), "b": torch.ones(5)})
    assert out["a"].dtype == torch.bfloat16
    assert torch.equal(out["b"], torch.ones(5))
    assert len(torch.unique(tf(g))) <= 16
    rng = np.random.default_rng(3)
    tree = {"w": rng.normal(size=(64, 48)).astype(np.float32),
            "s": rng.normal(size=(10,)).astype(np.float32)}
    got = gc.make_grad_transform(gc.CompressConfig(), axis_name="pod")(
        {k: T(v) for k, v in tree.items()})
    want = gc_ref.make_grad_transform(gc_ref.CompressConfig(),
                                      axis_name="pod")(
        {k: jnp.asarray(v) for k, v in tree.items()})
    for k in tree:
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-6, atol=1e-6, err_msg=k)


# ---------------------------------------------------------------------------
# Data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", [None, "internvl2-76b",
                                  "seamless-m4t-medium"])
def test_synthetic_lm_matches(arch):
    """``SyntheticLM``'s batches (tokens, labels, frontend / encoder
    embeddings) equal the reference's at several steps, hosts partition
    the global batch, labels are the tokens shifted."""
    from repro import configs
    from repro_torch import configs as configs_t

    cfg, cfg_t = ((TINY, TINY_T) if arch is None
                  else (configs.get_reduced(arch),
                        configs_t.get_reduced(arch)))
    dc = dict(seed=1, global_batch=4, seq_len=32)
    for step in (0, 5, 17):
        b = pipe_ref.SyntheticLM(cfg, pipe_ref.DataConfig(**dc)).batch_at(
            step)
        bt = pipe.SyntheticLM(cfg_t, pipe.DataConfig(**dc)).batch_at(step)
        assert b.keys() == bt.keys()
        for k in b:
            assert bt[k].dtype == b[k].dtype
            np.testing.assert_array_equal(bt[k], b[k], err_msg=k)
    np.testing.assert_array_equal(bt["tokens"][:, 1:], bt["labels"][:, :-1])
    halves = [pipe.SyntheticLM(cfg_t, pipe.DataConfig(
        **dc, host_id=h, n_hosts=2)).batch_at(17)["tokens"] for h in (0, 1)]
    np.testing.assert_array_equal(np.concatenate(halves), bt["tokens"])


def test_uci_style_suite_matches():
    a, b = pipe_ref.uci_style_suite(3), pipe.uci_style_suite(3)
    assert list(a) == list(b)
    for name in a:
        for x, y in zip(a[name], b[name]):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(y, x, err_msg=name)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def _ckpt_tree():
    """A tree with f32, bf16 and int32 leaves, lists and an OptState."""
    rng = np.random.default_rng(4)
    f = lambda *s: torch.from_numpy(  # noqa: E731
        rng.normal(size=s).astype(np.float32))
    # keys in sorted order: tree.leaves and jax.tree.leaves then agree
    params = {"a": f(4, 5), "b": [f(3), f(2, 2).to(torch.bfloat16)]}
    opt = adamw.OptState(tree.map_(lambda t: t.float() * 2, params),
                         tree.map_(lambda t: t.float() ** 2, params),
                         torch.tensor(7, dtype=torch.int32))
    return {"opt": opt, "params": params}


def _as_jax(t):
    return jax.tree.map(
        lambda x: (jnp.asarray(x.float().numpy(), jnp.bfloat16)
                   if x.dtype == torch.bfloat16 else jnp.asarray(x.numpy())),
        t, is_leaf=torch.is_tensor)


def _bits_equal(a, b):
    """numpy / jax leaf a and tensor b: equal dtypes and bits."""
    a = np.asarray(a)
    if b.dtype == torch.bfloat16:
        assert a.dtype.name == "bfloat16"
        return np.array_equal(a.view(np.uint16),
                              b.view(torch.int16).numpy().view(np.uint16))
    return a.dtype == b.numpy().dtype and np.array_equal(a, b.numpy())


def test_ckpt_roundtrip_prune_and_uncommitted(tmp_path):
    """Round trip at two steps, ``latest_step``, a step directory with no
    DONE marker ignored, ``prune`` keeping the newest."""
    d = str(tmp_path)
    t = _ckpt_tree()
    ckpt.save(d, 3, t)
    ckpt.save(d, 7, tree.map_(lambda x: x * 2, t))
    assert ckpt.latest_step(d) == 7
    back, step = ckpt.restore(d, t)
    assert step == 7
    for a, b in zip(tree.leaves(back), tree.leaves(t)):
        assert a.dtype == b.dtype and torch.equal(a, b * 2)
    assert isinstance(back["opt"], adamw.OptState)
    os.makedirs(os.path.join(d, "step_00000009"))     # crash mid-save
    assert ckpt.latest_step(d) == 7
    th = ckpt.save(d, 8, t, blocking=False)
    th.join()
    assert ckpt.latest_step(d) == 8
    # leaves that make their host copy when called (bridge.params_to_host)
    for blocking, s in ((True, 11), (False, 12)):
        th = ckpt.save(d, s, tree.map_(lambda x: (lambda x=x: x * 3), t),
                       blocking=blocking)
        if th is not None:
            th.join()
        back, _ = ckpt.restore(d, t, step=s)
        for a, b in zip(tree.leaves(back), tree.leaves(t)):
            assert a.dtype == b.dtype and torch.equal(a, b * 3)
    for s in (11, 12):
        shutil.rmtree(os.path.join(d, f"step_{s:08d}"))
    ckpt.prune(d, keep=2)
    assert sorted(x for x in os.listdir(d) if x.endswith("7")
                  or x.endswith("8") or x.endswith("3")) == [
        "step_00000007", "step_00000008"]


def test_ckpt_cross_restore(tmp_path):
    """A port checkpoint restores in ``repro.checkpoint.ckpt``, and a
    reference checkpoint in the port's, bit for bit, with the same keys
    and dtypes in meta.json."""
    t = _ckpt_tree()
    tj = {"params": _as_jax(t["params"]),
          "opt": adamw_ref.OptState(*_as_jax(tuple(t["opt"])))}
    ckpt.save(str(tmp_path / "port"), 5, t)
    back_j, step = ckpt_ref.restore(str(tmp_path / "port"), tj)
    assert step == 5
    for a, b in zip(jax.tree.leaves(back_j), tree.leaves(t)):
        assert _bits_equal(a, b)
    ckpt_ref.save(str(tmp_path / "ref"), 6, tj)
    back_t, step = ckpt.restore(str(tmp_path / "ref"), t)
    assert step == 6
    for a, b in zip(jax.tree.leaves(tj), tree.leaves(back_t)):
        assert _bits_equal(a, b)
    metas = [open(tmp_path / w / f"step_0000000{s}" / "meta.json").read()
             for w, s in (("port", 5), ("ref", 6))]
    assert metas[0].replace('"step": 5', "") == metas[1].replace(
        '"step": 6', "")


# ---------------------------------------------------------------------------
# Trainer (tests/test_system.py's TINY)
# ---------------------------------------------------------------------------


def _aw(n_steps):
    return dict(lr=1e-2, warmup_steps=5, total_steps=n_steps,
                weight_decay=0.01)


def _ref_trainer(tmpdir, n_steps, fail_at=None):
    """tests/test_system.py's make_pieces."""
    data = pipe_ref.SyntheticLM(TINY, pipe_ref.DataConfig(
        seed=7, global_batch=8, seq_len=32))
    aw = adamw_ref.AdamWConfig(**_aw(n_steps))

    @jax.jit
    def step_fn(params, opt_state, batch):
        b = {k: jnp.asarray(v) for k, v in batch.items()}
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: tfm_ref.train_loss(p, TINY, b, remat=False),
            has_aux=True)(params)
        params, opt_state, om = adamw_ref.update(grads, opt_state, params,
                                                 aw)
        return params, opt_state, dict(metrics, loss=loss, **om)

    return TrainerRef(TINY, TrainerConfigRef(
        n_steps=n_steps, ckpt_dir=str(tmpdir), ckpt_every=10, log_every=100,
        fail_at_step=fail_at), aw, step_fn, data)


def _port_trainer(tmpdir, n_steps, fail_at=None):
    data = pipe.SyntheticLM(TINY_T, pipe.DataConfig(seed=7, global_batch=8,
                                                    seq_len=32))
    aw = adamw.AdamWConfig(**_aw(n_steps))
    p0 = jax.tree.map(np.asarray, ref_init_params(TINY))
    return Trainer(TINY_T, TrainerConfig(
        n_steps=n_steps, ckpt_dir=str(tmpdir), ckpt_every=10, log_every=100,
        fail_at_step=fail_at), aw,
        steps.make_train_step(TINY_T, aw, steps.StepOptions(remat=False)),
        data, init_params_fn=lambda: bridge.params_from_numpy(p0, TINY_T,
                                                              "cpu"),
        device="cpu")


def _params_close(ref_params, port_params, tol):
    got = bridge.params_to_numpy(port_params, TINY_T)
    for kp, a in jax.tree_util.tree_flatten_with_path(ref_params)[0]:
        b = dict(jax.tree_util.tree_flatten_with_path(got)[0])[kp]
        np.testing.assert_allclose(b, np.asarray(a), rtol=tol, atol=tol,
                                   err_msg=jax.tree_util.keystr(kp))


def test_trainer_matches_reference_and_resumes(tmp_path):
    """25 steps of the TINY Trainer: the losses within 1e-4 of the
    reference Trainer's (which start from the same parameters and read
    the same batches), and the loss falls as tests/test_system.py asks.
    A port run that crashes at step 17 and resumes from its step-10
    checkpoint ends within 1e-5 of the uninterrupted run; so does a port
    run that resumes from the reference's crashed run's checkpoint (the
    cross-package restore), against the reference's uninterrupted run."""
    ref = _ref_trainer(tmp_path / "ref", 25)
    p_ref, _ = ref.run()
    clean = _port_trainer(tmp_path / "clean", 25)
    p_clean, _ = clean.run()
    np.testing.assert_allclose(clean.losses, ref.losses, rtol=1e-4,
                               atol=1e-4)
    assert np.mean(clean.losses[-5:]) < np.mean(clean.losses[:5]) - 0.2
    _params_close(p_ref, p_clean, 1e-3)
    with pytest.raises(RuntimeError, match="injected failure"):
        _port_trainer(tmp_path / "crash", 25, fail_at=17).run()
    assert ckpt.latest_step(str(tmp_path / "crash")) == 10
    resumed = _port_trainer(tmp_path / "crash", 25)
    p_res, _ = resumed.run()
    assert len(resumed.losses) == 15
    for a, b in zip(tree.leaves(p_clean), tree.leaves(p_res)):
        np.testing.assert_allclose(b.detach().numpy(), a.detach().numpy(),
                                   rtol=1e-5, atol=1e-5)
    with pytest.raises(RuntimeError, match="injected failure"):
        _ref_trainer(tmp_path / "ref_crash", 25, fail_at=17).run()
    cross = _port_trainer(tmp_path / "ref_crash", 25)
    p_cross, _ = cross.run()
    _params_close(p_ref, p_cross, 1e-3)
    np.testing.assert_allclose(cross.losses, ref.losses[10:], rtol=1e-4,
                               atol=1e-4)


def test_straggler_median_matches(monkeypatch):
    """The Trainer's median and MAD of step times (16 bits) against the
    reference's: within one 16-bit quantum of the reference's as it runs
    (its scale takes jnp.exp2, ROADMAP Queue C 1), and bit for bit under
    the exact power of two (tests/_torch_ref.py); the median is the lower
    median of the times within a quantum."""
    rng = np.random.default_rng(5)
    cases = []
    for n in (8, 23, 64):
        times = (0.05 + 0.01 * rng.random(n)).astype(np.float32)[:, None]
        tt = T(times)
        med = bitserial.median(tt, bits=16)[0]
        mad = bitserial.median(torch.abs(tt - med), bits=16)[0]
        q = 1.0 / float(quantizer.auto_scale(tt.reshape(n, 1), 16)[0])
        cases.append((times, float(med), float(mad), q))
    for exact in (False, True):
        if exact:
            monkeypatch.setattr(quantizer_ref, "auto_scale",
                                _auto_scale_exact)
        for times, med, mad, q in cases:
            med_r = bitserial_ref.median(jnp.asarray(times), bits=16)[0]
            mad_r = bitserial_ref.median(
                jnp.abs(jnp.asarray(times) - med_r), bits=16)[0]
            if exact:
                assert (med, mad) == (float(med_r), float(mad_r))
            else:
                assert abs(med - float(med_r)) <= q
                assert abs(mad - float(mad_r)) <= q
            lower = float(np.sort(times[:, 0])[(len(times) - 1) // 2])
            assert abs(med - lower) <= q


# ---------------------------------------------------------------------------
# Steps and entry points
# ---------------------------------------------------------------------------


def test_accum_grads_matches_reference():
    """``make_train_step`` with 2 microbatches (f32 gradient sums, the
    last microbatch's metrics, the mean loss) against the reference's on
    TINY: the loss and every metric within 1e-5, the updated parameters
    within 1e-5 but for at most 0.1 % of them, within 2 lr: AdamW's first
    step moves an element by lr g / (|g| + eps), so where |g| is near eps
    the two packages' roundings of g move it differently."""
    from repro.launch import steps as steps_ref

    p0 = jax.tree.map(np.asarray, ref_init_params(TINY))
    batch = pipe.SyntheticLM(TINY_T, pipe.DataConfig(
        seed=3, global_batch=4, seq_len=16)).batch_at(0)
    aw = dict(lr=1e-2, warmup_steps=0, total_steps=10)
    step_r = jax.jit(steps_ref.make_train_step(
        TINY, adamw_ref.AdamWConfig(**aw),
        steps_ref.StepOptions(microbatch=2, remat=False, loss_chunk=8)))
    pr, _, mr = step_r(p0, adamw_ref.init(p0),
                       {k: jnp.asarray(v) for k, v in batch.items()})
    pt = bridge.params_from_numpy(p0, TINY_T, "cpu")
    step_t = steps.make_train_step(
        TINY_T, adamw.AdamWConfig(**aw),
        steps.StepOptions(microbatch=2, remat=False, loss_chunk=8))
    pt, st, mt = step_t(pt, adamw.init(pt), batch)
    assert int(st.step) == 1 and set(mt) == set(mr)
    for k in mr:
        np.testing.assert_allclose(float(mt[k]), float(mr[k]), rtol=1e-5,
                                   atol=1e-5, err_msg=k)
    got = dict(jax.tree_util.tree_flatten_with_path(
        bridge.params_to_numpy(pt, TINY_T))[0])
    off = total = 0
    for kp, a in jax.tree_util.tree_flatten_with_path(pr)[0]:
        d = np.abs(got[kp] - np.asarray(a))
        assert d.max() <= 2 * aw["lr"], jax.tree_util.keystr(kp)
        off += int((d > 1e-5).sum())
        total += d.size
    assert off <= 1e-3 * total, (off, total)


def test_param_counts_match():
    """``param_count`` (on the meta device, MTP included) and
    ``active_param_count`` equal the reference's at full width."""
    from repro import configs
    from repro.launch import steps as steps_ref
    from repro_torch import configs as configs_t

    assert steps.param_count(configs_t.get_config("qwen3-4b")) \
        == 4_022_468_096
    for arch in ("qwen3-4b", "qwen2-moe-a2.7b", "deepseek-v3-671b"):
        cfg, cfg_t = configs.get_config(arch), configs_t.get_config(arch)
        assert steps.param_count(cfg_t) == steps_ref.param_count(cfg), arch
        assert steps.active_param_count(cfg_t) \
            == steps_ref.active_param_count(cfg), arch


def test_train_entry_points_on_cpu(tmp_path, capsys, monkeypatch):
    """``python -m repro_torch.launch.train`` on the CPU trains the reduced
    qwen3 and checkpoints its last step; ``--mesh pod`` with no world of
    256 ranks fails naming them; ``examples/train_lm_torch.py`` prints
    its twin's lines."""
    import runpy
    import sys

    from repro_torch.launch import train

    train.main(["--arch", "qwen3-4b", "--reduced", "--steps", "3",
                "--batch", "2", "--seq", "16", "--device", "cpu",
                "--ckpt-dir", str(tmp_path / "t")])
    assert "[train] done: final loss" in capsys.readouterr().out
    assert ckpt.latest_step(str(tmp_path / "t")) == 3
    with pytest.raises(SystemExit):
        train.main(["--arch", "qwen3-4b", "--mesh", "pod", "--device",
                    "cpu"])
    assert "256 ranks" in capsys.readouterr().err
    monkeypatch.setattr(sys, "argv", [
        "train_lm_torch.py", "--steps", "5", "--batch", "2", "--seq", "16",
        "--device", "cpu", "--ckpt-dir", str(tmp_path / "e")])
    runpy.run_path(os.path.join(os.path.dirname(__file__), "..", "examples",
                                "train_lm_torch.py"), run_name="__main__")
    assert "[example] loss:" in capsys.readouterr().out
