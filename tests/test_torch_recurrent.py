"""The port's recurrent layers ('M' Mamba2 SSD, 'R' RG-LRU) against the
reference on the same seeded inputs.

Parameters come from the reference's ``init_params`` and cross by value
through ``bridge`` (the gate and SSD scalars stay f32, as the reference
reads them uncast); inputs are numpy draws from a seed.  All in f32 on the
reduced mamba2-2.7b and recurrentgemma-9b configs.  Tolerances: the
one-token decodes, the sequential prefill and every stepping path within
1e-5 (rtol and atol); the parallel forms (``ssd_chunked``, the RG-LRU
scan and "scan"-mode prefill) within 1e-5 of the reference's parallel form
and within 2e-3 of the port's own sequential form, as the reference's
``TestSSD`` / ``TestRGLRU`` allow.  The packed recurrent advance gives the
dense mixed advance's values within 1e-6.

Also: the recurrent half of ``core.layer_state`` and ``RecurrentRetention``
answer as the reference's, ``init_params`` draws every leaf of the
reference's init with its dtype, and a slot snapshot of recurrent state is
a copy that survives the slot advancing."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import ref_init_params
from repro import configs
from repro.core import layer_state
from repro.core import retention as ret
from repro.models import rglru as rg
from repro.models import ssm
from repro.models import transformer as tfm
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import layer_state as layer_state_t
from repro_torch.core import retention as ret_t
from repro_torch.models import rglru as rg_t
from repro_torch.models import ssm as ssm_t
from repro_torch.models import transformer as tfm_t

T = torch.from_numpy
ARCHS = ["mamba2-2.7b", "recurrentgemma-9b"]


def _configs(name, dtype="float32"):
    return (dataclasses.replace(configs.get_reduced(name), dtype=dtype),
            dataclasses.replace(configs_t.get_reduced(name), dtype=dtype))


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """(cfg, cfg_t, params, port params, the first recurrent layer's index,
    kind, reference sublayer params, port sublayer params)."""
    cfg, cfg_t = _configs(request.param)
    params = ref_init_params(cfg, 1)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    kinds = tfm_t.layer_kinds(cfg_t)
    li = next(i for i, k in enumerate(kinds) if k in "MR")
    lp_t = pt["layers"][li]
    lp_j = jax.tree.map(lambda t: jnp.asarray(bridge.to_numpy(t)), lp_t)
    return cfg, cfg_t, params, pt, li, kinds[li], lp_j, lp_t


def _close(got: torch.Tensor, want, what: str, tol: float = 1e-5):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _x(shape, seed, scale=0.5):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return jnp.asarray(x), T(x)


def _state_pair(cache_j):
    return cache_j, {k: T(np.array(v)) for k, v in cache_j.items()}


# ---------------------------------------------------------------------------
# layer-state families, retention, params
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS + ["qwen3-4b"])
def test_recurrent_state_bytes_match_reference(arch):
    """Per-slot recurrent bytes, leaf classification and the (unstacked)
    port leaves on full-width configs' caches (shapes only: the caches
    are built on the meta device and by ``jax.eval_shape``)."""
    cfg, cfg_t = configs.get_config(arch), configs_t.get_config(arch)
    cache = jax.eval_shape(lambda: tfm.init_cache(cfg, 3, 64))
    cache_t = tfm_t.init_cache(cfg_t, 3, 64, device="meta")
    assert layer_state_t.recurrent_state_bytes(cache_t, 3) == \
        layer_state.recurrent_state_bytes(cache, 3)
    n_rec = sum(k in "MR" for k in tfm_t.layer_kinds(cfg_t))
    leaves = [leaf for leaf in cache_t["layers"]
              if layer_state_t.is_recurrent_leaf(leaf)]
    assert len(leaves) == n_rec
    assert not any(layer_state_t.recurrent_leaf_stacked(leaf)
                   for leaf in leaves)
    assert all(tuple(leaf) in layer_state_t.RECURRENT_LEAF_KEYS
               for leaf in leaves)
    assert layer_state_t.RECURRENT_LEAF_KEYS == layer_state.RECURRENT_LEAF_KEYS
    assert layer_state_t.RECURRENT_KINDS == layer_state.RECURRENT_KINDS
    for leaf in cache_t["layers"]:
        assert layer_state_t.is_ring_leaf(leaf) != \
            layer_state_t.is_recurrent_leaf(leaf)


def test_recurrent_state_bytes_of_the_full_width_configs():
    """The per-slot figures the smoke gates on: recurrentgemma-9b's 26
    'R' layers of (3 x 4,096 bf16 conv, 4,096 f32 h) and mamba2-2.7b's 64
    'M' layers of (3 x 5,376 bf16 conv, 80 x 64 x 128 f32 state)."""
    for arch, want in (("recurrentgemma-9b", 26 * (3 * 4096 * 2 + 4096 * 4)),
                       ("mamba2-2.7b",
                        64 * (3 * 5376 * 2 + 80 * 64 * 128 * 4))):
        cache = tfm_t.init_cache(configs_t.get_config(arch), 4, 64,
                                 device="meta")
        assert layer_state_t.recurrent_state_bytes(cache, 4) == want


def test_recurrent_retention_matches_reference():
    a, b = ret.RecurrentRetention(("M", "R")), ret_t.RecurrentRetention(
        ("M", "R"))
    assert (a.kind, a.keep_unwritten) == (b.kind, b.keep_unwritten)
    rng = np.random.default_rng(0)
    for _ in range(50):
        slot, t = int(rng.integers(0, 4)), int(rng.integers(0, 500))
        assert b.retire_lo(slot, t) == a.retire_lo(slot, t) == 0
        assert b.advance(slot, t) == a.advance(slot, t) == 0
    assert b.diagnostics() == a.diagnostics()
    assert ret_t.RecurrentRetention(("R",)).diagnostics() == \
        ret.RecurrentRetention(("R",)).diagnostics()


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_draws_every_reference_leaf(arch):
    """The port's own init has every leaf of the reference's, with the
    shape the bridge gives it and the same dtype (f32 where the reference
    reads the leaf uncast), and the reference's constant starts (``A_log``
    0, ``D`` / ``norm`` / ``lam`` 1, zero biases).  The reference's tree
    comes from ``jax.eval_shape``; its constants from one layer's
    ``init_ssm`` / ``init_rglru``."""
    cfg, cfg_t = _configs(arch, "bfloat16")
    shapes = jax.eval_shape(lambda: tfm.init_params(jax.random.PRNGKey(0),
                                                    cfg))
    bridged = bridge.params_from_numpy(
        jax.tree.map(lambda a: np.zeros(a.shape, a.dtype), shapes), cfg_t,
        "cpu")
    own = tfm_t.init_params(0, cfg_t, device="cpu")

    def walk(a, b, path):
        if isinstance(a, dict):
            assert set(a) == set(b), path
            for k in a:
                walk(a[k], b[k], f"{path}/{k}")
        elif isinstance(a, list):
            assert len(a) == len(b), path
            for i, (x, y) in enumerate(zip(a, b)):
                walk(x, y, f"{path}/{i}")
        else:
            assert a.shape == b.shape and a.dtype == b.dtype, path

    walk(bridged, own, "")
    ref = {"ssm": ssm.init_ssm(jax.random.PRNGKey(0), cfg) if cfg.ssm
           else None,
           "rg": rg.init_rglru(jax.random.PRNGKey(0), cfg)
           if cfg.lru_width else None}
    consts = ("A_log", "D", "norm", "dt_bias", "conv_b", "lam", "ba_gate",
              "bi_gate")
    for lp in own["layers"]:
        for key in ("ssm", "rg"):
            for k in consts:
                if key in lp and k in lp[key]:
                    want = np.asarray(ref[key][k])
                    assert torch.equal(lp[key][k].float(), T(want)), k
                    assert lp[key][k].dtype == (
                        torch.float32 if k in bridge.F32_KEYS
                        else torch.bfloat16), k


# ---------------------------------------------------------------------------
# the SSD and RG-LRU blocks
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("s,chunk", [(48, 16), (37, 32), (5, 8)])
def test_ssd_chunked_matches(s, chunk):
    rng = np.random.default_rng(s)
    b, h, p, g, n = 2, 4, 8, 2, 16
    x = rng.normal(size=(b, s, h, p)).astype(np.float32)
    dt = np.log1p(np.exp(rng.normal(size=(b, s, h)))).astype(np.float32)
    A = -np.exp(rng.normal(size=(h,)) * 0.5).astype(np.float32)
    B = rng.normal(size=(b, s, g, n)).astype(np.float32)
    C = rng.normal(size=(b, s, g, n)).astype(np.float32)
    D = rng.normal(size=(h,)).astype(np.float32)
    yw, sw = jax.jit(ssm.ssd_chunked, static_argnums=6)(
        *map(jnp.asarray, (x, dt, A, B, C, D)), chunk)
    yg, sg = ssm_t.ssd_chunked(*map(T, (x, dt, A, B, C, D)), chunk)
    _close(yg, yw, "y")
    _close(sg, sw, "final state")


def _ssm_or_rg(kind):
    if kind == "M":
        return ("ssm", ssm.ssm_decode, ssm_t.ssm_decode, ssm.init_cache_ssm,
                ssm_t.init_cache_ssm)
    return ("rg", rg.rglru_decode, rg_t.rglru_decode, rg.init_cache_rglru,
            rg_t.init_cache_rglru)


def test_decode_steps_match(model):
    """Four one-token steps from a random state, the state carried along
    (the port's decode returns new tensors and leaves its input as it
    was)."""
    cfg, cfg_t, _, _, _, kind, lp_j, lp_t = model
    key, dec, dec_t, init, _ = _ssm_or_rg(kind)
    shapes = jax.tree.map(lambda a: a.shape, init(cfg, 2))
    rng = np.random.default_rng(3)
    cj, ct = _state_pair({k: jnp.asarray(rng.normal(size=s).astype(
        np.float32) * 0.3) for k, s in shapes.items()})
    dec_j = jax.jit(lambda p, x, c: dec(p, x, cfg, c))
    for step in range(4):
        xj, xt = _x((2, 1, cfg.d_model), 10 + step)
        before = {k: v.clone() for k, v in ct.items()}
        yw, cj = dec_j(lp_j[key], xj, cj)
        yg, ct_new = dec_t(lp_t[key], xt, cfg_t, ct)
        for k in ct:
            assert torch.equal(ct[k], before[k]), "decode wrote its input"
        ct = ct_new
        _close(yg, yw, f"{kind} step {step} y")
        for k in ct:
            _close(ct[k], cj[k], f"{kind} step {step} {k}")


def test_prefill_forms_match(model):
    """The parallel prefill (chunked SSD / the RG-LRU scan) against the
    reference's within 1e-5; the sequential oracles against the
    reference's within 1e-5; the parallel form against the port's own
    sequential form within 2e-3 (the reference's TestSSD / TestRGLRU)."""
    cfg, cfg_t, _, _, _, kind, lp_j, lp_t = model
    xj, xt = _x((2, 45, cfg.d_model), 4)
    if kind == "M":
        par, seq, key = tfm._ssm_prefill, ssm.ssm_sequential_ref, "ssm"
        yg, cg = ssm_t.ssm_prefill(lp_t["ssm"], xt, cfg_t)
        seq_g = ssm_t.ssm_sequential_ref(lp_t["ssm"], xt, cfg_t)
    else:
        par, seq, key = rg.rglru_prefill, rg.rglru_sequential_ref, "rg"
        yg, cg = rg_t.rglru_prefill(lp_t["rg"], xt, cfg_t)
        seq_g = rg_t.rglru_sequential_ref(lp_t["rg"], xt, cfg_t)
    yw, cw, seq_w = jax.jit(lambda p, x: (*par(p, x, cfg), seq(p, x, cfg)))(
        lp_j[key], xj)
    _close(yg, yw, "parallel y")
    for k in cg:
        assert cg[k].shape == cw[k].shape
        _close(cg[k], cw[k], f"parallel {k}")
    _close(seq_g, seq_w, "sequential y")
    _close(yg, seq_g.numpy(), "parallel vs sequential", tol=2e-3)


@pytest.mark.parametrize("mode", ["scan", "sequential"])
@pytest.mark.parametrize("s", [2, 37])
def test_sublayer_prefill_matches(model, mode, s):
    """A recurrent sublayer's prefill (norm, block, residual and, for 'R',
    the FFN) and its final state, in both modes; 2 tokens is shorter than
    the conv tail."""
    cfg, cfg_t, _, _, _, kind, lp_j, lp_t = model
    xj, xt = _x((2, s, cfg.d_model), 5, scale=1.0)
    kw = dict(kv_repeat=1, max_seq=64, recurrent_mode=mode)
    hw, cw, _ = jax.jit(lambda p, x: tfm.sublayer_prefill(
        p, x, cfg, kind, positions=jnp.arange(s), **kw))(lp_j, xj)
    kw["positions"] = torch.arange(s)
    hg, cg = tfm_t.sublayer_prefill(lp_t, xt, cfg_t, kind, **kw)
    _close(hg, hw, f"{mode} h")
    for k in cg:
        _close(cg[k], cw[k], f"{mode} {k}")


def _stepper(kind, lp, cfg, mod):
    if kind == "M":
        return lambda xt, c: mod[0].ssm_decode(lp["ssm"], xt, cfg, c)
    return lambda xt, c: mod[1].rglru_decode(lp["rg"], xt, cfg, c)


def test_recurrent_mixed_advance_matches(model):
    """A mixed launch of L = 6 columns, slot 0 a 6-token chunk, slot 1
    one decode token: the reference's outputs and states, and each slot
    equal to stepping its own tokens alone through the one-token decode
    (the columns past a slot's chunk leave its state untouched)."""
    cfg, cfg_t, _, _, _, kind, lp_j, lp_t = model
    _, _, _, init, init_t = _ssm_or_rg(kind)
    shapes = jax.tree.map(lambda a: a.shape, init(cfg, 2))
    rng = np.random.default_rng(6)
    cj, ct = _state_pair({k: jnp.asarray(rng.normal(size=s).astype(
        np.float32) * 0.3) for k, s in shapes.items()})
    xj, xt = _x((2, 6, cfg.d_model), 7)
    cl = np.array([6, 1], np.int32)
    yw, sw = jax.jit(lambda p, x, c, n: tfm._recurrent_mixed_advance(
        _stepper(kind, p, cfg, (ssm, rg)), x, c, n))(lp_j, xj, cj,
                                                    jnp.asarray(cl))
    step_t = _stepper(kind, lp_t, cfg_t, (ssm_t, rg_t))
    yg, sg = tfm_t._recurrent_mixed_advance(step_t, xt, ct, T(cl))
    for b in range(2):
        _close(yg[b, :cl[b]], yw[b, :cl[b]], f"slot {b} y")
    for k in sg:
        _close(sg[k], sw[k], f"state {k}")
        assert not torch.equal(sg[k], ct[k])      # the input was not written
    for b in range(2):
        st = {k: v[b:b + 1] for k, v in ct.items()}
        for i in range(cl[b]):
            y, st = step_t(xt[b:b + 1, i:i + 1], st)
            _close(yg[b:b + 1, i], y[:, 0].numpy(), f"slot {b} col {i}")
        for k in st:
            _close(sg[k][b:b + 1], st[k].numpy(), f"slot {b} {k} stepped")


def test_padded_steps_give_the_unpadded_rows(model):
    """ROADMAP Queue C 10's repair: a recurrent column stepped at the
    engine's slot count.  The sequential prefill of 2 prompts padded to 5
    rows, a mixed launch and a one-token step of 2 slots padded to 5 rows
    (``recurrent_rows``) give the unpadded outputs and states bit for bit
    on the CPU, and hand back only the real rows (no padding row reaches a
    slot)."""
    cfg, cfg_t, _, _, _, kind, _, lp_t = model
    _, _, _, _, init_t = _ssm_or_rg(kind)
    step_t = _stepper(kind, lp_t, cfg_t, (ssm_t, rg_t))
    _, xt = _x((2, 9, cfg.d_model), 12)
    want = tfm_t._recurrent_prefill_sequential(step_t, xt,
                                               init_t(cfg_t, 2,
                                                      device="cpu"))
    got = tfm_t._recurrent_prefill_sequential(step_t, xt,
                                              init_t(cfg_t, 2, device="cpu"),
                                              rows=5)
    assert torch.equal(got[0], want[0])
    for k in want[1]:
        assert got[1][k].shape == want[1][k].shape
        assert torch.equal(got[1][k], want[1][k]), k
    rng = np.random.default_rng(13)
    state = {k: T(rng.normal(size=v.shape).astype(np.float32) * 0.3)
             for k, v in init_t(cfg_t, 2, device="cpu").items()}
    t = T(np.array([9, 30], np.int32))
    for hx, cl in ((xt[:, :6], T(np.array([6, 1], np.int32))),
                   (xt[:, :1], None)):
        outs = []
        for rows in (None, 5):
            c = {k: v.clone() for k, v in state.items()}
            h, _ = tfm_t.sublayer_decode(lp_t, hx, cfg_t, kind, c, t,
                                         kv_repeat=1, chunk_len=cl,
                                         recurrent_rows=rows)
            outs.append((h, c))
        (h0, c0), (h1, c1) = outs
        assert torch.equal(h1, h0)
        for k in c0:
            assert c1[k].shape == c0[k].shape and torch.equal(c1[k], c0[k])


def test_recurrent_packed_matches_dense(model):
    """Packed rows (slot 1's 4-row chunk, slot 0's decode row, two padding
    rows, slot 2 idle) against the dense mixed advance of the same
    tokens: the real rows' outputs and every slot's state; the idle slot
    and the padding rows write nothing.  Against the reference's packed
    form too."""
    cfg, cfg_t, _, _, _, kind, lp_j, lp_t = model
    _, _, _, init, _ = _ssm_or_rg(kind)
    shapes = jax.tree.map(lambda a: a.shape, init(cfg, 3))
    rng = np.random.default_rng(8)
    cj, ct = _state_pair({k: jnp.asarray(rng.normal(size=s).astype(
        np.float32) * 0.3) for k, s in shapes.items()})
    row_slot = np.array([1, 1, 1, 1, 0, 0, 0], np.int32)
    row_pos = np.array([9, 10, 11, 12, 30, -1, -1], np.int32)
    row_cidx = np.array([0, 1, 2, 3, 0, 0, 0], np.int32)
    xj, xt = _x((7, 1, cfg.d_model), 9, scale=1.0)
    kw = dict(row_slot=row_slot, row_pos=row_pos, row_cidx=row_cidx)
    packed_ct = {k: v.clone() for k, v in ct.items()}
    idx, sizes = tfm_t.recurrent_round_plan(row_slot, row_pos, row_cidx,
                                            width=4)
    rounds = tfm_t.recurrent_rounds(T(idx), sizes)
    hg, _ = tfm_t._sublayer_decode_recurrent_packed(lp_t, xt, cfg_t,
                                                    packed_ct, kind,
                                                    rounds=rounds)
    hw, cw = jax.jit(lambda p, x, c, r: tfm._sublayer_decode_recurrent_packed(
        p, x, cfg, c, kind, width=4, **r))(
            lp_j, xj, cj, {k: jnp.asarray(v) for k, v in kw.items()})
    _close(hg[:5], hw[:5], "packed vs reference packed")
    for k in packed_ct:
        _close(packed_ct[k], cw[k], f"packed state {k}")
    # the same tokens as a dense mixed launch over the 3 slots
    dense_x = torch.zeros(3, 4, cfg.d_model)
    dense_x[1] = xt[:4, 0]
    dense_x[0, 0] = xt[4, 0]
    dense_ct = {k: v.clone() for k, v in ct.items()}
    hd, _ = tfm_t.sublayer_decode(lp_t, dense_x, cfg_t, kind, dense_ct,
                                  T(np.array([30, 9, 0], np.int32)),
                                  kv_repeat=1,
                                  chunk_len=T(np.array([1, 4, 0], np.int32)))
    _close(hg[:4, 0], hd[1].numpy(), "chunk rows vs dense", tol=1e-6)
    _close(hg[4, 0], hd[0, 0].numpy(), "decode row vs dense", tol=1e-6)
    for k in packed_ct:
        _close(packed_ct[k][:2], dense_ct[k][:2].numpy(), f"state {k}",
               tol=1e-6)
        assert torch.equal(packed_ct[k][2], ct[k][2]), "idle slot written"


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["sequential", "scan"])
def test_prefill_and_decode_steps_match(model, mode):
    """A 37-token prefill, then mixed launches of two slots at different
    depths and one-token steps, the caches carried along (recurrent
    states, and recurrentgemma's 'L' window rings)."""
    cfg, cfg_t, params, pt = model[:4]
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 37)).astype(np.int32)
    lw, cw = jax.jit(lambda tk: tfm.prefill(
        params, cfg, tk, max_seq=64, recurrent_mode=mode))(jnp.asarray(toks))
    lg, cg = tfm_t.prefill(pt, cfg_t, T(toks), max_seq=64,
                           recurrent_mode=mode)
    _close(lg, lw, "prefill logits")
    ref_layers = bridge.cache_from_numpy(jax.tree.map(np.asarray, cw),
                                         cfg_t)["layers"]
    for li, (a, b) in enumerate(zip(ref_layers, cg["layers"])):
        assert set(a) == set(b)
        for key in a:
            assert b[key].shape == a[key].shape
            _close(b[key], a[key].numpy(), f"layer {li} {key}")
    step = jax.jit(lambda c, tk, t, cl: tfm.decode_step(params, cfg, c, tk, t,
                                                        chunk_len=cl))
    step1 = jax.jit(lambda c, tk, t: tfm.decode_step(params, cfg, c, tk, t))
    t = np.array([37, 37], np.int32)
    for si, cl in enumerate(([5, 1], [3, 5])):
        cl = np.array(cl, np.int32)
        tok = rng.integers(0, cfg.vocab, size=(2, 5)).astype(np.int32)
        lw, cw = step(cw, jnp.asarray(tok), jnp.asarray(t), jnp.asarray(cl))
        lg, cg = tfm_t.decode_step(pt, cfg_t, cg, T(tok), T(t),
                                   chunk_len=T(cl))
        _close(lg, lw, f"mixed step {si}")
        t = t + cl
    for k in range(3):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        lw, cw = step1(cw, jnp.asarray(tok), jnp.asarray(t))
        lg, cg = tfm_t.decode_step(pt, cfg_t, cg, T(tok), T(t))
        _close(lg, lw, f"decode step {k}")
        t = t + 1
    ref_layers = bridge.cache_from_numpy(jax.tree.map(np.asarray, cw),
                                         cfg_t)["layers"]
    for li, (a, b) in enumerate(zip(ref_layers, cg["layers"])):
        for key in a:
            _close(b[key], a[key].numpy(), f"final layer {li} {key}")


def test_snapshot_survives_the_slot_advancing(model):
    """Regression twin of the clustered case: a recurrent slot snapshot is
    a copy.  The slot goes on decoding (its state moves, in the dense
    step's new tensors and by the packed step's in-place scatter); a
    later restore gives the state as it was at the snapshot."""
    cfg, cfg_t, _, pt, li, kind, _, _ = model
    cache = tfm_t.init_cache(cfg_t, 2, 64, device="cpu")
    rng = np.random.default_rng(11)
    for leaf in cache["layers"]:
        if layer_state_t.is_recurrent_leaf(leaf):
            for v in leaf.values():
                v.copy_(T(rng.normal(size=v.shape).astype(np.float32)))
    snap = tfm_t.clustered_slot_state(cache, 1)
    assert snap["layers"][li] is not None
    before = [None if s is None else {k: v.clone() for k, v in s.items()}
              for s in snap["layers"]]
    tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
    tfm_t.decode_step(pt, cfg_t, cache, T(tok), T(np.array([40, 40])))
    rows = [T(np.array(a, np.int32)) for a in ([1], [41], [42], [0])]
    tfm_t.decode_step_packed(pt, cfg_t, cache, T(tok[1]), *rows, None,
                             block_size=4)
    leaf = cache["layers"][li]
    for k in leaf:
        assert not torch.equal(leaf[k][1:2], before[li][k])   # advanced
    for s, b in zip(snap["layers"], before):
        if s is not None:
            for k in s:
                assert torch.equal(s[k], b[k]), k
    tfm_t.restore_clustered_slot_state(cache, snap, 0)
    for k in leaf:
        assert torch.equal(leaf[k][0:1], before[li][k])
