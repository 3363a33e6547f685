"""The port's sliding-window ('L') modules and retention policies against
the reference on the same seeded inputs.

``WindowRetention`` and ``QuotaRetention`` answer random call sequences
as the reference's do, and the block pool's ``free_retired`` frees the
same blocks under either policy.  ``decode_attention`` with ``window`` and
``ring`` (one-token and mixed forms, softcap) within 1e-6 in f32.  On the
reduced gemma2-27b ('LG', window 16, softcap 50) and gemma3-4b ('LLLLLG'
with a tail 'L' layer, window 8, qk-norm, local rope theta): an 'L'
layer's ``attn_prefill`` (prompts shorter and longer than the window) and
``attn_decode`` (one-token, and the mixed form's staged per-row commits
into a wrapped ring), and ``attn_decode_window_packed`` over packed rows,
within 1e-5 in f32 and 2 bf16 ulps of each tensor's largest magnitude in
bf16; then whole-model ``prefill`` and mixed and one-token ``decode_step``
with the caches carried along, within 1e-5 in f32."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import ref_init_params
from repro import configs
from repro.core import retention as ret
from repro.models import attention as attn
from repro.models import transformer as tfm
from repro.runtime import kv_pool as kv_ref
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import retention as ret_t
from repro_torch.models import attention as attn_t
from repro_torch.models import transformer as tfm_t
from repro_torch.runtime import kv_pool as kv_t

T = torch.from_numpy


# ---------------------------------------------------------------------------
# retention policies
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", range(4))
def test_window_retention_matches_reference(seed):
    rng = np.random.default_rng(seed)
    window = int(rng.integers(1, 20))
    a, b = ret.WindowRetention(window, 3), ret_t.WindowRetention(window, 3)
    assert (a.kind, a.keep_unwritten) == (b.kind, b.keep_unwritten)
    for _ in range(200):
        slot = int(rng.integers(0, 3))
        t = int(rng.integers(0, 80))
        op = rng.integers(0, 4)
        if op == 0:
            assert b.advance(slot, t) == a.advance(slot, t)
        elif op == 1:
            a.on_slot_free(slot)
            b.on_slot_free(slot)
        elif op == 2:
            blocks = rng.integers(0, 9, size=3).tolist()
            a.protect_write(slot, blocks)
            b.protect_write(slot, blocks)
        assert b.retire_lo(slot, t) == a.retire_lo(slot, t)
        assert b.protected_blocks(slot) == a.protected_blocks(slot)
    for cls in (ret.WindowRetention, ret_t.WindowRetention):
        with pytest.raises(ValueError, match="positive window"):
            cls(0)


@pytest.mark.parametrize("seed", range(2))
def test_quota_retention_matches_reference(seed):
    rng = np.random.default_rng(seed)
    bs, per = int(rng.integers(1, 9)), int(rng.integers(1, 40))
    a, b = ret.QuotaRetention(bs, per), ret_t.QuotaRetention(bs, per)
    assert (a.kind, a.keep_unwritten) == (b.kind, b.keep_unwritten) == (
        "quota", True)
    for _ in range(200):
        plen, new = int(rng.integers(0, 300)), int(rng.integers(-2, 60))
        assert b.admit_blocks(plen, new) == a.admit_blocks(plen, new)
        slot, t = int(rng.integers(0, 4)), int(rng.integers(0, 300))
        assert b.retire_lo(slot, t) == a.retire_lo(slot, t) == 0


@pytest.mark.parametrize("kind", ["window", "quota"])
def test_free_retired_under_policies_matches_reference(kind):
    """The same ensure / free_retired / free_slot sequence on both pools,
    each with its own package's policy, frees the same blocks and leaves
    the same tables (keep_unwritten keeps quota reservations)."""
    rng = np.random.default_rng(7)
    cfg_r, cfg_p = kv_ref.PagedKVConfig(4, 24), kv_t.PagedKVConfig(4, 24)
    pr = kv_ref.BlockPool(3, 32, cfg_r, full_tail_resident=False)
    pp = kv_t.BlockPool(3, 32, cfg_p, full_tail_resident=False)
    if kind == "window":
        pol_r, pol_p = ret.WindowRetention(9, 3), ret_t.WindowRetention(9, 3)
    else:
        pol_r, pol_p = ret.QuotaRetention(4, 8), ret_t.QuotaRetention(4, 8)
    for _ in range(300):
        slot, t = int(rng.integers(0, 3)), int(rng.integers(0, 80))
        op = rng.integers(0, 4)
        if op == 0:
            blocks = sorted(set(rng.integers(0, 8, size=2).tolist()))
            got = []
            for pool in (pr, pp):
                try:
                    pool.ensure(slot, blocks, [])
                    got.append("ok")
                except Exception as e:       # PoolExhausted of each package
                    got.append(type(e).__name__)
            assert got[0] == got[1]
        elif op == 1:
            prot = rng.integers(0, 8, size=2).tolist()
            pol_r.protect_write(slot, prot)
            pol_p.protect_write(slot, prot)
            assert (pp.free_retired(slot, t, pol_p)
                    == pr.free_retired(slot, t, pol_r))
            pol_r.clear_protection(slot)
            pol_p.clear_protection(slot)
        elif op == 2:
            pr.free_slot(slot)
            pp.free_slot(slot)
        assert pp.table.tolist() == pr.table.tolist()
        assert pp.allocated() == pr.allocated()


# ---------------------------------------------------------------------------
# decode_attention with window and ring
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("form", ["decode", "mixed"])
@pytest.mark.parametrize("window,ring,softcap", [
    (None, False, None), (5, True, None), (5, True, 20.0), (7, False, None),
    (None, True, None)])
def test_decode_attention_window_ring(form, window, ring, softcap):
    rng = np.random.default_rng(3)
    sc = 12
    k = rng.normal(size=(3, sc, 2, 8)).astype(np.float32)
    v = rng.normal(size=(3, sc, 2, 8)).astype(np.float32)
    kw = dict(scale=0.3, window=window, ring=ring, softcap=softcap)
    if form == "decode":
        q = rng.normal(size=(3, 4, 8)).astype(np.float32)
        t = np.array([4, 12, 29], np.int32)
        want = attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), t=jnp.asarray(t), **kw)
        got = attn_t.decode_attention(T(q), T(k), T(v), t=T(t), **kw)
    else:
        q = rng.normal(size=(3, 4, 4, 8)).astype(np.float32)
        t = np.array([0, 6, 21], np.int32)
        cl = np.array([4, 2, 3], np.int32)
        want = attn.decode_attention(jnp.asarray(q), jnp.asarray(k),
                                     jnp.asarray(v), t=jnp.asarray(t),
                                     chunk_len=jnp.asarray(cl), **kw)
        got = attn_t.decode_attention(T(q), T(k), T(v), t=T(t),
                                      chunk_len=T(cl), **kw)
        # rows past chunk_len are garbage by contract
        keep = np.arange(4)[None, :] < cl[:, None]
        want, got = np.asarray(want)[keep], got.numpy()[keep]
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# 'L' layers on the reduced gemma configs
# ---------------------------------------------------------------------------


def _configs(name, dtype):
    return (dataclasses.replace(configs.get_reduced(name), dtype=dtype),
            dataclasses.replace(configs_t.get_reduced(name), dtype=dtype))


@pytest.fixture(scope="module",
                params=[("gemma2-27b", "float32"), ("gemma2-27b", "bfloat16"),
                        ("gemma3-4b", "float32"), ("gemma3-4b", "bfloat16")],
                ids=lambda p: "-".join(p))
def model(request):
    cfg, cfg_t = _configs(*request.param)
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    # the 'L' layer under test: gemma2's first, gemma3's tail layer
    li = max(i for i, k in enumerate(tfm_t.layer_kinds(cfg_t)) if k == "L")
    li = 0 if cfg.name.startswith("gemma2") else li
    assert tfm_t.layer_kinds(cfg_t)[li] == "L"
    p_t = pt["layers"][li]["attn"]
    p_j = {k: jnp.asarray(bridge.to_numpy(v)) for k, v in p_t.items()}
    return cfg, cfg_t, params, pt, p_j, p_t


def _close(got: torch.Tensor, want, dtype: str, what: str):
    """f32: within 1e-5 (rtol and atol); bf16: within 2 bf16 ulps of the
    tensor's largest magnitude."""
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
        return
    ulp = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
    err = np.abs(got - want).max()
    assert err <= 2 * ulp, f"{what}: {err} > 2 ulps of {ulp}"


def _x(cfg, shape, seed):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    xj = jnp.asarray(x, cfg.dtype)
    return xj, bridge.to_torch(np.asarray(xj))


@pytest.mark.parametrize("s", [5, 37])
def test_attn_prefill_window_matches(model, s):
    """Shorter than the window: the keys zero-padded to ``window``;
    longer: the last ``window`` keys at their ring slots."""
    cfg, cfg_t, _, _, p_j, p_t = model
    xj, xt = _x(cfg, (2, s, cfg.d_model), 1)
    yw, cw = attn.attn_prefill(p_j, xj, cfg, layer_kind="L",
                               positions=jnp.arange(s))
    yg, cg = attn_t.attn_prefill(p_t, xt, cfg_t, layer_kind="L",
                                 positions=torch.arange(s))
    _close(yg, yw, cfg.dtype, "y")
    for key in ("k", "v"):
        assert cg[key].shape == cw[key].shape == (
            2, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim)
        _close(cg[key], cw[key], cfg.dtype, key)


def _ring(cfg, seed):
    shape = (2, cfg.sliding_window, cfg.n_kv_heads, cfg.head_dim)
    rng = np.random.default_rng(seed)
    k, v = (jnp.asarray(rng.normal(size=shape), cfg.dtype) for _ in "kv")
    return ({"k": k, "v": v},
            {"k": bridge.to_torch(np.asarray(k)),
             "v": bridge.to_torch(np.asarray(v))})


def test_attn_decode_window_matches(model):
    """One-token steps, then a mixed launch whose chunk rows commit one by
    one into a ring that wraps mid-chunk, then one-token steps again, the
    ring carried along (the port writes it in place)."""
    cfg, cfg_t, _, _, p_j, p_t = model
    cj, ct = _ring(cfg, 2)
    w = cfg.sliding_window
    t = np.array([w - 3, 2 * w + 5], np.int32)
    for step in range(3):
        xj, xt = _x(cfg, (2, 1, cfg.d_model), 10 + step)
        yw, cj = attn.attn_decode(p_j, xj, cfg, layer_kind="L", cache=cj,
                                  t=jnp.asarray(t))
        yg, ct = attn_t.attn_decode(p_t, xt, cfg_t, layer_kind="L",
                                    cache=ct, t=T(t))
        _close(yg, yw, cfg.dtype, f"decode step {step}")
        t = t + 1
    L = 6
    cl = np.array([6, 2], np.int32)
    xj, xt = _x(cfg, (2, L, cfg.d_model), 20)
    yw, cj = attn.attn_decode(p_j, xj, cfg, layer_kind="L", cache=cj,
                              t=jnp.asarray(t), chunk_len=jnp.asarray(cl))
    yg, ct = attn_t.attn_decode(p_t, xt, cfg_t, layer_kind="L", cache=ct,
                                t=T(t), chunk_len=T(cl))
    for b in range(2):
        _close(yg[b, :cl[b]], yw[b, :cl[b]], cfg.dtype, f"mixed slot {b}")
    for key in ("k", "v"):
        _close(ct[key], cj[key], cfg.dtype, f"ring {key}")
    t = t + cl
    xj, xt = _x(cfg, (2, 1, cfg.d_model), 30)
    yw, _ = attn.attn_decode(p_j, xj, cfg, layer_kind="L", cache=cj,
                             t=jnp.asarray(t))
    yg, _ = attn_t.attn_decode(p_t, xt, cfg_t, layer_kind="L", cache=ct,
                               t=T(t))
    _close(yg, yw, cfg.dtype, "decode after the chunk")


def test_attn_decode_window_packed_matches(model):
    """Packed rows: slot 0 feeds a 4-row chunk that wraps its ring, slot 1
    decodes one row, two padding rows; rows commit in row_cidx order."""
    cfg, cfg_t, _, _, p_j, p_t = model
    cj, ct = _ring(cfg, 4)
    w = cfg.sliding_window
    row_slot = np.array([0, 0, 0, 0, 1, 0, 0], np.int32)
    row_pos = np.array([w - 2, w - 1, w, w + 1, 3 * w + 1, -1, -1], np.int32)
    row_cidx = np.array([0, 1, 2, 3, 0, 0, 0], np.int32)
    xj, xt = _x(cfg, (7, 1, cfg.d_model), 5)
    kw = dict(row_slot=row_slot, row_pos=row_pos, row_cidx=row_cidx)
    yw, cw = attn.attn_decode_window_packed(
        p_j, xj, cfg, cache=cj, width=4,
        **{k: jnp.asarray(v) for k, v in kw.items()})
    yg, cg = attn_t.attn_decode_window_packed(
        p_t, xt, cfg_t, cache=ct, width=4, **{k: T(v) for k, v in kw.items()})
    _close(yg[:5], yw[:5], cfg.dtype, "real rows")
    for key in ("k", "v"):
        _close(cg[key], cw[key], cfg.dtype, f"ring {key}")


@pytest.mark.parametrize("name", ["gemma2-27b", "gemma3-4b"])
def test_prefill_and_decode_steps_match(name):
    """Whole model in f32: a 37-token prefill (past every window), then
    mixed launches of two slots at different depths and one-token steps,
    the caches carried along (exact 'G' caches padded to max_seq, 'L'
    window rings)."""
    cfg, cfg_t = _configs(name, "float32")
    params = ref_init_params(cfg, 1)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, size=(2, 37)).astype(np.int32)
    lw, cw = jax.jit(lambda tk: tfm.prefill(params, cfg, tk, max_seq=64))(
        jnp.asarray(toks))
    lg, cg = tfm_t.prefill(pt, cfg_t, T(toks), max_seq=64)
    _close(lg, lw, "float32", "prefill logits")
    ref_layers = bridge.cache_from_numpy(jax.tree.map(np.asarray, cw),
                                         cfg_t)["layers"]
    for li, (a, b) in enumerate(zip(ref_layers, cg["layers"])):
        for key in ("k", "v"):
            assert b[key].shape == a[key].shape
            _close(b[key], a[key].numpy(), "float32", f"layer {li} {key}")
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
        _close(lg, lw, "float32", f"mixed step {si}")
        t = t + cl
    for k in range(4):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        lw, cw = step1(cw, jnp.asarray(tok), jnp.asarray(t))
        lg, cg = tfm_t.decode_step(pt, cfg_t, cg, T(tok), T(t))
        _close(lg, lw, "float32", f"decode step {k}")
        t = t + 1
