"""The port's blocking-admission prefill against the reference on the same
seeded inputs: ``chunked_attention`` (causal, softcap, window, q_offset,
key lengths that are not a multiple of ``chunk_kv``) within 1e-6 in f32;
``ring_slot_positions`` exactly; ``attn_prefill`` and ``prefill`` with
``last_pos`` (logits and the exact cache padded to max_seq) on TINY and
the reduced qwen3-4b, within 1e-5 in f32 and within 2 bf16 ulps of each
tensor's largest magnitude in bf16; and decode over an int8 exact cache,
the twin of tests/test_clustered_decode.py::test_int8_kv_decode_close_to_bf16."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import ref_init_params
from repro import configs
from repro.models import attention as attn
from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.models import attention as attn_t
from repro_torch.models import transformer as tfm_t
from repro_torch.models.config import ModelConfig as ModelConfigT

T = torch.from_numpy
_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")


@pytest.mark.parametrize("sq,skv,kw", [
    (37, 37, dict(causal=True)),
    (37, 37, dict(causal=True, softcap=5.0)),
    (37, 37, dict(causal=True, window=8)),
    (9, 29, dict(causal=True, q_offset=20)),
    (11, 45, dict(causal=False)),
    (40, 40, dict(causal=True, chunk_kv=1024)),
])
def test_chunked_attention_matches(sq, skv, kw):
    rng = np.random.default_rng(sq + skv)
    q = rng.normal(size=(2, sq, 4, 16)).astype(np.float32)
    k = rng.normal(size=(2, skv, 2, 16)).astype(np.float32)
    v = rng.normal(size=(2, skv, 2, 8)).astype(np.float32)
    kw = dict(dict(scale=0.25, chunk_kv=16), **kw)
    want = attn.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), **kw)
    got = attn_t.chunked_attention(T(q), T(k), T(v), **kw)
    assert got.shape == (2, sq, 4, 8)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=1e-6)


def test_ring_slot_positions_match():
    for size, t in [(8, 0), (8, 5), (8, 8), (8, 21), (16, 100)]:
        np.testing.assert_array_equal(
            attn_t.ring_slot_positions(size, t).numpy(),
            np.asarray(attn.ring_slot_positions(size, jnp.int32(t))))
    tv = np.array([3, 8, 30], np.int32)
    np.testing.assert_array_equal(
        attn_t.ring_slot_positions(8, T(tv)).numpy(),
        np.asarray(attn.ring_slot_positions(8, jnp.asarray(tv))))


def _configs(which, dtype):
    if which == "tiny":
        return (ModelConfig(**dict(_TINY_KW, dtype=dtype)),
                ModelConfigT(**dict(_TINY_KW, dtype=dtype)))
    return (dataclasses.replace(configs.get_reduced("qwen3-4b"), dtype=dtype),
            dataclasses.replace(configs_t.get_reduced("qwen3-4b"),
                                dtype=dtype))


@pytest.fixture(scope="module",
                params=[("tiny", "float32"), ("tiny", "bfloat16"),
                        ("qwen3", "float32"), ("qwen3", "bfloat16")],
                ids=lambda p: "-".join(p))
def model(request):
    cfg, cfg_t = _configs(*request.param)
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    return cfg, cfg_t, params, pt


def _close(got: torch.Tensor, want, dtype: str, what: str):
    """f32: within 1e-5 (rtol and atol); bf16: within 2 bf16 ulps of the
    tensor's largest magnitude (the tolerance of a value rounded twice
    somewhere up the stack)."""
    got = got.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5,
                                   err_msg=what)
        return
    ulp = 2.0 ** (np.floor(np.log2(max(np.abs(want).max(), 1e-30))) - 7)
    err = np.abs(got - want).max()
    assert err <= 2 * ulp, f"{what}: {err} > 2 ulps of {ulp}"


def test_attn_prefill_matches(model):
    cfg, cfg_t, params, pt = model
    x = np.random.default_rng(1).normal(size=(2, 37, cfg.d_model))
    xj = jnp.asarray(x, cfg.dtype)
    lp = jax.tree.map(lambda a: a[0], params["scan"]["sub0"])["attn"]
    yw, cw = attn.attn_prefill(lp, xj, cfg, layer_kind="G",
                               positions=jnp.arange(37))
    yg, cg = attn_t.attn_prefill(pt["layers"][0]["attn"],
                                 bridge.to_torch(np.asarray(xj)), cfg_t,
                                 layer_kind="G", positions=torch.arange(37))
    _close(yg, yw, cfg.dtype, "y")
    for key in ("k", "v"):
        assert cg[key].shape == cw[key].shape
        _close(cg[key], cw[key], cfg.dtype, key)


@pytest.mark.parametrize("last_pos", [None, 30])
def test_prefill_matches(model, last_pos):
    """A prompt right-padded past ``last_pos`` (as blocking admission pads
    to its bucket): the logits of that position and every layer's cache,
    padded out to max_seq."""
    cfg, cfg_t, params, pt = model
    toks = np.random.default_rng(0).integers(
        0, cfg.vocab, size=(2, 37)).astype(np.int32)
    lw, cw = jax.jit(lambda t: tfm.prefill(params, cfg, t, max_seq=48,
                                           last_pos=last_pos))(
        jnp.asarray(toks))
    lg, cg = tfm_t.prefill(pt, cfg_t, T(toks), max_seq=48, last_pos=last_pos)
    assert lg.dtype == torch.float32 and lg.shape == lw.shape
    _close(lg, lw, cfg.dtype, "logits")
    cw = bridge.cache_from_numpy(jax.tree.map(np.asarray, cw), cfg_t)
    for li, (a, b) in enumerate(zip(cw["layers"], cg["layers"])):
        for key in ("k", "v"):
            assert b[key].shape == (2, 48, cfg.n_kv_heads, cfg.head_dim)
            _close(b[key], a[key].float().numpy(), cfg.dtype,
                   f"layer {li} {key}")


def test_int8_kv_decode_matches_reference():
    """Decode over an int8 exact cache with per-head scales 0.05 (set on
    every layer, scan-stacked ones included), 12 steps:
    the port's logits equal the reference's within 1e-4, the quantised
    caches agree (round half to even, ±127), and the port's greedy token
    agrees with its exact cache on at least 10 of 12 steps, as the
    reference's test asks of the reference."""
    cfg = dataclasses.replace(configs.get_reduced("qwen3-4b"),
                              dtype="float32")
    cfg_t = dataclasses.replace(configs_t.get_reduced("qwen3-4b"),
                                dtype="float32")
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    toks = np.random.default_rng(2).integers(0, cfg.vocab,
                                             size=(2, 12)).astype(np.int32)
    # a fresh int8 leaf: the reference's init_cache_attn (its scan-stacked
    # init_cache zero-fills every leaf, scales included)
    want = attn.init_cache_attn(cfg, "G", 2, 32, quantized=True)
    got = tfm_t.init_cache(cfg_t, 2, 32, kv_mode="int8",
                           device="cpu")["layers"][0]
    assert want.keys() == got.keys()
    for key in want:
        assert torch.equal(got[key], bridge.to_torch(np.asarray(want[key])))
    cache_q = jax.tree_util.tree_map_with_path(
        lambda path, l: (jnp.full(l.shape, 0.05, l.dtype)
                         if path[-1].key.endswith("_scale") else l),
        tfm.init_cache(cfg, 2, 32, kv_mode="int8"))
    cache_qt = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache_q),
                                       cfg_t, "cpu")
    cache_et = tfm_t.init_cache(cfg_t, 2, 32, device="cpu")
    for leaf in cache_qt["layers"]:
        assert leaf["k"].dtype == torch.int8
        assert (leaf["k_scale"] == 0.05).all()
    step = jax.jit(lambda c, tk, t: tfm.decode_step(params, cfg, c, tk, t))
    ok = 0
    for t in range(12):
        tk = toks[:, t:t + 1]
        lq, cache_q = step(cache_q, jnp.asarray(tk), jnp.int32(t))
        lqt, _ = tfm_t.decode_step(pt, cfg_t, cache_qt, T(tk), t)
        let, _ = tfm_t.decode_step(pt, cfg_t, cache_et, T(tk), t)
        np.testing.assert_allclose(lqt.numpy(), np.asarray(lq), rtol=1e-4,
                                   atol=1e-4, err_msg=f"t={t}")
        ok += int(torch.equal(torch.argmax(let, -1), torch.argmax(lqt, -1)))
    assert ok >= 10, f"top-1 agreement only {ok}/12"
    want = bridge.cache_from_numpy(jax.tree.map(np.asarray, cache_q), cfg_t)
    for a, b in zip(want["layers"], cache_qt["layers"]):
        for key in ("k", "v"):
            diff = (a[key].int() - b[key].int()).abs()
            assert diff.max() <= 1 and (diff > 0).float().mean() < 1e-3
            assert b[key].abs().max() <= 127
