"""The port's decode_step against the reference's, in f32: logits of the
one-token and mixed (chunked prefill + decode) forms agree at atol = rtol
= 1e-4 over 8 steps with the caches carried along, for exact and
clustered caches, on TINY and the reduced qwen3 (qk-norm).  And the
port's own ``init_params`` on the gemma configs (sandwich norms): the
reference's leaf names and shapes, and a tree decode can use."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import ref_init_params
from repro import configs
from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.models import transformer as tfm_t
from repro_torch.models.config import ModelConfig as ModelConfigT

T = torch.from_numpy
TOL = dict(rtol=1e-4, atol=1e-4)
_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")


def _configs(which):
    if which == "tiny":
        return ModelConfig(**_TINY_KW), ModelConfigT(**_TINY_KW)
    return (dataclasses.replace(configs.get_reduced("qwen3-4b"),
                                dtype="float32"),
            dataclasses.replace(configs_t.get_reduced("qwen3-4b"),
                                dtype="float32"))


@pytest.fixture(scope="module", params=["tiny", "qwen3"])
def model(request):
    cfg, cfg_t = _configs(request.param)
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    # the reference's step, jitted once per shape (as its server runs it)
    step = jax.jit(lambda c, tk, t, cl: tfm.decode_step(params, cfg, c, tk, t,
                                                         chunk_len=cl))
    step1 = jax.jit(lambda c, tk, t: tfm.decode_step(params, cfg, c, tk, t))
    return cfg, cfg_t, (step, step1), pt


def _caches(cfg, cfg_t, kv_mode, rng):
    b = 2
    if kv_mode == "exact":
        cache = tfm.init_cache(cfg, b, 32)
    else:
        # live centroids (cov 0) and a ring small enough to wrap
        cache = tfm.init_cache(cfg, b, 32, kv_mode="clustered",
                               kv_clusters=6, kv_tail=8)

        def fill(path, leaf):
            name = path[-1].key
            a = np.asarray(leaf)
            if name in ("k_cents", "v_cents"):
                return rng.normal(size=a.shape).astype(a.dtype)
            if name == "counts":
                return rng.integers(0, 3, size=a.shape).astype(a.dtype)
            return a

        cache = jax.tree_util.tree_map_with_path(fill, cache)
    cache_np = jax.tree.map(np.asarray, cache)
    return (jax.tree.map(jnp.asarray, cache_np),
            bridge.cache_from_numpy(cache_np, cfg_t, "cpu"))


@pytest.mark.parametrize("kv_mode", ["exact", "clustered"])
def test_decode_steps_match(model, kv_mode):
    cfg, cfg_t, (_, step1), pt = model
    rng = np.random.default_rng(0)
    cache, cache_t = _caches(cfg, cfg_t, kv_mode, rng)
    toks = rng.integers(0, cfg.vocab, size=(2, 8)).astype(np.int32)
    for t in range(8):
        lj, cache = step1(cache, jnp.asarray(toks[:, t:t + 1]), jnp.int32(t))
        lt, cache_t = tfm_t.decode_step(pt, cfg_t, cache_t,
                                        T(toks[:, t:t + 1]), t)
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"t={t}")


@pytest.mark.parametrize("kv_mode", ["exact", "clustered"])
def test_mixed_steps_match(model, kv_mode):
    """Prompt chunks of different lengths per slot ride one launch with
    decode rows; then plain decode continues from the carried caches."""
    cfg, cfg_t, (step, step1), pt = model
    rng = np.random.default_rng(1)
    cache, cache_t = _caches(cfg, cfg_t, kv_mode, rng)
    L = 5
    # (t, chunk_len) per slot for each mixed launch
    plan = [((0, 5), (0, 3)), ((5, 2), (3, 5)), ((7, 1), (8, 4))]
    for si, launch in enumerate(plan):
        tok = rng.integers(0, cfg.vocab, size=(2, L)).astype(np.int32)
        t = np.array([s[0] for s in launch], np.int32)
        cl = np.array([s[1] for s in launch], np.int32)
        lj, cache = step(cache, jnp.asarray(tok), jnp.asarray(t),
                         jnp.asarray(cl))
        lt, cache_t = tfm_t.decode_step(pt, cfg_t, cache_t, T(tok), T(t),
                                        chunk_len=T(cl))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"mixed step {si}")
    t = np.array([8, 12], np.int32)
    for k in range(5):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        lj, cache = step1(cache, jnp.asarray(tok), jnp.asarray(t + k))
        lt, cache_t = tfm_t.decode_step(pt, cfg_t, cache_t, T(tok),
                                        T(t + k))
        np.testing.assert_allclose(lt.numpy(), np.asarray(lj), **TOL,
                                   err_msg=f"decode step {k}")


@pytest.mark.parametrize("name", ["gemma2-27b", "gemma3-4b"])
def test_init_params_matches_reference_tree(name):
    """``post_norms`` configs get "post_attn_norm" and "post_mlp_norm" in
    every layer: the port's random tree has the leaves (names, shapes,
    dtypes) of the reference's tree carried over by ``bridge``, and
    ``decode_step`` runs on it, exact and clustered."""
    cfg = configs.get_reduced(name)
    cfg_t = configs_t.get_reduced(name)
    want = bridge.params_from_numpy(
        jax.tree.map(np.asarray, ref_init_params(cfg)),
        cfg_t, "cpu")
    got = tfm_t.init_params(0, cfg_t, device="cpu")

    def leaves(tree, path=()):
        if isinstance(tree, dict):
            for k in sorted(tree):
                yield from leaves(tree[k], path + (k,))
        elif isinstance(tree, list):
            for i, v in enumerate(tree):
                yield from leaves(v, path + (i,))
        else:
            yield path, tuple(tree.shape), tree.dtype

    assert list(leaves(got)) == list(leaves(want))
    assert all("post_attn_norm" in lp and "post_mlp_norm" in lp
               for lp in got["layers"])
    toks = torch.zeros((2, 1), dtype=torch.int32)
    for kv_mode in ("exact", "clustered"):
        cache = tfm_t.init_cache(cfg_t, 2, 32, kv_mode=kv_mode,
                                 kv_clusters=4, kv_tail=8, device="cpu")
        logits, _ = tfm_t.decode_step(got, cfg_t, cache, toks, 3)
        assert logits.shape == (2, cfg_t.padded_vocab)
        assert torch.isfinite(logits.float()).all()
