"""The bridge carries the reference's parameter and cache trees into the
PyTorch port and back by value: a round trip returns identical numpy
trees (bf16 included), weights are cast to the config dtype once while
norm scales stay f32, and the port's entry points default to CUDA."""

import dataclasses

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from repro.models import transformer as tfm
from repro.models.config import ModelConfig
from repro_torch import bridge
from repro_torch.models import transformer as tfm_t
from repro_torch.models.config import ModelConfig as ModelConfigT

_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
TINY = ModelConfig(**_TINY_KW)
TINY_T = ModelConfigT(**_TINY_KW)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, f"{prefix}/{k}"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {f"{prefix}#len": len(tree)}
        for i, v in enumerate(tree):
            out.update(_flat(v, f"{prefix}[{i}]"))
        return out
    return {prefix: tree}


def _assert_same_tree(a, b):
    fa, fb = _flat(a), _flat(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if k.endswith("#len"):
            assert fa[k] == fb[k], k
            continue
        x, y = np.asarray(fa[k]), np.asarray(fb[k])
        assert x.dtype == y.dtype and x.shape == y.shape, k
        # compare bit patterns so bf16 and NaN payloads count too
        np.testing.assert_array_equal(x.view(np.uint8), y.view(np.uint8),
                                      err_msg=k)


@pytest.fixture(scope="module")
def params_np():
    params = tfm.init_params(jax.random.PRNGKey(0), TINY)
    return jax.tree.map(np.asarray, params)


def test_params_round_trip(params_np):
    pt = bridge.params_from_numpy(params_np, TINY_T, "cpu")
    # qwen3-style pattern "G": every layer came out of params["scan"]
    assert len(pt["layers"]) == TINY.n_layers
    assert pt["layers"][1]["attn"]["wq"].shape == (64, 64)
    _assert_same_tree(bridge.params_to_numpy(pt, TINY_T), params_np)


def test_clustered_bf16_cache_round_trip():
    cfg = dataclasses.replace(TINY, dtype="bfloat16")
    cfg_t = dataclasses.replace(TINY_T, dtype="bfloat16")
    cache = tfm.init_cache(cfg, 2, 32, kv_mode="clustered", kv_clusters=8,
                           kv_tail=16)
    rng = np.random.default_rng(0)

    def fill(leaf):
        a = np.asarray(leaf)
        if a.dtype == np.int32:
            return rng.integers(0, 40, size=a.shape).astype(np.int32)
        return rng.normal(size=a.shape).astype(a.dtype)

    cache_np = jax.tree.map(fill, cache)
    assert np.asarray(cache_np["scan"]["sub0"]["k_tail"]).dtype == \
        ml_dtypes.bfloat16
    ct = bridge.cache_from_numpy(cache_np, cfg_t, "cpu")
    leaf = ct["layers"][0]
    assert leaf["k_cents"].dtype == torch.bfloat16
    assert leaf["k_cents"].shape == (2, 8, 2, 16)      # (B, C, Hkv, Dh)
    assert leaf["counts"].dtype == torch.float32 and leaf["cov"].shape == (2,)
    _assert_same_tree(bridge.cache_to_numpy(ct, cfg_t), cache_np)


def test_bf16_weights_cast_once_norms_stay_f32(params_np):
    cfg_t = dataclasses.replace(TINY_T, dtype="bfloat16")
    pt = bridge.params_from_numpy(params_np, cfg_t, "cpu")
    lp = pt["layers"][0]
    assert lp["attn"]["wq"].dtype == torch.bfloat16
    assert lp["norm1"]["scale"].dtype == torch.float32
    assert pt["final_norm"]["scale"].dtype == torch.float32
    # the same rounding as the reference's per-use astype(bfloat16)
    want = np.asarray(jnp.asarray(params_np["scan"]["sub0"]["attn"]["wq"][0])
                      .astype(jnp.bfloat16))
    np.testing.assert_array_equal(bridge.to_numpy(lp["attn"]["wq"]), want)


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the default is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm_t.init_params(0, TINY_T)
    with pytest.raises(RuntimeError, match="CUDA"):
        tfm_t.init_cache(TINY_T, 2, 32)
    # an explicit CPU request works
    p = tfm_t.init_params(0, TINY_T, device="cpu")
    assert p["embed"]["table"].shape == (TINY.padded_vocab, TINY.d_model)
