"""The port's MLA attention (``repro_torch.models.attention``'s ``mla_*``)
and the reduced deepseek-v3-671b stack against the reference on the same
seeded inputs.

Parameters come from the reference's ``init_params`` and cross by value
through ``bridge`` (``q_norm`` and ``kv_norm`` stay f32, as the reference
reads them uncast); inputs are numpy draws from a seed.  All in f32 on the
reduced deepseek-v3-671b (4 heads, q_lora 64, kv_lora 32, nope 32, rope
16, v 32; one dense prefix layer, then MoE layers).  Tolerance: 1e-5 on
every output, cache and logit.
"""

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
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.models import attention as attn_t
from repro_torch.models import transformer as tfm_t

T = torch.from_numpy
ARCH = "deepseek-v3-671b"


def _configs(dtype="float32"):
    return (dataclasses.replace(configs.get_reduced(ARCH), dtype=dtype),
            dataclasses.replace(configs_t.get_reduced(ARCH), dtype=dtype))


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


@pytest.fixture(scope="module")
def model():
    """(cfg, cfg_t, reference params, port params) of the reduced model."""
    cfg, cfg_t = _configs()
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    return cfg, cfg_t, params, pt


@pytest.fixture(scope="module")
def layer(model):
    """The first layer's MLA parameters on both sides and a (2, 12, d)
    input."""
    cfg, cfg_t, params, pt = model
    x = np.random.default_rng(3).normal(size=(2, 12, cfg.d_model)).astype(
        np.float32)
    return cfg, cfg_t, params["prefix"][0]["attn"], pt["layers"][0]["attn"], x


def test_mla_q_and_latent_match(layer):
    cfg, cfg_t, p, pt, x = layer
    pos = np.arange(12)
    qn, qr = attn._mla_q(p, jnp.asarray(x), cfg, jnp.asarray(pos))
    qnt, qrt = attn_t._mla_q(pt, T(x), cfg_t, T(pos))
    _close(qnt.numpy(), qn, "q_nope")
    _close(qrt.numpy(), qr, "q_rope")
    ckv, kpe = attn._mla_latent(p, jnp.asarray(x), cfg, jnp.asarray(pos))
    ckvt, kpet = attn_t._mla_latent(pt, T(x), cfg_t, T(pos))
    assert ckvt.shape == (2, 12, cfg.mla.kv_lora_rank)
    assert kpet.shape == (2, 12, cfg.mla.qk_rope_head_dim)
    _close(ckvt.numpy(), ckv, "ckv")
    _close(kpet.numpy(), kpe, "kpe")


@pytest.mark.parametrize("chunk_kv", [1024, 5])
def test_mla_train_matches(layer, chunk_kv):
    """The expanded form, in one key chunk and in chunks of 5 (the last
    one short)."""
    cfg, cfg_t, p, pt, x = layer
    pos = np.arange(12)
    y = attn.mla_train(p, jnp.asarray(x), cfg, positions=jnp.asarray(pos),
                       chunk_kv=chunk_kv)
    yt = attn_t.mla_train(pt, T(x), cfg_t, positions=T(pos),
                          chunk_kv=chunk_kv)
    _close(yt.numpy(), y, "mla_train")


def _prefill_both(layer, max_seq=16):
    cfg, cfg_t, p, pt, x = layer
    pos = np.arange(12)
    y, c = attn.mla_prefill(p, jnp.asarray(x), cfg,
                            positions=jnp.asarray(pos), max_seq=max_seq)
    yt, ct = attn_t.mla_prefill(pt, T(x), cfg_t, positions=T(pos),
                                max_seq=max_seq)
    return y, c, yt, ct


def test_mla_prefill_matches(layer):
    y, c, yt, ct = _prefill_both(layer)
    _close(yt.numpy(), y, "mla_prefill y")
    assert set(ct) == {"ckv", "kpe"}
    for k in ("ckv", "kpe"):
        assert ct[k].shape == c[k].shape == (2, 16, c[k].shape[-1])
        _close(ct[k].numpy(), c[k], k)
        assert not ct[k][:, 12:].any()


@pytest.mark.parametrize("t", [12, "per_slot", "past_max_seq"])
def test_mla_decode_matches(layer, t):
    """The absorbed decode over the prefill's latent: a scalar t, a
    per-slot t where slot 1 rewrites position 7 and masks the rest, and a
    slot at t = max_seq, whose write the reference drops (its cache rows
    stay as they were, and it attends to all of them)."""
    cfg, cfg_t, p, pt, _ = layer
    _, c, _, ct = _prefill_both(layer)
    tv = {12: 12, "per_slot": np.array([12, 7], np.int32),
          "past_max_seq": np.array([16, 12], np.int32)}[t]
    before = {k: ct[k].clone() for k in ct}
    x1 = np.random.default_rng(4).normal(size=(2, 1, cfg.d_model)).astype(
        np.float32)
    y, c2 = attn.mla_decode(p, jnp.asarray(x1), cfg, cache=c,
                            t=jnp.asarray(tv))
    yt, ct2 = attn_t.mla_decode(pt, T(x1), cfg_t, cache=ct,
                                t=T(np.asarray(tv)))
    _close(yt.numpy(), y, "mla_decode y")
    for k in ("ckv", "kpe"):
        _close(ct2[k].numpy(), c2[k], k)
    assert ct2["ckv"] is ct["ckv"]            # written in place
    if t == "past_max_seq":
        for k in ("ckv", "kpe"):
            assert torch.equal(ct2[k][0], before[k][0])


def test_mla_decode_equals_expanded_prefill(layer):
    """The absorbed decode of position 11 equals the expanded form's last
    row over the same 12 positions (the algebra of absorbing W_uk)."""
    cfg, cfg_t, _, pt, x = layer
    _, ct = attn_t.mla_prefill(pt, T(x[:, :11]), cfg_t,
                               positions=torch.arange(11), max_seq=16)
    y1, _ = attn_t.mla_decode(pt, T(x[:, 11:]), cfg_t, cache=ct, t=11)
    full = attn_t.mla_train(pt, T(x), cfg_t, positions=torch.arange(12))
    _close(y1[:, 0].numpy(), full[:, 11].numpy(), "absorbed vs expanded")


def test_mixed_chunk_on_mla_raises(model):
    cfg, cfg_t, _, pt = model
    cache = tfm_t.init_cache(cfg_t, 2, 16, device="cpu")
    with pytest.raises(NotImplementedError, match="MLA latent caches"):
        tfm_t.decode_step(pt, cfg_t, cache, torch.zeros(2, 4, dtype=torch.int32),
                          torch.tensor([0, 0]), chunk_len=torch.tensor([4, 1]))


def test_prefill_and_decode_steps_match(model):
    """The whole reduced model: a right-padded 21-token prefill (logits at
    position 17), then 8 one-token steps at per-slot positions, the latent
    caches carried along: logits within 1e-5 at every step, and the
    caches too."""
    cfg, cfg_t, params, pt = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 21)).astype(np.int32)
    lw, cw = jax.jit(lambda tk: tfm.prefill(params, cfg, tk, max_seq=32,
                                            last_pos=17))(jnp.asarray(toks))
    lg, cg = tfm_t.prefill(pt, cfg_t, T(toks), max_seq=32, last_pos=17)
    _close(lg.numpy(), lw, "prefill logits")
    step = jax.jit(lambda c, tk, t: tfm.decode_step(params, cfg, c, tk, t))
    t = np.array([18, 21], np.int32)
    for k in range(8):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        lw, cw = step(cw, jnp.asarray(tok), jnp.asarray(t))
        lg, cg = tfm_t.decode_step(pt, cfg_t, cg, T(tok), T(t))
        _close(lg.numpy(), lw, f"decode step {k}")
        t = t + 1
    back = bridge.cache_from_numpy(jax.tree.map(np.asarray, cw), cfg_t)
    for i, (a, b) in enumerate(zip(cg["layers"], back["layers"])):
        for k in ("ckv", "kpe"):
            _close(a[k].numpy(), b[k].numpy(), f"layer {i} {k}")


def test_init_params_and_bridge_round_trip():
    """The port's init has every leaf of the reference's, DeepSeek's MTP
    head ("mtp") included, with the shape and dtype the bridge gives it
    (``q_norm`` and ``kv_norm`` f32 in a bf16 model); the reference's
    params cross to the port and back bit for bit, "mtp" with them."""
    cfg, cfg_t = _configs("bfloat16")
    params = jax.tree.map(np.asarray, ref_init_params(cfg))
    assert "mtp" in params
    pt = bridge.params_from_numpy(params, cfg_t, "cpu")
    own = tfm_t.init_params(0, cfg_t, device="cpu")
    assert "mtp" in own and "mtp" in pt

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

    walk(pt, own, "")
    for lp in pt["layers"]:
        a = lp["attn"]
        assert set(a) == {"wdq", "q_norm", "wuq", "wdkv", "kv_norm", "wukv",
                          "wkr", "wo"}
        assert a["q_norm"].dtype == a["kv_norm"].dtype == torch.float32
        assert a["wukv"].dtype == torch.bfloat16
    cfg32, cfg32_t = _configs()
    p32 = jax.tree.map(np.asarray, ref_init_params(cfg32))
    back = bridge.params_to_numpy(bridge.params_from_numpy(p32, cfg32_t,
                                                           "cpu"), cfg32_t)
    flat_a = jax.tree_util.tree_leaves_with_path(p32)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(np.asarray(flat_b[path]), a), path


def test_cache_layout_matches_reference(model):
    """``init_cache`` gives every MLA layer the latent leaf, whatever
    ``kv_mode`` asks, as the reference's does."""
    cfg, cfg_t, _, _ = model
    for mode in ("exact", "clustered"):
        ref = jax.tree.map(np.asarray, tfm.init_cache(
            cfg, 2, 24, kv_mode=mode, kv_clusters=4, kv_tail=8))
        got = tfm_t.init_cache(cfg_t, 2, 24, kv_mode=mode, kv_clusters=4,
                               kv_tail=8, device="cpu")
        want = bridge.cache_from_numpy(ref, cfg_t)
        assert len(got["layers"]) == cfg.n_layers
        for a, b in zip(got["layers"], want["layers"]):
            assert set(a) == set(b) == {"ckv", "kpe"}
            for k in a:
                assert a[k].shape == b[k].shape and a[k].dtype == b[k].dtype
