"""The port's frontend stubs, sinusoidal positions, cross-attention and
encoder-decoder stack against the reference on the same seeded inputs:
the reduced seamless-m4t-medium (an audio-stub encoder of 2 layers, a
decoder of 2 layers with cross-attention, LayerNorm, GeGLU, absolute
sinusoidal positions) and the reduced internvl2-76b (a vision stub whose
4 projected patch embeddings are prepended to the text of a decoder-only
GQA stack).

Parameters come from the reference's ``init_params`` and cross by value
through ``bridge``; inputs are numpy draws from a seed.  All in f32;
tolerance 1e-5 on every output and logit.  The reduced internvl2 serves
static and blocking on both packages with equal tokens (text-only: a
request carries no patch embeddings).  An encoder-decoder serves through
the model entry points only: the continuous engine refuses it as the
reference's does, and the static engine raises a ValueError naming the
missing encoder inputs where the reference's fails with an AttributeError
(ROADMAP Queue C 12).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import ref_init_params
from repro import configs
from repro.core.request_cluster import Request
from repro.core import kv_compress
from repro.models import attention as attn
from repro.models import layers
from repro.models import transformer as tfm
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.models import attention as attn_t
from repro_torch.models import layers as layers_t
from repro_torch.models import transformer as tfm_t
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

T = torch.from_numpy
SEAMLESS, INTERNVL = "seamless-m4t-medium", "internvl2-76b"


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


class _Model:
    """A reduced config in f32 on both packages, the reference's params
    and their bridged twin."""

    def __init__(self, arch, **kw):
        self.cfg = dataclasses.replace(configs.get_reduced(arch),
                                       dtype="float32", **kw)
        self.cfg_t = dataclasses.replace(configs_t.get_reduced(arch),
                                         dtype="float32", **kw)
        self.params = ref_init_params(self.cfg)
        self.np = jax.tree.map(np.asarray, self.params)
        self.pt = bridge.params_from_numpy(self.np, self.cfg_t, "cpu")


@pytest.fixture(scope="module")
def seamless():
    return _Model(SEAMLESS)


@pytest.fixture(scope="module")
def internvl():
    return _Model(INTERNVL)


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# the pieces
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("offset", [0, 37, "per_slot"])
def test_sinusoidal_pos_matches(offset):
    """(S, dim) at a scalar offset; (B, S, dim) at per-slot offsets, the
    reference's vmap over slots."""
    if offset == "per_slot":
        off = np.array([0, 5, 300], np.int32)
        want = jax.vmap(lambda o: layers.sinusoidal_pos(4, 64, offset=o))(
            jnp.asarray(off))
        got = layers_t.sinusoidal_pos(4, 64, offset=T(off))
        assert got.shape == (3, 4, 64)
    else:
        want = layers.sinusoidal_pos(9, 64, offset=offset)
        got = layers_t.sinusoidal_pos(9, 64, offset=offset)
        assert got.shape == (9, 64)
    assert got.dtype == torch.float32
    _close(got.numpy(), want, "sinusoidal_pos")


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_apply_frontend_matches(arch, seamless, internvl):
    m = seamless if arch == SEAMLESS else internvl
    e = _x((2, 5, m.cfg.d_model), 1)
    want = layers.apply_frontend(m.params["frontend"], jnp.asarray(e), m.cfg)
    got = layers_t.apply_frontend(m.pt["frontend"], T(e), m.cfg_t)
    _close(got.numpy(), want, "apply_frontend")


@pytest.mark.parametrize("softcap", [None, 5.0])
def test_cross_attention_matches(seamless, softcap):
    """``cross_kv`` over an encoder output and ``cross_attn_apply`` of 6
    decoder rows over its 11 positions (bidirectional), with and without a
    logit softcap."""
    cfg = dataclasses.replace(seamless.cfg, attn_logit_softcap=softcap)
    cfg_t = dataclasses.replace(seamless.cfg_t, attn_logit_softcap=softcap)
    p = seamless.params["scan"]["sub0"]["xattn"]
    p = jax.tree.map(lambda a: a[1], p)                  # decoder layer 1
    pt = seamless.pt["layers"][1]["xattn"]
    enc, x = _x((2, 11, cfg.d_model), 2), _x((2, 6, cfg.d_model), 3)
    k, v = attn.cross_kv(p, jnp.asarray(enc), cfg)
    kt, vt = attn_t.cross_kv(pt, T(enc), cfg_t)
    _close(kt.numpy(), k, "cross k")
    _close(vt.numpy(), v, "cross v")
    y = attn.cross_attn_apply(p, jnp.asarray(x), (k, v), cfg)
    yt = attn_t.cross_attn_apply(pt, T(x), (kt, vt), cfg_t)
    _close(yt.numpy(), y, "cross_attn_apply")


def test_encode_matches(seamless):
    """The bidirectional encoder over 13 frames: every output row."""
    e = _x((2, 13, seamless.cfg.d_model), 4)
    want = tfm.encode(seamless.params, seamless.cfg, jnp.asarray(e))
    got = tfm_t.encode(seamless.pt, seamless.cfg_t, T(e))
    _close(got.numpy(), want, "encode")


def test_no_rope_under_sinusoidal_positions(seamless):
    """A model with absolute positions rotates nothing in its attention:
    the port's projections equal the reference's ``_qkv`` at any
    positions."""
    p = jax.tree.map(lambda a: a[0], seamless.params["scan"]["sub0"]["attn"])
    pt = seamless.pt["layers"][0]["attn"]
    x = _x((1, 5, seamless.cfg.d_model), 5)
    pos = np.arange(100, 105)
    want = attn._qkv(p, jnp.asarray(x), seamless.cfg, jnp.asarray(pos), "G",
                     1)
    got = attn_t._qkv(pt, T(x), seamless.cfg_t, T(pos), "G", 1)
    for a, b in zip(got, want):
        _close(a.numpy(), b, "qkv")


# ---------------------------------------------------------------------------
# whole models: the twin of tests/test_models_smoke.py's prefill + decode
# ---------------------------------------------------------------------------


def _batch(cfg, seed=1, batch=2, seq=32):
    """tests/test_models_smoke.py's ``make_batch`` inputs, numpy."""
    r = np.random.default_rng(seed)
    out = {}
    s_tok = seq
    if cfg.is_encdec:
        s_tok = seq // 2
        out["enc_embeds"] = r.normal(size=(batch, seq // 2, cfg.d_model)
                                     ).astype(np.float32)
    elif cfg.n_frontend_tokens:
        s_tok = seq - cfg.n_frontend_tokens
        out["frontend_embeds"] = r.normal(
            size=(batch, cfg.n_frontend_tokens, cfg.d_model)).astype(
                np.float32)
    out["tokens"] = r.integers(0, cfg.vocab, size=(batch, s_tok)).astype(
        np.int32)
    return out


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_prefill_decode_matches(arch, seamless, internvl):
    """Prefill (the encoder's frames, or the prepended patches) and 3
    greedy decode steps, logits against the reference's at every step and
    the tokens equal."""
    m = seamless if arch == SEAMLESS else internvl
    cfg, cfg_t = m.cfg, m.cfg_t
    b = _batch(cfg)
    extra = {k: v for k, v in b.items() if k != "tokens"}
    lw, cw = jax.jit(lambda p, tk, ex: tfm.prefill(
        p, cfg, tk, max_seq=48, **ex))(m.params, jnp.asarray(b["tokens"]),
                                       jax.tree.map(jnp.asarray, extra))
    lg, cg = tfm_t.prefill(m.pt, cfg_t, T(b["tokens"]), max_seq=48,
                           **{k: T(v) for k, v in extra.items()})
    assert lg.shape == (2, cfg.padded_vocab)
    _close(lg.numpy(), lw, "prefill logits")
    assert ("cross" in cg) == cfg.is_encdec
    t0 = b["tokens"].shape[1] + (0 if cfg.is_encdec
                                 else cfg.n_frontend_tokens)
    step = jax.jit(lambda p, c, tk, t: tfm.decode_step(p, cfg, c, tk, t))
    tk = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)[:, None]
    assert np.array_equal(tk[:, 0], lg.argmax(-1).numpy())
    for i in range(3):
        lw, cw = step(m.params, cw, jnp.asarray(tk), jnp.int32(t0 + i))
        lg, cg = tfm_t.decode_step(m.pt, cfg_t, cg, T(tk), t0 + i)
        _close(lg.numpy(), lw, f"decode step {i}")
        tk = np.asarray(jnp.argmax(lw, -1)).astype(np.int32)[:, None]
        assert np.array_equal(tk[:, 0], lg.argmax(-1).numpy())


def test_per_slot_decode_positions(seamless):
    """Decode at per-slot positions (B,): the sinusoidal offsets and the
    self-attention masks follow each slot's t."""
    cfg, cfg_t = seamless.cfg, seamless.cfg_t
    b = _batch(cfg, seed=2)
    _, cw = tfm.prefill(seamless.params, cfg, jnp.asarray(b["tokens"]),
                        max_seq=40, enc_embeds=jnp.asarray(b["enc_embeds"]))
    _, cg = tfm_t.prefill(seamless.pt, cfg_t, T(b["tokens"]), max_seq=40,
                          enc_embeds=T(b["enc_embeds"]))
    t = np.array([16, 9], np.int32)
    tk = np.array([[3], [77]], np.int32)
    lw, _ = tfm.decode_step(seamless.params, cfg, cw, jnp.asarray(tk),
                            jnp.asarray(t))
    lg, _ = tfm_t.decode_step(seamless.pt, cfg_t, cg, T(tk), T(t))
    _close(lg.numpy(), lw, "per-slot decode")


def test_cross_cache_bridge_round_trip(seamless):
    """The reference's enc-dec prefill cache (self-attention leaves, and
    the encoder keys and values under ``scan["xkv0"]``) crosses to the
    port's ``{"layers", "cross"}`` and back bit for bit, and equals the
    port's own prefill cache within 1e-5."""
    cfg, cfg_t = seamless.cfg, seamless.cfg_t
    b = _batch(cfg, seed=3)
    _, cw = tfm.prefill(seamless.params, cfg, jnp.asarray(b["tokens"]),
                        max_seq=24, enc_embeds=jnp.asarray(b["enc_embeds"]))
    cw = jax.tree.map(np.asarray, cw)
    assert "xkv0" in cw["scan"]
    ct = bridge.cache_from_numpy(cw, cfg_t)
    assert len(ct["cross"]) == cfg.n_layers
    assert all(isinstance(kv, tuple) and len(kv) == 2 for kv in ct["cross"])
    back = bridge.cache_to_numpy(ct, cfg_t)
    flat_a = jax.tree_util.tree_leaves_with_path(cw)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(flat_b[path], a), path
    _, cg = tfm_t.prefill(seamless.pt, cfg_t, T(b["tokens"]), max_seq=24,
                          enc_embeds=T(b["enc_embeds"]))
    for (k, v), (k2, v2) in zip(cg["cross"], ct["cross"]):
        _close(k.numpy(), k2.numpy(), "cross k")
        _close(v.numpy(), v2.numpy(), "cross v")


def test_decode_step_packed_adds_positions():
    """The packed step adds each row's sinusoidal position, as the
    reference's does: a decoder-only variant of the reduced seamless (no
    encoder, no frontend) over a random paged clustered cache, a chunk of
    3 beside a decode row and a padding row: every row's logits within
    1e-5."""
    m = _Model(SEAMLESS, enc_layers=0, frontend=None)
    cfg, cfg_t = m.cfg, m.cfg_t
    rng = np.random.default_rng(6)
    r, bs, c, b = 8, 4, 4, 2
    nt = r // bs
    nb = b * nt + 1
    cache = jax.tree.map(np.asarray, tfm.init_cache(
        cfg, b, 32, kv_mode="clustered", kv_clusters=c, kv_tail=r,
        kv_pool_blocks=nb, kv_block_size=bs))
    lv = cache["scan"]["sub0"]
    for key in ("k_cents", "v_cents", "k_tail", "v_tail"):
        lv[key] = rng.normal(size=lv[key].shape).astype(np.float32)
    lv["counts"] = rng.integers(0, 3, size=lv["counts"].shape).astype(
        np.float32)
    bt = rng.permutation(nb)[:b * nt].reshape(b, nt).astype(np.int32)
    # rows (token, slot, position, watermark, chunk index)
    rows = np.array([(5, 0, 2, 5, 0), (9, 0, 3, 5, 1), (11, 0, 4, 5, 2),
                     (7, 1, 6, 7, 0), (0, 0, -1, 0, 0)], np.int32).T
    want, _ = tfm.decode_step_packed(
        m.params, cfg, jax.tree.map(jnp.asarray, cache),
        *(jnp.asarray(x) for x in rows), jnp.asarray(bt), block_size=bs,
        width=3)
    got, _ = tfm_t.decode_step_packed(
        m.pt, cfg_t, bridge.cache_from_numpy(cache, cfg_t, "cpu"),
        *(T(x) for x in rows), T(bt), block_size=bs, width=3)
    _close(got.numpy(), want, "packed logits, every row")


@pytest.mark.parametrize("arch", [SEAMLESS, INTERNVL])
def test_init_params_and_bridge_round_trip(arch):
    """The port's init has every leaf of the reference's ("frontend",
    "encoder", each decoder layer's "xnorm" / "xattn"), with the shape and
    dtype the bridge gives it; the reference's params cross to the port
    and back bit for bit."""
    cfg = dataclasses.replace(configs.get_reduced(arch), dtype="bfloat16")
    cfg_t = dataclasses.replace(configs_t.get_reduced(arch),
                                dtype="bfloat16")
    params = jax.tree.map(np.asarray, ref_init_params(cfg))
    pt = bridge.params_from_numpy(params, cfg_t, "cpu")
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

    walk(pt, own, "")
    assert "frontend" in pt
    assert ("encoder" in pt) == cfg.is_encdec
    if cfg.is_encdec:
        assert len(pt["encoder"]["layers"]) == cfg.enc_layers
        assert all("xattn" in lp for lp in pt["layers"])
    m = _Model(arch)
    back = bridge.params_to_numpy(m.pt, m.cfg_t)
    flat_a = jax.tree_util.tree_leaves_with_path(m.np)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(np.asarray(flat_b[path]), a), path


# ---------------------------------------------------------------------------
# serving
# ---------------------------------------------------------------------------


def _stream():
    """4 requests of 10-30 prompt tokens, 5-12 new tokens each."""
    rng = np.random.default_rng(12)
    lens = rng.integers(10, 31, size=4)
    prompts = {i: rng.integers(0, 512, size=int(n)).astype(np.int32)
               for i, n in enumerate(lens)}
    return [(i, int(n), int(rng.integers(5, 13)))
            for i, n in enumerate(lens)], prompts


SERVE_MODES = {
    "static": dict(batch_size=2, max_seq=64, engine="static"),
    "blocking": dict(batch_size=2, max_seq=64),
    "clustered": dict(batch_size=2, max_seq=64,
                      kv_compress=kv_compress.KVCompressConfig(
                          n_clusters=8, iters=4, keep_recent=16,
                          refresh_every=8)),
}


@pytest.mark.parametrize("mode", list(SERVE_MODES))
def test_internvl_serves_equal_reference(internvl, mode):
    """Text-only serves of the frontend model: the reference's tokens,
    request for request."""
    kw = SERVE_MODES[mode]
    reqs, prompts = _stream()
    ref = Server(internvl.cfg, ServerConfig(**kw), internvl.params)
    want = {o.uid: o.tokens for o in ref.serve([Request(*r) for r in reqs],
                                               prompts)}
    kwt = dict(kw)
    if kw.get("kv_compress") is not None:
        kwt["kv_compress"] = kv_t.KVCompressConfig(
            **dataclasses.asdict(kw["kv_compress"]))
    srv = ServerT(internvl.cfg_t, ServerConfigT(**kwt), internvl.pt,
                  device="cpu")
    got = {o.uid: o.tokens for o in srv.serve([RequestT(*r) for r in reqs],
                                              prompts)}
    assert got == want
    assert all(len(t) > 0 for t in got.values())


def test_frontend_chunked_is_refused_as_in_the_reference(internvl):
    with pytest.raises(ValueError) as ref:
        Server(internvl.cfg, ServerConfig(prefill_chunk=8), internvl.params)
    with pytest.raises(ValueError) as got:
        ServerT(internvl.cfg_t, ServerConfigT(prefill_chunk=8), internvl.pt,
                device="cpu")
    assert str(got.value) == str(ref.value)
    assert "modality frontend" in str(got.value)


def test_encdec_server_raises_in_both_engines(seamless):
    """Continuous: the reference's NotImplementedError, word for word.
    Static: the port's ValueError names the missing encoder inputs; the
    reference's static engine reaches its encoder with None and fails with
    an AttributeError (ROADMAP Queue C 12, reference side), pinned here on
    its smallest input, one request of one token."""
    reqs, prompts = [(0, 1, 1)], {0: np.array([5], np.int32)}
    ref = Server(seamless.cfg, ServerConfig(batch_size=1, max_seq=8),
                 seamless.params)
    srv = ServerT(seamless.cfg_t, ServerConfigT(batch_size=1, max_seq=8),
                  seamless.pt, device="cpu")
    with pytest.raises(NotImplementedError) as want:
        ref.serve([Request(*r) for r in reqs], prompts)
    with pytest.raises(NotImplementedError) as got:
        srv.serve([RequestT(*r) for r in reqs], prompts)
    assert str(got.value) == str(want.value) == (
        "continuous engine serves decoder-only models")
    ref = Server(seamless.cfg, ServerConfig(batch_size=1, max_seq=8,
                                            engine="static"),
                 seamless.params)
    srv = ServerT(seamless.cfg_t, ServerConfigT(batch_size=1, max_seq=8,
                                                engine="static"),
                  seamless.pt, device="cpu")
    with pytest.raises(AttributeError, match="astype"):
        ref.serve([Request(*r) for r in reqs], prompts)
    with pytest.raises(ValueError, match="needs enc_embeds"):
        srv.serve([RequestT(*r) for r in reqs], prompts)
