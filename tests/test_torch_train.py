"""The port's training forward (``repro_torch.models.transformer``'s
``sublayer_train`` / ``forward_trunk`` / ``chunked_ce``, ``ssm_train``,
``rglru_train``) against the reference on the same inputs, and the port's
twin of ``tests/test_models_parity.py::test_decode_matches_forward``.

All f32 at the reduced configs; parameters from the reference's
``init_params`` carried across by ``bridge``, inputs numpy draws from a
seed.  Tolerances: outputs within 1e-5 (relative and absolute); each
gradient leaf within 1e-4 of the reference's largest entry of that leaf
(``_torch_train.GRAD_TOL``); remat against no remat bit for bit; the decode
twin within the reference test's 2e-2.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_train import (DECODE_ARCHS, close, configs_f32, expert_sets_agree,
                          model)
from repro.models import rglru as rg
from repro.models import ssm
from repro.models import transformer as tfm
from repro_torch.core import tree
from repro_torch.models import attention as attn_t
from repro_torch.models import rglru as rg_t
from repro_torch.models import ssm as ssm_t
from repro_torch.models import transformer as tfm_t
from repro_torch.models.layers import lm_logits

T = torch.from_numpy

#: one layer of each kind: (case, arch, the reference's scan sub-layer,
#: kind).  mla: deepseek-v3's first MoE layer; cross: seamless's first
#: decoder layer over an encoder output; L: gemma2's window layer (sandwich
#: norms, logit softcap)
KINDS = [("gqa", "qwen3-4b", "sub0", "G"), ("window", "gemma2-27b", "sub0",
                                            "L"),
         ("mla", "deepseek-v3-671b", "sub0", "G"),
         ("ssm", "mamba2-2.7b", "sub0", "M"),
         ("rglru", "recurrentgemma-9b", "sub0", "R"),
         ("cross", "seamless-m4t-medium", "sub0", "G")]


def _x(shape, seed):
    return np.random.default_rng(seed).normal(size=shape).astype(
        np.float32) * 0.5


def _layer(arch, sub):
    """The first repeat's ``sub`` layer on both sides, and its index in
    the port's list."""
    cfg, cfg_t, p, pt = model(arch)
    n_prefix = tfm.layout(cfg)[0]
    lp = jax.tree.map(lambda a: a[0], p["scan"][sub])
    return cfg, cfg_t, lp, pt["layers"][n_prefix + int(sub[3:])]


@functools.lru_cache(maxsize=None)
def _ref_sublayer(case):
    """The reference's (h, aux) of the case's layer and the gradients of
    sum(h * ct) + aux with respect to the layer and to x (and to the
    encoder output under cross-attention)."""
    _, arch, sub, kind = next(k for k in KINDS if k[0] == case)
    cfg, _, lp, _ = _layer(arch, sub)
    x, ct, enc = _sublayer_inputs(cfg)

    def f(lp, x, enc):
        ekv = attn_cross_kv(lp, enc, cfg) if enc is not None else None
        h, aux = tfm.sublayer_train(lp, x, cfg, kind,
                                    positions=jnp.arange(x.shape[1]),
                                    kv_repeat=1, enc_kv=ekv)
        return jnp.sum(h * ct) + aux, (h, aux)

    (_, (h, aux)), grads = jax.jit(jax.value_and_grad(
        f, argnums=(0, 1, 2), has_aux=True))(lp, x, enc)
    return jax.tree.map(np.asarray, (h, aux, grads))


def attn_cross_kv(lp, enc, cfg):
    from repro.models import attention as attn

    return attn.cross_kv(lp["xattn"], enc, cfg)


def _sublayer_inputs(cfg):
    x = _x((2, 13, cfg.d_model), 1)
    ct = _x((2, 13, cfg.d_model), 2)
    enc = _x((2, 7, cfg.d_model), 3) if cfg.is_encdec else None
    return x, ct, enc


@pytest.mark.parametrize("case", [k[0] for k in KINDS])
def test_sublayer_train_matches(case):
    """Each layer kind's (h, aux) and the gradients of every parameter and
    of the input: GQA 'G', a window 'L', MLA with a MoE FFN (expert sets
    checked first), an 'M' and an 'R' layer, a decoder layer's
    cross-attention."""
    _, arch, sub, kind = next(k for k in KINDS if k[0] == case)
    cfg, cfg_t, lp, lpt = _layer(arch, sub)
    h, aux, (g_lp, g_x, g_enc) = _ref_sublayer(case)
    x, ct, enc = _sublayer_inputs(cfg)
    lpt = tree.map_(lambda t: t.detach().clone().requires_grad_(True), lpt)
    xt = T(x).requires_grad_(True)
    enct = T(enc).requires_grad_(True) if enc is not None else None
    with expert_sets_agree(cfg):
        ekv = (attn_t.cross_kv(lpt["xattn"], enct, cfg_t)
               if enct is not None else None)
        ht, auxt = tfm_t.sublayer_train(lpt, xt, cfg_t, kind,
                                        positions=torch.arange(13),
                                        enc_kv=ekv)
    close(ht.detach().numpy(), h, f"{case} h")
    close(float(torch.as_tensor(auxt).detach()), aux, f"{case} aux")
    wrt = tree.leaves(lpt) + [xt] + ([enct] if enct is not None else [])
    got = torch.autograd.grad((ht * T(ct)).sum() + auxt, wrt,
                              allow_unused=True)
    want_flat = jax.tree_util.tree_flatten_with_path(g_lp)[0]
    want = dict((jax.tree_util.keystr(kp), a) for kp, a in want_flat)
    paths = _paths(lpt)
    assert len(paths) + 1 + (enct is not None) == len(got)
    for path, g in zip(paths, got):
        w = want[path]
        g = np.zeros_like(w) if g is None else g.numpy()
        scale = max(float(np.abs(w).max()), 1e-30)
        assert float(np.abs(g - w).max()) <= 1e-4 * scale, (case, path)
    close(got[len(paths)].numpy(), g_x, f"{case} dx", tol=1e-4)
    if enct is not None:
        close(got[-1].numpy(), g_enc, f"{case} d enc_out", tol=1e-4)


def _paths(t, prefix=""):
    """jax keystr paths of a port layer dict's leaves, in tree.leaves
    order (a layer dict has no lists)."""
    out = []
    for k, v in t.items():
        if isinstance(v, dict):
            out += _paths(v, f"{prefix}['{k}']")
        else:
            out.append(f"{prefix}['{k}']")
    return out


@pytest.mark.parametrize("form", ["ssm_train", "rglru_train"])
def test_recurrent_train_forms_match(form):
    """``ssm_train`` (the chunked SSD, S not a multiple of the chunk) and
    ``rglru_train`` (the log-depth scan) against the reference's, and
    against stepping the port's decode (the reference's own 2e-3)."""
    arch = "mamba2-2.7b" if form == "ssm_train" else "recurrentgemma-9b"
    key, mod, mod_t = (("ssm", ssm, ssm_t) if form == "ssm_train"
                       else ("rg", rg, rg_t))
    cfg, cfg_t, lp, lpt = _layer(arch, "sub0")
    x = _x((2, 45, cfg.d_model), 4)
    y = jax.jit(lambda p, x: getattr(mod, form)(p, x, cfg))(lp[key], x)
    yt = getattr(mod_t, form)(lpt[key], T(x), cfg_t)
    close(yt.numpy(), y, form)
    seq = (ssm_t.ssm_sequential_ref if form == "ssm_train"
           else rg_t.rglru_sequential_ref)(lpt[key], T(x), cfg_t)
    close(yt.numpy(), seq.numpy(), f"{form} vs sequential", tol=2e-3)


@pytest.mark.parametrize("arch", ["gemma3-4b", "deepseek-v3-671b"])
def test_forward_trunk_remat_matches(arch):
    """``forward_trunk`` with remat equals it without, bit for bit, in h,
    aux and every gradient (gemma3's 'LLLLLG' repeat and its tail, deepseek's
    dense prefix and MoE repeats); h and aux against the reference's."""
    cfg, cfg_t, p, pt = model(arch)
    tokens = np.random.default_rng(5).integers(0, cfg.vocab, size=(2, 17))
    out = {}
    for remat in (True, False):
        ptr = tree.map_(lambda t: t.detach().clone().requires_grad_(True),
                        pt)
        with expert_sets_agree(cfg):
            h, aux = tfm_t.forward_trunk(ptr, cfg_t, T(tokens), remat=remat)
        leaves = tree.leaves(ptr)
        g = torch.autograd.grad((h * h).mean() + aux, leaves,
                                allow_unused=True)
        out[remat] = (h.detach(), aux.detach(), g)
    (h1, a1, g1), (h0, a0, g0) = out[True], out[False]
    assert torch.equal(h1, h0) and torch.equal(a1, a0)
    for x1, x0 in zip(g1, g0):
        assert (x1 is None) == (x0 is None)
        assert x1 is None or torch.equal(x1, x0)
    hr, ar = jax.jit(lambda p, t: tfm.forward_trunk(p, cfg, t, remat=True))(
        p, jnp.asarray(tokens))
    close(h1.numpy(), hr, f"{arch} h")
    close(float(a1), ar, f"{arch} aux")


def test_chunked_ce_masks_and_pads():
    """``chunked_ce`` with masked labels (-1) and S = 20 padded to chunks of
    8, against the reference's, with the nll's gradient with respect to h
    and the embedding; chunks of 4 and of 20 give the same sums."""
    cfg, cfg_t, p, pt = model("gemma2-27b")        # final logit softcap
    rng = np.random.default_rng(6)
    h = rng.normal(size=(2, 20, cfg.d_model)).astype(np.float32)
    labels = rng.integers(0, cfg.vocab, size=(2, 20)).astype(np.int32)
    labels[0, 3:7] = -1
    labels[1, -2:] = -1

    def ref(p, h):
        nll, nv = tfm.chunked_ce(p, cfg, h, jnp.asarray(labels), 8)
        return nll, nv

    (nll, nv), (g_p, g_h) = jax.jit(lambda p, h: (
        ref(p, h), jax.grad(lambda p, h: ref(p, h)[0], argnums=(0, 1))(
            p, h)))(p, h)
    assert float(nv) == 2 * 20 - 6
    ht = T(h).requires_grad_(True)
    table = pt["embed"]["table"].detach().clone().requires_grad_(True)
    emb = dict(pt, embed={"table": table})
    nllt, nvt = tfm_t.chunked_ce(emb, cfg_t, ht, T(labels), 8)
    close(float(nllt.detach()), nll, "nll")
    assert float(nvt) == float(nv)
    dh, dtab = torch.autograd.grad(nllt, [ht, table])
    close(dh.numpy(), g_h, "d h", tol=1e-4)
    close(dtab.numpy(), g_p["embed"]["table"], "d table", tol=1e-4)
    with torch.no_grad():
        for chunk in (4, 20):
            n2, v2 = tfm_t.chunked_ce(pt, cfg_t, T(h), T(labels), chunk)
            close(float(n2), float(nllt), f"chunk {chunk}")
            assert float(v2) == float(nvt)


@pytest.mark.parametrize("arch", DECODE_ARCHS)
def test_decode_matches_forward_trunk(arch):
    """The port's twin of test_decode_matches_forward: ``prefill`` of 12
    tokens plus 8 ``decode_step``s reproduce the logits of the port's own
    ``forward_trunk`` over all 20 (the recurrent layers' parallel prefill,
    as the reference's default)."""
    _, cfg_t, _, pt = model(arch)
    rng = np.random.default_rng(3)
    s, pre = 20, 12
    tokens = T(rng.integers(0, cfg_t.vocab, size=(1, s)))
    with torch.no_grad():
        h, _ = tfm_t.forward_trunk(pt, cfg_t, tokens, remat=False)
        full = lm_logits(pt["embed"], h, cfg_t)
        logits, cache = tfm_t.prefill(pt, cfg_t, tokens[:, :pre], max_seq=s,
                                      recurrent_mode="scan")
        close(logits.numpy(), full[:, pre - 1].numpy(), f"{arch} prefill",
              tol=2e-2)
        for t in range(pre, s):
            logits, cache = tfm_t.decode_step(pt, cfg_t, cache,
                                              tokens[:, t:t + 1], t)
            close(logits.numpy(), full[:, t].numpy(),
                  f"{arch} decode step t={t}", tol=2e-2)


def test_init_params_builds_mtp():
    """``init_params`` builds the reference's "mtp" leaves (shapes and
    dtypes) under mtp_depth > 0."""
    _, cfg_t, p, _ = model("deepseek-v3-671b")
    want = p["mtp"]
    pt = tfm_t.init_params(0, cfg_t, device="cpu")
    got = jax.tree_util.tree_flatten_with_path(
        jax.tree.map(lambda t: np.zeros(t.shape, np.float32), pt["mtp"],
                     is_leaf=torch.is_tensor))[0]
    want = jax.tree_util.tree_flatten_with_path(want)[0]
    assert [(jax.tree_util.keystr(k), a.shape) for k, a in got] == \
        [(jax.tree_util.keystr(k), a.shape) for k, a in want]
    assert "moe" in pt["mtp"]["layer"]
