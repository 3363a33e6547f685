"""The port's MoE layer (``repro_torch.models.moe``) and the MoE stacks of
``transformer`` against the reference on the same seeded inputs.

Parameters come from the reference's ``init_moe`` / ``init_params`` and
cross by value through ``bridge`` (the router and its selection bias stay
f32, as the reference reads them uncast); inputs are numpy draws from a
seed.  All in f32, on the reduced qwen2-moe-a2.7b (softmax router) and the
reduced deepseek-v3-671b's MoE (sigmoid router, ``norm_topk``, a nonzero
selection bias).  Tolerances: routing indices, ``expert_load`` and
``drop_frac`` exact; the top-k weights and router probabilities within
1e-6; ``y`` within 1e-5 and ``aux_loss`` within 1e-6; whole-model logits
within 1e-5.  A cut ``capacity_factor`` makes experts overflow, so the
dropped set must be the reference's too (a token that lost or kept an
expert output the other did not would miss by far more than 1e-5); the
whole-model steps run both at the config's factor and at a cut one, where
padding rows and decode slots' pad columns take capacity too.

Also the port's twins of ``tests/test_moe.py``'s pins, the bridge's round
trip of the MoE leaves and a dense prefix, and the port's own init.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_ref import ref_init_params
from repro import configs
from repro.models import moe
from repro.models import transformer as tfm
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.models import moe as moe_t
from repro_torch.models import transformer as tfm_t
from repro_torch.models.layers import apply_mlp as apply_mlp_t

T = torch.from_numpy
ARCHS = ["qwen2-moe-a2.7b", "deepseek-v3-671b"]


def _configs(name, dtype="float32", **moe_kw):
    cfg = dataclasses.replace(configs.get_reduced(name), dtype=dtype)
    cfg_t = dataclasses.replace(configs_t.get_reduced(name), dtype=dtype)
    if moe_kw:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **moe_kw))
        cfg_t = dataclasses.replace(cfg_t, moe=dataclasses.replace(
            cfg_t.moe, **moe_kw))
    return cfg, cfg_t


def _moe_params(cfg, cfg_t, seed=0, bias_seed=None):
    """The reference's init_moe and its bridged twin; ``bias_seed`` draws a
    nonzero selection bias (the trainer's state after some updates)."""
    p = jax.tree.map(np.asarray, moe.init_moe(jax.random.PRNGKey(seed), cfg))
    if bias_seed is not None:
        p["bias"] = (np.random.default_rng(bias_seed).normal(
            size=p["bias"].shape) * 0.05).astype(np.float32)
    pt = {k: (bridge.to_torch(v) if k in bridge.F32_KEYS else
              bridge.to_torch(v).to(torch.float32))
          for k, v in p.items() if k != "shared"}
    if "shared" in p:
        pt["shared"] = {k: bridge.to_torch(v) for k, v in p["shared"].items()}
    return jax.tree.map(jnp.asarray, p), pt


def _x(shape, seed, scale=1.0):
    x = (np.random.default_rng(seed).normal(size=shape) * scale).astype(
        np.float32)
    return jnp.asarray(x), T(x)


def _close(got, want, what, tol=1e-5):
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol, err_msg=what)


def _metrics_close(got, want):
    assert torch.equal(got["expert_load"], T(np.asarray(
        want["expert_load"], np.float32))), "expert_load"
    assert float(got["drop_frac"]) == float(want["drop_frac"]), "drop_frac"
    _close(got["aux_loss"].numpy(), np.asarray(want["aux_loss"]), "aux",
           tol=1e-6)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("arch", ARCHS)
def test_route_matches(arch):
    """Top-k indices exact, weights and probabilities within 1e-6."""
    cfg, cfg_t = _configs(arch)
    p, pt = _moe_params(cfg, cfg_t, bias_seed=1)
    xj, xt = _x((48, cfg.d_model), 2)
    w, idx, probs = moe.route(p, xj, cfg)
    wt, idxt, probst = moe_t.route(pt, xt, cfg_t)
    assert idxt.dtype == torch.int32 and wt.dtype == torch.float32
    assert torch.equal(idxt, T(np.array(idx)))
    _close(wt.numpy(), w, "weights", tol=1e-6)
    _close(probst.numpy(), probs, "probs", tol=1e-6)


def test_top_k_ties_go_to_the_lower_index():
    """As ``jax.lax.top_k``: equal values are taken lowest index first."""
    v = np.array([[0.5, 0.9, 0.5, 0.9, 0.1], [0.2, 0.2, 0.2, 0.2, 0.2]],
                 np.float32)
    vals, idx = jax.lax.top_k(jnp.asarray(v), 3)
    vt, it = moe_t._top_k(T(v), 3)
    assert torch.equal(it, T(np.asarray(idx)).long())
    assert torch.equal(vt, T(np.asarray(vals)))


@pytest.mark.parametrize("t", [1, 7, 64, 256, 1000])
def test_capacity_matches(t):
    for arch in ARCHS:
        cfg, cfg_t = _configs(arch)
        assert moe_t.capacity(cfg_t, t) == moe.capacity(cfg, t)
    full = configs_t.get_config("qwen2-moe-a2.7b")
    assert moe_t.capacity(full, t) == moe.capacity(
        configs.get_config("qwen2-moe-a2.7b"), t)


def test_update_router_bias_matches():
    load = np.random.default_rng(0).integers(0, 30, size=8).astype(
        np.float32)
    bias = np.random.default_rng(1).normal(size=8).astype(np.float32)
    want = moe.update_router_bias(jnp.asarray(bias), jnp.asarray(load),
                                  gamma=0.002)
    got = moe_t.update_router_bias(T(bias), T(load), gamma=0.002)
    assert torch.equal(got, T(np.asarray(want)))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cap", [1.25, 0.25])
def test_dispatch_compute_matches(arch, cap):
    """``_dispatch_compute`` at one data shard: y, counts, mean probs and
    the kept share; at capacity factor 0.25 experts overflow."""
    cfg, cfg_t = _configs(arch, capacity_factor=cap)
    p, pt = _moe_params(cfg, cfg_t, bias_seed=3)
    xj, xt = _x((64, cfg.d_model), 4)
    y, counts, pbar, keep = moe._dispatch_compute(p, xj, cfg, 1)
    yt, countst, pbart, keept = moe_t._dispatch_compute(pt, xt, cfg_t)
    assert torch.equal(countst, T(np.asarray(counts, np.float32)))
    assert float(keept) == float(keep)
    if cap < 1:
        assert float(keep) < 1.0
    _close(yt.numpy(), y, "y")
    _close(pbart.numpy(), pbar, "mean probs", tol=1e-6)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("cap,impl", [(1.25, "sharded"), (0.25, "sharded"),
                                      (1.25, "global"), (1.25, "a2a")])
def test_apply_moe_matches(arch, cap, impl):
    """The whole layer with its shared expert: y within 1e-5, expert load
    and drop fraction exact, aux within 1e-6; every ``impl`` reaches the
    one-shard dispatch with no mesh, as in the reference."""
    cfg, cfg_t = _configs(arch, capacity_factor=cap, impl=impl)
    p, pt = _moe_params(cfg, cfg_t, bias_seed=5)
    xj, xt = _x((4, 16, cfg.d_model), 6)
    y, m = moe.apply_moe(p, xj, cfg)
    yt, mt = moe_t.apply_moe(pt, xt, cfg_t)
    assert yt.shape == (4, 16, cfg.d_model)
    _close(yt.numpy(), y, "y")
    _metrics_close(mt, m)
    if cap < 1:
        assert float(m["drop_frac"]) > 0.0


@pytest.mark.parametrize("arch", ARCHS)
def test_apply_moe_matches_in_bf16(arch):
    """bf16 weights and activations (the dtype served at full width):
    routing exact (the router runs in f32 on its f32 weights), y within
    4 bf16 ulps (2^-8 relative) of the output's largest magnitude (the
    two frameworks round the bf16 intermediates at different points)."""
    cfg, cfg_t = _configs(arch, dtype="bfloat16")
    p, _ = _moe_params(cfg, cfg_t, bias_seed=7)
    pt = {k: bridge.to_torch(np.asarray(v)) if k in bridge.F32_KEYS else
          bridge.to_torch(np.asarray(v)).to(torch.bfloat16)
          for k, v in p.items() if k != "shared"}
    if "shared" in p:
        pt["shared"] = {k: bridge.to_torch(np.asarray(v)).to(torch.bfloat16)
                        for k, v in p["shared"].items()}
    x = (np.random.default_rng(8).normal(size=(2, 16, cfg.d_model))
         ).astype(np.float32)
    y, m = moe.apply_moe(p, jnp.asarray(x, jnp.bfloat16), cfg)
    yt, mt = moe_t.apply_moe(pt, T(x).to(torch.bfloat16), cfg_t)
    assert yt.dtype == torch.bfloat16
    assert torch.equal(mt["expert_load"], T(np.asarray(m["expert_load"],
                                                       np.float32)))
    want = np.asarray(y, np.float32)
    err = np.abs(yt.float().numpy() - want)
    assert err.max() <= 4 * 2.0 ** -8 * np.abs(want).max()


def test_combine_is_run_order_free():
    """Each token's output is its K expert outputs added in k order: the
    same whatever other tokens share the launch (a token's y depends on
    the others only through which of its assignments are dropped)."""
    cfg, cfg_t = _configs("qwen2-moe-a2.7b", capacity_factor=8.0)
    _, pt = _moe_params(cfg, cfg_t)
    _, xt = _x((2, 16, cfg.d_model), 9)
    y_all, _ = moe_t.apply_moe(pt, xt, cfg_t)
    y_perm, _ = moe_t.apply_moe(pt, xt.flip(0), cfg_t)
    assert torch.equal(y_all, y_perm.flip(0))


# ---------------------------------------------------------------------------
# twins of tests/test_moe.py
# ---------------------------------------------------------------------------


def _dense_reference_t(p, x, cfg):
    """Every token through its top-k experts, computed directly."""
    m = cfg.moe
    b, s, d = x.shape
    xf = x.reshape(b * s, d)
    w, idx, _ = moe_t.route(p, xf, cfg)
    act = moe_t._act(cfg)
    y = torch.zeros_like(xf)
    for kk in range(m.top_k):
        e = idx[:, kk].long()
        g = act(torch.einsum("td,tdf->tf", xf, p["w_gate"][e]))
        u = torch.einsum("td,tdf->tf", xf, p["w_up"][e])
        y = y + torch.einsum("tf,tfd->td", g * u, p["w_down"][e]) \
            * w[:, kk:kk + 1]
    y = y.reshape(b, s, d)
    if m.n_shared > 0:
        y = y + apply_mlp_t(p["shared"], x, cfg)
    return y


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_matches_dense_reference(arch):
    _, cfg_t = _configs(arch, capacity_factor=8.0)
    p = moe_t.init_moe(torch.Generator().manual_seed(0), cfg_t, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 8, cfg_t.d_model)).astype(np.float32)) * 0.5
    y, metrics = moe_t.apply_moe(p, x, cfg_t)
    np.testing.assert_allclose(y.numpy(), _dense_reference_t(p, x, cfg_t)
                               .numpy(), rtol=2e-4, atol=2e-4)
    assert float(metrics["drop_frac"]) == 0.0


def test_capacity_drops_tokens():
    _, cfg_t = _configs("qwen2-moe-a2.7b", capacity_factor=0.1)
    p = moe_t.init_moe(torch.Generator().manual_seed(0), cfg_t, "cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, 32, cfg_t.d_model)).astype(np.float32))
    _, metrics = moe_t.apply_moe(p, x, cfg_t)
    assert float(metrics["drop_frac"]) > 0.0


def test_global_and_sharded_impls_agree():
    _, cfg_g = _configs("qwen2-moe-a2.7b", capacity_factor=8.0,
                        impl="global")
    _, cfg_s = _configs("qwen2-moe-a2.7b", capacity_factor=8.0,
                        impl="sharded")
    p = moe_t.init_moe(torch.Generator().manual_seed(0), cfg_g, "cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 16, cfg_g.d_model)).astype(np.float32))
    yg, _ = moe_t.apply_moe(p, x, cfg_g)
    ys, _ = moe_t.apply_moe(p, x, cfg_s)
    np.testing.assert_allclose(yg.numpy(), ys.numpy(), rtol=1e-5, atol=1e-5)


def test_sigmoid_router_normalizes():
    _, cfg_t = _configs("deepseek-v3-671b")
    p = moe_t.init_moe(torch.Generator().manual_seed(0), cfg_t, "cpu")
    x = torch.from_numpy(np.random.default_rng(3).normal(
        size=(8, cfg_t.d_model)).astype(np.float32))
    w, idx, _ = moe_t.route(p, x, cfg_t)
    np.testing.assert_allclose(w.sum(-1).numpy(), np.ones(8), rtol=1e-5)
    assert idx.shape == (8, cfg_t.moe.top_k)


def test_router_bias_balancing_converges():
    """The aux-free bias update drives expert load toward uniform."""
    _, cfg_t = _configs("deepseek-v3-671b")
    p = moe_t.init_moe(torch.Generator().manual_seed(0), cfg_t, "cpu")
    x = torch.from_numpy(np.random.default_rng(4).normal(
        size=(4, 64, cfg_t.d_model)).astype(np.float32))

    def imbalance(bias):
        _, m = moe_t.apply_moe(dict(p, bias=bias), x, cfg_t)
        load = m["expert_load"].double()
        return float(load.std(unbiased=False) / max(float(load.mean()),
                                                    1e-9)), m["expert_load"]

    bias = p["bias"]
    imb0, load = imbalance(bias)
    hist = []
    for _ in range(100):
        bias = moe_t.update_router_bias(bias, load, gamma=0.002)
        imb, load = imbalance(bias)
        hist.append(imb)
    assert np.mean(hist[-10:]) < imb0 * 0.6, (imb0, np.mean(hist[-10:]))


# ---------------------------------------------------------------------------
# params and the bridge
# ---------------------------------------------------------------------------


def _prefix_variant(cfg, cfg_t):
    """The reduced qwen2-moe with one dense leading layer (d_ff_dense 80)."""
    kw = dict(n_dense_layers=1, d_ff_dense=80)
    return (dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **kw)),
            dataclasses.replace(cfg_t, moe=dataclasses.replace(cfg_t.moe,
                                                               **kw)))


@pytest.mark.parametrize("prefix", [False, True])
def test_init_params_and_bridge_round_trip(prefix):
    """The port's init has every leaf of the reference's, with the shape
    the bridge gives it and the same dtype (the router and bias f32, the
    experts bf16); the reference's params cross to the port and back
    bit for bit, the dense prefix first."""
    cfg, cfg_t = _configs("qwen2-moe-a2.7b", "bfloat16")
    if prefix:
        cfg, cfg_t = _prefix_variant(cfg, cfg_t)
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
    first = pt["layers"][0]
    if prefix:
        assert "mlp" in first and first["mlp"]["w_up"].shape == (
            cfg.d_model, 80)
    assert pt["layers"][-1]["moe"]["router"].dtype == torch.float32
    assert pt["layers"][-1]["moe"]["w_gate"].shape == (
        cfg.moe.n_routed, cfg.d_model, cfg.moe.d_expert)
    # round trip in f32 (bf16 masters would round on the way in)
    cfg32, cfg32_t = _configs("qwen2-moe-a2.7b")
    if prefix:
        cfg32, cfg32_t = _prefix_variant(cfg32, cfg32_t)
    p32 = jax.tree.map(np.asarray, ref_init_params(cfg32))
    back = bridge.params_to_numpy(bridge.params_from_numpy(p32, cfg32_t,
                                                           "cpu"), cfg32_t)
    flat_a = jax.tree_util.tree_leaves_with_path(p32)
    flat_b = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat_a) == len(flat_b)
    for path, a in flat_a:
        assert np.array_equal(np.asarray(flat_b[path]), a), path


# ---------------------------------------------------------------------------
# whole models
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module", params=["plain", "prefix", "overflow"])
def model(request):
    """(cfg, cfg_t, params, port params): the reduced qwen2-moe, its
    one-dense-layer variant, and the reduced model with capacity factor
    0.25, where every launch overflows its experts."""
    cfg, cfg_t = _configs("qwen2-moe-a2.7b")
    if request.param == "prefix":
        cfg, cfg_t = _prefix_variant(cfg, cfg_t)
    elif request.param == "overflow":
        cfg, cfg_t = _configs("qwen2-moe-a2.7b", capacity_factor=0.25)
    params = ref_init_params(cfg, 1)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    return cfg, cfg_t, params, pt


def test_prefill_and_decode_steps_match(model):
    """A 37-token prefill of two prompts, mixed launches of two slots at
    different depths (a 5-token chunk beside a decode row's pad columns,
    then two chunks), and one-token steps, the exact caches carried
    along: logits within 1e-5 at every step."""
    cfg, cfg_t, params, pt = model
    rng = np.random.default_rng(1)
    toks = rng.integers(0, cfg.vocab, size=(2, 37)).astype(np.int32)
    lw, cw = jax.jit(lambda tk: tfm.prefill(params, cfg, tk, max_seq=64,
                                            last_pos=30))(jnp.asarray(toks))
    lg, cg = tfm_t.prefill(pt, cfg_t, T(toks), max_seq=64, last_pos=30)
    _close(lg.numpy(), lw, "prefill logits")
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
        _close(lg.numpy(), lw, f"mixed step {si}")
        t = t + cl
    for k in range(3):
        tok = rng.integers(0, cfg.vocab, size=(2, 1)).astype(np.int32)
        lw, cw = step1(cw, jnp.asarray(tok), jnp.asarray(t))
        lg, cg = tfm_t.decode_step(pt, cfg_t, cg, T(tok), T(t))
        _close(lg.numpy(), lw, f"decode step {k}")
        t = t + 1


def test_mixed_sublayer_matches_on_every_row(model):
    """One MoE 'G' sublayer in a mixed launch (a 6-token chunk beside a
    decode slot): every row of h within 1e-5, the decode slot's pad
    columns included, since they take expert capacity."""
    cfg, cfg_t, params, pt = model
    li = len(pt["layers"]) - 1
    lp_t = pt["layers"][li]
    lp_j = jax.tree.map(lambda a: jnp.asarray(bridge.to_numpy(a)), lp_t)
    cache_j = tfm.init_sublayer_cache(cfg, "G", 2, 32, 1)
    cache_t = tfm_t.init_sublayer_cache(cfg_t, "G", 2, 32, 1, device="cpu")
    rng = np.random.default_rng(2)
    for key in ("k", "v"):
        fill = rng.normal(size=cache_t[key].shape).astype(np.float32)
        cache_j[key] = jnp.asarray(fill)
        cache_t[key] = T(fill)
    hj, ht = _x((2, 6, cfg.d_model), 3)
    t = np.array([10, 4], np.int32)
    cl = np.array([6, 1], np.int32)
    want, _ = jax.jit(lambda h, c: tfm.sublayer_decode(
        lp_j, h, cfg, "G", c, jnp.asarray(t), kv_repeat=1,
        chunk_len=jnp.asarray(cl)))(hj, cache_j)
    got, _ = tfm_t.sublayer_decode(lp_t, ht, cfg_t, "G", cache_t, T(t),
                                   kv_repeat=1, chunk_len=T(cl))
    _close(got.numpy(), want, "every row")


def test_decode_step_packed_matches(model):
    """Two packed steps over a random paged clustered cache (a chunk of 5
    beside a decode row, then two decode rows, each padded to 8 rows):
    every row's logits within 1e-5, the padding rows' too."""
    cfg, cfg_t, params, pt = model
    rng = np.random.default_rng(3)
    r, bs, c = 16, 4, 8
    b, nt, hkv = 2, r // bs, cfg.n_kv_heads
    nb = b * nt + 1
    cache = tfm.init_cache(cfg, b, 64, kv_mode="clustered", kv_clusters=c,
                           kv_tail=r, kv_pool_blocks=nb, kv_block_size=bs)
    cache = jax.tree.map(np.asarray, cache)
    leaves = [cache["scan"]["sub0"]] + list(cache["prefix"])
    for lv in leaves:
        for key in ("k_cents", "v_cents", "k_tail", "v_tail"):
            lv[key] = rng.normal(size=lv[key].shape).astype(np.float32)
        lv["counts"] = rng.integers(0, 3, size=lv["counts"].shape).astype(
            np.float32)
        lv["cov"] = np.broadcast_to(np.array([0, 5], np.int32),
                                    lv["cov"].shape).copy()
    bt = rng.permutation(nb)[:b * nt].reshape(b, nt).astype(np.int32)
    cache_t = bridge.cache_from_numpy(cache, cfg_t, "cpu")
    cache_j = jax.tree.map(jnp.asarray, cache)
    steps = [[(0, 7, i, 5, i) for i in range(5)] + [(1, 3, 20, 21, 0)],
             [(0, 9, 5, 6, 0), (1, 4, 21, 22, 0)]]
    for rows in steps:
        packed = np.zeros((5, 8), np.int32)
        packed[2] = -1
        packed[:, :len(rows)] = np.asarray(rows, np.int32).T
        width = max(x[4] for x in rows) + 1
        want, cache_j = tfm.decode_step_packed(
            params, cfg, cache_j, *(jnp.asarray(x) for x in
                                    packed[[1, 0, 2, 3, 4]]),
            jnp.asarray(bt), block_size=bs, width=width)
        got, cache_t = tfm_t.decode_step_packed(
            pt, cfg_t, cache_t, *(T(x) for x in packed[[1, 0, 2, 3, 4]]),
            T(bt), block_size=bs, width=width)
        _close(got.numpy(), want, "packed logits, every row")
