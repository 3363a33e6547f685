"""The port's clustered-KV memory manager against the reference on the
same cache: ``absorb_chunk`` and ``recompact_clustered`` give equal counts
and coverage frontiers and centroids equal to 1e-6; a slot whose frontier
does not move keeps a bit-identical bank; total counts equal the new
frontier per head.  The reference runs with exact power-of-two scales
(see tests/_torch_ref.py), except in one case held against it as it
stands."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs
from repro.core import kv_compress as kv
from repro.core import layer_state, retention
from repro_torch import configs as configs_t
from repro_torch.core import kv_compress as kv_t
from repro_torch.core import layer_state as layer_state_t
from repro_torch.core import retention as retention_t

from _torch_ref import exact_pow2_reference  # noqa: F401  (fixture)

T = torch.from_numpy
CFG = dict(n_clusters=8, iters=4, keep_recent=16, refresh_every=8,
           prompt_clusters=6)


def _cache(rng, b=3, c=8, r=16, h=2, dh=16, live_counts=True):
    f = lambda *s: rng.normal(size=s).astype(np.float32)  # noqa: E731
    counts = (rng.integers(1, 5, size=(b, c, h)).astype(np.float32)
              if live_counts else np.zeros((b, c, h), np.float32))
    return {"k_cents": f(b, c, h, dh), "v_cents": f(b, c, h, dh),
            "counts": counts, "k_tail": f(b, r, h, dh),
            "v_tail": f(b, r, h, dh), "cov": np.zeros((b,), np.int32)}


def _run(fn_ref, fn_t, cache, *args):
    want = fn_ref.__wrapped__(jax.tree.map(jnp.asarray, cache),
                              *(jnp.asarray(a) for a in args[:-1]), args[-1])
    got = fn_t({k: T(v.copy()) for k, v in cache.items()},
               *(T(a) for a in args[:-1]), args[-1])
    return jax.tree.map(np.asarray, want), {k: v.numpy()
                                            for k, v in got.items()}


def _assert_close(got, want):
    np.testing.assert_array_equal(got["cov"], want["cov"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    for k in ("k_cents", "v_cents"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, atol=1e-6,
                                   err_msg=k)
    for k in ("k_tail", "v_tail"):
        np.testing.assert_array_equal(got[k], want[k])


def test_ring_positions_and_frontier_match():
    for r, t in [(8, 3), (8, 8), (8, 21), (16, 40)]:
        np.testing.assert_array_equal(
            kv_t.ring_positions(r, torch.tensor([t, 2 * t])).numpy(),
            np.asarray(kv.ring_positions(r, jnp.asarray([t, 2 * t]))))
    cfg, cfg_t = kv.KVCompressConfig(**CFG), kv_t.KVCompressConfig(**CFG)
    for pos in (0, 5, 16, 17, 100):
        assert kv_t.coverage_frontier(pos, cfg_t) == \
            kv.coverage_frontier(pos, cfg)


def test_recompact_matches(exact_pow2_reference):
    rng = np.random.default_rng(0)
    cache = _cache(rng)
    cache["cov"] = np.array([0, 5, 30], np.int32)
    # slot 2's frontier cannot move (lengths 0): its bank must not change
    lengths = np.array([20, 29, 0], np.int32)
    want, got = _run(kv.recompact_clustered, kv_t.recompact_clustered,
                     cache, lengths, kv_t.KVCompressConfig(**CFG))
    _assert_close(got, want)
    assert (got["cov"][:2] > cache["cov"][:2]).all()
    for k in ("k_cents", "v_cents", "counts"):
        np.testing.assert_array_equal(got[k][2], cache[k][2])


def test_recompact_matches_unpatched_reference():
    """Against the reference as it stands, with its jnp.exp2 scale a few
    ulps off 2^f: a key may then round to the neighbouring point of the
    16-bit fixed-point grid, so key centroids agree to one grid step;
    counts, frontiers and value centroids are unaffected."""
    rng = np.random.default_rng(0)
    cache = _cache(rng)
    cache["cov"] = np.array([0, 5, 30], np.int32)
    lengths = np.array([20, 29, 0], np.int32)
    cfg = kv_t.KVCompressConfig(**CFG)
    want, got = _run(kv.recompact_clustered, kv_t.recompact_clustered,
                     cache, lengths, cfg)
    np.testing.assert_array_equal(got["cov"], want["cov"])
    np.testing.assert_array_equal(got["counts"], want["counts"])
    # auto_scale leaves 2 bits of headroom: a step is at most
    # 2 * absmax / 2^(bits - 3)
    absmax = max(np.abs(cache["k_cents"]).max(), np.abs(cache["k_tail"]).max())
    np.testing.assert_allclose(got["k_cents"], want["k_cents"], rtol=0,
                               atol=2 * absmax / 2 ** (cfg.bits - 3))
    np.testing.assert_allclose(got["v_cents"], want["v_cents"], rtol=1e-6,
                               atol=1e-6)


def test_absorb_chunk_matches(exact_pow2_reference):
    """First chunk of a fresh request (all-zero bank, dead rows re-seeded)
    and a slot whose target does not pass its frontier."""
    rng = np.random.default_rng(1)
    cache = _cache(rng, live_counts=False)
    cache["k_cents"][:] = 0.0
    cache["cov"] = np.array([0, 0, 4], np.int32)
    lengths = np.array([16, 12, 16], np.int32)
    target = np.array([10, 7, 2], np.int32)     # slot 2: target < cov
    cfg = kv_t.KVCompressConfig(**CFG)
    want, got = _run(kv.absorb_chunk, kv_t.absorb_chunk, cache, lengths,
                     target, cfg)
    _assert_close(got, want)
    np.testing.assert_array_equal(got["cov"], [10, 7, 4])
    # mass conservation: every absorbed position is counted once per head
    np.testing.assert_array_equal(got["counts"].sum(1)[:2],
                                  np.array([[10, 10], [7, 7]], np.float32))
    # prompt budget: rows past prompt_clusters stay empty
    assert (got["counts"][:, cfg.prompt_budget:] == 0).all()
    for k in ("k_cents", "v_cents", "counts"):
        np.testing.assert_array_equal(got[k][2], cache[k][2])


def test_absorb_then_recompact_chain(exact_pow2_reference):
    """Absorb into a live bank, then re-compact: the chain stays equal and
    total mass tracks the frontier."""
    rng = np.random.default_rng(2)
    cache = _cache(rng, live_counts=False)
    cfg = kv_t.KVCompressConfig(**CFG)
    want, got = _run(kv.absorb_chunk, kv_t.absorb_chunk, cache,
                     np.array([16, 16, 16], np.int32),
                     np.array([6, 9, 12], np.int32), cfg)
    _assert_close(got, want)
    want2, got2 = _run(kv.recompact_clustered, kv_t.recompact_clustered,
                       got, np.array([22, 20, 16], np.int32), cfg)
    _assert_close(got2, want2)
    np.testing.assert_array_equal(got2["counts"].sum(1),
                                  got2["cov"][:, None].astype(np.float32)
                                  .repeat(2, 1))


@pytest.mark.parametrize("arch", ["qwen3-4b", "gemma3-4b", "mamba2-2.7b",
                                  "recurrentgemma-9b"])
def test_layer_state_families_match(arch):
    f = layer_state.families_for(configs.get_config(arch))
    f_t = layer_state_t.families_for(configs_t.get_config(arch))
    assert f_t.ring.kinds == f.ring.kinds
    assert f_t.recurrent_kinds == f.recurrent.kinds
    assert (f_t.has_ring, f_t.has_recurrent) == (f.has_ring, f.has_recurrent)
    for kind in "GLMR":
        assert layer_state_t.family_of_kind(kind) == \
            layer_state.family_of_kind(kind)


def test_frontier_retention_and_ring_bytes_match():
    cfg, cfg_t = kv.KVCompressConfig(**CFG), kv_t.KVCompressConfig(**CFG)
    fr, fr_t = retention.FrontierRetention(3, cfg), \
        retention_t.FrontierRetention(3, cfg_t)
    for pos in (0, 9, 16, 40):
        assert fr_t.target(pos) == fr.target(pos)
    fr.set_frontier(1, 12)
    fr_t.set_frontier(1, 12)
    assert fr_t.retire_lo(1, 30) == fr.retire_lo(1, 30) == 12
    fr_t.on_slot_free(1)
    assert fr_t.frontier(1) == 0
    cache = _cache(np.random.default_rng(3))
    assert layer_state_t.ring_state_bytes(
        {"layers": [{k: T(v) for k, v in cache.items()}]}, 3) == \
        layer_state.ring_state_bytes({"tail": [cache]}, 3)
