"""Hypothesis twins, on the port, of the clustered-KV invariants that
tests/test_properties.py holds the reference to: ``TestCoverageFrontier``
(``compress_cache_batched`` then ``recompact_clustered``: summary mass ==
cov · H, no token leaves the ring uncovered, the frontier is monotone and
a drained slot keeps it) and ``TestAbsorbChunkProperties`` (streaming
``absorb_chunk``: the frontier advances to its target, mass is conserved,
the prompt budget confines it, and a no-op target leaves a slot
bit-identical)."""

import numpy as np
import pytest
import torch

hypothesis = pytest.importorskip("hypothesis")
from hypothesis import given, settings, strategies as st  # noqa: E402

from repro_torch.core import kv_compress  # noqa: E402

T = torch.from_numpy


class TestCoverageFrontier:
    @staticmethod
    def _mass_equals_cov(cc):
        h = cc["counts"].shape[2]
        mass = cc["counts"].numpy().sum(axis=(1, 2))
        np.testing.assert_allclose(mass, cc["cov"].numpy() * h, rtol=1e-5,
                                   atol=1e-3)

    @staticmethod
    def _no_uncovered_eviction(cc, lengths, r, refresh):
        cov = cc["cov"].numpy()
        t = np.asarray(lengths)
        assert (cov <= t).all(), (cov, t)
        assert (cov >= t - r).all(), "ring no longer holds an uncovered token"
        ring_pos = kv_compress.ring_positions(r, T(t)).numpy()
        live = (ring_pos >= cov[:, None]) & (ring_pos >= 0) \
            & (ring_pos < t[:, None])
        np.testing.assert_array_equal(live.sum(1), t - cov)
        evict_horizon = t + refresh - r
        assert ((cov >= evict_horizon) | (evict_horizon <= 0)).all(), \
            "a token would be evicted before a compaction covers it"

    @settings(max_examples=8, deadline=None)
    @given(st.sampled_from([(48, 4, 8, 1), (64, 6, 16, 2), (80, 8, 16, 4)]),
           st.sampled_from(["1", "half", "full"]),
           st.integers(0, 10_000))
    def test_compress_and_recompact_conserve_and_cover(self, shape, rmode,
                                                       seed):
        S, C, R, H = shape
        refresh = {"1": 1, "half": max(R // 2, 1), "full": R}[rmode]
        rng = np.random.default_rng(seed)
        cfg = kv_compress.KVCompressConfig(n_clusters=C, iters=2,
                                           keep_recent=R,
                                           refresh_every=refresh)
        B = 2
        lengths = rng.integers(1, S + 1, size=B).astype(np.int32)
        k = T(rng.normal(size=(B, S, H, 8)).astype(np.float32))
        v = T(rng.normal(size=(B, S, H, 8)).astype(np.float32))
        cc = kv_compress.compress_cache_batched(k, v, T(lengths), cfg)
        r = min(R, S)
        self._mass_equals_cov(cc)
        self._no_uncovered_eviction(cc, lengths, r, cfg.refresh)
        for _ in range(3):
            adv = rng.integers(0, cfg.refresh + 1, size=B).astype(np.int32)
            lengths = lengths + adv
            prev_cov = cc["cov"].numpy()
            cc = kv_compress.recompact_clustered(cc, T(lengths), cfg)
            assert (cc["cov"].numpy() >= prev_cov).all()
            self._mass_equals_cov(cc)
            self._no_uncovered_eviction(cc, lengths, r, cfg.refresh)

    @settings(max_examples=6, deadline=None)
    @given(st.integers(0, 10_000))
    def test_drained_slot_frontier_never_regresses(self, seed):
        rng = np.random.default_rng(seed)
        cfg = kv_compress.KVCompressConfig(n_clusters=4, iters=2,
                                           keep_recent=8, refresh_every=4)
        k = T(rng.normal(size=(2, 48, 2, 8)).astype(np.float32))
        cc = kv_compress.compress_cache_batched(k, k, torch.tensor([40, 32]),
                                                cfg)
        cov0 = cc["cov"].numpy()
        cc2 = kv_compress.recompact_clustered(cc, torch.tensor([44, 0]), cfg)
        cov2 = cc2["cov"].numpy()
        assert cov2[1] == cov0[1], "drained slot must keep its frontier"
        assert cov2[0] >= cov0[0]
        self._mass_equals_cov(cc2)


class TestAbsorbChunkProperties:
    @settings(max_examples=8, deadline=None)
    @given(st.sampled_from([(8, 16, 2, 0), (6, 12, 1, 4), (4, 8, 2, 2)]),
           st.integers(1, 6),
           st.integers(0, 10_000))
    def test_streaming_absorb_conserves_and_advances(self, shape, chunk,
                                                     seed):
        C, R, H, budget = shape
        chunk = min(chunk, R)
        rng = np.random.default_rng(seed)
        cfg = kv_compress.KVCompressConfig(n_clusters=C, iters=2,
                                           keep_recent=R, refresh_every=2,
                                           prompt_clusters=budget)
        dh = 8
        z = lambda *s: torch.zeros(s)  # noqa: E731
        cache = {"k_cents": z(1, C, H, dh), "v_cents": z(1, C, H, dh),
                 "counts": z(1, C, H), "k_tail": z(1, R, H, dh),
                 "v_tail": z(1, R, H, dh),
                 "cov": torch.zeros(1, dtype=torch.int32)}
        plen = int(rng.integers(R + 1, 3 * R + 1))  # forces absorption
        fed = 0
        while fed < plen:
            cl = min(chunk, plen - fed)
            cov = int(cache["cov"][0])
            if fed + cl - cov > R:
                # the engine's pre-feed absorb: make ring room for the
                # chunk, keeping the eviction-safety margin
                target = int(np.clip(fed + cl - R + cfg.refresh, 0, fed))
                prev_cov = cov
                cache = kv_compress.absorb_chunk(
                    cache, torch.tensor([fed]), torch.tensor([target]), cfg)
                cov = int(cache["cov"][0])
                assert cov == target >= prev_cov
                np.testing.assert_allclose(cache["counts"].sum().item(),
                                           cov * H, rtol=1e-5, atol=1e-3)
                assert (cache["counts"][0, cfg.prompt_budget:] == 0).all()
            # stream the chunk into the ring at positions fed..fed+cl-1
            for i in range(cl):
                row = T(rng.normal(size=(H, dh)).astype(np.float32))
                cache["k_tail"][0, (fed + i) % R] = row
                cache["v_tail"][0, (fed + i) % R] = row
            fed += cl
        # end-of-admission absorb: the engine's post-feed invariant
        target = int(np.clip(plen - R + cfg.refresh, 0, plen))
        if int(cache["cov"][0]) < target:
            cache = kv_compress.absorb_chunk(
                cache, torch.tensor([plen]), torch.tensor([target]), cfg)
        cov = int(cache["cov"][0])
        assert cov >= plen - R + cfg.refresh
        np.testing.assert_allclose(cache["counts"].sum().item(), cov * H,
                                   rtol=1e-5, atol=1e-3)

    @settings(max_examples=6, deadline=None)
    @given(st.integers(0, 10_000))
    def test_noop_target_keeps_slot_bit_identical(self, seed):
        rng = np.random.default_rng(seed)
        cfg = kv_compress.KVCompressConfig(n_clusters=4, iters=2,
                                           keep_recent=8, refresh_every=2)
        k = T(rng.normal(size=(2, 32, 2, 8)).astype(np.float32))
        lengths = torch.tensor([30, 24], dtype=torch.int32)
        cc = kv_compress.compress_cache_batched(k, k, lengths, cfg)
        out = kv_compress.absorb_chunk(cc, lengths, cc["cov"].clone(), cfg)
        for key in ("k_cents", "v_cents", "counts", "cov"):
            assert torch.equal(out[key], cc[key]), key
