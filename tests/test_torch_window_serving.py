"""The port's Server against the reference Server on models with
sliding-window ('L') layers and on paged exact KV under QuotaRetention.

Twins of tests/test_serving_engine.py's ``TestWindowedServing`` (GLWIN,
the reference's tiny 'GL' config: chunked dense and chunked paged
admission give the reference's blocking tokens, with its
``kv_retired_window`` and ``kv_retired_frontier``), ``TestQuotaRetention``
(TINY through an oversubscribed pool with no ``kv_compress``, blocking
and chunked: the static engine's exact tokens while admissions defer,
with the reference's ``kv_retired_quota``),
``test_sliding_window_layers_stay_exact_under_compaction`` (exact and
clustered) and ``TestPagedEngine.test_validation`` (the gates that
replace the port's old refusals).  Every reference serve runs once a
module (module-scoped fixtures), so its jits compile once."""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_ref import ref_init_params
from repro.core import kv_compress
from repro.core.request_cluster import Request
from repro.models.config import ModelConfig
from repro.runtime.kv_pool import PagedKVConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime.kv_pool import PagedKVConfig as PagedKVConfigT
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

_GLWIN_KW = dict(name="tiny-gl", family="dense", n_layers=2, d_model=32,
                 n_heads=2, n_kv_heads=2, head_dim=16, d_ff=64, vocab=64,
                 pad_vocab_multiple=16, dtype="float32", layer_pattern="GL",
                 sliding_window=16)
_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
GLWIN, GLWIN_T = ModelConfig(**_GLWIN_KW), ModelConfigT(**_GLWIN_KW)
TINY, TINY_T = ModelConfig(**_TINY_KW), ModelConfigT(**_TINY_KW)
# TestWindowedServing's: prompts fit the tail ring but exceed the window,
# budgets push positions past keep_recent so compactions run mid-decode
WIN_CC = dict(n_clusters=4, iters=2, keep_recent=32, refresh_every=4)
WIN_SPEC, WIN_SEED = [(26, 10), (12, 6), (20, 8), (8, 5)], 13
# tests/test_serving_engine.py's ``pieces`` stream
PIECES = [(5, 4), (23, 6), (9, 3), (17, 5), (6, 1), (21, 4)]
WINDOW_STATS = ("kv_retired_window", "kv_retired_frontier",
                "kv_retired_quota", "decode_steps", "kv_compactions",
                "prefill_chunks", "state_bytes_ring")


def _pair(cfg, cfg_t, seed):
    params = ref_init_params(cfg, seed)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                            cfg_t, "cpu")


def _requests(spec, seed):
    rng = np.random.default_rng(seed)
    prompts = {i: rng.integers(0, 64, size=(l,)).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    return ([Request(i, l, g) for i, (l, g) in enumerate(spec)],
            [RequestT(i, l, g) for i, (l, g) in enumerate(spec)], prompts)


def _kw_t(kw):
    """A reference ServerConfig's keywords with the port's config types."""
    out = dict(kw)
    if out.get("kv_compress") is not None:
        out["kv_compress"] = kv_t.KVCompressConfig(
            **dataclasses.asdict(out["kv_compress"]))
    if out.get("paged") is not None:
        out["paged"] = PagedKVConfigT(**dataclasses.asdict(out["paged"]))
    return out


class _Twin:
    """Serve a stream through the reference and the port under the same
    ServerConfig keywords; each reference serve is kept by its keys."""

    def __init__(self, cfg, cfg_t, seed, spec, req_seed):
        self.cfg, self.cfg_t = cfg, cfg_t
        self.params, self.pt = _pair(cfg, cfg_t, seed)
        self.reqs, self.reqs_t, self.prompts = _requests(spec, req_seed)
        self._ref = {}

    def ref(self, **kw):
        key = repr(sorted(kw.items()))
        if key not in self._ref:
            srv = Server(self.cfg, ServerConfig(**kw), self.params)
            out = {o.uid: o.tokens for o in srv.serve(self.reqs,
                                                      self.prompts)}
            self._ref[key] = (out, srv.last_stats)
        return self._ref[key]

    def port(self, **kw):
        srv = ServerT(self.cfg_t, ServerConfigT(**_kw_t(kw)), self.pt,
                      device="cpu")
        out = {o.uid: o.tokens for o in srv.serve(self.reqs_t,
                                                  self.prompts)}
        return out, srv.last_stats


@pytest.fixture(scope="module")
def win():
    return _Twin(GLWIN, GLWIN_T, 7, WIN_SPEC, WIN_SEED)


@pytest.fixture(scope="module")
def tiny():
    return _Twin(TINY, TINY_T, 0, PIECES, 0)


def _same_stats(st, st_ref, keys=WINDOW_STATS):
    for key in keys:
        assert st[key] == st_ref[key], key


# ---------------------------------------------------------------------------
# TestWindowedServing
# ---------------------------------------------------------------------------


def _win_kw(**kw):
    return dict(batch_size=2, max_seq=64,
                kv_compress=kv_compress.KVCompressConfig(**WIN_CC), **kw)


def test_windowed_blocking_dense_equals_reference(win):
    want, st_ref = win.ref(**_win_kw())
    got, st = win.port(**_win_kw())
    assert got == want
    assert st_ref["kv_retired_window"] > 0
    _same_stats(st, st_ref)


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_windowed_chunked_equals_blocking(win, paged):
    """Chunked admission, dense and paged, gives the reference's blocking
    tokens; both retention policies retire what the reference's chunked
    serve of the same mode retires."""
    want, _ = win.ref(**_win_kw())
    kw = _win_kw(prefill_chunk=8,
                 paged=PagedKVConfig(block_size=4) if paged else None)
    _, st_ref = win.ref(**kw)
    got, st = win.port(**kw)
    assert got == want
    assert st["kv_retired_window"] > 0 and st["kv_retired_frontier"] > 0
    assert st["prefill_chunks"] > 0
    _same_stats(st, st_ref)
    if paged:
        assert st["pool_blocks_end"] == 0.0
        _same_stats(st, st_ref, ("pool_allocs", "pool_frees",
                                 "pool_blocks_peak", "launch_pad_frac"))


def test_windowed_paged_blocking_equals_dense(win):
    want, _ = win.ref(**_win_kw())
    kw = _win_kw(paged=PagedKVConfig(block_size=4))
    _, st_ref = win.ref(**kw)
    got, st = win.port(**kw)
    assert got == want
    _same_stats(st, st_ref, WINDOW_STATS + ("pool_allocs", "pool_frees"))
    assert st["pool_blocks_end"] == 0.0


# ---------------------------------------------------------------------------
# TestQuotaRetention
# ---------------------------------------------------------------------------


STATIC_KW = dict(batch_size=1, max_seq=64, engine="static",
                 use_clustered_batching=False)


@pytest.mark.parametrize("chunk", [0, 8], ids=["blocking", "chunked"])
def test_quota_oversubscribed_burst(tiny, chunk):
    """8 blocks against the 13-block peak two full requests would need at
    once: admissions defer, every request completes with the static
    engine's exact tokens, positions retire only at request exit."""
    want, _ = tiny.ref(**STATIC_KW)
    kw = dict(batch_size=2, max_seq=64, prefill_chunk=chunk,
              paged=PagedKVConfig(block_size=4, pool_blocks=8))
    got_ref, st_ref = tiny.ref(**kw)
    assert got_ref == want
    got, st = tiny.port(**kw)
    assert got == want
    assert st["kv_retired_quota"] > 0
    assert st["kv_retired_frontier"] == 0.0
    assert st["pool_blocks_end"] == 0.0
    assert st["pool_occupancy_peak"] <= 1.0
    _same_stats(st, st_ref, WINDOW_STATS + (
        "pool_allocs", "pool_frees", "pool_blocks_peak",
        "pool_occupancy_peak", "kv_frag", "kv_alloc_tokens_peak"))


def test_quota_deferral_is_admission_only(tiny, monkeypatch):
    """Every refusal of the pool under QuotaRetention is an admission's
    reservation: the decode rows' blocks were reserved up front, so no
    slot stalls mid-decode and the refused calls are whole-depth claims."""
    from repro_torch.runtime import kv_pool as kv_pool_t

    claims = []
    ensure = kv_pool_t.BlockPool.ensure

    def spy(self, slot, blocks, pairs=None):
        try:
            return ensure(self, slot, blocks, pairs)
        except kv_pool_t.PoolExhausted:
            claims.append(list(blocks))
            raise

    monkeypatch.setattr(kv_pool_t.BlockPool, "ensure", spy)
    want, _ = tiny.ref(**STATIC_KW)
    got, _ = tiny.port(batch_size=2, max_seq=64,
                       paged=PagedKVConfig(block_size=4, pool_blocks=8))
    assert got == want
    assert claims and all(c == list(range(len(c))) for c in claims)


# ---------------------------------------------------------------------------
# test_sliding_window_layers_stay_exact_under_compaction
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def glc():
    return _Twin(GLWIN, GLWIN_T, 1, [(30, 6), (12, 6), (25, 6)], 4)


@pytest.mark.parametrize("mode", ["exact", "clustered"])
def test_sliding_window_layers_stay_exact_under_compaction(glc, mode):
    """compact_kv never clusters an 'L' ring, and a windowed model admits
    at its exact prompt length whatever ``prefill_bucket`` says: exact
    continuous serving gives the static engine's tokens, and clustered
    serving gives the reference's clustered tokens, with its window
    retirement."""
    if mode == "exact":
        want, _ = glc.ref(**STATIC_KW)
        kw = dict(batch_size=2, max_seq=64, prefill_bucket=16)
        got_static, _ = glc.port(**STATIC_KW)
        assert got_static == want
    else:
        kw = dict(batch_size=2, max_seq=64,
                  kv_compress=kv_compress.KVCompressConfig(
                      n_clusters=4, iters=2, keep_recent=8,
                      refresh_every=4))
        want, st_ref = glc.ref(**kw)
        assert st_ref["kv_compactions"] > 0
    got, st = glc.port(**kw)
    assert got == want
    assert sorted(got) == [0, 1, 2]
    for toks in got.values():
        assert len(toks) == 6
        assert all(0 <= t < GLWIN.padded_vocab for t in toks)
    if mode == "clustered":
        _same_stats(st, st_ref)


# ---------------------------------------------------------------------------
# TestPagedEngine.test_validation
# ---------------------------------------------------------------------------


def test_paged_validation_matches_reference(tiny):
    """Paged serving without kv_compress is exact KV under QuotaRetention:
    whole blocks must tile max_seq; with kv_compress they must tile
    keep_recent; MLA's latent caches have no retention policy.  The port
    raises where the reference raises, with the same words."""
    ccfg = kv_compress.KVCompressConfig(n_clusters=8, iters=4,
                                        keep_recent=16, refresh_every=8)
    mla = dataclasses.replace(TINY_T, attn_kind="mla")
    for kw, cfg_t, match in (
            (dict(max_seq=30, paged=PagedKVConfig(block_size=4)), TINY_T,
             "max_seq"),
            (dict(kv_compress=ccfg, paged=PagedKVConfig(block_size=5)),
             TINY_T, "block_size"),
            (dict(kv_compress=ccfg, paged=PagedKVConfig(block_size=4)), mla,
             "latent KV")):
        with pytest.raises(ValueError, match=match):
            ServerT(cfg_t, ServerConfigT(**_kw_t(kw)), tiny.pt, device="cpu")
        if cfg_t is TINY_T:
            with pytest.raises(ValueError, match=match):
                Server(TINY, ServerConfig(**kw), tiny.params)
    # and a block size that tiles max_seq serves
    ServerT(TINY_T, ServerConfigT(max_seq=32, paged=PagedKVConfigT(4)),
            tiny.pt, device="cpu")
