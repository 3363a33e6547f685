"""The port's prefix-shared and template-store serves against the
reference Server on TINY (f32), parameters carried over by ``bridge``.

Twins of tests/test_serving_engine.py's ``TestPrefixSharing`` (templated
bursts at refresh 8, where compactions and copy-on-write run, and 12,
where neither does; suffixes longer than a chunk) and of
tests/test_template_store.py's engine tests (a warm second serve, uids
reused for another template, a pool with no room for pins, a store
carried to a Server with other weights, and to one with the same bytes
in a new tree).  Tokens equal the reference's, and so do the sharing,
pool and template stats, exactly.  The port also keeps the reference's
invariants: prefix-shared tokens equal unshared paged tokens, and a warm
store serve equals a cold one.  Every reference scenario is served once
a module (``_Runs``), so its jits compile once."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from _torch_ref import ref_init_params
from repro.core import kv_compress
from repro.core.request_cluster import Request
from repro.models.config import ModelConfig
from repro.runtime.kv_pool import PagedKVConfig
from repro.runtime.prefix_cache import PrefixShareConfig
from repro.runtime.server import Server, ServerConfig
from repro.runtime.template_store import TemplateStore, TemplateStoreConfig
from repro_torch import bridge
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.runtime import prefix_cache as pc_t
from repro_torch.runtime import template_store as ts_t
from repro_torch.runtime.kv_pool import PagedKVConfig as PagedKVConfigT
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

_TINY_KW = dict(name="tiny", family="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
TINY, TINY_T = ModelConfig(**_TINY_KW), ModelConfigT(**_TINY_KW)
# the stats whose equality the port owes the reference
SHARE_STATS = ("prefix_hits", "prefix_tokens_reused", "prefill_chunks",
               "kv_shared_blocks", "kv_bytes_saved", "pool_cow",
               "pool_allocs", "pool_frees", "pool_blocks_end")


def _pair(seed):
    params = ref_init_params(TINY, seed)
    return params, bridge.params_from_numpy(jax.tree.map(np.asarray, params),
                                            TINY_T, "cpu")


def _port_kw(kw):
    """A reference ServerConfig's keywords with the port's types (a
    TemplateStore instance is passed through: the caller gives each side
    its own)."""
    out = dict(kw)
    out["kv_compress"] = kv_t.KVCompressConfig(
        **dataclasses.asdict(kw["kv_compress"]))
    out["paged"] = PagedKVConfigT(**dataclasses.asdict(kw["paged"]))
    if kw.get("prefix_share") is not None:
        out["prefix_share"] = pc_t.PrefixShareConfig(
            **dataclasses.asdict(kw["prefix_share"]))
    if isinstance(kw.get("template_store"), TemplateStoreConfig):
        out["template_store"] = ts_t.TemplateStoreConfig(
            **dataclasses.asdict(kw["template_store"]))
    return out


def _both(reqs):
    return ([Request(*r) for r in reqs], [RequestT(*r) for r in reqs])


def _template_stream(n=6, tpl_len=40, seed=5):
    """TestPrefixSharing's burst: one template, suffixes of 3-8 tokens."""
    rng = np.random.default_rng(seed)
    template = rng.integers(0, 64, size=(tpl_len,)).astype(np.int32)
    reqs, prompts = [], {}
    for i in range(n):
        sfx = rng.integers(0, 64, size=(int(rng.integers(3, 9)),)).astype(
            np.int32)
        prompts[i] = np.concatenate([template, sfx])
        reqs.append((i, len(prompts[i]), int(rng.integers(6, 12))))
    return reqs, prompts


def _long_suffix_stream():
    """test_long_suffixes_still_hit_the_template_entry's: a 24-token
    template, suffixes of 10-20 tokens."""
    rng = np.random.default_rng(11)
    template = rng.integers(0, 64, size=(24,)).astype(np.int32)
    reqs, prompts = [], {}
    for i in range(5):
        sfx = rng.integers(0, 64, size=(int(rng.integers(10, 21)),))
        prompts[i] = np.concatenate([template, sfx]).astype(np.int32)
        reqs.append((i, len(prompts[i]), 5))
    return reqs, prompts


def _store_stream(template_seed=5, sfx_seed=11, n=4, tpl_len=40):
    """tests/test_template_store.py's ``_stream``: uids from 0 in every
    stream, so repeat serves recycle them."""
    rng = np.random.default_rng(template_seed)
    template = rng.integers(0, 64, size=(tpl_len,)).astype(np.int32)
    sfx_rng = np.random.default_rng(sfx_seed)
    reqs, prompts = [], {}
    for i in range(n):
        sfx = sfx_rng.integers(0, 64, size=(
            int(sfx_rng.integers(3, 9)),)).astype(np.int32)
        prompts[i] = np.concatenate([template, sfx])
        reqs.append((i, len(prompts[i]), int(sfx_rng.integers(6, 12))))
    return reqs, prompts


def _share_kw(refresh, **kw):
    return dict(batch_size=2, max_seq=96, prefill_chunk=8,
                kv_compress=kv_compress.KVCompressConfig(
                    n_clusters=8, iters=4, keep_recent=16,
                    refresh_every=refresh),
                paged=PagedKVConfig(block_size=4), **kw)


# tests/test_template_store.py's SCFG: a pool of 24 blocks leaves the pins
# room above the slots' own 8
STORE_KW = dict(batch_size=2, max_seq=96, prefill_chunk=8,
                kv_compress=kv_compress.KVCompressConfig(
                    n_clusters=8, iters=4, keep_recent=16, refresh_every=8),
                paged=PagedKVConfig(block_size=4, pool_blocks=24))
TIGHT_KW = dict(STORE_KW, paged=PagedKVConfig(block_size=4))


def _clone(tree):
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.clone()


class _Runs:
    """Each scenario served once by the reference and once by the port;
    a serve is (tokens by uid, last_stats)."""

    def __init__(self):
        self.w0, self.w1 = _pair(0), _pair(1)
        self._memo = {}

    def get(self, name):
        if name not in self._memo:
            self._memo[name] = getattr(self, "_" + name)()
        return self._memo[name]

    @staticmethod
    def _serve(srv, reqs, prompts, port):
        r, r_t = _both(reqs)
        outs = srv.serve(r_t if port else r, prompts)
        return {o.uid: o.tokens for o in outs}, dict(srv.last_stats)

    def _server(self, port, kw, weights=None):
        params, pt = weights or self.w0
        if port:
            return ServerT(TINY_T, ServerConfigT(**_port_kw(kw)), pt,
                           device="cpu")
        return Server(TINY, ServerConfig(**kw), params)

    def _shared(self, stream, refresh):
        reqs, prompts = stream
        out = {}
        for port in (False, True):
            srv = self._server(port, _share_kw(
                refresh, prefix_share=PrefixShareConfig()))
            out["port" if port else "ref"] = self._serve(srv, reqs, prompts,
                                                         port)
        out["unshared"] = self._serve(self._server(True, _share_kw(refresh)),
                                      reqs, prompts, True)
        return out

    def _refresh8(self):
        return self._shared(_template_stream(), 8)

    def _refresh12(self):
        return self._shared(_template_stream(), 12)

    def _long(self):
        return self._shared(_long_suffix_stream(), 12)

    def _two_serves(self, kw, s1, s2):
        """One store Server, two serves, for each package; the port's
        cold serve of s2 too."""
        out = {}
        for port in (False, True):
            srv = self._server(port, dict(
                kw, template_store=TemplateStoreConfig()))
            first = self._serve(srv, *s1, port)
            pins = (srv._store.pinned_blocks(), srv._tmpl_pool.allocated())
            second = self._serve(srv, *s2, port)
            srv.invalidate_templates()
            drained = (srv._store.pinned_blocks(), srv._tmpl_pool,
                       srv._tmpl_cache)
            out["port" if port else "ref"] = dict(
                serves=[first, second], pins=pins, drained=drained)
        out["cold"] = self._serve(self._server(True, kw), *s2, True)
        return out

    def _warm(self):
        return self._two_serves(STORE_KW, _store_stream(sfx_seed=11),
                                _store_stream(sfx_seed=13))

    def _uid_reuse(self):
        return self._two_serves(STORE_KW, _store_stream(template_seed=5),
                                _store_stream(template_seed=9, sfx_seed=13))

    def _oversubscribed(self):
        return self._two_serves(TIGHT_KW, _store_stream(sfx_seed=11),
                                _store_stream(sfx_seed=13))

    def _handover(self, s1, s2, weights2):
        """A TemplateStore instance served by one Server, then handed to
        a second Server over ``weights2``; the port's cold serve of s2
        over the same weights too."""
        out = {}
        for port in (False, True):
            store = (ts_t.TemplateStore(ts_t.TemplateStoreConfig()) if port
                     else TemplateStore(TemplateStoreConfig()))
            kw = dict(STORE_KW, template_store=store)
            first = self._serve(self._server(port, kw), *s1, port)
            pins, inval0 = store.pinned_blocks(), store.invalidations
            second = self._serve(self._server(port, kw, weights2), *s2,
                                 port)
            out["port" if port else "ref"] = dict(
                serves=[first, second], pins=pins,
                invalidations=store.invalidations - inval0)
        out["cold"] = self._serve(self._server(True, STORE_KW, weights2),
                                  *s2, True)
        return out

    def _epoch(self):
        return self._handover(_store_stream(), _store_stream(), self.w1)

    def _same_bytes(self):
        params, pt = self.w0
        return self._handover(_store_stream(sfx_seed=11),
                              _store_stream(sfx_seed=13),
                              (params, _clone(pt)))


@pytest.fixture(scope="module")
def runs():
    return _Runs()


def _same_stats(st, st_ref, keys=SHARE_STATS):
    for key in keys:
        assert st[key] == st_ref[key], key


# ---------------------------------------------------------------------------
# TestPrefixSharing
# ---------------------------------------------------------------------------

SHARED = ["refresh8", "refresh12", "long"]


@pytest.mark.parametrize("name", SHARED)
def test_prefix_shared_tokens_equal_reference(runs, name):
    r = runs.get(name)
    assert r["port"][0] == r["ref"][0]


@pytest.mark.parametrize("name", SHARED)
def test_prefix_shared_stats_equal_reference(runs, name):
    r = runs.get(name)
    (_, st), (_, st_ref) = r["port"], r["ref"]
    assert set(st) == set(st_ref)
    _same_stats(st, st_ref, SHARE_STATS + ("pool_retains", "decode_steps",
                                           "kv_compactions", "kv_absorbs",
                                           "kv_retired_frontier"))
    # sharing really happened, and every pin was released at drain
    assert st["prefix_hits"] > 0 and st["prefix_tokens_reused"] > 0
    assert st["prefill_chunks"] < r["unshared"][1]["prefill_chunks"]
    assert st["pool_blocks_end"] == 0.0
    if name != "long":
        # short suffixes: slots map the template's blocks side by side
        assert st["kv_shared_blocks"] > 0 and st["kv_bytes_saved"] > 0
    if name == "refresh8":
        # divergent suffixes wrote into shared blocks: copy-on-write ran
        assert st["kv_compactions"] > 0 and st["pool_cow"] > 0
    if name == "long":
        # the pure-template entry survives the suffixes' registrations
        assert st["prefix_hits"] >= 3
        assert st["prefix_tokens_reused"] >= 24 * 3


@pytest.mark.parametrize("name", SHARED)
def test_prefix_shared_tokens_equal_unshared(runs, name):
    r = runs.get(name)
    assert r["port"][0] == r["unshared"][0]
    assert "prefix_hits" not in r["unshared"][1]
    assert r["unshared"][1]["kv_shared_blocks"] == 0


# ---------------------------------------------------------------------------
# TestTemplateStoreEngine and TestContentHashEpoch
# ---------------------------------------------------------------------------

STORE = ["warm", "uid_reuse", "oversubscribed", "epoch", "same_bytes"]


@pytest.mark.parametrize("name", STORE)
def test_store_tokens_equal_reference(runs, name):
    r = runs.get(name)
    for (got, _), (want, _) in zip(r["port"]["serves"], r["ref"]["serves"]):
        assert got == want


@pytest.mark.parametrize("name", STORE)
def test_store_stats_equal_reference(runs, name):
    r = runs.get(name)
    for (_, st), (_, st_ref) in zip(r["port"]["serves"], r["ref"]["serves"]):
        assert set(st) == set(st_ref)
        tmpl = tuple(k for k in st_ref if k.startswith("template_"))
        assert "template_hits_total" in tmpl
        _same_stats(st, st_ref, SHARE_STATS + tmpl)
    assert r["port"]["pins"] == r["ref"]["pins"]


@pytest.mark.parametrize("name", STORE)
def test_store_warm_serve_equals_cold(runs, name):
    r = runs.get(name)
    assert r["port"]["serves"][1][0] == r["cold"][0]
    for _, st in r["port"]["serves"]:
        assert st["pool_blocks_end"] == 0.0


def test_warm_serve_hits_and_drains(runs):
    r = runs.get("warm")["port"]
    (_, st1), (_, st2) = r["serves"]
    assert st1["template_entries"] > 0
    assert st1["template_pinned_blocks"] > 0
    pinned, allocated = r["pins"]
    assert pinned > 0 and allocated == pinned
    assert st2["prefix_hits"] > 0
    assert st2["prefill_chunks"] < st1["prefill_chunks"]
    assert st2["template_hits_total"] == (st1["prefix_hits"]
                                          + st2["prefix_hits"])
    assert st2["template_tokens_reused_total"] == (
        st1["prefix_tokens_reused"] + st2["prefix_tokens_reused"])
    assert st2["template_clusters"] >= 1
    assert 0.0 < st2["template_cohesion_mean"] <= 1.0
    assert st2["template_bytes_pinned"] > 0
    assert st2["template_cluster0_hit_rate"] >= 0.0
    # invalidate_templates() drained every pin and dropped the warm cache
    assert r["drained"] == (0, None, None)


def test_oversubscribed_pool_hits_under_pressure(runs):
    r = runs.get("oversubscribed")
    assert r["port"]["serves"][0][1]["prefix_hits"] > 0


def test_uid_reuse_never_adopts_the_other_template(runs):
    r = runs.get("uid_reuse")
    _, prompts2 = _store_stream(template_seed=9, sfx_seed=13)
    st2 = r["port"]["serves"][1][1]
    assert st2["prefix_tokens_reused"] <= sum(len(p)
                                              for p in prompts2.values())


@pytest.mark.parametrize("name,invalidated", [("epoch", True),
                                              ("same_bytes", False)])
def test_store_epoch_follows_weight_bytes(runs, name, invalidated):
    """Other weights invalidate a handed-over store; a new tree with the
    same bytes keeps its pins warm, as in the reference."""
    r = runs.get(name)
    assert r["port"]["pins"] > 0
    assert (r["port"]["invalidations"] > 0) == invalidated
    assert r["port"]["invalidations"] == r["ref"]["invalidations"]
    if not invalidated:
        assert r["port"]["serves"][1][1]["prefix_hits"] > 0


def test_params_digest_is_by_content(runs):
    _, pt = runs.w0
    copy = _clone(pt)
    assert ServerT._params_digest(copy) == ServerT._params_digest(pt)
    copy["final_norm"]["scale"][0] += 1.0
    assert ServerT._params_digest(copy) != ServerT._params_digest(pt)
    assert ServerT._params_digest(runs.w1[1]) != ServerT._params_digest(pt)


def test_cow_copies_blocks_in_every_tail_leaf():
    """``_cow_impl``: each pair's source block lands in its destination in
    every clustered tail leaf, read before any write; a repeated pair
    writes the same values."""
    g = torch.Generator().manual_seed(0)
    leaf = lambda: {k: torch.randn(6, 4, 2, 8, generator=g)  # noqa: E731
                    for k in ("k_tail", "v_tail")} | {
        "k_cents": torch.zeros(1), "cov": torch.zeros(1)}
    cache = {"layers": [leaf(), {"k": torch.zeros(1), "v": torch.zeros(1)},
                        leaf()]}
    before = _clone(cache)
    ServerT._cow_impl(cache, [(1, 4), (2, 5), (1, 4)])
    for got, old in zip(cache["layers"], before["layers"]):
        for k in got:
            want = old[k].clone()
            if k in ("k_tail", "v_tail"):
                want[4], want[5] = old[k][1], old[k][2]
            assert torch.equal(got[k], want), k
