"""The port's Server on the reduced deepseek-v3-671b (f32, MLA attention,
one dense prefix layer, then sigmoid-routed MoE layers) against the
reference Server.

Parameters come from the reference's ``init_params`` and cross by value
through ``bridge``.  Each mode the reference serves MLA in runs the same
stream on both packages: static, blocking over exact KV and blocking
under a ``KVCompressConfig``, where the latent leaves stay exact (no
absorb, no compaction reaches them, and no tail bytes exist).  Tokens must
be equal request for request, and ``last_stats`` equal key for key, every
value but the wall-clock ones.  The modes the reference refuses MLA in
(chunked, paged, prefix sharing, the SLO scheduler) raise its errors, word
for word.  Each reference serve runs once a module.
"""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_ref import ref_init_params
from repro import configs
from repro.core import kv_compress
from repro.core.request_cluster import Request
from repro.runtime.kv_pool import PagedKVConfig
from repro.runtime.prefix_cache import PrefixShareConfig
from repro.runtime.scheduler import SLOConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.runtime.kv_pool import PagedKVConfig as PagedKVConfigT
from repro_torch.runtime.prefix_cache import \
    PrefixShareConfig as PrefixShareConfigT
from repro_torch.runtime.scheduler import SLOConfig as SLOConfigT
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

ARCH = "deepseek-v3-671b"
CC = dict(n_clusters=8, iters=4, keep_recent=16, refresh_every=8)
#: last_stats keys read off the host's clock
WALL_KEYS = frozenset({"decode_s", "tokens_per_s", "wall_s",
                       "tokens_per_s_wall", "ttft_p50_ms", "ttft_p95_ms",
                       "ttft_p99_ms", "itl_p50_ms", "itl_p95_ms",
                       "itl_p99_ms"})


def _stream():
    """4 requests of 12-40 prompt tokens, 6-20 new tokens each (past
    refresh 8, so compaction passes run)."""
    rng = np.random.default_rng(11)
    lens = rng.integers(12, 41, size=4)
    prompts = {i: rng.integers(0, 256, size=int(n)).astype(np.int32)
               for i, n in enumerate(lens)}
    return [(i, int(n), int(rng.integers(6, 21)))
            for i, n in enumerate(lens)], prompts


def _overflow_stream():
    """2 requests whose slots decode past max_seq 64: a prompt that fills
    it and one that reaches it on its 5th new token."""
    rng = np.random.default_rng(12)
    reqs = [(0, 64, 4), (1, 60, 8)]
    return reqs, {u: rng.integers(0, 256, size=n).astype(np.int32)
                  for u, n, _ in reqs}


MODES = {
    "static": dict(batch_size=2, max_seq=64, engine="static"),
    "blocking": dict(batch_size=2, max_seq=64),
    "clustered": dict(batch_size=2, max_seq=64,
                      kv_compress=kv_compress.KVCompressConfig(**CC)),
}

#: the modes the reference refuses MLA in
REFUSED = {
    "chunked": dict(prefill_chunk=8),
    "paged": dict(prefill_chunk=8, paged=PagedKVConfig(block_size=4)),
    "prefix_share": dict(prefill_chunk=8,
                         prefix_share=PrefixShareConfig(max_entries=2)),
    "scheduler": dict(scheduler=SLOConfig()),
    "compress_chunked": dict(prefill_chunk=8, kv_compress=kv_compress
                             .KVCompressConfig(**CC)),
}


def _port_kw(kw):
    out = dict(kw)
    for key, cls in (("kv_compress", kv_t.KVCompressConfig),
                     ("paged", PagedKVConfigT), ("scheduler", SLOConfigT),
                     ("prefix_share", PrefixShareConfigT)):
        if out.get(key) is not None:
            out[key] = cls(**dataclasses.asdict(out[key]))
    return out


class _Runs:
    """Each mode's reference and port serve, served once and kept: (tokens
    by uid, last_stats)."""

    def __init__(self):
        self.cfg = dataclasses.replace(configs.get_reduced(ARCH),
                                       dtype="float32")
        self.cfg_t = dataclasses.replace(configs_t.get_reduced(ARCH),
                                         dtype="float32")
        self.params = ref_init_params(self.cfg)
        self.pt = bridge.params_from_numpy(
            jax.tree.map(np.asarray, self.params), self.cfg_t, "cpu")
        self._memo = {}

    def get(self, side, mode, stream=_stream):
        if (side, mode, stream) not in self._memo:
            reqs, prompts = stream()
            if side == "ref":
                srv = Server(self.cfg, ServerConfig(**MODES[mode]),
                             self.params)
                outs = srv.serve([Request(*r) for r in reqs], prompts)
            else:
                srv = ServerT(self.cfg_t,
                              ServerConfigT(**_port_kw(MODES[mode])),
                              self.pt, device="cpu")
                outs = srv.serve([RequestT(*r) for r in reqs], prompts)
            self._memo[side, mode, stream] = (
                {o.uid: o.tokens for o in outs}, dict(srv.last_stats))
        return self._memo[side, mode, stream]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("mode", list(MODES))
def test_tokens_and_stats_equal_reference(runs, mode):
    got, st = runs.get("port", mode)
    want, st_ref = runs.get("ref", mode)
    assert got == want
    assert all(len(t) > 0 for t in got.values())
    assert set(st) == set(st_ref)
    for key in sorted(set(st_ref) - WALL_KEYS):
        assert st[key] == pytest.approx(st_ref[key], rel=1e-6, abs=1e-9), key


def test_clustered_config_leaves_the_latent_exact(runs):
    """Under kv_compress the latent passes through admission and the
    compaction passes untouched: the tokens are the exact blocking
    serve's, no absorb runs, no tail byte exists, and the frontier is
    bookkeeping only."""
    got, st = runs.get("port", "clustered")
    assert got == runs.get("port", "blocking")[0]
    assert st["kv_absorbs"] == 0 and st["kv_compactions"] > 0
    assert st["kv_bytes_peak_per_shard"] == 0.0
    assert st["kv_retired_frontier"] > 0


@pytest.mark.parametrize("mode", ["static", "blocking"])
def test_slot_past_max_seq_matches_reference(runs, mode):
    """A slot that decodes at t >= max_seq serves on: the latent write is
    dropped as the reference's out-of-bounds update is, and the tokens
    are the reference's."""
    got, _ = runs.get("port", mode, _overflow_stream)
    want, _ = runs.get("ref", mode, _overflow_stream)
    assert got == want
    assert [len(got[u]) for u in (0, 1)] == [4, 8]


@pytest.mark.parametrize("mode", list(REFUSED))
def test_refused_modes_raise_reference_errors(runs, mode):
    kw = dict(batch_size=2, max_seq=64, **REFUSED[mode])
    with pytest.raises(ValueError) as ref:
        Server(runs.cfg, ServerConfig(**kw), runs.params)
    with pytest.raises(ValueError) as got:
        ServerT(runs.cfg_t, ServerConfigT(**_port_kw(kw)), runs.pt,
                device="cpu")
    assert str(got.value) == str(ref.value)
