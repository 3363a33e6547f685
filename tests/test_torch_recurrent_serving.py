"""The port's Server on recurrent-state layers ('M' Mamba2 SSD, 'R' RG-LRU)
against the reference Server.

Twins of tests/test_serving_engine.py's ``TestRecurrentServing`` on its
pinned configs (f32, 2 layers, d_model 64, 'GM', 'GR' and 'M'), parameters
from the reference's ``init_params`` carried over by ``bridge``: chunked
dense, chunked paged, blocking, the preempt → swap → resume cycle, pure
recurrent dense chunked, and the pure-recurrent paged refusal.  Every port
serve gives the tokens of the reference's blocking static serve of the
same stream (batch 1, exact KV), token for token, which holds the port to
the reference's invariants: chunked == blocking, paged == dense, and swap
== an unpressured run.  The swap's scheduler counters equal the reference
Server's on 'GM'; ``state_bytes_recurrent`` equals the reference's
``recurrent_state_bytes`` of the same cache; a prefix-shared serve
restores recurrent state from its snapshots and keeps the tokens.  The
reduced mamba2-2.7b and recurrentgemma-9b serve with the reference's
tokens and retirement counters.  Each reference serve of a pattern runs
once a module (``_Runs``).

Also Queue C 9's pin: the port's ``ServerConfig`` declares the reference's
fields in the reference's order (``greedy`` included)."""

import dataclasses

import jax
import numpy as np
import pytest

from _torch_ref import ref_init_params
from repro import configs
from repro.core import kv_compress
from repro.core import layer_state
from repro.core.request_cluster import Request
from repro.models import transformer as tfm
from repro.models.config import ModelConfig, SSMConfig
from repro.runtime.kv_pool import PagedKVConfig
from repro.runtime.scheduler import SLOConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.models.config import ModelConfig as ModelConfigT
from repro_torch.models.config import SSMConfig as SSMConfigT
from repro_torch.runtime.kv_pool import PagedKVConfig as PagedKVConfigT
from repro_torch.runtime.prefix_cache import PrefixShareConfig as PSCT
from repro_torch.runtime.scheduler import SLOConfig as SLOConfigT
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

_BASE = dict(n_layers=2, d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
             d_ff=128, vocab=64, pad_vocab_multiple=16, dtype="float32")
_SSM = dict(d_state=16, d_conv=4, expand=2, head_dim=32, n_groups=1,
            chunk=32)


def _cfgs(pattern):
    """The reference's GM_REC / GR_REC / M_PURE, in both packages."""
    if "M" in pattern:
        return tuple(MC(name=pattern.lower(), family="hybrid",
                        layer_pattern=pattern, ssm=SC(**_SSM), **_BASE)
                     for MC, SC in ((ModelConfig, SSMConfig),
                                    (ModelConfigT, SSMConfigT)))
    return tuple(MC(name=pattern.lower(), family="hybrid",
                    layer_pattern=pattern, lru_width=64, **_BASE)
                 for MC in (ModelConfig, ModelConfigT))


CC = dict(n_clusters=8, iters=4, keep_recent=16, refresh_every=8)
STATIC = dict(batch_size=1, max_seq=96, engine="static",
              use_clustered_batching=False)


def _rec_stream(vocab=64, seed=9):
    """tests/test_serving_engine.py's ``_rec_stream``."""
    rng = np.random.default_rng(seed)
    spec = [(60, 12), (9, 10), (48, 9), (21, 14)]
    prompts = {i: rng.integers(0, vocab, size=(l,)).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    return [(i, l, g, 0) for i, (l, g) in enumerate(spec)], prompts


def _swap_stream():
    """``test_preempt_swap_resume_bit_identical``'s 8 requests: the last
    three priority 1, at the FIFO tail."""
    rng = np.random.default_rng(3)
    reqs, prompts = [], {}
    for i in range(8):
        plen = int(rng.integers(6, 30))
        prompts[i] = rng.integers(0, 64, size=(plen,)).astype(np.int32)
        reqs.append((i, plen, int(rng.integers(6, 14)), 1 if i >= 5 else 0))
    return reqs, prompts


def _port_kw(kw):
    """A reference ServerConfig's keywords with the port's config types."""
    out = dict(kw)
    for key, cls in (("kv_compress", kv_t.KVCompressConfig),
                     ("paged", PagedKVConfigT), ("scheduler", SLOConfigT)):
        if out.get(key) is not None:
            out[key] = cls(**dataclasses.asdict(out[key]))
    return out


def _chunked(**kw):
    return dict(batch_size=2, max_seq=96, prefill_chunk=8,
                kv_compress=kv_compress.KVCompressConfig(**CC), **kw)


SWAP_BIG = _chunked(paged=PagedKVConfig(block_size=4, pool_blocks=48),
                    use_clustered_batching=False)
SWAP_TIGHT = _chunked(paged=PagedKVConfig(block_size=4, pool_blocks=10),
                      use_clustered_batching=False,
                      scheduler=SLOConfig(priority_admission=False))


class _Runs:
    """One pattern's reference and port serves, each served once and kept
    by name; a serve is (tokens by uid, shed uids, last_stats)."""

    def __init__(self, pattern):
        self.cfg, self.cfg_t = _cfgs(pattern)
        self.params = ref_init_params(self.cfg)
        self.pt = bridge.params_from_numpy(
            jax.tree.map(np.asarray, self.params), self.cfg_t, "cpu")
        self._memo = {}

    def ref(self, stream, **kw):
        return self._get(("ref", stream, repr(sorted(kw.items()))),
                         lambda: Server(self.cfg, ServerConfig(**kw),
                                        self.params),
                         stream, Request)

    def port(self, stream, **kw):
        return self._get(("port", stream, repr(sorted(kw.items()))),
                         lambda: ServerT(self.cfg_t,
                                         ServerConfigT(**_port_kw(kw)),
                                         self.pt, device="cpu"),
                         stream, RequestT)

    def _get(self, key, make, stream, request_cls):
        if key not in self._memo:
            reqs, prompts = {"rec": _rec_stream, "swap": _swap_stream}[
                stream]()
            srv = make()
            outs = srv.serve([request_cls(*r) for r in reqs], prompts)
            self._memo[key] = ({o.uid: o.tokens for o in outs},
                               {o.uid for o in outs if o.shed},
                               dict(srv.last_stats))
        return self._memo[key]


@pytest.fixture(scope="module", params=["GM", "GR"], ids=["gm", "gr"])
def rec(request):
    return _Runs(request.param)


@pytest.fixture(scope="module")
def pure():
    return _Runs("M")


def _reference_state_bytes(cfg, **kw):
    """The reference's ``recurrent_state_bytes`` of the engine cache the
    config builds (shapes only)."""
    cache = jax.eval_shape(lambda: tfm.init_cache(cfg, 2, 96, **kw))
    return layer_state.recurrent_state_bytes(cache, 2)


# ---------------------------------------------------------------------------
# TestRecurrentServing's twins
# ---------------------------------------------------------------------------


def test_chunked_dense_bit_identical(rec):
    want = rec.ref("rec", **STATIC)[0]
    got, _, st = rec.port("rec", **_chunked())
    assert got == want
    assert st["state_bytes_recurrent"] == _reference_state_bytes(
        rec.cfg, kv_mode="clustered", kv_clusters=8, kv_tail=16) > 0
    assert st["kv_retired_recurrent"] == 0
    assert st["prefill_chunks"] > 0


def test_chunked_paged_bit_identical(rec):
    want = rec.ref("rec", **STATIC)[0]
    got, _, st = rec.port("rec", **_chunked(paged=PagedKVConfig(
        block_size=4)))
    assert got == want
    # both families are priced and visible in the metrics surface
    assert st["state_bytes_recurrent"] == _reference_state_bytes(
        rec.cfg, kv_mode="clustered", kv_clusters=8, kv_tail=16,
        kv_pool_blocks=8, kv_block_size=4) > 0
    assert st["state_bytes_ring"] > 0
    # recurrent state never retires: the counter exists and stays 0
    assert st["kv_retired_recurrent"] == 0
    assert st["pool_blocks_end"] == 0
    assert st["pool_frees"] == st["pool_allocs"]


@pytest.mark.parametrize("paged", [False, True], ids=["dense", "paged"])
def test_blocking_equals_chunked(rec, paged):
    """Blocking admission prefills recurrent state by stepping the decode
    (one prefill at the exact prompt length): the chunked serve's
    tokens."""
    pkw = dict(paged=PagedKVConfig(block_size=4)) if paged else {}
    got, _, st = rec.port("rec", batch_size=2, max_seq=96,
                          kv_compress=kv_compress.KVCompressConfig(**CC),
                          **pkw)
    assert got == rec.port("rec", **_chunked(**pkw))[0]
    assert got == rec.ref("rec", **STATIC)[0]
    assert st["prefill_chunks"] == 0 and st["prefill_pad_frac"] == 0


def test_static_engine_equals_reference(rec):
    assert rec.port("rec", **STATIC)[0] == rec.ref("rec", **STATIC)[0]


def test_preempt_swap_resume_bit_identical(rec):
    """One preempt → host swap → resume cycle through recurrent state: the
    snapshot carries the (conv, ssm) / (conv, h) leaves whole, the
    swap-bytes ledger prices them, and restored requests finish with the
    tokens of an unpressured run (and of the reference's static serve)."""
    want = rec.ref("swap", **STATIC)[0]
    big = rec.port("swap", **SWAP_BIG)
    assert big[0] == want
    got, shed, st = rec.port("swap", **SWAP_TIGHT)
    assert st["sched_preemptions"] >= 1
    assert st["sched_swaps_in"] >= 1
    assert st["sched_swap_bytes"] == 0          # the ledger drains to zero
    assert st["state_bytes_recurrent"] > 0
    for uid, toks in got.items():
        if uid not in shed:
            assert toks == want[uid], f"uid {uid} diverged"


def test_swap_schedule_equals_reference():
    """On 'GM' the port's scheduled serve makes the reference Server's
    decisions: tokens, shed requests and every sched_* counter."""
    runs = _Runs("GM")
    ref, port = runs.ref("swap", **SWAP_TIGHT), runs.port("swap",
                                                          **SWAP_TIGHT)
    assert port[:2] == ref[:2]
    keys = [k for k in ref[2] if k.startswith("sched_")]
    assert keys
    for key in keys + ["state_bytes_recurrent", "kv_retired_recurrent",
                       "pool_blocks_end", "decode_steps"]:
        assert port[2][key] == ref[2][key], key


def test_prefix_share_restores_recurrent_state(rec):
    """Prompts sharing a 32-token prefix, prefix-shared: later requests
    adopt the registered blocks and restore the snapshot, recurrent state
    included, and keep the unshared serve's tokens."""
    rng = np.random.default_rng(5)
    head = rng.integers(0, 64, size=32).astype(np.int32)
    prompts = {i: np.concatenate([head, rng.integers(
        0, 64, size=int(n)).astype(np.int32)])
        for i, n in enumerate((5, 11, 3, 9))}
    reqs = [RequestT(i, len(p), 6) for i, p in prompts.items()]
    outs = {}
    for name, share in (("unshared", None),
                        ("shared", PSCT(max_entries=4))):
        srv = ServerT(rec.cfg_t, ServerConfigT(**_port_kw(_chunked(
            paged=PagedKVConfig(block_size=4))), prefix_share=share),
            rec.pt, device="cpu")
        outs[name] = ({o.uid: o.tokens for o in srv.serve(reqs, prompts)},
                      dict(srv.last_stats))
    assert outs["shared"][0] == outs["unshared"][0]
    st = outs["shared"][1]
    assert st["prefix_hits"] >= 1
    assert st["prefill_chunks"] < outs["unshared"][1]["prefill_chunks"]
    assert st["pool_blocks_end"] == 0


def test_pure_recurrent_dense_chunked(pure):
    """An attention-free pattern (no ring layer at all) serves chunked
    and blocking dense with the reference's tokens."""
    want = pure.ref("rec", **STATIC)[0]
    got, _, st = pure.port("rec", batch_size=2, max_seq=96, prefill_chunk=8)
    assert got == want
    assert pure.port("rec", batch_size=2, max_seq=96)[0] == want
    assert st["state_bytes_recurrent"] == _reference_state_bytes(pure.cfg)
    assert st["state_bytes_ring"] == 0


def test_pure_recurrent_paged_rejected(pure):
    """Recurrent state is never pool-backed, so a pure-recurrent pattern
    has nothing to page: both packages refuse it with the same words."""
    kw = _chunked(paged=PagedKVConfig(block_size=4))
    with pytest.raises(ValueError, match="ring-family") as ref_err:
        Server(pure.cfg, ServerConfig(**kw), pure.params)
    with pytest.raises(ValueError, match="ring-family") as port_err:
        ServerT(pure.cfg_t, ServerConfigT(**_port_kw(kw)), pure.pt,
                device="cpu")
    assert str(port_err.value) == str(ref_err.value)


@pytest.mark.parametrize("arch", ["recurrentgemma-9b", "mamba2-2.7b"])
def test_reduced_zoo_configs_serve_like_reference(arch):
    """The reduced recurrentgemma-9b ('RRL' with a tail 'RR', window 8) and
    mamba2-2.7b ('M') under a KVCompressConfig that has no 'G' layer to
    act on: the port's chunked dense, blocking dense and (recurrentgemma)
    chunked paged serves give the reference's blocking serve's tokens and
    retirement counters (the frontier advances as bookkeeping; absorbs run
    over no clustered leaf); mamba2-2.7b paged is refused, as in the
    reference."""
    cfg, cfg_t = (dataclasses.replace(c.get_reduced(arch), dtype="float32")
                  for c in (configs, configs_t))
    params = ref_init_params(cfg)
    pt = bridge.params_from_numpy(jax.tree.map(np.asarray, params), cfg_t,
                                  "cpu")
    rng = np.random.default_rng(5)
    spec = [(70, 8), (20, 6), (40, 7)]
    prompts = {i: rng.integers(0, cfg.vocab, size=l).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    kw = dict(batch_size=2, max_seq=96,
              kv_compress=kv_compress.KVCompressConfig(**CC))
    ref = Server(cfg, ServerConfig(**kw), params)
    want = {o.uid: o.tokens for o in ref.serve(
        [Request(i, l, g) for i, (l, g) in enumerate(spec)], prompts)}
    modes = {"blocking": {}, "chunked": dict(prefill_chunk=8)}
    if "L" in cfg.layer_pattern:
        modes["paged"] = dict(prefill_chunk=8,
                              paged=PagedKVConfig(block_size=4))
    else:
        with pytest.raises(ValueError, match="ring-family"):
            ServerT(cfg_t, ServerConfigT(**_port_kw(dict(
                kw, prefill_chunk=8, paged=PagedKVConfig(block_size=4)))),
                pt, device="cpu")
    for mode, extra in modes.items():
        srv = ServerT(cfg_t, ServerConfigT(**_port_kw(dict(kw, **extra))),
                      pt, device="cpu")
        got = {o.uid: o.tokens for o in srv.serve(
            [RequestT(i, l, g) for i, (l, g) in enumerate(spec)], prompts)}
        assert got == want, mode
        st = srv.last_stats
        for key in ("kv_retired_window", "kv_retired_frontier",
                    "kv_retired_recurrent", "state_bytes_recurrent",
                    "state_bytes_ring"):
            assert st[key] == ref.last_stats[key], (mode, key)
        # the 70-token prompt streams past the ring in chunked admission
        assert (st["kv_absorbs"] > 0) == (mode != "blocking"), mode
    assert ref.last_stats["state_bytes_recurrent"] > 0


# ---------------------------------------------------------------------------
# ROADMAP Queue C 9: ServerConfig's fields
# ---------------------------------------------------------------------------


def test_server_config_fields_equal_reference():
    """The same field names in the same order with the same defaults (the
    config types aside), so positional construction binds alike."""
    ref = dataclasses.fields(ServerConfig)
    port = dataclasses.fields(ServerConfigT)
    assert [f.name for f in port] == [f.name for f in ref]
    for f, g in zip(ref, port):
        if f.default is None or isinstance(f.default, (bool, int, str)):
            assert g.default == f.default, f.name
    assert ServerConfigT(greedy=True).greedy
    a, b = ServerConfig(4, 256, True, 4, "x"), ServerConfigT(4, 256, True, 4,
                                                             "x")
    assert (b.greedy, b.engine) == (a.greedy, a.engine) == ("x", "continuous")
