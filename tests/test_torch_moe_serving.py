"""The port's Server on the reduced qwen2-moe-a2.7b (f32, 2 'G' layers of 8
routed experts, top-2, and a shared expert) against the reference Server.

Parameters come from the reference's ``init_params`` and cross by value
through ``bridge``.  Each mode serves the same stream on both packages
and the tokens must be equal, request for request: blocking admission
(the reference's default), chunked admission (chunks of 8), chunked paged
(blocks of 4), and one preempt → host swap → resume cycle under the SLO
scheduler over a tight pool.  A MoE launch routes all of its rows at once,
so which tokens an expert drops depends on the launch; the port matches
the reference launch for launch.  Each reference serve runs once a module.
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
from repro.runtime.scheduler import SLOConfig
from repro.runtime.server import Server, ServerConfig
from repro_torch import bridge
from repro_torch import configs as configs_t
from repro_torch.core import kv_compress as kv_t
from repro_torch.core.request_cluster import Request as RequestT
from repro_torch.runtime.kv_pool import PagedKVConfig as PagedKVConfigT
from repro_torch.runtime.scheduler import SLOConfig as SLOConfigT
from repro_torch.runtime.server import Server as ServerT
from repro_torch.runtime.server import ServerConfig as ServerConfigT

ARCH = "qwen2-moe-a2.7b"
CC = dict(n_clusters=4, iters=4, keep_recent=16, refresh_every=8)


def _stream():
    """5 requests of 9-40 prompt tokens, 6-12 new tokens each."""
    rng = np.random.default_rng(7)
    lens = rng.integers(9, 41, size=5)
    prompts = {i: rng.integers(0, 256, size=int(n)).astype(np.int32)
               for i, n in enumerate(lens)}
    return [(i, int(n), int(rng.integers(6, 13)), 0)
            for i, n in enumerate(lens)], prompts


def _swap_stream():
    """tests/test_serving_engine.py's swap stream: 8 requests, the last
    three priority 1, at the FIFO tail."""
    rng = np.random.default_rng(3)
    reqs, prompts = [], {}
    for i in range(8):
        plen = int(rng.integers(6, 30))
        prompts[i] = rng.integers(0, 256, size=(plen,)).astype(np.int32)
        reqs.append((i, plen, int(rng.integers(6, 14)), 1 if i >= 5 else 0))
    return reqs, prompts


MODES = {
    "blocking": dict(batch_size=4, max_seq=96,
                     kv_compress=kv_compress.KVCompressConfig(**CC)),
    "chunked": dict(batch_size=4, max_seq=96, prefill_chunk=8,
                    kv_compress=kv_compress.KVCompressConfig(**CC)),
    "paged": dict(batch_size=4, max_seq=96, prefill_chunk=8,
                  kv_compress=kv_compress.KVCompressConfig(**CC),
                  paged=PagedKVConfig(block_size=4)),
    "swap": dict(batch_size=2, max_seq=96, prefill_chunk=8,
                 kv_compress=kv_compress.KVCompressConfig(**CC),
                 paged=PagedKVConfig(block_size=4, pool_blocks=10),
                 use_clustered_batching=False,
                 scheduler=SLOConfig(priority_admission=False)),
}


def _port_kw(kw):
    out = dict(kw)
    for key, cls in (("kv_compress", kv_t.KVCompressConfig),
                     ("paged", PagedKVConfigT), ("scheduler", SLOConfigT)):
        if out.get(key) is not None:
            out[key] = cls(**dataclasses.asdict(out[key]))
    return out


class _Runs:
    """Each mode's reference and port serve, served once and kept: (tokens
    by uid, shed uids, last_stats)."""

    def __init__(self):
        self.cfg = dataclasses.replace(configs.get_reduced(ARCH),
                                       dtype="float32")
        self.cfg_t = dataclasses.replace(configs_t.get_reduced(ARCH),
                                         dtype="float32")
        self.params = ref_init_params(self.cfg)
        self.pt = bridge.params_from_numpy(
            jax.tree.map(np.asarray, self.params), self.cfg_t, "cpu")
        self._memo = {}

    def get(self, side, mode):
        if (side, mode) not in self._memo:
            reqs, prompts = (_swap_stream if mode == "swap" else _stream)()
            if side == "ref":
                srv = Server(self.cfg, ServerConfig(**MODES[mode]),
                             self.params)
                outs = srv.serve([Request(*r) for r in reqs], prompts)
            else:
                srv = ServerT(self.cfg_t,
                              ServerConfigT(**_port_kw(MODES[mode])),
                              self.pt, device="cpu")
                outs = srv.serve([RequestT(*r) for r in reqs], prompts)
            self._memo[side, mode] = ({o.uid: o.tokens for o in outs},
                                      {o.uid for o in outs if o.shed},
                                      dict(srv.last_stats))
        return self._memo[side, mode]


@pytest.fixture(scope="module")
def runs():
    return _Runs()


@pytest.mark.parametrize("mode", ["blocking", "chunked", "paged"])
def test_tokens_equal_reference(runs, mode):
    got, _, st = runs.get("port", mode)
    want, _, st_ref = runs.get("ref", mode)
    assert got == want
    assert all(len(t) > 0 for t in got.values())
    for key in ("decode_steps", "prefill_chunks", "kv_compactions"):
        if key in st_ref:
            assert st[key] == st_ref[key], key
    if mode == "paged":
        assert st["pool_blocks_end"] == 0
        assert st["pool_frees"] == st["pool_allocs"]


def test_preempt_swap_resume_equals_reference(runs):
    """Preemption to host memory and resume: the reference's tokens, shed
    set and scheduler counters."""
    got, shed, st = runs.get("port", "swap")
    want, shed_ref, st_ref = runs.get("ref", "swap")
    assert st["sched_preemptions"] >= 1 and st["sched_swaps_in"] >= 1
    assert (got, shed) == (want, shed_ref)
    for key in [k for k in st_ref if k.startswith("sched_")]:
        assert st[key] == st_ref[key], key


def test_serving_publishes_no_moe_stat(runs):
    """The serving FFN discards the MoE metrics, as the reference's does:
    the port's stats keys are the reference's."""
    for mode in ("chunked", "paged"):
        assert set(runs.get("port", mode)[2]) == set(runs.get("ref",
                                                              mode)[2])
