"""The ranks of tests/test_torch_sharded_serving.py's gloo world (run
through ``_torch_world``; imports neither JAX nor the reference).

Every rank builds the (data=2, model=4) serving mesh over the 8-rank world
and serves tests/test_sharded_serving.py's mixed-length stream through the
port's mesh engine, scenario by scenario, on the weights the caller bridged
from the reference (numpy trees), the decode kernels' wrappers asked for
contiguous arguments as their CUDA versions ask.  Each returns its
completions' tokens and the stats the tests read: every rank runs the
same host engine, so all must return the same.
"""

import numpy as np
import torch

from repro_torch import bridge
from repro_torch.core import kv_compress
from repro_torch.core.request_cluster import Request
from repro_torch.kernels import ops
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.kv_pool import PagedKVConfig
from repro_torch.runtime.server import Server, ServerConfig

TINY4 = dict(name="tiny4", family="dense", n_layers=2, d_model=64,
             n_heads=4, n_kv_heads=4, head_dim=16, d_ff=128, vocab=64,
             pad_vocab_multiple=16, dtype="float32")
TINY2 = dict(TINY4, name="tiny2", n_kv_heads=2)
CCFG = dict(n_clusters=8, iters=4, keep_recent=16, refresh_every=8)
STATS = ("n_data_shards", "slot_waste_shard0", "slot_waste_shard1",
         "prefill_chunks", "prefill_pad_frac", "kv_absorbs",
         "kv_compactions", "pool_blocks_end", "decode_steps")

# name -> (model, ServerConfig fields beyond batch_size=4, max_seq=64)
SCENARIOS = {
    "exact": ("tiny4", {}),
    "compaction": ("tiny4", {"kv_compress": CCFG}),
    "chunked": ("tiny4", {"prefill_chunk": 8}),
    "chunked_compaction": ("tiny4", {"kv_compress": CCFG,
                                     "prefill_chunk": 8}),
    "paged_blocking": ("tiny4", {"kv_compress": CCFG, "paged": 4}),
    "paged_chunked": ("tiny4", {"kv_compress": CCFG, "prefill_chunk": 8,
                                "paged": 4}),
    "indivisible_heads": ("tiny2", {}),
    # the stream with 10 more tokens a request: compaction runs mid-decode
    "compaction_long": ("tiny4", {"kv_compress": CCFG}),
    "paged_long": ("tiny4", {"kv_compress": CCFG, "prefill_chunk": 8,
                             "paged": 4}),
}


def stream(name: str = ""):
    """tests/test_sharded_serving.py's _COMMON stream: more requests than
    slots, short and long prompts, ragged budgets (10 tokens more for a
    ``*_long`` scenario, past refresh_every)."""
    rng = np.random.default_rng(0)
    spec = [(5, 4), (23, 6), (9, 3), (17, 5), (6, 1), (21, 4), (12, 5),
            (30, 2), (8, 6)]
    prompts = {i: rng.integers(0, 64, size=(l,)).astype(np.int32)
               for i, (l, _) in enumerate(spec)}
    if name.endswith("_long"):
        spec = [(l, g + 10) for l, g in spec]
    return spec, prompts


def requests(name: str, cls=Request):
    spec, prompts = stream(name)
    return [cls(i, l, g) for i, (l, g) in enumerate(spec)], prompts


def server_config(fields: dict, mesh=None, kv_cls=None, paged_cls=None):
    """ServerConfig(batch_size=4, max_seq=64, **fields) with the KV and
    pool configs built from their classes (the port's or the
    reference's)."""
    kw = dict(fields)
    if "kv_compress" in kw:
        kw["kv_compress"] = (kv_cls or kv_compress.KVCompressConfig)(
            **kw["kv_compress"])
    if "paged" in kw:
        kw["paged"] = (paged_cls or PagedKVConfig)(block_size=kw["paged"])
    if mesh is not None:
        kw["mesh"] = mesh
    return kw


def _contiguous_only(fn):
    """``fn`` that first requires every tensor argument contiguous, as the
    CUDA wrappers do (the plain versions on the CPU would not notice)."""
    def call(*args, **kw):
        bad = [i for i, a in enumerate(args)
               if torch.is_tensor(a) and not a.is_contiguous()]
        assert not bad, f"{fn.__name__}: arguments {bad} not contiguous"
        return fn(*args, **kw)
    return call


def main(rank, world, weights):
    """weights: {"tiny4": numpy tree, "tiny2": numpy tree} (the reference
    layout)."""
    for name in ("clustered_decode", "paged_clustered_decode"):
        setattr(ops, name, _contiguous_only(getattr(ops, name)))
    mesh = make_serving_mesh("2x4")
    cfgs = {"tiny4": ModelConfig(**TINY4), "tiny2": ModelConfig(**TINY2)}
    params = {k: bridge.params_from_numpy(v, cfgs[k], "cpu")
              for k, v in weights.items()}
    out = {}
    for name, (model, fields) in SCENARIOS.items():
        srv = Server(cfgs[model],
                     ServerConfig(batch_size=4, max_seq=64,
                                  **server_config(fields, mesh)),
                     params[model], device="cpu")
        toks = {o.uid: o.tokens for o in srv.serve(*requests(name))}
        out[name] = (toks, {k: srv.last_stats.get(k) for k in STATS})
    return out


def config(model: str, cls=ModelConfig):
    return cls(**(TINY4 if model == "tiny4" else TINY2))
