"""The ranks of tests/test_torch_sharded_moe.py's and
tests/test_torch_sharded_layers.py's gloo worlds (run through
``_torch_world``; imports neither JAX nor the reference).

Every rank builds the (data=2, model=4) serving mesh over the 8-rank world
and serves each scenario through the port's mesh engine on the weights the
caller bridged from the reference (numpy trees, the reference layout).
Each returns its completions' tokens, the stats the tests read and the
mesh MoE dispatch counts of the serve: every rank runs the same host
engine, so all must return the same tokens.  The MoE world also returns
this rank's parameter placement, single ``apply_moe`` calls under the
"sharded" and "global" dispatches (rows split over the data shards, and
whole), and one on the a2a geometry, once as built and once with the
return ``all_to_all`` skipped (a planted fault the tests must catch).
"""

import dataclasses

import numpy as np
import torch

from repro_torch import bridge
from repro_torch import configs
from repro_torch.core.request_cluster import Request
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import moe
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.sharding import rules as shard_rules

import _torch_serving_ranks as serving

STATS = ("n_data_shards", "prefill_chunks", "kv_absorbs", "kv_compactions",
         "pool_blocks_end", "decode_steps", "kv_retired_window",
         "kv_retired_frontier", "kv_retired_recurrent",
         "state_bytes_recurrent")


# ---------------------------------------------------------------------------
# configurations (the port's classes; the tests build the reference's twins
# from the same fields)
# ---------------------------------------------------------------------------


def moe_config(impl=None, reduced=configs.get_reduced, n_routed=None):
    """The reduced qwen2-moe-a2.7b in f32 (8 routed experts, top-2, a shared
    expert), its dispatch ``impl`` and its routed-expert count replaced
    when given."""
    cfg = dataclasses.replace(reduced("qwen2-moe-a2.7b"), dtype="float32")
    change = {k: v for k, v in (("impl", impl), ("n_routed", n_routed))
              if v is not None}
    if change:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe,
                                                               **change))
    return cfg


def mla_config(moe_layers=True, reduced=configs.get_reduced):
    """The reduced deepseek-v3-671b in f32 (MLA; its MoE layers of 8
    routed experts, ``impl="a2a"`` as its config has it, or none), no MTP
    head (serving never reads it)."""
    cfg = dataclasses.replace(reduced("deepseek-v3-671b"), dtype="float32",
                              mtp_depth=0)
    if not moe_layers:
        cfg = dataclasses.replace(cfg, moe=None, family="dense")
    return cfg


def family_config(name: str, cls=ModelConfig, ssm_cls=SSMConfig):
    """tests/test_sharded_serving.py's 'GL' (:272), 'GM' and 'GR' (:461)
    configs."""
    base = dict(family="hybrid", n_layers=2, d_model=64, n_heads=4,
                n_kv_heads=2, head_dim=16, d_ff=128, vocab=64,
                pad_vocab_multiple=16, dtype="float32")
    if name == "GL":
        return cls(**dict(serving.TINY4, name="tiny-gl4", layer_pattern="GL",
                          sliding_window=16))
    if name == "GM":
        return cls(name="gm4", layer_pattern="GM",
                   ssm=ssm_cls(d_state=16, d_conv=4, expand=2, head_dim=32,
                               n_groups=1, chunk=32), **base)
    return cls(name="gr4", layer_pattern="GR", lru_width=64, **base)


# ---------------------------------------------------------------------------
# streams
# ---------------------------------------------------------------------------


def window_stream(cls=Request):
    """The windowed pin's stream (:272): prompts fit the 32-position tail
    ring but pass the 16-token window, budgets past keep_recent; drawn
    from ``default_rng(0)`` after the common stream's prompts."""
    rng = np.random.default_rng(0)
    for l, _ in serving.stream()[0]:
        rng.integers(0, 64, size=(l,))
    reqs = [cls(i, l, g) for i, (l, g) in enumerate(
        [(26, 10), (12, 6), (20, 8), (8, 5), (24, 7), (15, 6)])]
    return reqs, {r.uid: rng.integers(0, 64, size=(r.prompt_len,)).astype(
        np.int32) for r in reqs}


def recurrent_stream(cls=Request):
    """The recurrent pin's stream (:461): 4 requests of 9-60 prompt
    tokens and 9-14 new ones, drawn after the common stream's prompts."""
    rng = np.random.default_rng(0)
    for l, _ in serving.stream()[0]:
        rng.integers(0, 64, size=(l,))
    reqs = [cls(i, l, g) for i, (l, g) in enumerate(
        [(60, 12), (9, 10), (48, 9), (21, 14)])]
    return reqs, {r.uid: rng.integers(0, 64, size=(r.prompt_len,)).astype(
        np.int32) for r in reqs}


def common_stream(cls=Request):
    return serving.requests("", cls)


STREAMS = {"common": common_stream, "window": window_stream,
           "recurrent": recurrent_stream}

CCFG = serving.CCFG                       # n_clusters 8, ring 16, refresh 8
WCCFG = dict(n_clusters=4, iters=2, keep_recent=32, refresh_every=4)

# name -> (model, stream, ServerConfig fields); the model names key the
# weights the caller sends
MOE_SCENARIOS = {
    "blocking": ("qwen2", "common", dict(batch_size=4, max_seq=64)),
    "chunked": ("qwen2", "common", dict(batch_size=4, max_seq=64,
                                        prefill_chunk=8)),
    "a2a_chunked": ("qwen2_a2a", "common",
                    dict(batch_size=4, max_seq=64, prefill_chunk=8)),
    # 4 experts do not divide over ("model", "data") on 2 x 4: the bank
    # spans ("model",), each data shard's buffers stay on its own ranks
    "e4_chunked": ("qwen2_e4", "common",
                   dict(batch_size=4, max_seq=64, prefill_chunk=8)),
    "global_chunked": ("qwen2_global", "common",
                       dict(batch_size=4, max_seq=64, prefill_chunk=8)),
    "mla_blocking": ("dsv3", "common", dict(batch_size=4, max_seq=64)),
}
LAYER_SCENARIOS = {
    "gl_paged": ("GL", "window", dict(batch_size=4, max_seq=64,
                                      kv_compress=WCCFG, prefill_chunk=8,
                                      paged=4)),
    "gm_dense": ("GM", "recurrent", dict(batch_size=4, max_seq=96,
                                         kv_compress=CCFG, prefill_chunk=8)),
    "gm_paged": ("GM", "recurrent", dict(batch_size=4, max_seq=96,
                                         kv_compress=CCFG, prefill_chunk=8,
                                         paged=4)),
    "gr_dense": ("GR", "recurrent", dict(batch_size=4, max_seq=96,
                                         kv_compress=CCFG, prefill_chunk=8)),
    "gr_paged": ("GR", "recurrent", dict(batch_size=4, max_seq=96,
                                         kv_compress=CCFG, prefill_chunk=8,
                                         paged=4)),
    "mla_exact": ("MLA", "common", dict(batch_size=4, max_seq=64)),
    "mla_clustered": ("MLA", "common", dict(batch_size=4, max_seq=64,
                                            kv_compress=CCFG)),
}


def model_config(name: str):
    """The port's config of model ``name`` (a key of the scenarios)."""
    return {"qwen2": lambda: moe_config(),
            "qwen2_a2a": lambda: moe_config("a2a"),
            "qwen2_e4": lambda: moe_config(n_routed=4),
            "qwen2_global": lambda: moe_config("global"),
            "dsv3": lambda: mla_config(),
            "MLA": lambda: mla_config(moe_layers=False)}.get(
        name, lambda: family_config(name))()


def server_config(fields: dict, mesh=None, kv_cls=None, paged_cls=None):
    kw = dict(fields)
    batch, max_seq = kw.pop("batch_size"), kw.pop("max_seq")
    return dict(batch_size=batch, max_seq=max_seq,
                **serving.server_config(kw, mesh, kv_cls, paged_cls))


def serve(cfg, fields, params, stream, mesh=None):
    """(tokens {uid: list}, stats, mesh dispatch counts) of one serve of
    ``stream`` under ServerConfig(**fields)."""
    moe.reset_mesh_dispatches()
    srv = Server(cfg, ServerConfig(**server_config(fields, mesh)), params,
                 device="cpu")
    toks = {o.uid: o.tokens for o in srv.serve(*STREAMS[stream]())}
    return (toks, {k: srv.last_stats.get(k) for k in STATS},
            dict(moe.mesh_dispatches)), srv


def _serve_all(scenarios, weights, mesh):
    out, servers = {}, {}
    for name, (model, stream, fields) in scenarios.items():
        cfg = model_config(model)
        params = bridge.params_from_numpy(weights[model], cfg, "cpu")
        out[name], servers[name] = serve(cfg, fields, params, stream, mesh)
    return out, servers


# ---------------------------------------------------------------------------
# single MoE layer calls on the mesh
# ---------------------------------------------------------------------------

A2A_SHAPE = (4, 8)        # (B, S): 2 rows a data shard, 16 tokens = 4 x 4
# the models of the "sharded" / "global" layer calls, their (B, S) and
# the skew of their inputs: rows that share a direction route alike, so
# experts overflow their capacities (64 rows a data shard: 4 experts keep
# 40 rows each of a shard, 8 experts 24)
LAYER_MODELS = ("qwen2", "qwen2_e4", "qwen2_global")
LAYER_SHAPE = (4, 32)
LAYER_SKEW = 2.0


def layer_inputs(d_model: int, skew: float = 0.0, shape=A2A_SHAPE):
    """A layer call's input x (B, S, d) f32, from ``default_rng(5)``:
    standard normal rows, plus ``skew`` times one common direction when
    ``skew`` is nonzero."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal(shape + (d_model,))
    if skew:
        x = x + skew * rng.standard_normal(d_model)
    return x.astype(np.float32)


def a2a_inputs(d_model: int):
    """The a2a layer call's input."""
    return layer_inputs(d_model)


def skip_return_all_to_all(fn):
    """``moe._all_to_all`` that runs the dispatch exchange and skips the
    return one: each call after the first of a pair hands back its input
    (the planted fault)."""
    calls = [0]

    def faulty(buf, ex):
        calls[0] += 1
        return buf if calls[0] % 2 == 0 else fn(buf, ex)

    return faulty


def layer_call(rules, p_moe, cfg, x, whole=False):
    """``apply_moe`` of x (B, S, d) on the mesh: (y, expert_load,
    drop_frac, branch counts).  The rows split over the data shards as an
    engine step's are (y: this rank's rows), or with ``whole`` every rank
    holds all of them, as in a B=1 admission prefill (y: all rows)."""
    x = torch.from_numpy(x)
    if whole:
        rules = dataclasses.replace(rules, whole_rows=True)
    else:
        n = x.shape[0] // 2
        di = rules.axis_index(("data",))
        x = x[di * n:(di + 1) * n]
    moe.reset_mesh_dispatches()
    with shard_rules.use_rules(rules):
        y, m = moe.apply_moe(p_moe, x, cfg)
    return (y.numpy(), m["expert_load"].numpy(), float(m["drop_frac"]),
            dict(moe.mesh_dispatches))


def flat_leaves(tree, path="") -> dict:
    """{"layers/0/moe/w_gate": numpy leaf, ...} of a parameter tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {path: tree.numpy().copy()}
    out = {}
    for k, v in items:
        out.update(flat_leaves(v, f"{path}/{k}" if path else str(k)))
    return out


# the scenarios whose rank placement the MoE world returns
PLACED = ("blocking", "e4_chunked")


def moe_main(rank, world, weights):
    """weights: the numpy trees of MOE_SCENARIOS' models."""
    mesh = make_serving_mesh("2x4")
    out, servers = _serve_all(MOE_SCENARIOS, weights, mesh)
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    out["coord"] = coord
    out["placement"] = {
        name: (flat_leaves(servers[name].params),
               servers[name].param_bytes())
        for name in PLACED}

    rules = shard_rules.Rules(mesh, shard_rules.default_table(False))

    def placed_moe(model):
        cfg = model_config(model)
        whole = bridge.params_from_numpy(weights[model], cfg, "cpu")
        return cfg, shard_rules.place_serving_params(
            {"moe": whole["layers"][0]["moe"]}, rules)["moe"]

    for model in LAYER_MODELS:
        cfg, p_moe = placed_moe(model)
        x = layer_inputs(cfg.d_model, LAYER_SKEW, LAYER_SHAPE)
        out[f"layer/{model}"] = layer_call(rules, p_moe, cfg, x)
        out[f"layer/{model}/whole"] = layer_call(rules, p_moe, cfg, x,
                                                 whole=True)
    cfg, p_moe = placed_moe("qwen2_a2a")
    x = a2a_inputs(cfg.d_model)
    out["a2a_layer"] = layer_call(rules, p_moe, cfg, x)
    built = moe._all_to_all
    moe._all_to_all = skip_return_all_to_all(built)
    try:
        out["a2a_layer_fault"] = layer_call(rules, p_moe, cfg, x)
    finally:
        moe._all_to_all = built
    return out


def layers_main(rank, world, weights):
    """weights: {"GL", "GM", "GR", "MLA"}: numpy trees."""
    return _serve_all(LAYER_SCENARIOS, weights, make_serving_mesh("2x4"))[0]
