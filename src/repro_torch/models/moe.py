"""Mixture-of-Experts layer: shared + routed top-k, capacity-based dispatch
(port of ``repro.models.moe``).

Dispatch is the sort-rank / capacity-buffer scheme (GShard-style, static
shapes, token-dropping above capacity): tokens are ranked within their
chosen expert, written into an (E, C, d) buffer, run through a batched
expert matmul, and combined back with router weights.  With no mesh every
``impl`` ("sharded", "global", "a2a") reaches the one-shard dispatch, as
in the reference.

Under mesh serving (``sharding.rules.use_rules`` active) a rank holds its
block of the routed-expert banks (``rules.place_serving_params``) and,
in an engine step, only its data shard's rows (a B=1 admission prefill:
all rows, ``Rules.whole_rows``).  The reference's three dispatches then
run with explicit collectives:

  * "sharded" (and "a2a" where its geometry fails): the step's T rows
    split into the mesh's data shards when T divides (the decision on the
    global row count), each with its own ``capacity(T / ds)`` buffer
    (E, C, d).  Every rank that owns an expert block runs it over every
    shard's buffer rows at once: the buffers are gathered over ``data``
    when the experts span it, and the owners' outputs are gathered over
    the expert group (``_gather_experts``), so each expert's rows go
    through one product of its weights and each rank combines its own
    tokens in k order;
  * "global": one capacity over the whole step; a rank gathers its data
    group's rows, dispatches them all and keeps its own;
  * "a2a": one routed expert a rank over ("model", "data") and rows that
    divide into ``model`` chunks a data shard: each rank routes its chunk,
    packs a (n_ep, cap, d) send buffer by stable ranks, ``all_to_all``
    takes it to the experts' owners and the inverse brings the outputs
    back, and an ``all_gather`` over ``model`` collects the chunks
    (``_apply_moe_a2a``).

``mesh_dispatches`` counts the mesh branch each MoE layer call took.

Under a training step's rules (``Rules.train_rows``, ``launch.steps.
MeshTrainStep``) a rank holds every expert (its leaves gathered whole)
and its rows of the global batch, and gives the reference's drops
without an exchange (:func:`_train_dispatch`): its rows cut into the
reference's data shards, each with its own capacity (``impl="a2a"``
where the reference's geometry takes the all-to-all: each data shard's
rows in ``model`` chunks, each chunk's own capacity a destination expert,
as its exchange packs them).  The expert load and the kept share are
summed over the row axes before they are read, and the mean router
probabilities stay this rank's part of the global mean, so the
auxiliary loss is this rank's part of the global one and its gradient
sums to the global gradient.

Routers: softmax (Qwen2-MoE, no top-k renorm) and sigmoid with selection
bias (DeepSeek-V3 aux-loss-free balancing; the bias is a non-gradient
buffer updated from expert load by :func:`update_router_bias`).

Every step that decides which tokens an expert keeps is exact and
deterministic: the router runs in f32 on its f32 weights, top-k breaks
ties toward the lower expert index (as ``jax.lax.top_k``), tokens are
ranked within an expert by a stable sort (as ``jnp.argsort``), and each
kept token is written to its own buffer row.  The combine adds a token's
K expert outputs in k order in the compute dtype, as the reference's
scatter-add does, so a token's output never depends on run order.  The
expert FFNs are plain batched matmuls, as in the reference (no Pallas
kernel there).
"""

from __future__ import annotations

import math

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, cdtype, dense_init, init_mlp
from repro_torch.sharding import rules as shard_rules


def init_moe(generator, cfg: ModelConfig, device=None):
    """The reference's ``init_moe`` leaves: "router" (d, E) and "bias" (E,)
    in f32 (the reference reads both uncast), the experts' "w_gate" /
    "w_up" (E, d, f) and "w_down" (E, f, d) in the config dtype, and the
    shared expert's MLP under "shared" when ``n_shared`` > 0."""
    m = cfg.moe
    d, dt = cfg.d_model, cdtype(cfg)
    p = {
        "router": dense_init(generator, (d, m.n_routed), device=device),
        "bias": torch.zeros(m.n_routed, dtype=torch.float32, device=device),
        "w_gate": dense_init(generator, (m.n_routed, d, m.d_expert),
                             dtype=dt, device=device),
        "w_up": dense_init(generator, (m.n_routed, d, m.d_expert),
                           dtype=dt, device=device),
        "w_down": dense_init(generator, (m.n_routed, m.d_expert, d),
                             dtype=dt, device=device),
    }
    if m.n_shared > 0:
        p["shared"] = init_mlp(generator, cfg,
                               m.d_shared or m.d_expert * m.n_shared, device)
    return p


def _top_k(v: torch.Tensor, k: int):
    """(values, indices) of the k largest entries of each row, ties to the
    lower index (``jax.lax.top_k``'s order): a stable descending sort."""
    idx = torch.sort(v, dim=-1, descending=True, stable=True).indices[:, :k]
    return torch.gather(v, 1, idx), idx


def route(p, x_flat: torch.Tensor, cfg: ModelConfig):
    """x_flat (T, d) → (weights (T, K) f32, idx (T, K) int32, probs (T, E)
    f32)."""
    m = cfg.moe
    logits = x_flat.to(torch.float32) @ p["router"].to(torch.float32)
    if m.router == "sigmoid":
        probs = torch.sigmoid(logits)
        _, idx = _top_k(probs + p["bias"][None, :], m.top_k)
        w = torch.gather(probs, 1, idx)
    else:
        e = torch.exp(logits - logits.amax(-1, keepdim=True))
        probs = e / e.sum(-1, keepdim=True)
        w, idx = _top_k(probs, m.top_k)
    if m.norm_topk:
        w = w / torch.clamp(w.sum(-1, keepdim=True), min=1e-20)
    return w.to(torch.float32), idx.to(torch.int32), probs


def update_router_bias(bias: torch.Tensor, expert_load: torch.Tensor,
                       gamma: float = 1e-3) -> torch.Tensor:
    """DeepSeek-V3 aux-loss-free balancing: nudge the (non-gradient)
    selection bias toward under-loaded experts, bias += γ·sign(mean_load −
    load)."""
    load = expert_load.to(torch.float32)
    return bias + gamma * torch.sign(load.mean() - load)


def capacity(cfg: ModelConfig, t: int) -> int:
    """Buffer rows an expert keeps for ``t`` tokens: ``capacity_factor``
    times its fair share, rounded up to a multiple of 8, at least 8."""
    m = cfg.moe
    c = int(m.capacity_factor * t * m.top_k / m.n_routed)
    return max(8, ((c + 7) // 8) * 8)


def _act(cfg: ModelConfig):
    # jax.nn.gelu defaults to the tanh approximation
    if cfg.mlp_kind == "swiglu":
        return F.silu
    return lambda v: F.gelu(v, approximate="tanh")


def _expert_ffn(p, buf: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Every expert of ``p``'s banks over its buffer rows: buf (NB, E, C,
    d) → (NB, E, C, d), each expert's NB x C rows through one product of
    its weights."""
    dt = cdtype(cfg)
    nb, e, c, d = buf.shape
    rows = buf.transpose(0, 1).reshape(e, nb * c, d) if nb > 1 else buf[0]
    g = _act(cfg)(torch.bmm(rows, p["w_gate"].to(dt)))
    u = torch.bmm(rows, p["w_up"].to(dt))
    out = torch.bmm(g * u, p["w_down"].to(dt))           # (E, NB*C, d)
    return out.reshape(e, nb, c, d).transpose(0, 1)


def _dispatch_compute(p, x_flat: torch.Tensor, cfg: ModelConfig,
                      ds: int = 1, ffn=None, cap: int = None):
    """Capacity-buffer dispatch of x_flat (T, d) over ``ds`` data shards
    of T / ds rows, each with its own ``capacity(cfg, T / ds)``.

    Returns (y (T, d), counts (E,) f32, mean_probs (E,), keep_mean): the
    reference's ``_dispatch_compute``.  An assignment (token, k) past its
    expert's capacity in its shard is dropped: it writes no buffer row and
    adds nothing to its token.  ``ffn(buf (ds, E, C, d)) -> (ds, E, C,
    d)`` runs the experts (default :func:`_expert_ffn` over every expert
    of ``p``)."""
    m = cfg.moe
    dt = cdtype(cfg)
    t, d = x_flat.shape
    e, k = m.n_routed, m.top_k
    dev = x_flat.device
    tl = t // ds
    w, idx, probs = route(p, x_flat, cfg)                # (T,K),(T,K),(T,E)
    cap = capacity(cfg, tl) if cap is None else cap
    flat_e = idx.reshape(ds, tl * k).long()
    token_id = torch.arange(tl * k, device=dev) // k
    row = torch.arange(ds, device=dev)[:, None]
    buf, pos_c, keep, counts = _pack(
        x_flat.reshape(ds, tl, d)[row, token_id].to(dt), flat_e, e, cap)
    out_buf = (ffn or (lambda b: _expert_ffn(p, b, cfg)))(buf)
    y = _combine(out_buf[row, flat_e, pos_c], w, keep, k)
    return (y, counts.sum(0).to(torch.float32), probs.mean(0),
            keep.to(torch.float32).mean())


def _pack(rows: torch.Tensor, flat_e: torch.Tensor, n_dest: int, cap: int):
    """Capacity-buffer packing by stable ranks: assignment i of shard s
    (``flat_e[s, i]``, its destination of ``n_dest``) writes ``rows[s,
    i]`` to row ``pos`` of its destination's block, ``pos`` its rank among
    the shard's assignments to that destination in token order.  Returns
    (buf (DS, n_dest, cap, d), pos_c, keep, counts (DS, n_dest) int64);
    an assignment with ``pos >= cap`` is dropped (``keep`` False)."""
    ds, tk = flat_e.shape
    dev = flat_e.device
    sort_idx = torch.argsort(flat_e, dim=1, stable=True)
    ranks = torch.empty_like(sort_idx).scatter_(
        1, sort_idx, torch.arange(tk, device=dev).expand(ds, tk))
    # bincount as a scatter-add, which also runs on the meta device (the
    # dry run's count)
    counts = torch.zeros((ds, n_dest), dtype=torch.int64,
                         device=dev).scatter_add_(1, flat_e,
                                                  torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 1) - counts
    pos = ranks - torch.gather(starts, 1, flat_e)
    keep = pos < cap
    # kept assignments own distinct rows (e, pos < cap); dropped ones all
    # go to a spare row cap that no expert reads, so no write can land on
    # a kept row and the buffer holds what the reference's add into zeros
    # does, without a host sync to select the kept ones
    buf = torch.zeros((ds, n_dest, cap + 1, rows.shape[-1]),
                      dtype=rows.dtype, device=dev)
    buf[torch.arange(ds, device=dev)[:, None], flat_e,
        torch.where(keep, pos, cap)] = rows
    return buf[:, :, :cap], torch.clamp(pos, 0, cap - 1), keep, counts


def _combine(y_slots: torch.Tensor, w: torch.Tensor, keep: torch.Tensor,
             k: int) -> torch.Tensor:
    """y_slots (DS, TK, d): each assignment's expert output → (T, d), a
    token's K outputs weighted by its router weights ``w`` (T, K) (0 where
    dropped) and added in k order: the reference's scatter-add into zeros,
    one assignment at a time (0 + a == a)."""
    d = y_slots.shape[-1]
    wk = (w.reshape(keep.shape) * keep.to(torch.float32)).to(y_slots.dtype)
    contrib = (y_slots * wk[..., None]).reshape(-1, k, d)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return y


# ---------------------------------------------------------------------------
# Mesh serving
# ---------------------------------------------------------------------------

mesh_dispatches = {"sharded": 0, "global": 0, "a2a": 0}


def reset_mesh_dispatches() -> None:
    for key in mesh_dispatches:
        mesh_dispatches[key] = 0


def _n_data_shards(rules) -> int:
    """The reference's data-parallel shard count under ``rules``: the size
    of the mesh's batch axes ("pod", "data"), whether or not this step's
    rows are split over them."""
    sizes = mesh_sizes(rules.mesh)
    return math.prod(sizes[a] for a in ("pod", "data") if a in sizes)


class ExpertGroup:
    """This rank's block of the routed experts under the rules: experts
    ``lo`` to ``lo + n_local`` of ``n_routed``, block ``index`` of the
    ``size`` ranks of ``group`` that the expert dim spans
    (``rules.expert_axes``); ``ranks[b]`` is the group rank that holds
    block b."""

    def __init__(self, rules, n_routed: int, held: int):
        axes = shard_rules.expert_axes(rules, n_routed)
        self.axes = axes or ()
        self.size = rules.size(axes) if axes else 1
        self.index = rules.axis_index(axes) if axes else 0
        self.n_local = n_routed // self.size
        self.lo = self.index * self.n_local
        if held != self.n_local:
            raise ValueError(
                f"this rank holds {held} of {n_routed} routed experts but "
                f"the mesh places {self.n_local} on it (over {self.axes}): "
                f"serve the tree from rules.place_serving_params")
        mesh = rules.mesh
        names = tuple(mesh.mesh_dim_names)
        if not axes:
            self.group, self.ranks = None, [0]
        elif len(axes) == 1:
            self.group = rules.group(axes)
            self.ranks = list(range(self.size))
        elif set(axes) == set(names):
            # the whole mesh, which is the whole world (launch.mesh): group
            # ranks are global ranks, blocks fold the axes in their order
            self.group = dist.group.WORLD
            grid = mesh.mesh.permute(*[names.index(a) for a in axes])
            self.ranks = [int(r) for r in grid.reshape(-1)]
        else:
            raise ValueError(f"no expert group over {axes} of a mesh of "
                             f"{names}: a serving mesh is (data, model)")

    def gather(self, out: torch.Tensor) -> torch.Tensor:
        """(NB, n_local, C, d) outputs of this rank's experts → (NB,
        n_routed, C, d), every block in expert order (an ``all_gather``
        over the expert group)."""
        if self.group is None:
            return out
        out = out.contiguous()
        parts = [torch.empty_like(out) for _ in range(len(self.ranks))]
        dist.all_gather(parts, out, group=self.group)
        return torch.cat([parts[r] for r in self.ranks], dim=1)

    def spans_data(self) -> bool:
        return "data" in self.axes


def _all_gather(x: torch.Tensor, group, n: int) -> torch.Tensor:
    """x from every rank of ``group`` (``n`` ranks), stacked in group-rank
    order along a new leading dim."""
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def _placed_ffn(p, cfg: ModelConfig, ex: ExpertGroup, data_group=None,
                n_data: int = 1, data_index: int = 0):
    """The experts' FFN of :func:`_dispatch_compute` when this rank holds
    block ``ex`` of them.  ``data_group``: this rank's buffer is its data
    shard's only (rows split over ``n_data`` shards); the other shards'
    are gathered first when the experts span ``data``, and only this
    shard's outputs are returned."""

    def ffn(buf):
        gather_data = data_group is not None and ex.spans_data()
        if gather_data:
            buf = _all_gather(buf[0], data_group, n_data)
        mine = buf[:, ex.lo:ex.lo + ex.n_local]
        out = ex.gather(_expert_ffn(p, mine, cfg))
        return out[data_index:data_index + 1] if gather_data else out

    return ffn


def _mesh_dispatch(p, x_flat: torch.Tensor, cfg: ModelConfig, rules):
    """The "sharded" / "global" dispatch of this rank's rows x_flat (T_here,
    d) on a mesh (module docstring).  Returns :func:`_dispatch_compute`'s
    tuple for this rank's rows, the metrics over every row of the step."""
    m = cfg.moe
    rs = shard_rules.row_shards(rules)
    data_group = data_index = None
    if rs > 1:
        axes = rules.table["batch"]
        data_group, data_index = rules.group(axes), rules.axis_index(axes)
    t_here, d = x_flat.shape
    t = t_here * rs
    ex = ExpertGroup(rules, m.n_routed, p["w_gate"].shape[0])
    if m.impl == "global":
        mesh_dispatches["global"] += 1
        if rs > 1:
            # one capacity over the whole step: every row, every rank
            x_all = _all_gather(x_flat, data_group, rs).reshape(t, d)
            y, counts, pbar, keep = _dispatch_compute(
                p, x_all, cfg, 1, _placed_ffn(p, cfg, ex))
            return (y[data_index * t_here:(data_index + 1) * t_here],
                    counts, pbar, keep)
        return _dispatch_compute(p, x_flat, cfg, 1,
                                 _placed_ffn(p, cfg, ex))
    mesh_dispatches["sharded"] += 1
    ds = _n_data_shards(rules)
    if t % ds != 0:
        ds = 1
    if rs == 1:
        # every rank holds all rows (a B=1 admission prefill): the shards
        # are blocks of them, each rank dispatches all
        return _dispatch_compute(p, x_flat, cfg, ds,
                                 _placed_ffn(p, cfg, ex))
    if ds != rs:
        raise ValueError(f"{rs} row shards on this mesh but the dispatch "
                         f"splits {t} rows into {ds}")
    y, counts, pbar, keep = _dispatch_compute(
        p, x_flat, cfg, 1,
        _placed_ffn(p, cfg, ex, data_group, rs, data_index))
    # the step's metrics: every data shard's counts, probs and kept share
    tot = torch.cat([counts, pbar * t_here,
                     (keep * t_here * m.top_k).reshape(1)])
    dist.all_reduce(tot, group=data_group)
    e = m.n_routed
    return (y, tot[:e], tot[e:2 * e] / t, tot[2 * e] / (t * m.top_k))


def _a2a_geometry(cfg: ModelConfig, rules, t_here: int) -> bool:
    """Whether the explicit all-to-all dispatch applies to a step whose
    rank holds ``t_here`` rows: one routed expert a rank over ("model",
    "data"), the step's rows split over the data shards as the reference's
    shard_map splits them (a rank holding all rows of a mesh with data
    shards, a B=1 admission prefill, takes the sharded path), and the
    local rows dividing into ``model`` chunks."""
    if rules is None:
        return False
    sizes = mesh_sizes(rules.mesh)
    if cfg.moe.n_routed != sizes["model"] * sizes["data"]:
        return False
    if shard_rules.row_shards(rules) != _n_data_shards(rules):
        return False
    return t_here % sizes["model"] == 0


def _all_to_all(buf: torch.Tensor, ex: ExpertGroup) -> torch.Tensor:
    """buf (n_ep, cap, d), block i for the owner of expert i → (n_ep, cap,
    d), block i from the rank that owns expert i (one ``all_to_all`` over
    the expert group, which is the whole mesh)."""
    order = torch.tensor(ex.ranks, device=buf.device)
    block_of = torch.empty_like(order)
    block_of[order] = torch.arange(len(ex.ranks), device=buf.device)
    send = buf[block_of].contiguous()                   # group-rank order
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=ex.group)
    return recv[order]


def _apply_moe_a2a(p, x: torch.Tensor, cfg: ModelConfig, rules):
    """The reference's ``_apply_moe_a2a`` on this rank's rows x (B_loc, S,
    d): (y (B_loc, S, d), metrics) with the metrics summed over every
    rank in f32."""
    m = cfg.moe
    dt = cdtype(cfg)
    b, s, d = x.shape
    dev = x.device
    ex = ExpertGroup(rules, m.n_routed, p["w_gate"].shape[0])
    model_n = mesh_sizes(rules.mesh)["model"]
    t_loc = b * s
    tc = t_loc // model_n                                # my chunk size
    j = rules.axis_index(("model",))
    chunk = x.reshape(t_loc, d)[j * tc:(j + 1) * tc]

    w, idx, probs = route(p, chunk, cfg)
    k = m.top_k
    tk = tc * k
    n_ep = ex.size
    flat_e = idx.reshape(1, tk).long()                   # dst per slot
    cap = max(8, int(-(-m.capacity_factor * tk // n_ep)))
    token_id = torch.arange(tk, device=dev) // k
    send, pos_c, keep, counts = _pack(chunk[token_id].to(dt)[None], flat_e,
                                      n_ep, cap)
    recv = _all_to_all(send[0], ex)

    # my (single) expert over everything I received
    rows = recv.reshape(n_ep * cap, d)
    g = _act(cfg)(rows @ p["w_gate"][0].to(dt))
    u = rows @ p["w_up"][0].to(dt)
    out_rows = (g * u) @ p["w_down"][0].to(dt)
    ret = _all_to_all(out_rows.reshape(n_ep, cap, d), ex)
    y_chunk = _combine(ret[flat_e, pos_c], w, keep, k)
    y = _all_gather(y_chunk, rules.group(("model",)), model_n)

    # metrics: global expert load, mean probs and kept share
    f32 = torch.float32
    tot = torch.cat([counts[0].to(f32), probs.sum(0),
                     torch.full((1,), tc, dtype=f32, device=dev),
                     keep.to(f32).sum().reshape(1),
                     torch.full((1,), tk, dtype=f32, device=dev)])
    dist.all_reduce(tot)
    load, pbar = tot[:n_ep], tot[n_ep:2 * n_ep] / tot[2 * n_ep]
    keep_mean = tot[2 * n_ep + 1] / torch.clamp(tot[2 * n_ep + 2], min=1.0)
    return y.reshape(b, s, d), load, pbar, keep_mean


def _train_dispatch(p, x_flat: torch.Tensor, cfg: ModelConfig, rules):
    """A training step's dispatch of this rank's rows x_flat (T_here, d)
    under ``rules.train_rows`` (module docstring): (y, expert load over
    the step, this rank's part of the mean router probabilities, the
    step's kept share, the step's token count)."""
    m = cfg.moe
    rows = rules.train_rows
    rs = rules.size(rows) if rows else 1
    t_here = x_flat.shape[0]
    t = t_here * rs
    sizes = mesh_sizes(rules.mesh)
    n_batch = _n_data_shards(rules)
    cap = None
    if (m.impl == "a2a" and m.n_routed == sizes["model"] * sizes["data"]
            and t % n_batch == 0 and (t // n_batch) % sizes["model"] == 0):
        ds = n_batch * sizes["model"]
        tk = t // ds * m.top_k
        cap = max(8, int(-(-m.capacity_factor * tk // m.n_routed)))
    else:
        ds = n_batch if m.impl in ("sharded", "a2a") else 1
        if t % ds != 0:
            ds = 1
    if ds % rs != 0:
        raise ValueError(
            f"MoE impl {m.impl!r} dispatches {t} rows in {ds} shard(s) but "
            f"this mesh splits the rows over {rs} ranks: a shard would "
            "span ranks")
    y, counts, pbar, keep = _dispatch_compute(p, x_flat, cfg, ds // rs,
                                              cap=cap)
    if rs > 1:
        e = m.n_routed
        tot = torch.cat([counts, (keep * t_here).reshape(1)])
        shard_rules.all_reduce(tot, rows, rules)
        counts, keep = tot[:e], tot[e] / t
        pbar = pbar * (t_here / t)
    return y, counts, pbar, keep, t


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (y (B, S, d), {"aux_loss", "expert_load",
    "drop_frac"}): the routed experts' capacity-buffer dispatch over all B
    x S tokens at once (on a mesh: this rank's rows, the module
    docstring's dispatches), plus the shared expert."""
    m = cfg.moe
    b, s, d = x.shape
    rules = shard_rules.current_rules()
    if rules is None:
        y, counts, pbar, keep_mean = _dispatch_compute(p, x.reshape(-1, d),
                                                       cfg)
        t = b * s
    elif rules.train_rows is not None:
        y, counts, pbar, keep_mean, t = _train_dispatch(
            p, x.reshape(-1, d), cfg, rules)
    elif m.impl == "a2a" and _a2a_geometry(cfg, rules, b * s):
        mesh_dispatches["a2a"] += 1
        y, counts, pbar, keep_mean = _apply_moe_a2a(p, x, cfg, rules)
        t = b * s * shard_rules.row_shards(rules)
    else:
        y, counts, pbar, keep_mean = _mesh_dispatch(p, x.reshape(-1, d),
                                                    cfg, rules)
        t = b * s * shard_rules.row_shards(rules)
    y = y.reshape(b, s, d)
    if m.n_shared > 0:
        y = y + apply_mlp(p["shared"], x, cfg)
    # load-balance metrics: f_e = dispatch fraction, P_e = mean router prob
    f = counts / max(t * m.top_k, 1)
    aux = (m.n_routed * torch.sum(f * pbar)) * m.aux_loss_coef
    return y, {"aux_loss": aux, "expert_load": counts,
               "drop_frac": 1.0 - keep_mean}
