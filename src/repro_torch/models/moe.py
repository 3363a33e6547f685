"""Mixture-of-Experts layer: shared + routed top-k, capacity-based dispatch
(port of ``repro.models.moe`` less its all-to-all path).

Dispatch is the sort-rank / capacity-buffer scheme (GShard-style, static
shapes, token-dropping above capacity): tokens are ranked within their
chosen expert, written into an (E, C, d) buffer, run through a batched
expert matmul, and combined back with router weights.  The reference runs
it per data shard of a mesh; with no mesh, as here, that is one shard, so
every ``impl`` ("sharded", "global", "a2a") reaches the same dispatch.
The all-to-all path and expert placement need a mesh (ROADMAP Queue A
item 10b).

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

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_mlp, cdtype, dense_init, init_mlp


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


def _dispatch_compute(p, x_flat: torch.Tensor, cfg: ModelConfig):
    """Capacity-buffer dispatch of x_flat (T, d) over one data shard.

    Returns (y (T, d), counts (E,) f32, mean_probs (E,), keep_mean): the
    reference's ``_dispatch_compute`` at ``ds`` = 1.  An assignment (token,
    k) past its expert's ``capacity`` is dropped: it writes no buffer row
    and adds nothing to its token."""
    m = cfg.moe
    dt = cdtype(cfg)
    t, d = x_flat.shape
    e, k = m.n_routed, m.top_k
    dev = x_flat.device
    w, idx, probs = route(p, x_flat, cfg)                # (T,K),(T,K),(T,E)
    cap = capacity(cfg, t)
    tk = t * k
    flat_e = idx.reshape(tk).long()
    token_id = torch.arange(tk, device=dev) // k

    # rank each assignment within its expert, in token order
    sort_idx = torch.argsort(flat_e, stable=True)
    ranks = torch.empty_like(sort_idx)
    ranks[sort_idx] = torch.arange(tk, device=dev)
    # (E,) int64: bincount as a scatter-add, which also runs on the meta
    # device (the dry run's count)
    counts = torch.zeros(e, dtype=torch.int64, device=dev).index_add_(
        0, flat_e, torch.ones_like(flat_e))
    starts = torch.cumsum(counts, 0) - counts
    pos = ranks - starts[flat_e]
    keep = pos < cap
    pos_c = torch.clamp(pos, 0, cap - 1)

    # kept assignments own distinct rows (e, pos < cap); dropped ones all
    # go to a spare row cap that no expert reads, so no write can land on
    # a kept row and the buffer holds what the reference's add into zeros
    # does, without a host sync to select the kept ones
    buf = torch.zeros((e, cap + 1, d), dtype=dt, device=dev)
    buf[flat_e, torch.where(keep, pos, cap)] = x_flat[token_id].to(dt)
    buf = buf[:, :cap]

    act = _act(cfg)
    g = act(torch.bmm(buf, p["w_gate"].to(dt)))
    u = torch.bmm(buf, p["w_up"].to(dt))
    out_buf = torch.bmm(g * u, p["w_down"].to(dt))       # (E, C, d)

    y_slots = out_buf[flat_e, pos_c]                     # (TK, d)
    wk = (w.reshape(tk) * keep.to(torch.float32)).to(dt)
    contrib = (y_slots * wk[:, None]).reshape(t, k, d)
    # the reference's scatter-add into zeros, one assignment at a time in
    # k order (0 + a == a)
    y = contrib[:, 0]
    for j in range(1, k):
        y = y + contrib[:, j]
    return (y, counts.to(torch.float32), probs.mean(0),
            keep.to(torch.float32).mean())


def apply_moe(p, x: torch.Tensor, cfg: ModelConfig):
    """x (B, S, d) → (y (B, S, d), {"aux_loss", "expert_load",
    "drop_frac"}): the routed experts' capacity-buffer dispatch over all B
    x S tokens at once, plus the shared expert."""
    m = cfg.moe
    b, s, d = x.shape
    t = b * s
    y, counts, pbar, keep_mean = _dispatch_compute(p, x.reshape(t, d), cfg)
    y = y.reshape(b, s, d)
    if m.n_shared > 0:
        y = y + apply_mlp(p["shared"], x, cfg)
    # load-balance metrics: f_e = dispatch fraction, P_e = mean router prob
    f = counts / max(t * m.top_k, 1)
    aux = (m.n_routed * torch.sum(f * pbar)) * m.aux_loss_coef
    return y, {"aux_loss": aux, "expert_load": counts,
               "drop_frac": 1.0 - keep_mean}
