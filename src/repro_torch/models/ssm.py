"""Mamba-2 (SSD, state-space duality) block (port of ``repro.models.ssm``).

Prefill runs the chunked SSD algorithm (an intra-chunk quadratic term plus
an inter-chunk linear state recurrence), so the state never materializes
per position.  Decode is the O(1)-per-token recurrence on an (H, hd, N)
state with a rolling depthwise-conv buffer.  The serving engine prefills
by stepping the decode (``transformer.sublayer_prefill`` with
``recurrent_mode="sequential"``), so its admissions give the same bits
chunked or blocking; :func:`ssm_prefill` is the chunked form, and
:func:`ssm_train` the training forward over it.

Parameters: ``in_proj``, ``conv_w``, ``conv_b`` and ``out_proj`` are stored
in the config dtype (the reference casts its f32 masters at every use);
``A_log``, ``D``, ``dt_bias`` and ``norm`` stay f32, as the reference
reads them uncast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, dense_init

#: the masked entries of the within-chunk decay matrix (exp(NEG) is 0)
NEG = -1e30


def _dims(cfg: ModelConfig):
    s = cfg.ssm
    d_in = s.expand * cfg.d_model
    h = d_in // s.head_dim
    conv_ch = d_in + 2 * s.n_groups * s.d_state
    return d_in, h, conv_ch


def init_ssm(generator, cfg: ModelConfig, device=None):
    """Every leaf of the reference's ``init_ssm``: ``A_log`` starts at 0,
    ``D`` and ``norm`` at 1, ``dt_bias`` and ``conv_b`` at 0."""
    s, d, dt = cfg.ssm, cfg.d_model, cdtype(cfg)
    d_in, h, conv_ch = _dims(cfg)
    proj_out = 2 * d_in + 2 * s.n_groups * s.d_state + h
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "in_proj": dense_init(generator, (d, proj_out), dtype=dt,
                              device=device),
        "conv_w": dense_init(generator, (s.d_conv, conv_ch), 0.2, dtype=dt,
                             device=device),
        "conv_b": torch.zeros(conv_ch, dtype=dt, device=device),
        "A_log": torch.zeros(h, **f32),
        "D": torch.ones(h, **f32),
        "dt_bias": torch.zeros(h, **f32),
        "norm": torch.ones(d_in, **f32),
        "out_proj": dense_init(generator, (d_in, d), dtype=dt, device=device),
    }


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0), with no linear cut-over (torch's
    ``F.softplus`` returns x above 20)."""
    return torch.logaddexp(x, torch.zeros((), dtype=x.dtype, device=x.device))


def _split(p, x, cfg: ModelConfig):
    s = cfg.ssm
    d_in, _, _ = _dims(cfg)
    gn = s.n_groups * s.d_state
    zxbcdt = x @ p["in_proj"]
    z = zxbcdt[..., :d_in]
    xbc = zxbcdt[..., d_in:2 * d_in + 2 * gn]
    dt_raw = zxbcdt[..., 2 * d_in + 2 * gn:]
    return z, xbc, dt_raw


def _conv_train(p, xbc, cfg: ModelConfig):
    """Causal depthwise conv over time: xbc (B, S, C)."""
    k = cfg.ssm.d_conv
    w = p["conv_w"].to(xbc.dtype)                        # (k, C)
    pad = F.pad(xbc, (0, 0, k - 1, 0))
    s = xbc.shape[1]
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu(out + p["conv_b"].to(xbc.dtype))


def _segsum(a):
    """Within-chunk cumulative-decay matrix: a (..., Q) → L (..., Q, Q)
    with L[i, j] = sum(a[j+1..i]) for i >= j, NEG otherwise."""
    q = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]           # (..., i, j)
    iq = torch.arange(q, device=a.device)
    mask = iq[:, None] >= iq[None, :]
    return torch.where(mask, diff, torch.full_like(diff, NEG))


def ssd_chunked(x, dt, A, B, C, D, chunk: int):
    """SSD forward.

    x (B, S, H, P), dt (B, S, H) (post-softplus), A (H,) (negative),
    B, C (B, S, G, N), D (H,) → y (B, S, H, P) f32 and the final state
    (B, H, P, N) f32.  Heads are grouped: G divides H."""
    b, s, h, p = x.shape
    g, n = B.shape[2], B.shape[3]
    pad = (-s) % chunk
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, 0, 0, pad))
    nc = (s + pad) // chunk
    rep = h // g

    xc = x.reshape(b, nc, chunk, h, p).float()
    dtc = dt.reshape(b, nc, chunk, h).float()
    Bc = B.reshape(b, nc, chunk, g, n).float()
    Cc = C.reshape(b, nc, chunk, g, n).float()

    a = dtc * A                                          # (B,Nc,Q,H) <= 0
    cum = torch.cumsum(a, dim=2)                         # within-chunk

    # intra-chunk (diagonal blocks)
    L = torch.exp(_segsum(a.permute(0, 1, 3, 2)))        # (B,Nc,H,Q,Q)
    scores = torch.einsum("bcqgn,bcsgn->bcgqs", Cc, Bc)  # (B,Nc,G,Q,S)
    scores = torch.repeat_interleave(scores, rep, dim=2)  # (B,Nc,H,Q,S)
    y_diag = torch.einsum("bchqs,bcsh,bcshp->bcqhp", scores * L, dtc, xc)

    # chunk states
    Bh = torch.repeat_interleave(Bc, rep, dim=3)         # (B,Nc,Q,H,N)
    decay_out = torch.exp(cum[:, :, -1:, :] - cum)       # (B,Nc,Q,H)
    states = torch.einsum("bcqhn,bcqh,bcqhp->bchpn", Bh, decay_out * dtc, xc)

    # inter-chunk recurrence: the state before each chunk
    chunk_decay = torch.exp(cum[:, :, -1, :])            # (B,Nc,H)
    st = torch.zeros((b, h, p, n), dtype=torch.float32, device=x.device)
    prefix = []
    for c in range(nc):
        prefix.append(st)
        st = st * chunk_decay[:, c, :, None, None] + states[:, c]
    prefix = torch.stack(prefix, dim=1)                  # (B,Nc,H,P,N)

    decay_in = torch.exp(cum)                            # (B,Nc,Q,H)
    Ch = torch.repeat_interleave(Cc, rep, dim=3)         # (B,Nc,Q,H,N)
    y_off = torch.einsum("bcqhn,bchpn,bcqh->bcqhp", Ch, prefix, decay_in)

    y = (y_diag + y_off).reshape(b, s + pad, h, p)[:, :s]
    y = y + D[None, None, :, None] * x[:, :s].float()
    return y, st


def _gated_out(p, y, z, cfg: ModelConfig):
    """The gated RMSNorm before the output projection: y (..., d_in) in
    the config dtype, gated by silu(z)."""
    dt_ = cdtype(cfg)
    gated = (y * F.silu(z)).float()
    var = (gated * gated).mean(-1, keepdim=True)
    gated = (gated * torch.rsqrt(var + cfg.norm_eps) * p["norm"]).to(dt_)
    return gated @ p["out_proj"]


def ssm_prefill(p, x, cfg: ModelConfig):
    """Chunked SSD forward of x (B, S, d) → (y (B, S, d), the final
    {"conv", "ssm"} state for decode)."""
    s_cfg = cfg.ssm
    dt_ = cdtype(cfg)
    d_in, hh, _ = _dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state
    z, xbc_raw, dt_raw = _split(p, x, cfg)
    xbc = _conv_train(p, xbc_raw, cfg)
    b, s, _ = x.shape
    xh = xbc[..., :d_in].reshape(b, s, hh, s_cfg.head_dim)
    Bm = xbc[..., d_in:d_in + gn].reshape(b, s, s_cfg.n_groups,
                                          s_cfg.d_state)
    Cm = xbc[..., d_in + gn:].reshape(b, s, s_cfg.n_groups, s_cfg.d_state)
    dt = _softplus(dt_raw.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    y, final_state = ssd_chunked(xh, dt, A, Bm, Cm, p["D"], s_cfg.chunk)
    out = _gated_out(p, y.reshape(b, s, d_in).to(dt_), z, cfg)
    k1 = s_cfg.d_conv - 1
    conv_tail = (xbc_raw[:, -k1:] if s >= k1
                 else F.pad(xbc_raw, (0, 0, k1 - s, 0)))
    return out, {"conv": conv_tail.to(dt_), "ssm": final_state}


def ssm_train(p, x, cfg: ModelConfig):
    """x (B, S, d) → y (B, S, d): the chunked SSD forward (the reference's
    training form)."""
    return ssm_prefill(p, x, cfg)[0]


def init_cache_ssm(cfg: ModelConfig, batch: int, dtype=None, device=None):
    s = cfg.ssm
    dt = dtype or cdtype(cfg)
    _, h, conv_ch = _dims(cfg)
    return {
        "conv": torch.zeros((batch, s.d_conv - 1, conv_ch), dtype=dt,
                            device=device),
        "ssm": torch.zeros((batch, h, s.head_dim, s.d_state),
                           dtype=torch.float32, device=device),
    }


def ssm_decode(p, x, cfg: ModelConfig, cache):
    """x (B, 1, d) → (y (B, 1, d), cache').  Functional: the returned state
    is new tensors and ``cache`` is left as it was."""
    s_cfg = cfg.ssm
    dt_ = cdtype(cfg)
    d_in, h, _ = _dims(cfg)
    gn = s_cfg.n_groups * s_cfg.d_state
    b = x.shape[0]
    z, xbc, dt_raw = _split(p, x, cfg)                   # (B,1,·)

    conv_buf = torch.cat([cache["conv"], xbc.to(cache["conv"].dtype)], dim=1)
    w = p["conv_w"].to(dt_)                              # (k, C)
    xbc_t = F.silu((conv_buf * w[None]).sum(dim=1)
                   + p["conv_b"].to(dt_))                # (B, C)
    new_conv = conv_buf[:, 1:]

    xh = xbc_t[:, :d_in].reshape(b, h, s_cfg.head_dim).float()
    Bm = xbc_t[:, d_in:d_in + gn].reshape(b, s_cfg.n_groups, s_cfg.d_state)
    Cm = xbc_t[:, d_in + gn:].reshape(b, s_cfg.n_groups, s_cfg.d_state)
    rep = h // s_cfg.n_groups
    Bh = torch.repeat_interleave(Bm, rep, dim=1).float()  # (B,H,N)
    Ch = torch.repeat_interleave(Cm, rep, dim=1).float()

    dt = _softplus(dt_raw[:, 0].float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])                           # (H,)
    decay = torch.exp(dt * A)                            # (B,H)
    st = (cache["ssm"] * decay[:, :, None, None]
          + (dt[:, :, None] * Bh)[:, :, None, :] * xh[:, :, :, None])
    y = (st @ Ch[:, :, :, None])[..., 0] + p["D"][None, :, None] * xh
    out = _gated_out(p, y.reshape(b, 1, d_in).to(dt_), z, cfg)
    return out, {"conv": new_conv, "ssm": st}


def ssm_sequential_ref(p, x, cfg: ModelConfig):
    """Sequential-recurrence oracle (tests): ``ssm_decode`` stepped over
    the S positions of x (B, S, d)."""
    cache = init_cache_ssm(cfg, x.shape[0], device=x.device)
    ys = []
    for t in range(x.shape[1]):
        y, cache = ssm_decode(p, x[:, t:t + 1], cfg, cache)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
