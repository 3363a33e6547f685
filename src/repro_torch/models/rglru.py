"""RG-LRU recurrent block (Griffin / RecurrentGemma; port of
``repro.models.rglru``).

Temporal mixing branch: linear → causal conv1d(4) → RG-LRU, gated by a
parallel GeLU branch, then an output projection.  Prefill and the
training forward run a log-depth scan over the first-order linear
recurrence h_t = a_t ⊙ h_{t-1} + b_t; decode is the one-step update.  The serving engine prefills by stepping
the decode (``transformer.sublayer_prefill`` with
``recurrent_mode="sequential"``).

Parameters: ``wg``, ``wx``, ``conv_w``, ``conv_b`` and ``rg_out`` are
stored in the config dtype (the reference casts them at every use); the
gate weights and biases ``wa_gate``, ``wi_gate``, ``ba_gate``, ``bi_gate``
and ``lam`` stay f32, as the reference reads them uncast.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import cdtype, dense_init
from repro_torch.models.ssm import _softplus

_C = 8.0  # Griffin's fixed recurrence-sharpness constant


def init_rglru(generator, cfg: ModelConfig, device=None):
    """Every leaf of the reference's ``init_rglru``: the biases start at 0
    and ``lam`` at 1."""
    d, w, dt = cfg.d_model, cfg.lru_width, cdtype(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {
        "wg": dense_init(generator, (d, w), dtype=dt, device=device),
        "wx": dense_init(generator, (d, w), dtype=dt, device=device),
        "conv_w": dense_init(generator, (4, w), 0.2, dtype=dt, device=device),
        "conv_b": torch.zeros(w, dtype=dt, device=device),
        "wa_gate": dense_init(generator, (w, w), device=device),
        "ba_gate": torch.zeros(w, **f32),
        "wi_gate": dense_init(generator, (w, w), device=device),
        "bi_gate": torch.zeros(w, **f32),
        "lam": torch.ones(w, **f32),
        "rg_out": dense_init(generator, (w, d), dtype=dt, device=device),
    }


def _gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default, the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def _conv_train(p, u, k: int = 4):
    w = p["conv_w"].to(u.dtype)
    pad = F.pad(u, (0, 0, k - 1, 0))
    s = u.shape[1]
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return out + p["conv_b"].to(u.dtype)


def _gates(p, u, cfg: ModelConfig):
    """RG-LRU gates from the post-conv input u (B, ..., W), in f32."""
    uf = u.float()
    r = torch.sigmoid(uf @ p["wa_gate"] + p["ba_gate"])
    i = torch.sigmoid(uf @ p["wi_gate"] + p["bi_gate"])
    log_a = -_C * r * _softplus(p["lam"])                # <= 0
    a = torch.exp(log_a)
    gated_in = torch.sqrt(torch.clamp(1.0 - a * a, min=1e-12)) * (i * uf)
    return a, gated_in


def _linear_scan(a, b):
    """h_t = a_t ⊙ h_{t-1} + b_t along axis 1 from h_{-1} = 0, by
    Hillis–Steele doubling (log-depth, as the reference's
    ``associative_scan``, though its products associate differently)."""
    s = a.shape[1]
    d = 1
    while d < s:
        a_prev = F.pad(a[:, :-d], (0, 0, d, 0), value=1.0)
        b_prev = F.pad(b[:, :-d], (0, 0, d, 0))
        b = a * b_prev + b
        a = a * a_prev
        d *= 2
    return b


def init_cache_rglru(cfg: ModelConfig, batch: int, dtype=None, device=None):
    dt = dtype or cdtype(cfg)
    return {
        "conv": torch.zeros((batch, 3, cfg.lru_width), dtype=dt,
                            device=device),
        "h": torch.zeros((batch, cfg.lru_width), dtype=torch.float32,
                         device=device),
    }


def rglru_prefill(p, x, cfg: ModelConfig):
    """x (B, S, d) → (y (B, S, d), cache): the final recurrent state and
    the conv tail."""
    dt = cdtype(cfg)
    gate = _gelu(x @ p["wg"])
    ux = x @ p["wx"]
    u = _conv_train(p, ux)
    a, bterm = _gates(p, u, cfg)
    h = _linear_scan(a, bterm)
    y = (gate.float() * h).to(dt) @ p["rg_out"]
    s = x.shape[1]
    tail = ux[:, -3:] if s >= 3 else F.pad(ux, (0, 0, 3 - s, 0))
    return y, {"conv": tail.to(dt), "h": h[:, -1]}


def rglru_train(p, x, cfg: ModelConfig):
    """x (B, S, d) → y (B, S, d): the scan forward (the reference's
    training form)."""
    return rglru_prefill(p, x, cfg)[0]


def rglru_decode(p, x, cfg: ModelConfig, cache):
    """x (B, 1, d) → (y (B, 1, d), cache').  Functional: the returned state
    is new tensors and ``cache`` is left as it was."""
    dt = cdtype(cfg)
    gate = _gelu(x @ p["wg"])                            # (B,1,W)
    ux = x @ p["wx"]                                     # (B,1,W)
    buf = torch.cat([cache["conv"], ux.to(cache["conv"].dtype)],
                    dim=1)                               # (B,4,W)
    w = p["conv_w"].to(dt)
    ut = (buf * w[None]).sum(dim=1) + p["conv_b"].to(dt)  # (B,W)
    a, bterm = _gates(p, ut, cfg)                        # (B,W)
    h = a * cache["h"] + bterm
    y = (gate[:, 0].float() * h).to(dt) @ p["rg_out"]
    return y[:, None, :], {"conv": buf[:, 1:], "h": h}


def rglru_sequential_ref(p, x, cfg: ModelConfig):
    """Step-by-step oracle (tests): ``rglru_decode`` over the S positions
    of x (B, S, d)."""
    cache = init_cache_rglru(cfg, x.shape[0], device=x.device)
    ys = []
    for t in range(x.shape[1]):
        y, cache = rglru_decode(p, x[:, t:t + 1], cfg, cache)
        ys.append(y[:, 0])
    return torch.stack(ys, dim=1)
