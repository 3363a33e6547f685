"""Shared building blocks: inits, norms, embeddings, positions, MLPs (port
of ``repro.models.layers``).

Parameters are nested dicts of tensors with the reference's keys.  Weight
matrices are stored in the config dtype — the reference keeps f32 masters
and casts at every use, and a cast is deterministic, so both compute the
same thing; norm scales stay f32, as ``apply_norm`` uses them.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.config import ModelConfig

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def cdtype(cfg: ModelConfig) -> torch.dtype:
    return _DTYPES[cfg.dtype]


def resolve_device(device=None) -> torch.device:
    """Entry points run on the card unless the caller asks for another
    device: None means "cuda", which must then be available."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available; pass device='cpu' to run "
                           "repro_torch on the CPU")
    return dev


def dense_init(generator: torch.Generator, shape, scale: float = 0.02, *,
               dtype=torch.float32, device=None) -> torch.Tensor:
    """Truncated-normal (±2σ) init drawn from ``generator``, cast to
    ``dtype`` once."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------


def init_norm(cfg: ModelConfig, dim: int, device=None):
    if cfg.norm_kind == "layernorm":
        return {"scale": torch.ones(dim, device=device),
                "bias": torch.zeros(dim, device=device)}
    return {"scale": torch.ones(dim, device=device)}


def apply_norm(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    xf = x.to(torch.float32)
    if cfg.norm_kind == "layernorm":
        mu = xf.mean(-1, keepdim=True)
        var = ((xf - mu) ** 2).mean(-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        var = (xf * xf).mean(-1, keepdim=True)
        y = xf * torch.rsqrt(var + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


def rms_head_norm(scale: torch.Tensor, x: torch.Tensor,
                  eps: float = 1e-6) -> torch.Tensor:
    """qk-norm over the head_dim axis: x (..., Dh), scale (Dh,)."""
    xf = x.to(torch.float32)
    var = (xf * xf).mean(-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * scale).to(x.dtype)


# ---------------------------------------------------------------------------
# Embeddings / positions / head
# ---------------------------------------------------------------------------


def init_embed(generator, cfg: ModelConfig, device=None):
    dt = cdtype(cfg)
    p = {"table": dense_init(generator, (cfg.padded_vocab, cfg.d_model), 1.0,
                             dtype=dt, device=device)}
    if not cfg.tie_embeddings:
        p["head"] = dense_init(generator, (cfg.d_model, cfg.padded_vocab),
                               dtype=dt, device=device)
    return p


def embed_tokens(p, tokens: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    h = p["table"][tokens.long()].to(cdtype(cfg))
    if cfg.embed_scale:
        h = h * torch.tensor(cfg.d_model ** 0.5, dtype=cdtype(cfg))
    return h


def lm_logits(p, h: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """h (..., d) -> logits (..., padded_vocab) in f32.  The reference
    contracts the config-dtype operands with an f32 result; products of
    bf16 values are exact in f32, so upcasting the operands and
    contracting in f32 computes the same logits, never rounded to bf16
    before the greedy argmax."""
    w = p["table"].T if cfg.tie_embeddings else p["head"]
    logits = torch.matmul(h.to(torch.float32), w.to(torch.float32))
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = torch.tanh(logits / c) * c
    return logits


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return theta ** (-torch.arange(0, head_dim // 2, dtype=torch.float32,
                                   device=device) / (head_dim // 2))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x (..., S, H, Dh) with positions (..., S) or (S,)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)
    ang = positions[..., None].to(torch.float32) * freqs  # (..., S, Dh/2)
    sin = torch.sin(ang)[..., None, :]                    # (..., S, 1, Dh/2)
    cos = torch.cos(ang)[..., None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def init_mlp(generator, cfg: ModelConfig, d_ff: int, device=None):
    d, dt = cfg.d_model, cdtype(cfg)
    return {
        "w_gate": dense_init(generator, (d, d_ff), dtype=dt, device=device),
        "w_up": dense_init(generator, (d, d_ff), dtype=dt, device=device),
        "w_down": dense_init(generator, (d_ff, d), dtype=dt, device=device),
    }


def apply_mlp(p, x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    gate = x @ p["w_gate"]
    # jax.nn.gelu defaults to the tanh approximation
    g = (F.gelu(gate, approximate="tanh") if cfg.mlp_kind == "geglu"
         else F.silu(gate))
    return (g * (x @ p["w_up"])) @ p["w_down"]
