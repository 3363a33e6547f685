"""Flash-decode — one-token exact attention over a long KV cache: the CUDA
kernel's wrapper and its plain PyTorch version (port of
``repro.kernels.flash_decode``; kernel source ``csrc/flash_decode.cu``).

q (B, Hq, Dh), k/v (B, S, Hkv, Dh) with Hq a multiple of Hkv (GQA), a
scalar ``t`` (positions >= t are masked with NEG = -1e30) → (B, Hq, Dh)
in q's dtype.  Scores are scaled, then soft-capped when a cap is given;
the cache is walked in chunks of ``chunk`` positions with an online
softmax, math in f32.  Like the reference, nothing in the model calls it:
the serve decodes through ``clustered_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8
MAX_HEAD_DIM = 256


def flash_decode_plain(q, k, v, t, *, scale: float,
                       softcap: Optional[float] = None, chunk: int = 512):
    """Step-by-step PyTorch version: the reference's chunk loop, the
    cache zero-padded to a multiple of ``chunk``."""
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    chunk = min(chunk, s)
    pad = (-s) % chunk
    f32 = torch.float32
    kp = torch.nn.functional.pad(k.to(f32), (0, 0, 0, 0, 0, pad))
    vp = torch.nn.functional.pad(v.to(f32), (0, 0, 0, 0, 0, pad))
    qh = q.to(f32).reshape(b, hkv, g, dh)
    m = torch.full((b, hkv, g, 1), NEG, dtype=f32, device=q.device)
    lsum = torch.zeros((b, hkv, g, 1), dtype=f32, device=q.device)
    acc = torch.zeros((b, hkv, g, dh), dtype=f32, device=q.device)
    t = int(t)
    for c0 in range(0, s + pad, chunk):
        kc = kp[:, c0:c0 + chunk].permute(0, 2, 1, 3)       # (B, Hkv, C, Dh)
        vc = vp[:, c0:c0 + chunk].permute(0, 2, 1, 3)
        sc = torch.matmul(qh, kc.transpose(-1, -2)) * scale
        if softcap is not None:
            sc = torch.tanh(sc / softcap) * softcap
        kpos = c0 + torch.arange(chunk, device=q.device)
        sc = torch.where(kpos < t, sc, torch.full_like(sc, NEG))
        m_new = torch.maximum(m, sc.amax(-1, keepdim=True))
        p = torch.exp(sc - m_new)
        corr = torch.exp(m - m_new)
        lsum = lsum * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(p, vc)
        m = m_new
    out = acc / torch.clamp(lsum, min=1e-30)
    return out.reshape(b, hq, dh).to(q.dtype)


def flash_decode_cuda(q, k, v, t, *, scale: float,
                      softcap: Optional[float] = None, chunk: int = 512):
    """Launch the CUDA kernels (chunk partials, then the merge) on
    ``torch.cuda.current_stream()``."""
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v)):
        raise ValueError("flash_decode: q, k and v must be on one CUDA "
                         "device")
    if q.dtype not in _DTYPE_CODE or k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError("flash_decode kernel takes float32 or bfloat16 q, k "
                        "and v, all of one dtype")
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    if (k.shape != (b, s, hkv, dh) or v.shape != k.shape or hq % hkv
            or s == 0):
        raise ValueError(f"flash_decode: shapes q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)}")
    g = hq // hkv
    if g > MAX_GROUP or dh > MAX_HEAD_DIM:
        raise ValueError(f"flash_decode kernel: {g} query heads per kv head "
                         f"(max {MAX_GROUP}), head dim {dh} (max "
                         f"{MAX_HEAD_DIM})")
    chunk = min(chunk, s)
    if 4 * (g * dh + g * chunk + 2 * g) > _build.MAX_SHARED_BYTES:
        raise ValueError(f"chunk {chunk} does not fit shared memory")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    nc = -(-s // chunk)
    scratch = torch.empty(b * hkv * nc * g * (2 + dh), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    _build.launch("flash_decode", _DTYPE_CODE[q.dtype], q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), b, s, hq, hkv, dh, chunk,
                  int(t), float(scale),
                  float(softcap) if softcap is not None else 0.0,
                  scratch.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    return out
