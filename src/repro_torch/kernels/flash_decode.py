"""Flash-decode — one-token exact attention over a long KV cache: the CUDA
kernel's wrapper and its plain PyTorch version (port of
``repro.kernels.flash_decode``; kernel source ``csrc/flash_decode.cu``).

q (B, Hq, Dh), k/v (B, S, Hkv, Dh) with Hq a multiple of Hkv (GQA), a
scalar ``t`` (positions >= t are masked with NEG = -1e30) → (B, Hq, Dh)
in q's dtype.  Scores are scaled, then soft-capped when a cap is given;
the cache is walked in chunks of ``chunk`` positions with an online
softmax, math in f32.  The kernel splits the cache into blocks of
``SPLIT`` positions of its own and merges them in order
(``flash_decode_splits`` is that algorithm in PyTorch, for the tests).
Like the reference, nothing in the model calls it: the serve decodes
through ``clustered_decode``.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_GROUP = 8
MAX_HEAD_DIM = 256
#: cache positions of one kernel block (a multiple of the tile's 16)
SPLIT = 128


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


def flash_decode_splits(q, k, v, t, *, scale: float,
                        softcap: Optional[float] = None, chunk: int = 512,
                        split: int = SPLIT):
    """The kernel's split-and-merge in PyTorch, for the tests.  Splits of
    ``split`` positions cover the real positions below min(t, S) (all S
    when t <= 0, where every score is NEG); each gives (m, l, acc); the
    merge takes them in order, then the reference's zero padding (``chunk``)
    as one term: positions [S, min(t, S + pad)) with score 0 when t >= 1,
    all ``pad`` positions with score NEG when t <= 0."""
    b, hq, dh = q.shape
    s, hkv = k.shape[1], k.shape[2]
    g = hq // hkv
    c = min(chunk, s)
    s_pad = -(-s // c) * c
    t = int(t)
    visible = t > 0
    n_real = min(t, s) if visible else s
    top = min(t, s_pad) if visible else s_pad
    f32 = torch.float32
    qh = q.to(f32).reshape(b, hkv, g, dh)
    parts = []
    for p0 in range(0, n_real, split):
        kc = k[:, p0:min(n_real, p0 + split)].to(f32).permute(0, 2, 1, 3)
        vc = v[:, p0:min(n_real, p0 + split)].to(f32).permute(0, 2, 1, 3)
        sc = torch.matmul(qh, kc.transpose(-1, -2)) * scale
        if softcap is not None:
            sc = torch.tanh(sc / softcap) * softcap
        if not visible:
            sc = torch.full_like(sc, NEG)
        m = sc.amax(-1, keepdim=True)
        p = torch.exp(sc - m)
        parts.append((m, p.sum(-1, keepdim=True), torch.matmul(p, vc)))
    if top > s:
        m_pad = torch.full((b, hkv, g, 1), 0.0 if visible else NEG, dtype=f32,
                           device=q.device)
        parts.append((m_pad, torch.full_like(m_pad, float(top - s)),
                      torch.zeros((b, hkv, g, dh), dtype=f32,
                                  device=q.device)))
    mx = torch.stack([m for m, _, _ in parts]).amax(0)
    lsum = torch.zeros_like(mx)
    acc = torch.zeros((b, hkv, g, dh), dtype=f32, device=q.device)
    for m, lp, ap in parts:
        f = torch.exp(m - mx)
        lsum = lsum + lp * f
        acc = acc + ap * f
    out = acc / torch.clamp(lsum, min=1e-30)
    return out.reshape(b, hq, dh).to(q.dtype)


def flash_decode_cuda(q, k, v, t, *, scale: float,
                      softcap: Optional[float] = None, chunk: int = 512):
    """Launch the CUDA kernels (split partials, then the merge) on
    ``torch.cuda.current_stream()``.  ``chunk`` sets the reference's zero
    padding, which the kernel adds without reading it."""
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
    vec = 16 // q.element_size()
    if dh % vec:
        raise ValueError(f"flash_decode kernel: head dim {dh} must be a "
                         f"multiple of {vec} (16-byte rows)")
    q, k, v = (x.contiguous() for x in (q, k, v))
    q, k, v = (x.clone() if x.data_ptr() % 16 else x for x in (q, k, v))
    n_sp = -(-s // SPLIT)
    scratch = torch.empty(b * hkv * n_sp * g * (2 + dh), dtype=torch.float32,
                          device=q.device)
    out = torch.empty_like(q)
    _build.launch("flash_decode", _DTYPE_CODE[q.dtype], q.data_ptr(),
                  k.data_ptr(), v.data_ptr(), b, s, hq, hkv, dh,
                  min(chunk, s), SPLIT, int(t), float(scale),
                  float(softcap) if softcap is not None else 0.0,
                  scratch.data_ptr(), out.data_ptr(),
                  torch.cuda.current_stream().cuda_stream)
    return out
