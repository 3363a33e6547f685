"""Fused clustered-KV decode attention, mixed mode: the CUDA kernel's
wrapper and its plain PyTorch version (port of
``repro.kernels.clustered_decode``; kernel sources
``csrc/clustered_decode.cu`` and ``csrc/clustered_score.cuh``).

Attention of each slot's query rows over [median centroids ⊕ exact tail
ring]: centroid logits get +log(count) and empty clusters are masked; ring
entries count only at positions in [cov, t + i] for chunk rows i <
chunk_len; one joint softmax over C + R entries.  Rows at index >=
chunk_len are garbage by contract: the kernel writes zeros for them, and
a block of 16 query rows that all lie there writes its zeros and returns
without reading any entry (the engine's mixed step is mostly such rows).

Layouts as in the reference: q (B, Hq, Dh) or (B, L, Hq, Dh); k/v_cents
(B, C, Hkv, Dh); counts (B, C, Hkv) f32; k/v_tail (B, R, Hkv, Dh) in ring
order with the chunk rows already written; t, cov, chunk_len (B,) int32.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build

NEG = -1e30
_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
MAX_HEAD_DIM = 256


def _softcap(s, cap):
    if cap is None:
        return s
    return torch.tanh(s / cap) * cap


def score_and_combine(q, kc, vc, cnt, kt, vt, row_ok, tail_ok, *,
                      scale: float, softcap):
    """Shared [centroids ⊕ tail ring] joint-softmax body, batched.

    q (..., rows, Dh) f32; kc/vc (..., C, Dh); cnt (..., C); kt/vt
    (..., R, Dh); row_ok broadcastable to (..., rows, C); tail_ok
    (..., rows, R) with the position window, coverage frontier and row
    validity pre-combined.  Returns (..., rows, Dh) f32."""
    s_c = torch.matmul(q, kc.transpose(-1, -2)) * scale
    s_c = _softcap(s_c, softcap)
    cnt_row = cnt.unsqueeze(-2)                          # (..., 1, C)
    s_c = torch.where((cnt_row > 0) & row_ok,
                      s_c + torch.log(torch.clamp(cnt_row, min=1e-9)),
                      torch.full_like(s_c, NEG))
    s_t = torch.matmul(q, kt.transpose(-1, -2)) * scale
    s_t = _softcap(s_t, softcap)
    s_t = torch.where(tail_ok, s_t, torch.full_like(s_t, NEG))
    m = torch.maximum(s_c.amax(-1, keepdim=True), s_t.amax(-1, keepdim=True))
    p_c = torch.exp(s_c - m)
    p_t = torch.exp(s_t - m)
    lsum = p_c.sum(-1, keepdim=True) + p_t.sum(-1, keepdim=True)
    acc = torch.matmul(p_c, vc) + torch.matmul(p_t, vt)
    return acc / torch.clamp(lsum, min=1e-30)


def per_slot(x, b: int, device, fill: Optional[int] = None) -> torch.Tensor:
    """A scalar or (B,) int (None: ``fill``) as a (B,) int32 tensor."""
    if x is None:
        x = fill
    x = torch.as_tensor(x, dtype=torch.int32, device=device)
    return torch.broadcast_to(x, (b,)).contiguous()


def clustered_decode_plain(q, k_cents, v_cents, counts, k_tail, v_tail, t,
                           cov, chunk_len=None, *, scale: float,
                           softcap: Optional[float] = None):
    """Step-by-step PyTorch version of the kernel (math in f32, output
    like q)."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, l, hq, dh = q.shape
    r = k_tail.shape[1]
    hkv = k_cents.shape[2]
    g = hq // hkv
    dev = q.device
    t = per_slot(t, b, dev)
    cov = per_slot(cov, b, dev)
    cl = per_slot(chunk_len, b, dev, fill=1)
    f32 = torch.float32
    qh = (q.to(f32).reshape(b, l, hkv, g, dh).permute(0, 2, 1, 3, 4)
          .reshape(b, hkv, l * g, dh))
    kc = k_cents.to(f32).permute(0, 2, 1, 3)            # (B, Hkv, C, Dh)
    vc = v_cents.to(f32).permute(0, 2, 1, 3)
    cnt = counts.to(f32).permute(0, 2, 1)               # (B, Hkv, C)
    kt = k_tail.to(f32).permute(0, 2, 1, 3)             # (B, Hkv, R, Dh)
    vt = v_tail.to(f32).permute(0, 2, 1, 3)

    # query row i*g + j carries chunk index i → absolute position t + i
    li = torch.arange(l * g, device=dev) // g                  # (LG,)
    row_ok = li[None, :] < cl[:, None]                         # (B, LG)
    # ring slot s holds position s while tw <= R, else the wrapped window
    sl = torch.arange(r, device=dev)[None, :]
    tw = (t + cl)[:, None]
    wrapped = tw - r + torch.remainder(sl - tw, r)
    pos = torch.where(tw <= r, sl, wrapped)                    # (B, R)
    qpos = t[:, None] + li[None, :]                            # (B, LG)
    ok = ((pos >= 0)[:, None, :] & (pos[:, None, :] < qpos[:, :, None] + 1)
          & (pos >= cov[:, None])[:, None, :] & row_ok[:, :, None])
    out = score_and_combine(qh, kc, vc, cnt, kt, vt,
                            row_ok[:, None, :, None], ok[:, None],
                            scale=scale, softcap=softcap)
    out = (out.reshape(b, hkv, l, g, dh).permute(0, 2, 1, 3, 4)
           .reshape(b, l, hq, dh).to(q.dtype))
    return out[:, 0] if squeeze else out


def clustered_decode_cuda(q, k_cents, v_cents, counts, k_tail, v_tail, t,
                          cov, chunk_len=None, *, scale: float,
                          softcap: Optional[float] = None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``."""
    squeeze = q.dim() == 3
    if squeeze:
        q = q[:, None]
    b, l, hq, dh = q.shape
    c, hkv = k_cents.shape[1], k_cents.shape[2]
    r = k_tail.shape[1]
    leaves = (q, k_cents, v_cents, k_tail, v_tail)
    if not all(x.is_cuda and x.device == q.device
               for x in leaves + (counts,)):
        raise ValueError("clustered_decode: every tensor must be on q's "
                         "CUDA device")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in leaves):
        raise TypeError("clustered_decode kernel takes float32 or bfloat16 "
                        "q, centroids and ring, all of one dtype")
    if counts.dtype != torch.float32:
        raise TypeError("clustered_decode kernel takes float32 counts")
    if (k_cents.shape != (b, c, hkv, dh) or v_cents.shape != k_cents.shape
            or counts.shape != (b, c, hkv) or k_tail.shape != (b, r, hkv, dh)
            or v_tail.shape != k_tail.shape or hq % hkv):
        raise ValueError("clustered_decode: inconsistent shapes")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}")
    if not all(x.is_contiguous() for x in leaves + (counts,)):
        raise ValueError("clustered_decode kernel needs contiguous inputs")
    # query rows, centroids and ring are read as 16-byte vectors
    if dh % (16 // q.element_size()) or any(x.data_ptr() % 16
                                            for x in leaves):
        raise ValueError("clustered_decode kernel needs 16-byte aligned "
                         "query, centroid and ring rows")
    t = per_slot(t, b, q.device)
    cov = per_slot(cov, b, q.device)
    cl = per_slot(chunk_len, b, q.device, fill=1)
    out = torch.empty_like(q)
    _build.launch("clustered_decode", _DTYPE_CODE[q.dtype], q.data_ptr(),
                  k_cents.data_ptr(), v_cents.data_ptr(), counts.data_ptr(),
                  k_tail.data_ptr(), v_tail.data_ptr(), t.data_ptr(),
                  cov.data_ptr(), cl.data_ptr(), out.data_ptr(), b, l, hq,
                  hkv, dh, c, r, float(scale),
                  float(softcap) if softcap is not None else 0.0,
                  torch.cuda.current_stream().cuda_stream)
    return out[:, 0] if squeeze else out
