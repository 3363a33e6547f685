"""The kernels' work models: the bytes each hand-written kernel must move
and the operations it must do on given inputs, and the least time one
H100 needs for them.

One function a kernel, shared by the dry run's count (``op_count``, fed
by the wrappers of ``kernels/ops.py``) and by the bound column of
``chip_smoke.py``'s kernel timings, so both count one way.  Bytes: each
input read once and each output written once, only what the kernel must
touch (the ring blocks a row can see, the words of points that vote).
Operations: what these inputs need where it depends on the data (visible
entries, voting points); on the ``meta`` device the data is unknown, and
the served worst case is counted instead: every centroid counted, the
whole ring visible, every point voting.

The peaks are NVIDIA's data sheet for the H100 SXM (dense, at its full
700 W): HBM3 bytes/s, f32 FLOP/s outside the tensor cores, bf16
tensor-core FLOP/s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from repro_torch.core.kv_compress import ring_positions

PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOP_PER_S = 67e12
PEAK_BF16_FLOP_PER_S = 989e12


@dataclasses.dataclass(frozen=True)
class Work:
    """``nbytes`` moved; ``flops``, the operations a counter adds (2 a
    multiply-add, a vote, an instruction); ``pipes``, (count, rate) pairs
    of what the card issues, for the bound; ``detail``, the model's own
    figures (entries seen, voting points)."""
    nbytes: int
    flops: int
    pipes: Tuple[Tuple[float, float], ...]
    detail: dict = dataclasses.field(default_factory=dict)

    def bound(self) -> Tuple[float, str]:
        return bound(self.nbytes, self.pipes)


def bound(nbytes, ops) -> Tuple[float, str]:
    """Least time in ms: bytes over the memory rate, or the operations,
    given as (count, rate) pairs, each over its rate, whichever is
    longer; and which of the two it is."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_ops = sum(f / rate for f, rate in ops) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def tensor_bytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors
               if t is not None)


def _known(*tensors) -> bool:
    """False when any tensor lies on ``meta``: no data to count."""
    return not any(torch.is_tensor(t) and t.is_meta for t in tensors)


def _vec(x, n: int) -> torch.Tensor:
    """A scalar, list or (n,) tensor as an (n,) int64 CPU tensor."""
    return torch.broadcast_to(torch.as_tensor(
        x.cpu() if torch.is_tensor(x) else x, dtype=torch.int64), (n,))


def ring_visible(tw, qpos1, cov, ring: int, wlo=None) -> torch.Tensor:
    """(rows, ring) bool: the ring entries a row at position qpos1 - 1 can
    see: at or past the frontier ``cov`` and the window floor ``wlo``,
    and not past the row (slots past an unwrapped ring's watermark hold
    positions >= tw, which no row sees)."""
    pos = ring_positions(ring, tw)
    ok = (pos < qpos1[:, None]) & (pos >= cov[:, None])
    if wlo is not None:
        ok &= pos >= wlo[:, None]
    return ok


def _decode_work(nbytes: int, entries: int, n_q_per_kv: int,
                 head_dim: int, detail: dict) -> Work:
    """q.k and p.v over ``entries`` (kv head, entry) pairs seen by the
    rows, each shared by the group's query heads: 2 flops a multiply-add
    for each; the kernels run q.k on bf16 tensor cores and p.v twice (p =
    hi + lo)."""
    fl = entries * n_q_per_kv * head_dim * 2
    return Work(nbytes, 2 * fl, ((3 * fl, PEAK_BF16_FLOP_PER_S),),
                dict(detail, flops_qk=fl, flops_pv=fl))


def clustered_decode_work(q, k_cents, v_cents, counts, k_tail, v_tail, t,
                          cov, chunk_len=None) -> Work:
    """B1: each input read once and the output written once; the valid
    rows (chunk rows i < chunk_len, one row a slot without chunks) against
    the centroids of count > 0 and the ring entries they can see."""
    b, c, hkv, dh = k_cents.shape
    ring = k_tail.shape[1]
    rows = q.shape[1] if q.dim() == 4 else 1
    g = q.shape[-2] // hkv
    nbytes = tensor_bytes(q, k_cents, v_cents, counts, k_tail, v_tail, q)
    nbytes += sum(tensor_bytes(x) for x in (t, cov, chunk_len)
                  if torch.is_tensor(x))
    if not _known(q, counts, t, cov, chunk_len):
        return _decode_work(nbytes, b * rows * hkv * (c + ring), g, dh,
                            {"worst_case": True})
    tb, cb = _vec(t, b), _vec(cov, b)
    cl = _vec(1 if chunk_len is None else chunk_len, b)
    i = torch.arange(rows)[None]
    valid = i < cl[:, None]                                   # (B, L)
    tw = (tb + cl).repeat_interleave(rows)
    seen = ring_visible(tw, (tb[:, None] + i + 1).reshape(-1),
                        cb.repeat_interleave(rows), ring).sum(-1)
    ring_rows = int((seen.reshape(b, rows) * valid).sum())
    cents = (counts.cpu() > 0).sum(1)                         # (B, Hkv)
    cent_rows = int((cents * valid.sum(1)[:, None]).sum())
    return _decode_work(nbytes, cent_rows + ring_rows * hkv, g, dh,
                        {"worst_case": False})


def paged_clustered_decode_work(q, k_cents, v_cents, counts, k_pool, v_pool,
                                row_slot, row_bt, qpos1, tw, cov,
                                row_wlo=None, row_group=None) -> Work:
    """B2: each real row's q and output once (qpos1 > 0; bucket padding
    costs nothing), each slot's centroids and counts once, each pool block
    holding a position some real row can see once, the row vectors
    (slot, qpos1, tw, cov, window floor, group) and block-table rows once;
    the same entries as the dense rows they equal."""
    n, hq, dh = q.shape
    nsl, c, hkv, _ = k_cents.shape
    nt, bs = row_bt.shape[1], k_pool.shape[1]
    ring = nt * bs
    g = hq // hkv
    el = q.element_size()
    side = nsl * c * hkv * (2 * dh * el + 4)
    block = 2 * bs * hkv * dh * el
    if not _known(q, counts, row_slot, row_bt, qpos1, tw, cov, row_wlo):
        nbytes = 2 * n * hq * dh * el + side + nsl * nt * block
        nbytes += n * 4 * (6 + nt)
        return _decode_work(nbytes, n * hkv * (c + ring), g, dh,
                            {"worst_case": True})
    q1 = _vec(qpos1, n)
    real = q1 > 0
    nr = int(real.sum())
    slot = _vec(row_slot, n)[real]
    wlo = None if row_wlo is None else _vec(row_wlo, n)[real]
    ok = ring_visible(_vec(tw, n)[real], q1[real], _vec(cov, n)[real], ring,
                      wlo)                                    # (nr, ring)
    need = ok.reshape(nr, nt, bs).any(-1)
    mapped = torch.unique(row_bt.cpu().long()[real][need]).numel()
    nbytes = (2 * nr * hq * dh * el + side + mapped * block
              + nr * 4 * (6 + nt))
    cents = (counts.cpu() > 0).sum(1)[slot]                   # (nr, Hkv)
    entries = int(cents.sum()) + int(ok.sum()) * hkv
    return _decode_work(nbytes, entries, g, dh,
                        {"worst_case": False, "rows": nr,
                         "mapped_blocks": mapped})


def flash_decode_work(q, k, v, t) -> Work:
    """B5: q and the output once, the keys and values of the visible
    positions (< t, at most the cache's S) once; q.k and p.v over them."""
    b, s, hkv, dh = k.shape
    el = q.element_size()
    tv = s if not _known(t) else min(max(int(t), 0), s)
    nbytes = 2 * q.numel() * el + 2 * b * tv * hkv * dh * el
    return _decode_work(nbytes, b * tv * hkv, q.shape[1] // hkv, dh,
                        {"visible": tv, "worst_case": not _known(t)})


def bitserial_median_work(u, assign, k: int, weights=None, *,
                          bits: int = 32) -> Work:
    """B3: the int32 assignments and f32 weights of every point once, the
    int64 words of the points that can vote (weight not 0, cluster in
    [0, k): the median does not depend on the others) once, the int64
    medians and f32 totals written once; one f32 vote add per (voting
    point, column, bit).  ``detail["bytes_all"]`` counts every point's
    words."""
    m = math.prod(u.shape[:-2])
    n, d = u.shape[-2:]
    side = m * (n * 4 + (n * 4 if weights is not None else 0) + k * d * 8
                + k * 4)
    if _known(assign, weights):
        voting = (assign >= 0) & (assign < k)
        if weights is not None:
            voting &= torch.broadcast_to(weights, assign.shape) != 0
        n_vote = int(voting.sum())
    else:
        n_vote = m * n
    votes = n_vote * d * bits
    return Work(side + n_vote * d * 8, votes,
                ((votes, PEAK_F32_FLOP_PER_S),),
                {"voting_points": n_vote, "bytes_all": side + m * n * d * 8})


def distance_argmin_work(n: int, d: int, k: int, metric: str) -> Work:
    """B4: the f32 points and centroids once, the assignment and distance
    written once; FP32-pipe instructions a (point, centroid): L1 2D + 1 (a
    subtract and an add with |.| folded into it per dim, the compare), L2
    D + 4 (an FFMA per dim; x2 - 2 xc, + |c|^2, the clamp, the compare),
    plus |x|^2 once a point (N D), issued at half the f32 FLOP rate."""
    instr = (n * k * (2 * d + 1) if metric == "l1"
             else n * k * (d + 4) + n * d)
    return Work(4 * (n * d + k * d + 2 * n), instr,
                ((instr, PEAK_F32_FLOP_PER_S / 2),))
