"""Paged clustered-KV decode attention over packed ragged rows: the CUDA
kernel's wrapper and its plain PyTorch version (port of
``repro.kernels.paged_clustered_decode``; kernel source
``csrc/paged_clustered_decode.cu``, scoring shared with the dense kernel
through ``csrc/clustered_score.cuh``).

Each packed row is one real (slot, position) pair of an engine step.  Its
query heads attend over [its slot's median centroids ⊕ its slot's exact
tail ring], where ring offset ``s`` lives at offset ``s % bs`` of pool
block ``row_bt[n, s // bs]``.  The scoring is the dense kernel's, entry
for entry, so a paged row is bit-identical to the dense row of the same
(slot, position).

Layouts as in the reference: q (N, Hq, Dh); k/v_cents (B, C, Hkv, Dh)
gathered through ``row_slot`` (N,); counts (B, C, Hkv) f32; k/v_pool
(nb, bs, Hkv, Dh); row_bt (N, T) global block ids, every entry a valid
pool index; qpos1 (row position + 1, 0 for a padding row), tw (the
slot's ring watermark t + chunk_len), cov and wlo (N,) int32.  A ring
entry counts when its position p satisfies 0 <= p < qpos1, p >= cov and
p >= wlo.  Padding rows return some finite value the caller discards.

The kernel scores a group of consecutive rows of one slot in one block
(``row_group``, built on the host by :func:`group_rows` where the packed
rows are built); the result does not depend on the grouping.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.kernels import _build
from repro_torch.kernels.clustered_decode import (_DTYPE_CODE, MAX_HEAD_DIM,
                                                  score_and_combine)

#: query rows one block of the kernel holds (``kRows`` in the header)
MAX_GROUP = 16
#: a ``row_group`` entry is ``start << GROUP_SHIFT | count`` (``kGroupShift``)
GROUP_SHIFT = 5


def group_rows(row_slot, qpos1, tw, g: int) -> np.ndarray:
    """The kernel's row groups of N packed rows, on the host (numpy).

    Consecutive rows that share their slot and ring watermark ``tw`` (the
    rows of one prefill chunk), or that are all padding (``qpos1`` 0),
    form runs; each run is cut into groups of at most ``MAX_GROUP // g``
    rows, so a group's g query heads per row fill at most the block's 16
    row places.  Returns (N,) int32: entry k is group k's ``start <<
    GROUP_SHIFT | count``, -1 past the last group.  Every row lies in
    exactly one group, in order.  The kernel reads a group's slot, ``tw``
    and block-table row from its first row, so the rows of one slot must
    share their block-table row, as the engine's do."""
    slot = np.asarray(row_slot, np.int64)
    real = np.asarray(qpos1) > 0
    tw = np.asarray(tw, np.int64)
    n = len(slot)
    cap = MAX_GROUP // g
    if cap < 1:
        raise ValueError(f"{g} query heads per kv head > {MAX_GROUP}")
    table = np.full(n, -1, np.int32)
    if n == 0:
        return table
    brk = np.ones(n, bool)
    brk[1:] = ((slot[1:] != slot[:-1]) | (tw[1:] != tw[:-1])
               | (real[1:] != real[:-1]))
    run_start = np.maximum.accumulate(np.where(brk, np.arange(n), 0))
    starts = np.nonzero((np.arange(n) - run_start) % cap == 0)[0]
    counts = np.diff(np.append(starts, n))
    table[:len(starts)] = (starts << GROUP_SHIFT) | counts
    return table


def _row_vector(x, n: int, device) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int32, device=device).reshape(n)


def paged_clustered_decode_plain(q, k_cents, v_cents, counts, k_pool, v_pool,
                                 row_slot, row_bt, qpos1, tw, cov, wlo=None,
                                 row_group=None, *, scale: float,
                                 softcap: Optional[float] = None):
    """Step-by-step PyTorch version of the kernel: gather each row's ring
    through its block table into the dense (R, Hkv, Dh) layout and its
    slot's centroids, then the dense kernel's plain scoring (math in f32,
    output like q).  ``row_group`` only schedules the kernel's blocks and
    is ignored here."""
    n, hq, dh = q.shape
    hkv = k_cents.shape[2]
    g = hq // hkv
    bs = k_pool.shape[1]
    r = row_bt.shape[1] * bs
    dev = q.device
    f32 = torch.float32
    rs = row_slot.long()
    bt = row_bt.long()
    qpos1 = _row_vector(qpos1, n, dev)
    tw = _row_vector(tw, n, dev)
    cov = _row_vector(cov, n, dev)
    wlo = (torch.zeros_like(qpos1) if wlo is None
           else _row_vector(wlo, n, dev))

    def ring(pool):                                    # (N, Hkv, R, Dh)
        return pool[bt].reshape(n, r, hkv, dh).to(f32).permute(0, 2, 1, 3)

    qh = q.to(f32).reshape(n, hkv, g, dh)
    kc = k_cents[rs].to(f32).permute(0, 2, 1, 3)         # (N, Hkv, C, Dh)
    vc = v_cents[rs].to(f32).permute(0, 2, 1, 3)
    cnt = counts[rs].to(f32).permute(0, 2, 1)           # (N, Hkv, C)
    sl = torch.arange(r, device=dev)[None, :]
    twc = tw[:, None]
    pos = torch.where(twc <= r, sl, twc - r + torch.remainder(sl - twc, r))
    row_ok = qpos1 > 0                                  # padding row?
    ok = ((pos >= 0) & (pos < qpos1[:, None]) & (pos >= cov[:, None])
          & (pos >= wlo[:, None]) & row_ok[:, None])     # (N, R)
    out = score_and_combine(qh, kc, vc, cnt, ring(k_pool), ring(v_pool),
                            row_ok[:, None, None, None], ok[:, None, None],
                            scale=scale, softcap=softcap)
    return out.reshape(n, hq, dh).to(q.dtype)


def paged_clustered_decode_cuda(q, k_cents, v_cents, counts, k_pool, v_pool,
                                row_slot, row_bt, qpos1, tw, cov, wlo=None,
                                row_group=None, *, scale: float,
                                softcap: Optional[float] = None):
    """Launch the CUDA kernel on ``torch.cuda.current_stream()``.  The
    row vectors and the block table must hold valid slot and block ids,
    and ``row_group`` (N,) int32 groups as :func:`group_rows` makes them
    (None: every row a group of its own): checking them would cost a
    device sync per layer."""
    n, hq, dh = q.shape
    b, c, hkv = k_cents.shape[0], k_cents.shape[1], k_cents.shape[2]
    nb, bs = k_pool.shape[0], k_pool.shape[1]
    dev = q.device
    qpos1 = _row_vector(qpos1, n, dev)
    tw = _row_vector(tw, n, dev)
    cov = _row_vector(cov, n, dev)
    wlo = (torch.zeros_like(qpos1) if wlo is None
           else _row_vector(wlo, n, dev))
    if row_group is None:
        row_group = ((torch.arange(n, dtype=torch.int32, device=dev)
                      << GROUP_SHIFT) | 1)
    leaves = (q, k_cents, v_cents, k_pool, v_pool)
    ints = (row_slot, row_bt, qpos1, tw, cov, wlo, row_group)
    if not all(x.is_cuda and x.device == dev
               for x in leaves + ints + (counts,)):
        raise ValueError("paged_clustered_decode: every tensor must be on "
                         "q's CUDA device")
    if q.dtype not in _DTYPE_CODE or any(x.dtype != q.dtype for x in leaves):
        raise TypeError("paged_clustered_decode kernel takes float32 or "
                        "bfloat16 q, centroids and pools, all of one dtype")
    if counts.dtype != torch.float32:
        raise TypeError("paged_clustered_decode kernel takes float32 counts")
    if any(x.dtype != torch.int32 for x in ints):
        raise TypeError("paged_clustered_decode kernel takes int32 row "
                        "vectors and block table")
    if (k_cents.shape != (b, c, hkv, dh) or v_cents.shape != k_cents.shape
            or counts.shape != (b, c, hkv)
            or k_pool.shape != (nb, bs, hkv, dh)
            or v_pool.shape != k_pool.shape or row_slot.shape != (n,)
            or row_group.shape != (n,) or row_bt.dim() != 2
            or row_bt.shape[0] != n or hq % hkv):
        raise ValueError("paged_clustered_decode: inconsistent shapes")
    if hq // hkv > MAX_GROUP:
        raise ValueError(f"{hq // hkv} query heads per kv head > "
                         f"{MAX_GROUP}")
    if dh > MAX_HEAD_DIM:
        raise ValueError(f"head dim {dh} > {MAX_HEAD_DIM}")
    if not all(x.is_contiguous() for x in leaves + ints + (counts,)):
        raise ValueError("paged_clustered_decode kernel needs contiguous "
                         "inputs")
    # query rows, centroids and pool rows are read as 16-byte vectors
    if dh % (16 // q.element_size()) or any(x.data_ptr() % 16
                                            for x in leaves):
        raise ValueError("paged_clustered_decode kernel needs 16-byte "
                         "aligned query, centroid and pool rows")
    out = torch.empty_like(q)
    _build.launch("paged_clustered_decode", _DTYPE_CODE[q.dtype],
                  q.data_ptr(), k_cents.data_ptr(), v_cents.data_ptr(),
                  counts.data_ptr(), k_pool.data_ptr(), v_pool.data_ptr(),
                  row_slot.data_ptr(), row_bt.data_ptr(), qpos1.data_ptr(),
                  tw.data_ptr(), cov.data_ptr(), wlo.data_ptr(),
                  row_group.data_ptr(), out.data_ptr(), n, hq, hkv, dh, c,
                  row_bt.shape[1], bs, float(scale),
                  float(softcap) if softcap is not None else 0.0,
                  torch.cuda.current_stream().cuda_stream)
    return out
