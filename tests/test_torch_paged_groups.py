"""The paged decode kernel's row groups, built on the host
(``repro_torch.kernels.paged_clustered_decode.group_rows``): every real
row lies in exactly one group, no group mixes slots (or ring watermarks,
or real and padding rows), and no group holds more than 16 / g rows.
Packed rows are laid out as the paged engine lays them out: each slot's
chunk rows contiguous, one row per decoding slot, padding rows (slot 0,
qpos1 0) up to a power-of-two bucket."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import paged_clustered_decode as pcd


def _engine_rows(rng, n_slots=6, chunk=64):
    """(slot, qpos1, tw) of one engine step's packed rows."""
    rows = []
    for j in range(n_slots):
        kind = rng.integers(0, 3)
        if kind == 0:                              # idle slot
            continue
        fed = int(rng.integers(0, 900))
        if kind == 1:                              # chunk of an admission
            cl = int(rng.integers(1, chunk + 1))
            rows += [(j, fed + i + 1, fed + cl) for i in range(cl)]
        else:                                      # one decode row
            rows.append((j, fed + 1, fed + 1))
    n = len(rows)
    bucket = 1 << max(0, (max(n, 1) - 1).bit_length())
    rows += [(0, 0, 0)] * (bucket - n)
    slot, qpos1, tw = (np.array(c, np.int32) for c in zip(*rows))
    return slot, qpos1, tw


def _groups(table):
    live = table[table >= 0]
    assert (table[len(live):] == -1).all()
    return [(int(e) >> pcd.GROUP_SHIFT,
             int(e) & ((1 << pcd.GROUP_SHIFT) - 1)) for e in live]


@pytest.mark.parametrize("g", [1, 2, 4, 8, 16])
@pytest.mark.parametrize("seed", range(8))
def test_group_rows_cover_each_row_once_within_one_slot(g, seed):
    slot, qpos1, tw = _engine_rows(np.random.default_rng(seed))
    table = pcd.group_rows(slot, qpos1, tw, g)
    assert table.dtype == np.int32 and table.shape == slot.shape
    seen = np.zeros(len(slot), int)
    prev_end = 0
    for start, count in _groups(table):
        assert start == prev_end                   # in order, no gaps
        assert 1 <= count <= pcd.MAX_GROUP // g
        members = slice(start, start + count)
        seen[members] += 1
        assert len(set(slot[members])) == 1        # one slot
        assert len(set(tw[members])) == 1          # one ring watermark
        assert len(set(qpos1[members] > 0)) == 1   # real or padding
        prev_end = start + count
    assert (seen == 1).all()


def test_group_rows_cut_a_chunk_into_full_groups():
    """A 64-row chunk at g = 4 is 16 groups of 4 rows; each decode row and
    each padding run stands apart."""
    chunk = [(0, 100 + i + 1, 164) for i in range(64)]
    decode = [(1, 51, 51), (2, 301, 301), (3, 7, 7)]
    rows = chunk + decode + [(0, 0, 0)] * (128 - 67)
    slot, qpos1, tw = (np.array(c, np.int32) for c in zip(*rows))
    groups = _groups(pcd.group_rows(slot, qpos1, tw, 4))
    assert groups[:16] == [(4 * k, 4) for k in range(16)]
    assert groups[16:19] == [(64, 1), (65, 1), (66, 1)]
    assert sum(c for _, c in groups[19:]) == 61
    assert all(c == 4 for _, c in groups[19:-1])


def test_group_rows_split_a_chunk_that_is_not_a_multiple():
    rows = [(2, 10 + i + 1, 17) for i in range(7)]
    slot, qpos1, tw = (np.array(c, np.int32) for c in zip(*rows))
    assert _groups(pcd.group_rows(slot, qpos1, tw, 4)) == [(0, 4), (4, 3)]
    assert _groups(pcd.group_rows(slot, qpos1, tw, 16)) == [
        (i, 1) for i in range(7)]


def test_group_rows_edge_cases():
    empty = pcd.group_rows(np.zeros(0, np.int32), np.zeros(0, np.int32),
                           np.zeros(0, np.int32), 4)
    assert empty.shape == (0,)
    with pytest.raises(ValueError):
        pcd.group_rows(np.zeros(2, np.int32), np.ones(2, np.int32),
                       np.ones(2, np.int32), 32)


def test_plain_paged_decode_ignores_the_groups():
    """The groups schedule the kernel's blocks only: the plain version
    gives the same bits with or without a table."""
    g = torch.Generator().manual_seed(0)
    n, hq, hkv, dh, b, c, nb, bs, t_blocks = 6, 8, 2, 16, 2, 5, 6, 4, 3
    q = torch.randn(n, hq, dh, generator=g)
    kc, vc = (torch.randn(b, c, hkv, dh, generator=g) for _ in range(2))
    counts = torch.randint(0, 3, (b, c, hkv), generator=g).float()
    kp, vp = (torch.randn(nb, bs, hkv, dh, generator=g) for _ in range(2))
    row_slot = torch.tensor([0, 0, 0, 1, 0, 0], dtype=torch.int32)
    row_bt = torch.randint(0, nb, (b, t_blocks), generator=g,
                           dtype=torch.int32)[row_slot.long()]
    qpos1 = torch.tensor([5, 6, 7, 3, 0, 0], dtype=torch.int32)
    tw = torch.tensor([7, 7, 7, 3, 7, 7], dtype=torch.int32)
    cov = torch.zeros(n, dtype=torch.int32)
    table = torch.from_numpy(pcd.group_rows(row_slot.numpy(),
                                            qpos1.numpy(), tw.numpy(),
                                            hq // hkv))
    args = (q, kc, vc, counts, kp, vp, row_slot, row_bt, qpos1, tw, cov)
    a = pcd.paged_clustered_decode_plain(*args, scale=0.25)
    b2 = pcd.paged_clustered_decode_plain(*args, None, table, scale=0.25)
    assert torch.equal(a, b2)
