"""The port's preemption swap protocol on a paged clustered cache with
random contents, on any device: imported by tests/test_torch_scheduler.py
(TINY on the CPU), tests/test_torch_gpu.py (TINY on the card) and
chip_smoke.py's phase 5k (qwen3-4b's full-width cache on the card).  It
imports torch and ``repro_torch`` only."""

import numpy as np
import torch

from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.runtime.kv_pool import BlockPool, PagedKVConfig
from repro_torch.runtime.server import Server


def _clone(tree):
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _clone(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_clone(v) for v in tree]
    return tree.detach().to("cpu", copy=True)


def tiny(dtype="float32"):
    """The TINY config of the serving tests."""
    return ModelConfig(name="tiny", family="dense", n_layers=2, d_model=64,
                       n_heads=4, n_kv_heads=2, head_dim=16, d_ff=128,
                       vocab=64, pad_vocab_multiple=16, dtype=dtype)


def swap_round_trip(dev, cfg, seed=0, slots=3, blocks=14, bs=4, tail=16,
                    clusters=8, max_seq=96):
    """Swap slot 0 of a paged clustered cache of ``cfg`` (random contents)
    out to the host, let another tenant overwrite every freed block, and
    resume the request into slot 2, as ``Server`` does: one ring block is
    pinned by a second holder (it re-adopts), ring block 0 is unmapped
    (covered), the rest are allocated afresh and take the host bytes.
    Asserts, bit for bit: slot 2's clustered state equals the snapshot,
    every mapped block of slot 2 holds the bytes slot 0 had, and every
    block that was not fresh, and every other slot's state, is
    unchanged.  Returns (fresh blocks, re-adopted blocks, host bytes of
    the swap payload)."""
    cache = tfm.init_cache(cfg, slots, max_seq, kv_mode="clustered",
                           kv_clusters=clusters, kv_tail=tail,
                           kv_pool_blocks=blocks, kv_block_size=bs,
                           device=dev)
    g = torch.Generator(device=dev).manual_seed(seed)

    def fill(t):
        if t.dtype == torch.int32:
            t.copy_(torch.randint(0, 64, t.shape, generator=g,
                                  dtype=torch.int32, device=t.device))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=t.device))

    for leaf in cache["layers"]:
        for t in leaf.values():
            fill(t)
    pool = BlockPool(slots, tail, PagedKVConfig(block_size=bs,
                                                pool_blocks=blocks))
    n_ring = tail // bs
    for bi in range(1, n_ring):
        pool.alloc(0, bi)
    pool.alloc(1, 0)
    pinned = int(pool.table[0, 2])
    pool.retain(pinned)                   # a second holder keeps it live
    before_out = _clone(cache)
    gid_of = {bi: int(pool.table[0, bi]) for bi in range(1, n_ring)}

    snap, tails = Server._swap_out(cache, 0, pool.row_for_read(0))
    held = pool.release_slot(0)
    assert sorted(held) == list(range(1, n_ring))
    for tree in (snap, tails):
        for leaf in tree["layers"]:
            assert leaf is None or all(t.device.type == "cpu"
                                       for t in leaf.values())
    # another tenant writes every free block
    free = [gid for gid in range(pool.n_blocks) if pool.ref[gid] == 0]
    idx = torch.tensor(free, dtype=torch.long, device=dev)
    for leaf in cache["layers"]:
        for key in ("k_tail", "v_tail"):
            leaf[key][idx] = torch.randn(
                (len(free),) + leaf[key].shape[1:], generator=g,
                device=leaf[key].device).to(leaf[key].dtype)

    fresh, readopted = [], []
    for bi, (gid, gen) in held.items():
        (readopted if pool.readopt(2, bi, gid, gen) else fresh).append(bi)
    pool.ensure(2, fresh, [])
    row = np.full(pool.blocks_per_slot, pool.n_blocks, np.int32)
    for bi in fresh:
        row[bi] = pool.table[2, bi]
    before_in = _clone(cache)
    Server._swap_in(cache, snap, tails, 2, row)
    after = _clone(cache)

    fresh_gids = {int(pool.table[2, bi]) for bi in fresh}
    restored = tfm.clustered_slot_state(after, 2)
    for got, want in zip(restored["layers"], snap["layers"]):
        for k in want:
            assert torch.equal(got[k], want[k]), k
    for li, (leaf, old) in enumerate(zip(after["layers"],
                                         before_out["layers"])):
        for key in ("k_tail", "v_tail"):
            for bi in held:
                # the host copy holds slot 0's bytes, and slot 2's block
                # holds them again after the resume
                assert torch.equal(tails["layers"][li][key][bi],
                                   old[key][gid_of[bi]]), (li, key, bi)
                assert torch.equal(leaf[key][int(pool.table[2, bi])],
                                   old[key][gid_of[bi]]), (li, key, bi)
            for gid in range(pool.n_blocks):
                if gid not in fresh_gids:
                    assert torch.equal(
                        leaf[key][gid], before_in["layers"][li][key][gid]), \
                        (li, key, gid)
        for k in ("k_cents", "v_cents", "counts", "cov"):
            for j in (0, 1):
                assert torch.equal(leaf[k][j],
                                   before_in["layers"][li][k][j]), (k, j)
    assert readopted == [2] and pinned == int(pool.table[2, 2])
    pool.check_invariants()
    nbytes = sum(t.numel() * t.element_size() for tree in (snap, tails)
                 for leaf in tree["layers"] if leaf is not None
                 for t in leaf.values())
    return len(fresh), len(readopted), nbytes
