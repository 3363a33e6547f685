"""Serving runtime: the continuous-batching engine with chunked admission
and device-resident clustered-KV compaction, on one device, with a dense
cache or a paged block pool (port of the dense and paged parts of
``repro.runtime.server``).

Requests are ordered by the clustering batcher (core/request_cluster.py);
a slot-based continuous batcher admits a request the moment a slot frees.
Admission is chunked and decode-interleaved: each engine step feeds one
prompt chunk of at most ``prefill_chunk`` tokens for at most one admitting
slot, fused into the same launch that advances every decoding slot by one
token (mixed-mode ``decode_step``).  With a ``KVCompressConfig`` the cache
is clustered end to end: a prompt longer than the tail ring streams in
through ``kv_compress.absorb_chunk``, and each slot is re-compacted after
``refresh_every`` of its own decode tokens (slots whose frontier does not
move keep their summaries bit-identical).  Once the queue drains, the
launch bucket shrinks by powers of two.

With ``paged=PagedKVConfig(...)`` the exact tail rings live in a block
pool behind per-slot block tables (runtime/kv_pool.py).  Blocks are
allocated right before the write that first touches them, given back
once compaction or a streaming absorb covers every position they hold,
and recycled when a request exits.  Each engine step is one packed
ragged launch (``decode_step_packed``): one row per real (slot, position)
pair, padded to a power-of-two row bucket, so mixed prefill + decode
compute scales with real tokens.  A slot whose next write finds the pool
empty even after a sweep of covered blocks stalls for the step; when
every slot stalls twice with nothing to reclaim the serve raises
``PoolExhausted``.  The launch bucket never shrinks in paged mode.

Per-slot host bookkeeping (``pos`` / ``cur`` / ``fed``, the coverage
frontier mirror) replays the reference engine step for step, so greedy
tokens match it.  Blocking admission, the static engine, paged serving
of exact KV, prefix sharing (and with it copy-on-write of shared
blocks), the template store, SLO scheduling, mesh serving and tracing
are later slices of the port; asking for one raises
``NotImplementedError`` naming its ROADMAP item.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.core import kv_compress
from repro_torch.core import layer_state
from repro_torch.core import retention
from repro_torch.core.request_cluster import (BatchPlan, Request,
                                              plan_batches, plan_fifo)
from repro_torch.kernels import paged_clustered_decode as pcd
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.runtime import kv_pool
from repro_torch.runtime import telemetry as tele_mod
from repro_torch.runtime.telemetry import TelemetryConfig


@dataclasses.dataclass
class ServerConfig:
    batch_size: int = 4            # decode slots
    max_seq: int = 256
    use_clustered_batching: bool = True
    n_request_clusters: int = 4
    engine: str = "continuous"     # "continuous" ("static": later slice)
    prefill_chunk: int = 0         # >0: chunked prefill interleaved with
                                   # decode; must be <= keep_recent when
                                   # serving clustered
    kv_compress: Optional[kv_compress.KVCompressConfig] = None
    # when set, the engine serves from a clustered KV cache end to end and
    # re-compacts every kv_compress.refresh decode steps per slot
    paged: Optional[kv_pool.PagedKVConfig] = None
    # paged clustered-KV memory manager: tail rings in a block pool behind
    # per-slot block tables, decoded by packed ragged launches; requires
    # kv_compress and prefill_chunk in this slice
    prefix_share: Optional[object] = None    # later slice (item 8.2)
    template_store: Optional[object] = None  # later slice (item 8.3)
    scheduler: Optional[object] = None       # later slice (item 8.4)
    telemetry: Optional[TelemetryConfig] = None
    mesh: Optional[object] = None            # later slice (item 11)


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prefill_ms: float              # wall-clock time to first token (TTFT)
    decode_ms: float
    shed: bool = False


def _pow2ceil(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _is_clustered_kv(node) -> bool:
    return isinstance(node, dict) and "k_cents" in node


def _gather_tail_rows(pool_arr: torch.Tensor, bt: torch.Tensor):
    """Dense ring view of a paged tail pool: pool (nb, bs, H, Dh) + block
    table bt (..., T) → (..., T*bs, H, Dh)."""
    got = pool_arr[bt.long()]                  # (..., T, bs, H, Dh)
    return got.reshape(bt.shape[:-1] + (-1,) + pool_arr.shape[2:])


class Server:
    def __init__(self, cfg: ModelConfig, scfg: ServerConfig, params,
                 device=None):
        """``params`` is the port's parameter dict (``tfm.init_params`` or
        ``bridge.params_from_numpy``); it is moved to ``device`` (None
        means CUDA, which must then be available)."""
        self.device = resolve_device(device)
        self.cfg = cfg
        self.scfg = scfg
        # the reference's ValueError gates, in its order
        if scfg.kv_compress is not None:
            if scfg.engine != "continuous":
                raise ValueError(
                    "kv_compress serving requires the continuous engine "
                    "(the static path would silently ignore it)")
            if scfg.kv_compress.refresh < 1:
                raise ValueError(
                    "continuous serving with kv_compress needs "
                    "refresh_every >= 1 (ring entries must reach "
                    "centroids before eviction)")
        paged = scfg.paged
        if paged is not None:
            if scfg.engine != "continuous":
                raise ValueError("paged serving requires the continuous "
                                 "engine")
            if (scfg.kv_compress is not None
                    and scfg.kv_compress.keep_recent % paged.block_size):
                raise ValueError(
                    f"block_size {paged.block_size} must divide "
                    f"keep_recent {scfg.kv_compress.keep_recent} (ring "
                    "offsets map to whole blocks)")
            report = cfg.serving_gate_report()
            if report is not None:
                raise ValueError("paged serving: " + report)
            if not layer_state.families_for(cfg).has_ring:
                raise ValueError(
                    "paged serving needs at least one ring-family layer: "
                    "recurrent-state layers ('M'/'R') carry fixed-size "
                    "per-slot state that is never pool-backed")
        self._chunk = scfg.prefill_chunk
        if self._chunk:
            if scfg.engine != "continuous":
                raise ValueError("chunked prefill requires the continuous "
                                 "engine")
            report = cfg.serving_gate_report()
            if report is not None:
                raise ValueError("chunked prefill: " + report)
            if (scfg.kv_compress is not None
                    and self._chunk > scfg.kv_compress.keep_recent):
                raise ValueError(
                    "prefill_chunk must fit the exact tail ring "
                    "(<= kv_compress.keep_recent): a chunk's K/V lands in "
                    "the ring before absorb_chunk can cover it")
        # what this slice of the port does not serve yet
        missing = []
        if scfg.engine != "continuous":
            missing.append(f"engine={scfg.engine!r} (ROADMAP Queue A "
                           "item 6)")
        if not self._chunk:
            missing.append("prefill_chunk == 0: blocking admission needs "
                           "prefill and _clusterize"
                           + (" and, paged, _write_slot_paged_impl"
                              if paged is not None else "")
                           + " (ROADMAP Queue A item 6)")
        if paged is not None and scfg.kv_compress is None:
            missing.append("paged= without kv_compress: exact KV under "
                           "QuotaRetention (ROADMAP Queue A item 8.1)")
        for name, item in (("prefix_share", "Queue A item 8.2"),
                           ("template_store", "Queue A item 8.3"),
                           ("scheduler", "Queue A item 8.4"),
                           ("mesh", "Queue A item 11")):
            if getattr(scfg, name) is not None:
                missing.append(f"{name}= (ROADMAP {item})")
        if scfg.telemetry is not None and (scfg.telemetry.trace
                                           or scfg.telemetry.jax_profiler):
            missing.append("telemetry tracing (ROADMAP Queue A item 8.5)")
        if set(tfm.layer_kinds(cfg)) - {"G"}:
            missing.append(f"layer pattern {cfg.layer_pattern!r}: only 'G' "
                           "layers are ported (ROADMAP Queue A item 9)")
        if missing:
            raise NotImplementedError("repro_torch Server: " +
                                      "; ".join(missing))
        tfm.check_supported(cfg)
        self.params = _to_device(params, self.device)
        self.last_stats: Dict[str, float] = {}
        self.metrics = tele_mod.MetricsRegistry()

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def serve(self, requests: Sequence[Request],
              prompts: Dict[int, np.ndarray]) -> List[Completion]:
        """prompts: uid -> token array.  Returns completions per request."""
        with torch.inference_mode():
            return self._serve_continuous(requests, prompts)

    def _plan(self, requests: Sequence[Request]) -> BatchPlan:
        scfg = self.scfg
        if scfg.use_clustered_batching:
            return plan_batches(requests, scfg.batch_size,
                                scfg.n_request_clusters)
        return plan_fifo(requests, scfg.batch_size)

    # ------------------------------------------------------------------
    # continuous-batching engine
    # ------------------------------------------------------------------

    def _serve_continuous(self, requests, prompts) -> List[Completion]:
        cfg, scfg = self.cfg, self.scfg
        dev = self.device
        t0_serve = time.perf_counter()
        reg = self.metrics
        reg.begin_serve()
        ccfg = scfg.kv_compress
        layout = ccfg
        chunk = self._chunk
        n = scfg.batch_size
        plan = self._plan(requests)
        order = [u for b in plan.batches for u in b]
        by_uid = {r.uid: r for r in requests}

        # the cache physically holds ``bucket`` slots: the full batch until
        # the queue drains, then powers of two down to the busiest index
        # (admissions only happen before the drain, at the full shape)
        bucket = n
        # paged memory manager: tail rings in a block pool behind per-slot
        # block tables; the launch bucket never shrinks (packed rows
        # already make compute follow real tokens)
        paged = scfg.paged
        pool = (kv_pool.BlockPool(n, layout.keep_recent, paged)
                if paged is not None else None)
        cache = tfm.init_cache(
            cfg, n, scfg.max_seq,
            kv_mode="clustered" if layout else "exact",
            kv_clusters=layout.n_clusters if layout else 512,
            kv_tail=layout.keep_recent if layout else 256,
            kv_pool_blocks=pool.n_blocks if pool else 0,
            kv_block_size=paged.block_size if paged else 0, device=dev)

        pos = np.zeros(n, np.int32)       # cache valid length per slot
        cur = np.zeros(n, np.int32)       # pending (unfed) token per slot
        active = np.zeros(n, bool)        # decoding
        admitting = np.zeros(n, bool)     # chunked prefill in flight
        fed = np.zeros(n, np.int32)       # prompt tokens streamed so far
        # 'G' layers, clustered: retire behind the coverage frontier (the
        # host cov mirror replays the device formulas step for step)
        fr = (retention.FrontierRetention(n, ccfg)
              if ccfg is not None else None)
        cov_of = fr.frontier if fr is not None else (lambda j: 0)
        kv_retired = {"frontier": 0, "window": 0, "quota": 0}
        slot_uid = [-1] * n
        prompt_np: Dict[int, np.ndarray] = {}
        toks: Dict[int, List[int]] = {}
        pre_ms: Dict[int, float] = {}
        token_t: Dict[int, List[float]] = {}

        qi = 0
        decode_steps = wasted_slots = 0
        rows_launched = 0
        pad_toks = useful_toks = 0
        n_chunks = n_absorbs = n_compacts = 0
        # compaction cadence is per-slot decode progress, not engine steps
        since_tok = np.zeros(n, np.int32)
        dec_s = 0.0
        R = layout.keep_recent if layout else 0
        launch_real = launch_padded = 0
        kv_live_sum = kv_alloc_sum = 0
        kv_alloc_peak = 0
        tail_bpt = self._tail_bytes_per_token(cache) if layout else 0
        stall_retries = 0
        bt_cache = [None]

        def bt_device():
            """Device copy of the block table, re-uploaded only when the
            allocator changed it since the last launch."""
            if bt_cache[0] is None or pool.dirty:
                bt_cache[0] = torch.from_numpy(pool.table_for_read()).to(dev)
                pool.dirty = False
            return bt_cache[0]

        def sweep_covered():
            """Give back every block the frontier has already retired
            (normally absorb and compaction do this the moment ``cov``
            advances, so a sweep only recovers blocks under pool
            pressure).  Each slot's upcoming write blocks are protected:
            allocated but not yet written, they look dead."""
            freed = 0
            for j in range(n):
                if admitting[j]:
                    plen = len(prompt_np[slot_uid[j]])
                    cl = int(min(chunk, plen - fed[j]))
                    t_j = int(fed[j])
                elif active[j]:
                    cl, t_j = 1, int(pos[j])
                else:
                    continue
                fr.protect_write(j, kv_pool.write_blocks(
                    t_j, cl, R, paged.block_size))
                freed += pool.free_retired(j, t_j, fr)
                fr.clear_protection(j)
            return freed

        def try_ensure(j, blocks):
            """``pool.ensure`` with a sweep of covered blocks on
            exhaustion.  False: the pool cannot back the write now, and
            the slot stalls for this step."""
            pairs = []
            while True:
                try:
                    pool.ensure(j, blocks, pairs)
                    # copy-on-write pairs come only from shared blocks
                    # (prefix sharing, a later slice)
                    assert not pairs, pairs
                    return True
                except kv_pool.PoolExhausted:
                    if sweep_covered():
                        continue
                    return False

        def start_admission(j, uid):
            p = np.asarray(prompts[uid], np.int32)[-scfg.max_seq:]
            prompt_np[uid] = p
            if pool is not None:
                pool.free_slot(j)   # recycle the previous occupant's blocks
            admitting[j] = True
            fed[j] = 0
            if fr is not None:
                fr.set_frontier(j, 0)
            slot_uid[j] = uid
            if layout is not None:
                # the previous occupant's counts would unmask its stale
                # centroids; ring entries are hidden by the position mask
                self._reset_slot(cache, j)

        while True:
            # ---- admission: at most one chunked prefill in flight --------
            while qi < len(order) and not admitting.any():
                free = [j for j in range(n)
                        if not (active[j] or admitting[j])]
                if not free:
                    break
                start_admission(free[0], order[qi])
                qi += 1
            if not (active.any() or admitting.any()):
                break

            # ---- bucketed launch: shrink to live occupancy ----------------
            if pool is None and qi >= len(order) and not admitting.any():
                busy = [j for j in range(n) if active[j] or admitting[j]]
                desired = min(n, _pow2ceil(max(busy) + 1))
                if desired < bucket:
                    cache = self._shrink_cache(cache, desired)
                    bucket = desired
            bp = bucket

            # ---- chunked admission: pre-step absorb (make ring room) ------
            step_chunks = {}            # slot -> chunk len this step
            for j in np.nonzero(admitting)[0]:
                j = int(j)
                plen = len(prompt_np[slot_uid[j]])
                cl = int(min(chunk, plen - fed[j]))
                step_chunks[j] = cl
                if fr is not None and fed[j] + cl - fr.frontier(j) > R:
                    target = int(np.clip(fed[j] + cl - R + ccfg.refresh,
                                         0, fed[j]))
                    kv_retired["frontier"] += target - fr.frontier(j)
                    self._absorb(cache, j, int(fed[j]), target, ccfg,
                                 self._row_for_read(pool, j, dev))
                    fr.set_frontier(j, target)
                    if pool is not None:
                        pool.free_retired(j, int(fed[j]), fr)
                    n_absorbs += 1

            # ---- build the launch -----------------------------------------
            mixed = bool(step_chunks)
            width = chunk if mixed else 1
            real_rows = int(active.sum()) + sum(step_chunks.values())
            stalled_decode = set()
            if pool is not None:
                # paged packed launch: the blocks this step's ring writes
                # land in are allocated first; a slot the pool cannot back
                # even after a sweep stalls for the step (its rows are not
                # packed) and retries after the next give-back
                for j in range(n):
                    if admitting[j]:
                        if not try_ensure(j, kv_pool.write_blocks(
                                int(fed[j]), step_chunks[j], R,
                                paged.block_size)):
                            del step_chunks[j]
                    elif active[j]:
                        if not try_ensure(j, kv_pool.write_blocks(
                                int(pos[j]), 1, R, paged.block_size)):
                            stalled_decode.add(j)
                mixed = bool(step_chunks)
                width = chunk if mixed else 1
                real_rows = (int(active.sum()) - len(stalled_decode)
                             + sum(step_chunks.values()))
                if real_rows == 0:
                    # every slot is stalled and nothing runs to give blocks
                    # back: twice with nothing to sweep is no progress
                    freed = sweep_covered()
                    stall_retries += 1
                    if stall_retries > 1 and freed == 0:
                        raise kv_pool.PoolExhausted(
                            "zero forward progress: every slot's next "
                            "ring write needs a block and no block is "
                            "reclaimable — raise pool_blocks or shorten "
                            "refresh_every")
                    continue
                stall_retries = 0
                # one row per real (slot, position) pair: (slot, token,
                # position, ring watermark, index in chunk), padded to a
                # power-of-two bucket with rows on slot 0 at position -1;
                # a sixth row carries the attention kernel's row groups
                # in the same host-to-device copy
                rows = []
                for j in range(n):
                    if j in step_chunks:
                        cl = step_chunks[j]
                        p = prompt_np[slot_uid[j]]
                        f = int(fed[j])
                        rows += [(j, int(p[f + i]), f + i, f + cl, i)
                                 for i in range(cl)]
                    elif active[j] and j not in stalled_decode:
                        rows.append((j, int(cur[j]), int(pos[j]),
                                     int(pos[j]) + 1, 0))
                compute_rows = _pow2ceil(len(rows))
                packed = np.zeros((6, compute_rows), np.int32)
                packed[2] = -1
                packed[:5, :len(rows)] = np.asarray(rows, np.int32).T
                packed[5] = pcd.group_rows(packed[0], packed[2] + 1,
                                           packed[3],
                                           cfg.n_heads // cfg.n_kv_heads)
                last_row = {r[0]: i for i, r in enumerate(rows)}
                bt_d = bt_device()
                t0 = time.perf_counter()
                rslot, tokp, rpos, rtw, rcidx, rgrp = torch.from_numpy(
                    packed).to(dev)
                logits, cache = tfm.decode_step_packed(
                    self.params, cfg, cache, tokp, rslot, rpos, rtw, rcidx,
                    bt_d, block_size=paged.block_size, width=width,
                    row_group=rgrp)
                nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
                nxt_of = lambda jj: nxt[last_row[jj]]      # noqa: E731
            else:
                tok = np.zeros((bp, width), np.int32)
                t_vec = np.zeros(bp, np.int32)
                cl_vec = np.ones(bp, np.int32)
                for j in range(min(n, bp)):
                    if admitting[j]:
                        cl = step_chunks[j]
                        p = prompt_np[slot_uid[j]]
                        tok[j, :cl] = p[fed[j]:fed[j] + cl]
                        t_vec[j] = fed[j]
                        cl_vec[j] = cl
                    else:
                        tok[j, 0] = cur[j]
                        t_vec[j] = pos[j]

                t0 = time.perf_counter()
                tok_d = torch.from_numpy(tok).to(dev)
                t_d = torch.from_numpy(t_vec).to(dev)
                if mixed:
                    logits, cache = tfm.decode_step(
                        self.params, cfg, cache, tok_d, t_d,
                        chunk_len=torch.from_numpy(cl_vec).to(dev))
                else:
                    logits, cache = tfm.decode_step(self.params, cfg, cache,
                                                    tok_d, t_d)
                nxt = torch.argmax(logits, -1).to(torch.int32).cpu().numpy()
                nxt_of = lambda jj: nxt[jj]                # noqa: E731
                compute_rows = bp * width
            now = time.perf_counter()
            dec_s += now - t0
            decode_steps += 1
            rows_launched += bp
            launch_real += real_rows
            launch_padded += compute_rows
            wasted_slots += int(n - (active | admitting).sum())
            advanced = active.copy()
            advanced[list(stalled_decode)] = False   # a stalled slot waits
            since_tok[advanced] += 1
            n_chunks += len(step_chunks)
            if layout is not None:
                live = 0
                for j in range(n):
                    if admitting[j]:
                        live += min(int(fed[j]) + step_chunks.get(j, 0)
                                    - cov_of(j), R)
                    elif active[j]:
                        live += min(int(pos[j]) + 1 - cov_of(j), R)
                # physical blocks only, in paged mode
                alloc = (pool.allocated() * paged.block_size if pool
                         else bp * R)
                kv_live_sum += live
                kv_alloc_sum += alloc
                kv_alloc_peak = max(kv_alloc_peak, alloc)

            # ---- host update ---------------------------------------------
            for j in range(min(n, bp)):
                uid = slot_uid[j]
                if admitting[j]:
                    if j not in step_chunks:
                        continue        # pool-stalled this step
                    cl = step_chunks[j]
                    fed[j] += cl
                    plen = len(prompt_np[uid])
                    useful_toks += cl
                    if fed[j] < plen:
                        continue
                    # final chunk landed: its last row's logits are the
                    # request's first generated token
                    if fr is not None:
                        target_end = fr.target(plen)
                        if fr.frontier(j) < target_end:
                            kv_retired["frontier"] += (target_end
                                                       - fr.frontier(j))
                            self._absorb(cache, j, plen, target_end, ccfg,
                                         self._row_for_read(pool, j, dev))
                            fr.set_frontier(j, target_end)
                            if pool is not None:
                                pool.free_retired(j, plen, fr)
                            n_absorbs += 1
                    first = int(nxt_of(j))
                    toks[uid] = [first]
                    token_t[uid] = [now]
                    pre_ms[uid] = (now - t0_serve) * 1e3    # TTFT
                    admitting[j] = False
                    if by_uid[uid].max_new_tokens <= 1:
                        slot_uid[j] = -1
                        if pool is not None:
                            pool.free_slot(j)   # recycling on early exit
                    else:
                        active[j] = True
                        since_tok[j] = 0
                        pos[j] = plen
                        cur[j] = first
                elif active[j] and j not in stalled_decode:
                    toks[uid].append(int(nxt_of(j)))
                    token_t[uid].append(now)
                    pos[j] += 1
                    cur[j] = nxt_of(j)
                    if len(toks[uid]) >= by_uid[uid].max_new_tokens:
                        active[j] = False
                        since_tok[j] = 0
                        if pool is not None:
                            pool.free_slot(j)   # recycling on exit

            # ---- compaction: per-slot cadence -----------------------------
            # a slot is due after ``refresh`` of its OWN decode tokens; one
            # batched call refreshes every due slot (others pass length 0
            # and recompact_clustered's gate keeps them bit-identical)
            due = [j for j in range(n)
                   if ccfg is not None and active[j]
                   and since_tok[j] >= ccfg.refresh and j < bucket]
            if due:
                lengths = np.zeros(bp, np.int32)
                for j in due:
                    lengths[j] = pos[j]
                cache = self.compact_kv(cache, lengths, ccfg,
                                        bt_device() if pool else None)
                # compaction is when the paged engine gives back the
                # blocks the new frontier covers
                for j in due:
                    newc = max(fr.frontier(j), fr.target(int(pos[j])))
                    kv_retired["frontier"] += newc - fr.frontier(j)
                    fr.set_frontier(j, newc)
                    if pool is not None:
                        pool.free_retired(j, int(pos[j]), fr)
                    since_tok[j] = 0
                n_compacts += 1

        wall = time.perf_counter() - t0_serve
        gen_total = sum(len(v) for v in toks.values())
        # each request's first token comes from its last prompt chunk;
        # tokens/s rates only the tokens the decode loop produced
        dec_tokens = gen_total - len(toks)
        dec_ms_tok = dec_s * 1e3 / max(gen_total, 1)
        ttfts = [pre_ms[u] / 1e3 for u in pre_ms]
        itls: List[float] = []
        for ts in token_t.values():
            itls.extend(b - a for a, b in zip(ts, ts[1:]))
        # ---- publish into the typed metrics registry -----------------
        reg.counter("decode_steps",
                    "engine launches this serve").add(decode_steps)
        reg.gauge("slot_waste", "idle slot-steps / total slot-steps"
                  ).set(wasted_slots / max(decode_steps * n, 1))
        reg.gauge("prefill_pad_frac",
                  "prompt pad tokens / all prefill tokens"
                  ).set(pad_toks / max(pad_toks + useful_toks, 1))
        reg.counter("gen_tokens", "tokens generated this serve"
                    ).add(gen_total)
        reg.gauge("decode_s", "seconds inside engine launches"
                  ).set(dec_s)
        reg.gauge("tokens_per_s", "decode-loop tokens per launch second"
                  ).set(dec_tokens / max(dec_s, 1e-9))
        reg.gauge("wall_s", "end-to-end serve wall seconds").set(wall)
        reg.gauge("tokens_per_s_wall", "all tokens per wall second"
                  ).set(gen_total / max(wall, 1e-9))
        ht = reg.histogram("ttft", "wall-clock time to first token",
                           quantiles=(50, 95, 99), scale=1e3,
                           suffix="_ms")
        for v in ttfts:
            ht.observe(v)
        hi = reg.histogram("itl", "inter-token latency",
                           quantiles=(50, 95, 99), scale=1e3,
                           suffix="_ms")
        for v in itls:
            hi.observe(v)
        reg.gauge("launch_rows_frac", "launched slot rows / slots×steps"
                  ).set(rows_launched / max(decode_steps * n, 1))
        reg.gauge("launch_bucket_mean", "mean launch bucket per shard"
                  ).set(rows_launched / max(decode_steps, 1))
        reg.gauge("launch_pad_frac",
                  "launched compute rows carrying no real token"
                  ).set(1.0 - launch_real / max(launch_padded, 1))
        reg.gauge("launch_ragged_frac",
                  "real tokens / launched compute rows"
                  ).set(launch_real / max(launch_padded, 1))
        reg.counter("prefill_chunks",
                    "prompt chunks fed through mixed launches"
                    ).add(n_chunks)
        reg.counter("kv_absorbs", "streaming absorb_chunk calls"
                    ).add(n_absorbs)
        reg.counter("kv_compactions", "batched compaction passes"
                    ).add(n_compacts)
        reg.counter("kv_retired_frontier",
                    "positions retired behind the coverage frontier"
                    ).add(kv_retired["frontier"])
        reg.counter("kv_retired_window",
                    "positions aged out of sliding windows"
                    ).add(kv_retired["window"])
        reg.counter("kv_retired_quota",
                    "block-backed positions released at request exit"
                    ).add(kv_retired["quota"])
        reg.counter("kv_retired_recurrent",
                    "positions retired from recurrent state (0 by "
                    "construction: fixed-size state folds every position)"
                    ).add(0)
        reg.gauge("state_bytes_ring",
                  "dense ring-family state bytes per slot (tails excluded)"
                  ).set(float(layer_state.ring_state_bytes(cache, bucket)))
        reg.gauge("state_bytes_recurrent",
                  "recurrent-family state bytes per slot").set(0.0)
        if layout is not None:
            reg.gauge("kv_frag",
                      "1 - live ring tokens / allocated ring capacity"
                      ).set(1.0 - kv_live_sum / max(kv_alloc_sum, 1))
            reg.gauge("kv_alloc_tokens_peak",
                      "peak allocated ring tokens"
                      ).set(float(kv_alloc_peak))
            if pool is not None:
                # kv_bytes_peak_per_shard, pool_blocks_*, pool_allocs /
                # frees / retains / cow
                pool.publish(reg, bytes_per_block=paged.block_size
                             * tail_bpt)
                # no block is shared without prefix sharing (a later
                # slice): the reference's sharing gauges read 0
                reg.gauge("kv_shared_blocks",
                          "peak logical mappings beyond physical blocks"
                          ).set(0.0)
                reg.gauge("kv_bytes_saved",
                          "tail KV bytes prefix sharing avoided").set(0.0)
                # every request completed → every block recycled
                reg.gauge("pool_blocks_end",
                          "blocks live beyond store pins (>0 = leak)"
                          ).set(float(pool.allocated()))
            else:
                reg.gauge("kv_bytes_peak_per_shard",
                          "peak live tail-KV bytes on the busiest shard"
                          ).set(float(n * R * tail_bpt))
                reg.gauge("pool_occupancy_peak",
                          "peak live blocks / capacity").set(1.0)
        self.last_stats = reg.flat_view()
        return [Completion(uid=r.uid, tokens=toks.get(r.uid, []),
                           prefill_ms=pre_ms.get(r.uid, 0.0),
                           decode_ms=dec_ms_tok * len(toks.get(r.uid, [])))
                for r in requests]

    # ------------------------------------------------------------------
    # cache plumbing
    # ------------------------------------------------------------------

    @staticmethod
    def _tail_bytes_per_token(cache) -> int:
        """Bytes one ring position costs across every tail leaf (k + v,
        all layers)."""
        total = 0
        for leaf in cache["layers"]:
            for key in ("k_tail", "v_tail"):
                if key in leaf:
                    a = leaf[key]
                    total += a.shape[-2] * a.shape[-1] * a.element_size()
        return total

    @staticmethod
    def _shrink_cache(cache, nb: int):
        """Keep the first nb slots of every leaf (the dropped high slots
        hold no live request)."""
        return {"layers": [{k: v[:nb] for k, v in leaf.items()}
                           for leaf in cache["layers"]]}

    @staticmethod
    def _reset_slot(cache, j: int) -> None:
        """Zero slot j's clustered bookkeeping (counts + cov), in place,
        ahead of a fresh admission."""
        for leaf in cache["layers"]:
            if _is_clustered_kv(leaf):
                leaf["counts"][j] = 0.0
                leaf["cov"][j] = 0

    @staticmethod
    def _row_for_read(pool, j: int, device):
        """Slot j's read-sanitized block-table row on ``device`` (paged),
        or None (dense)."""
        if pool is None:
            return None
        return torch.from_numpy(pool.row_for_read(j)).to(device)

    @staticmethod
    def _absorb(cache, j: int, lengths: int, target: int, ccfg,
                bt_row=None) -> None:
        """Advance slot j's coverage frontier to ``target`` in every layer
        by one batched ``absorb_chunk`` over the layers, touching only that
        slot (in place): mid-decode neighbours stay bit-identical.  Paged
        (``bt_row`` (T,) the slot's read-sanitized table row): the slot's
        blocks are gathered into ring order first; absorb never moves
        tail bytes, so the pool is left as it is."""
        leaves = [leaf for leaf in cache["layers"] if _is_clustered_kv(leaf)]
        n_l = len(leaves)
        dev = leaves[0]["cov"].device

        def rows(leaf, k):
            if bt_row is not None and k in ("k_tail", "v_tail"):
                return _gather_tail_rows(leaf[k], bt_row)
            return leaf[k][j]

        sub = {k: torch.stack([rows(leaf, k) for leaf in leaves])
               for k in leaves[0]}
        got = kv_compress.absorb_chunk(
            sub, torch.full((n_l,), lengths, dtype=torch.int32, device=dev),
            torch.full((n_l,), target, dtype=torch.int32, device=dev), ccfg)
        for li, leaf in enumerate(leaves):
            for k in ("k_cents", "v_cents", "counts", "cov"):
                leaf[k][j] = got[k][li]

    def compact_kv(self, cache, t, ccfg: kv_compress.KVCompressConfig,
                   bt=None):
        """Re-compact every clustered layer with warm-started k-medians in
        one batched call over (layer, slot, head); ``t`` is a scalar length
        or a per-slot (B,) vector (0 = leave the slot alone).  Returns the
        cache with new centroid banks; tail rings are untouched.  Paged
        (``bt`` (B, T) the read-sanitized block table): every slot's
        blocks are gathered into ring order first."""
        leaves = [leaf for leaf in cache["layers"] if _is_clustered_kv(leaf)]
        if not leaves:
            return cache
        b = leaves[0]["cov"].shape[0]
        dev = leaves[0]["cov"].device
        lengths = torch.broadcast_to(
            torch.as_tensor(t, dtype=torch.int32, device=dev), (b,))

        def rows(leaf, k):
            if bt is not None and k in ("k_tail", "v_tail"):
                return _gather_tail_rows(leaf[k], bt)
            return leaf[k]

        flat = {k: torch.cat([rows(leaf, k) for leaf in leaves])
                for k in leaves[0]}
        out = kv_compress.recompact_clustered(
            flat, lengths.repeat(len(leaves)), ccfg)
        for li, leaf in enumerate(leaves):
            for k in ("k_cents", "v_cents", "counts", "cov"):
                leaf[k] = out[k][li * b:(li + 1) * b]
        return cache


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
