"""Serving runtime: the continuous-batching engine with chunked or
blocking admission and device-resident clustered-KV compaction, on one
device or a (data, model) mesh of ranks, with a dense cache or a paged
block pool, and the static batch-at-a-time baseline (port of
``repro.runtime.server``).

Requests are ordered by the clustering batcher (core/request_cluster.py);
a slot-based continuous batcher admits a request the moment a slot frees.
Admission runs in one of two modes:

  * chunked, decode-interleaved (``prefill_chunk > 0``): each engine step
    feeds one prompt chunk of at most ``prefill_chunk`` tokens for at most
    one admitting slot, fused into the same launch that advances every
    decoding slot by one token (mixed-mode ``decode_step``).  With a
    ``KVCompressConfig`` a prompt longer than the tail ring streams in
    through ``kv_compress.absorb_chunk``;
  * blocking (``prefill_chunk == 0``, the reference's default): one
    ``prefill`` of the prompt right-padded to a multiple of
    ``prefill_bucket``, then a write of the B=1 cache into the slot.  With
    a ``KVCompressConfig`` the prefill cache is first put in clustered
    form (``_clusterize``): a prompt that fits the ring less ``refresh``
    positions goes in as the ring alone, a longer one through
    ``kv_compress.compress_cache_batched``.

Each slot is re-compacted after ``refresh_every`` of its own decode tokens
(slots whose frontier does not move keep their summaries bit-identical).
Once the queue drains, the dense launch bucket shrinks by powers of two.

Sliding-window ('L') layers keep a dense ring of their last ``window``
positions per slot, exact in every mode (only 'G' layers are clustered),
and retire behind the window (``WindowRetention``).  Recurrent layers ('M'
Mamba2 SSD, 'R' RG-LRU) carry a fixed-size state per slot that never
retires (``RecurrentRetention``): the mixed launch advances it token by
token, blocking admission prefills it by stepping the same decode
(``recurrent_mode="sequential"``), a chunked admission zeroes it first,
and slot snapshots (prefix sharing, the swap) carry it whole.  Every
launch steps a recurrent column at the engine's slot count
(``recurrent_rows``, bound once in ``Server._prefill`` / ``_decode``), so
a row's bits do not depend on the launch.  A
model with 'L', 'M' or 'R' layers admits prompts at their exact length
(bucket 1): pad tokens would enter a window ring or a recurrent state.

With ``paged=PagedKVConfig(...)`` the 'G' layers' exact tail rings live
in a block pool behind per-slot block tables (runtime/kv_pool.py).  With
``kv_compress`` the pool serves the clustered cache; without it, the
cache keeps the clustered layout with one dead centroid (count 0) and a
ring of ``max_seq`` positions, ``cov`` pinned at 0, so every position
stays exact (``QuotaRetention``): an admission reserves the request's
whole block depth up front and is put back in the queue when the pool
cannot supply it, and the blocks return only at slot exit.  Blocks are
allocated right before the write that first touches them (a blocking
admission claims its live prompt blocks before its prefill, and is put
back in the queue when the pool cannot supply them), given back once
compaction or a streaming absorb covers every position they hold, and
recycled when a request exits.  Each engine step is one packed ragged
launch (``decode_step_packed``): one row per real (slot, position) pair,
padded to a power-of-two row bucket, so mixed prefill + decode compute
scales with real tokens.  A slot whose next write finds the pool empty
even after a sweep of covered blocks stalls for the step; when every
slot stalls twice with nothing to reclaim, or an idle engine cannot admit
twice, the serve raises ``PoolExhausted``.  The launch bucket never
shrinks in paged mode.

``engine="static"`` serves the batcher's batches one at a time: a
left-padded prefill of the batch, then decode steps over its exact cache
until its longest request is done.

With ``prefix_share=PrefixShareConfig(...)`` (paged, chunked, clustered,
'G' layers only) a chunked admission registers its prefix-pure state at
every chunk boundary (runtime/prefix_cache.py): the live ring blocks,
retained in the pool, and a snapshot of the slot's centroids, counts and
frontier (``transformer.clustered_slot_state``).  A later request whose
prompt starts with a registered prefix adopts the blocks, restores the
snapshot and streams only the rest; a write into a block that another
holder still maps copies it first (``kv_pool.ensure``'s copy-on-write
pairs, ``_cow_impl``).  ``template_store=`` keeps those entries, their
pinned blocks, the pool and the device cache across ``serve`` calls
(runtime/template_store.py), under an epoch that stamps the model, the
KV and pool configs and a content hash of the weights.

With ``scheduler=SLOConfig(...)`` (paged, clustered, 'G' layers only)
requests carry a priority class and a soft TTFT deadline
(runtime/scheduler.py): under slot or pool pressure the engine preempts
the cheapest lower-priority decoding slot, gathering its slot snapshot
and mapped tail blocks to host memory and releasing its blocks; a parked
request resumes mid-stream when capacity returns, re-adopting the blocks
whose ``(gid, generation)`` survived and re-uploading the rest, with the
tokens of an uninterrupted run.  Before the engine would raise
``PoolExhausted`` it sheds best-effort work; only protected work raises.
With ``telemetry=TelemetryConfig(trace=True)`` the serve records the
request lifecycle and every engine step (``last_trace``,
``export_trace``).

MLA models (DeepSeek-V3) serve static and blocking, exact or under
``kv_compress``: an MLA layer's latent cache stays exact in every mode
(``_clusterize`` and compaction pass it through; the coverage frontier is
bookkeeping only), and chunked or paged serving raises the reference's
ValueError.  A frontend model (InternVL2) serves text-only in the same
modes; an encoder-decoder (SeamlessM4T) serves through the model entry
points only (``transformer.prefill(enc_embeds=...)`` and
``decode_step``): the continuous engine raises NotImplementedError and
the static one a ValueError naming the missing encoder inputs.

Per-slot host bookkeeping (``pos`` / ``cur`` / ``fed``, the coverage
frontier mirror) replays the reference engine step for step, so greedy
tokens match it.

With ``mesh=`` (``launch.mesh.make_serving_mesh``: a ``DeviceMesh`` over a
``torch.distributed`` world, one process a rank) every rank runs this same
engine SPMD, as the reference's one process drives its mesh.  Every rank
holds the replicated weights and the whole host state, so all make the
same decisions; slot j lives on data shard j // per_shard at index
j % per_shard, and a rank's device cache holds only its data shard's slots
(and pool blocks) and its model shard's kv heads (``sharding.rules``'s
blocks).  A device step runs on the rank's own rows, its attention through
``kernels.ops.head_island`` (heads gathered back over ``model`` before
``wo``), and the next tokens are gathered over ``data``, so every host sees
every slot.  Absorb and compaction touch one slot's heads at a time, so
they stay rank-local, the median on the ``bitserial_median`` kernel.  A
blocking admission's B=1 prefill runs on every rank (each needs its first
token); the slot's owners keep their head block.  At most one admitting
slot a data shard in chunked mode, the emptiest shard first.  Slots that do
not divide the data axis replicate over it, heads that do not divide the
model axis replicate over it (the reference's fallbacks).  Every model
family serves on a mesh.

Prefix sharing, the template store and the SLO scheduler keep their host
maps per data shard, as the reference does: block ids mean something only
on the shard that owns them, so a prefix entry lives on one shard's map,
admission steers a request toward the shards that hold its match (then
its traffic cluster), and an adoption never crosses shards.  Every rank
keeps the same host entries; only the ranks of the entry's shard hold its
snapshot (their head block of it).  Preemption picks a victim on the
shard under pressure; a parked request resumes into the emptiest shard's
lowest free slot, which may be another shard than the one it left: the
owning ranks keep the only host copy of the payload (the slot snapshot
and the tail blocks, their head block of each) and send it point to point
to the ranks of the same model index on the resuming shard
(``sharding.rules.move_payload``).  Every host decision is the same on
every rank: the one that reads a clock (the TTFT deadline shed) takes
rank 0's verdict, broadcast over the world, and the template store's
epoch hashes the world's weight digests together.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
import hashlib
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from repro_torch.core import kv_compress
from repro_torch.core import layer_state
from repro_torch.core import retention
from repro_torch.core.request_cluster import (BatchPlan, Request,
                                              plan_batches, plan_fifo)
from repro_torch.kernels import paged_clustered_decode as pcd
from repro_torch.launch.mesh import mesh_sizes
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import resolve_device
from repro_torch.runtime import kv_pool
from repro_torch.runtime import prefix_cache as prefix_mod
from repro_torch.runtime import telemetry as tele_mod
from repro_torch.runtime import template_store as template_mod
from repro_torch.runtime.scheduler import SLOConfig, SLOScheduler, SwapRecord
from repro_torch.runtime.telemetry import TelemetryConfig
from repro_torch.sharding import rules as shard_rules


@dataclasses.dataclass
class ServerConfig:
    batch_size: int = 4            # decode slots
    max_seq: int = 256
    use_clustered_batching: bool = True
    n_request_clusters: int = 4
    greedy: bool = True            # the engine decodes greedily either way
    engine: str = "continuous"     # "continuous" | "static"
    prefill_bucket: int = 16       # blocking admission right-pads prompts
                                   # to a multiple of this (the causal mask
                                   # keeps the logits of the last real
                                   # position exact)
    prefill_chunk: int = 0         # >0: chunked prefill interleaved with
                                   # decode, at most this many prompt
                                   # tokens a step (<= keep_recent when
                                   # serving clustered); 0: blocking
                                   # admission
    kv_compress: Optional[kv_compress.KVCompressConfig] = None
    # when set, the engine serves from a clustered KV cache end to end and
    # re-compacts every kv_compress.refresh decode steps per slot
    paged: Optional[kv_pool.PagedKVConfig] = None
    # paged KV memory manager: tail rings in a block pool behind per-slot
    # block tables, decoded by packed ragged launches; clustered under
    # kv_compress, else exact KV under a per-slot block quota
    prefix_share: Optional[prefix_mod.PrefixShareConfig] = None
    # prefix-shared paged admission: chunk-boundary state registered and
    # adopted across requests of one serve (paged + chunked + kv_compress)
    template_store: Optional[object] = None
    # a TemplateStoreConfig or a TemplateStore: prefix sharing whose
    # entries persist across serve() calls (subsumes prefix_share)
    scheduler: Optional[SLOConfig] = None
    # SLO-aware preemption, host swap and brownout (paged + kv_compress)
    telemetry: Optional[TelemetryConfig] = None
    mesh: Optional[object] = None
    # (data, model) DeviceMesh (launch/mesh.make_serving_mesh): decode
    # slots and their caches over data, kv heads over model, one rank a
    # process; None = one device


@dataclasses.dataclass
class Completion:
    uid: int
    tokens: List[int]
    prefill_ms: float              # wall-clock time to first token (TTFT)
    decode_ms: float
    shed: bool = False


def _pow2ceil(x: int) -> int:
    return 1 << max(x - 1, 0).bit_length()


def _is_exact_kv(node) -> bool:
    return (isinstance(node, dict) and "k" in node and "v" in node
            and "k_scale" not in node)


def _is_clustered_kv(node) -> bool:
    return isinstance(node, dict) and "k_cents" in node


def _compress_exact_layers(leaves, lengths, ccfg):
    """Exact (B, S, H, Dh) leaves → clustered leaves, every layer in one
    ``compress_cache_batched`` fit whose members are (layer, slot, head),
    as the reference's per-layer calls are (a member's fit depends on its
    own points only); ``lengths`` (B,) valid counts per slot."""
    b = leaves[0]["k"].shape[0]
    out = kv_compress.compress_cache_batched(
        torch.cat([leaf["k"] for leaf in leaves]),
        torch.cat([leaf["v"] for leaf in leaves]),
        lengths.repeat(len(leaves)), ccfg)
    return [{k: v[i * b:(i + 1) * b] for k, v in out.items()}
            for i in range(len(leaves))]


def _sync(device) -> None:
    """Wait for the card's queue (host timers around device work)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


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
            if scfg.kv_compress is not None:
                if scfg.kv_compress.keep_recent % paged.block_size:
                    raise ValueError(
                        f"block_size {paged.block_size} must divide "
                        f"keep_recent {scfg.kv_compress.keep_recent} (ring "
                        "offsets map to whole blocks)")
            elif scfg.max_seq % paged.block_size:
                raise ValueError(
                    f"block_size {paged.block_size} must divide max_seq "
                    f"{scfg.max_seq}: paged serving without kv_compress is "
                    "exact KV under QuotaRetention, the full sequence "
                    "backed by whole blocks reserved at admission")
            report = cfg.serving_gate_report()
            if report is not None:
                raise ValueError("paged serving: " + report)
            if not layer_state.families_for(cfg).has_ring:
                raise ValueError(
                    "paged serving needs at least one ring-family layer: "
                    "recurrent-state layers ('M'/'R') carry fixed-size "
                    "per-slot state that is never pool-backed, so a "
                    "pure-recurrent pattern has nothing to page — serve "
                    "dense chunked instead (prefill_chunk= without paged=)")
        # paged without kv_compress: exact KV under a block quota, in the
        # clustered layout with one dead centroid and a ring of max_seq
        # positions (cov stays 0, so every position stays exact)
        self._kv_layout = scfg.kv_compress
        if paged is not None and scfg.kv_compress is None:
            self._kv_layout = kv_compress.KVCompressConfig(
                n_clusters=1, keep_recent=scfg.max_seq, refresh_every=0)
        self._pshare = scfg.prefix_share
        self._store: Optional[template_mod.TemplateStore] = None
        if scfg.template_store is not None:
            if self._pshare is not None:
                raise ValueError(
                    "template_store subsumes prefix_share (same adopting "
                    "admission path, persistent entries) — set only one")
            ts = scfg.template_store
            self._store = (ts if isinstance(ts, template_mod.TemplateStore)
                           else template_mod.TemplateStore(ts))
            self._pshare = self._store.share
        if self._pshare is not None:
            if (paged is None or not scfg.prefill_chunk
                    or scfg.kv_compress is None
                    or set(cfg.layer_pattern) - set("GMR")):
                raise ValueError(
                    "prefix_share/template_store requires the paged "
                    "clustered engine with chunked prefill over snapshot-"
                    "coverable layers ('G' clustered rings plus 'M'/'R' "
                    "recurrent state; 'L' window rings are not in "
                    "snapshots) — kv_compress= + paged= + prefill_chunk=: "
                    "block-granular sharing needs the block pool's ref "
                    "counts, slot snapshots restore clustered summaries "
                    "and recurrent state only, and prefix-pure "
                    "registration points only exist on the chunked "
                    "admission schedule")
        self._slo = scfg.scheduler
        if self._slo is not None:
            if (paged is None or scfg.kv_compress is None
                    or set(cfg.layer_pattern) - set("GMR")
                    or scfg.engine != "continuous"):
                raise ValueError(
                    "scheduler= (SLO-aware preemption) requires the "
                    "paged clustered continuous engine over snapshot-"
                    "coverable layers ('G' clustered rings plus 'M'/'R' "
                    "recurrent state; 'L' window rings are not in "
                    "snapshots) — kv_compress= + paged=: swap snapshots "
                    "restore clustered summaries and recurrent state "
                    "only, and preemption frees pool blocks — the dense "
                    "and exact engines have nothing to swap")
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
        if scfg.mesh is not None and scfg.engine != "continuous":
            raise ValueError("mesh serving requires the continuous "
                             "engine (static batches are per-device)")
        tfm.check_supported(cfg)
        self._mesh_setup(cfg, scfg)
        # every dense launch steps a recurrent column at the slot count of
        # the rank's cache (on a mesh its data shard's), whatever rows it
        # holds (blocking admission's fresh one-row cache, a shrunk bucket,
        # the static batch); the packed launch reads the count from its
        # all-slot cache
        rows = max(scfg.batch_size // self._n_data_shards, 1)
        self._prefill = functools.partial(
            tfm.prefill, recurrent_mode="sequential", recurrent_rows=rows)
        self._decode = functools.partial(tfm.decode_step,
                                         recurrent_rows=rows)
        # the template store's weight stamp: the tree this rank was given,
        # hashed before placement (the ranks of an MoE mesh then hold
        # different blocks of it), and on a mesh the world's digests
        # hashed together, so every rank holds one epoch and comes up warm
        # or cold with the others
        digest = None
        if self._store is not None:
            digest = self._params_digest(params)
            if self._rules is not None:
                digest = self._world_digest(digest)
        if self._rules is not None:
            # this rank's block of the routed-expert banks, every other
            # leaf whole (the reference's serving_param_specs placement)
            params = shard_rules.place_serving_params(params, self._rules)
        self.params = _to_device(params, self.device)
        self.last_stats: Dict[str, float] = {}
        # port-only counts of a blocking clustered serve's admissions by
        # _clusterize form ("kv_admit_compress", "kv_admit_tail") and its
        # seconds in _clusterize ("clusterize_s"); kept out of the metrics
        # registry, whose surface is the reference's (docs/metrics_torch.md)
        self.last_admission: Dict[str, float] = {}
        # typed metrics registry and lifecycle tracer: last_stats is a flat
        # view regenerated from the registry at the end of every serve
        self.metrics = tele_mod.MetricsRegistry()
        self._tele = scfg.telemetry or TelemetryConfig()
        self.tracer = (tele_mod.Tracer(self._tele.max_events)
                       if self._tele.trace else None)
        self.last_trace: List[dict] = []
        # layer-state families (core/layer_state.py): ring KV ('G'/'L',
        # retention-governed) and fixed-size recurrent state ('M'/'R',
        # checkpointed whole)
        self._kinds = tfm.layer_kinds(cfg)
        self._families = layer_state.families_for(cfg)
        self._has_recurrent = self._families.has_recurrent
        # bucket-padded prefill is exact only for global attention (causal
        # mask, masked decode): a sliding-window ring or a recurrent state
        # would take the pad tokens in, so such models admit at the exact
        # prompt length
        self._bucket = (1 if set(self._kinds) & set("LMR")
                        else scfg.prefill_bucket)
        # cross-serve template persistence: the pool and the device cache
        # that carry the store's pinned blocks between serve() calls.  The
        # epoch stamps every input a registered snapshot depends on, the
        # weights by content (a reloaded identical tree keeps a warm
        # store); nothing else reads it, so it is hashed only for a store
        self._tmpl_pool: Optional[kv_pool.BlockPool] = None
        self._tmpl_cache = None
        self._store_epoch = None
        if self._store is not None:
            self._store_epoch = (repr(cfg), repr(scfg.kv_compress),
                                 repr(scfg.paged), scfg.prefill_chunk,
                                 scfg.max_seq, scfg.batch_size,
                                 self._n_data_shards, digest)

    def _mesh_setup(self, cfg: ModelConfig, scfg: ServerConfig) -> None:
        """Mesh serving's rules and this rank's place in them: the data
        shard count (``axes_for("batch", batch_size)``: slots that do not
        divide the data axis replicate over it, and so do their pools),
        this rank's data shard and the group the next tokens are gathered
        over.  Every model family and every runtime mode (prefix
        sharing, the template store, the SLO scheduler) serves on a
        mesh."""
        self._rules: Optional[shard_rules.Rules] = None
        self._n_data_shards = 1
        self._data_index = 0
        self._data_group = None
        mesh = scfg.mesh
        if mesh is None:
            return
        if not isinstance(mesh, DeviceMesh):
            raise TypeError("mesh= takes a DeviceMesh "
                            "(launch.mesh.make_serving_mesh), not "
                            f"{type(mesh).__name__}")
        if mesh.device_type != self.device.type:
            raise ValueError(f"a mesh of {mesh.device_type} ranks cannot "
                             f"serve on {self.device}")
        table = shard_rules.default_table("pod" in mesh_sizes(mesh))
        rules = shard_rules.Rules(mesh, table)
        axes = rules.axes_for("batch", scfg.batch_size)
        if axes:
            self._n_data_shards = rules.size(axes)
            self._data_index = rules.axis_index(axes)
            self._data_group = rules.group(axes)
        table["batch"] = axes
        self._rules = rules

    def _mesh_ctx(self, whole_rows: bool = False):
        """The sharding rules around a device step (the head islands, the
        MoE dispatch); ``whole_rows``: every rank holds all of the step's
        rows (a B=1 admission prefill)."""
        if self._rules is None:
            return contextlib.nullcontext()
        return shard_rules.use_rules(
            dataclasses.replace(self._rules, whole_rows=True)
            if whole_rows else self._rules)

    def param_bytes(self) -> Dict[str, int]:
        """This rank's parameter bytes: "total", and "experts" those of its
        routed-expert banks (its block of them on a mesh)."""
        out = {"total": 0, "experts": 0}

        def walk(node, path):
            if isinstance(node, dict):
                for k, v in node.items():
                    walk(v, f"{path}/{k}")
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, f"{path}/{i}")
            elif torch.is_tensor(node):
                n = node.numel() * node.element_size()
                out["total"] += n
                if shard_rules.is_expert_bank(path):
                    out["experts"] += n

        walk(self.params, "")
        return out

    def _gather_rows(self, x: torch.Tensor) -> torch.Tensor:
        """This rank's rows of a step output → every data shard's, in
        shard order (an ``all_gather`` over ``data``); as is on one shard."""
        if self._data_group is None:
            return x
        x = x.contiguous()
        parts = [torch.empty_like(x) for _ in range(self._n_data_shards)]
        dist.all_gather(parts, x, group=self._data_group)
        return torch.cat(parts)

    # ------------------------------------------------------------------
    # entry
    # ------------------------------------------------------------------

    def invalidate_templates(self) -> None:
        """Drop every persistent template entry, releasing the pool blocks
        the store pinned across serves: afterwards the pool is drained
        (``allocated() == 0``; nothing else holds a block between serves)
        and the warm device cache is dropped, so the next serve starts
        cold."""
        if self._store is not None:
            self._store.invalidate()
        if self._tmpl_pool is not None:
            assert self._tmpl_pool.allocated() == 0, \
                "template pins released but pool still holds blocks"
        self._tmpl_pool = None
        self._tmpl_cache = None

    def serve(self, requests: Sequence[Request],
              prompts: Dict[int, np.ndarray]) -> List[Completion]:
        """prompts: uid -> token array.  Returns completions per request."""
        with torch.inference_mode():
            if self.scfg.engine == "continuous":
                return self._serve_continuous(requests, prompts)
            return self._serve_static(requests, prompts)

    def export_trace(self, path: str, fmt: str = "chrome") -> None:
        """Write the last serve's lifecycle trace (needs
        ``ServerConfig.telemetry.trace``): ``fmt="chrome"`` writes Chrome
        trace-event JSON loadable in Perfetto (spans nested under slot
        threads, last_stats embedded for offline reconciliation);
        ``fmt="jsonl"`` the raw event log, one JSON object per line."""
        if fmt == "chrome":
            tele_mod.write_chrome_trace(self.last_trace, path,
                                        n_shards=self._n_data_shards,
                                        stats=self.last_stats)
        elif fmt == "jsonl":
            tele_mod.write_jsonl(
                self.last_trace, path,
                meta={"n_shards": self._n_data_shards,
                      "last_stats": {k: float(v)
                                     for k, v in self.last_stats.items()}})
        else:
            raise ValueError(f"unknown trace format {fmt!r} "
                             "(expected 'chrome' or 'jsonl')")

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
        if cfg.is_encdec:
            raise NotImplementedError(
                "continuous engine serves decoder-only models")
        dev = self.device
        t0_serve = time.perf_counter()
        reg = self.metrics
        reg.begin_serve()
        tr = self.tracer
        _annot = (tele_mod.annotation if self._tele.jax_profiler
                  else (lambda _n: contextlib.nullcontext()))
        ccfg = scfg.kv_compress
        # the cache layout (clustered leaves, ring geometry) is apart from
        # the retention policy on top of it: ccfg means FrontierRetention,
        # paged without ccfg QuotaRetention over a full-depth ring
        layout = self._kv_layout
        chunk = self._chunk
        n = scfg.batch_size
        plan = self._plan(requests)
        order = [u for b in plan.batches for u in b]
        by_uid = {r.uid: r for r in requests}
        slo_cfg = self._slo
        if slo_cfg is not None and slo_cfg.priority_admission:
            # admission control: the protected class admits ahead of
            # best-effort work wherever it queues (stable within a class,
            # so the batcher's order survives inside each); tokens are
            # unaffected, only who waits
            order.sort(key=lambda uid: -by_uid[uid].priority)
        # data shards: slot j lives on data shard j // per_shard at index
        # j % per_shard (one shard: per_shard = n, index = j).  The whole
        # engine's launch rows are shard-major, ``shards * bucket`` of them
        # (phys(j)); a rank's device cache holds its own shard's ``bucket``
        # rows: per_shard until the queue drains, then powers of two down
        # to the busiest index (admissions only happen before the drain,
        # at the full shape)
        shards = self._n_data_shards
        per_shard = max(n // shards, 1)
        bucket = per_shard
        shard_of = lambda j: min(j // per_shard, shards - 1)  # noqa: E731
        idx_of = lambda j: j % per_shard                      # noqa: E731
        me = self._data_index

        def mine(j):
            """Slot j's rows live on this rank."""
            return shard_of(j) == me

        def shard_slots(sh):
            return range(sh * per_shard, min((sh + 1) * per_shard, n))

        def phys(j):
            return shard_of(j) * bucket + idx_of(j)

        if tr is not None:
            tr.begin_serve(t0_serve, shards)
            fam = self._families
            # the layer-state families this serve runs with, so offline
            # readers can segment span populations by family mix
            tr.event("state_families", tid="engine", t=t0_serve,
                     ring="".join(sorted(fam.ring.kinds)),
                     recurrent="".join(sorted(fam.recurrent.kinds)))
            for qpos, quid in enumerate(order):
                qr = by_uid[quid]
                tr.event("queued", tid="queue", uid=quid, t=t0_serve,
                         queue_pos=qpos, priority=qr.priority,
                         prompt_len=qr.prompt_len)

        # paged memory manager: tail rings in a block pool behind per-slot
        # block tables; the launch bucket never shrinks (packed rows
        # already make compute follow real tokens)
        paged = scfg.paged
        pool = pcache = cache = None
        store = self._store
        if paged is not None:
            parked = store.parked if store is not None else None
            if (parked is not None and parked[2] == self._store_epoch
                    and parked[3] == shards):
                # warm start: the parked pool and device cache carry the
                # store's pinned blocks.  They live on the store, keyed by
                # epoch, so another Server under the same epoch adopts
                # them too; the slot is taken eagerly, so a serve that dies
                # mid-flight leaves nothing half-donated (the next serve
                # comes up cold and bind() drops the orphaned entries)
                pool, cache = parked[0], parked[1]
                store.parked = None
                self._tmpl_pool = self._tmpl_cache = None
                pool.reset_peaks()
            else:
                pool = kv_pool.BlockPool(n, layout.keep_recent, paged,
                                         n_shards=shards,
                                         slots_per_shard=per_shard,
                                         full_tail_resident=ccfg is not None)
            if store is not None:
                # a store warmed under another epoch or pool is
                # invalidated here, never adopted
                store.bind(self._store_epoch, shards, pool)
                pcache = store
            elif self._pshare is not None:
                pcache = prefix_mod.PrefixCache(self._pshare, shards, pool)
        full = cache
        if cache is None or self._rules is not None:
            # on a mesh the whole cache is shapes only (meta): a rank
            # allocates just its block, zeros like every fresh leaf, and a
            # warm store's parked cache is that block too, so the byte
            # prices below read the meta one
            full = tfm.init_cache(
                cfg, n, scfg.max_seq,
                kv_mode="clustered" if layout else "exact",
                kv_clusters=layout.n_clusters if layout else 512,
                kv_tail=layout.keep_recent if layout else 256,
                kv_pool_blocks=pool.n_blocks if pool else 0,
                kv_block_size=paged.block_size if paged else 0,
                device=dev if self._rules is None else "meta")
        if cache is None:
            cache = full
            if self._rules is not None:
                cache = _zeros_on(shard_rules.shard_cache(full, self._rules),
                                  dev)
        # per-serve stats are deltas against these marks: a persistent
        # store and pool carry lifetime counters across serves
        hits0 = pcache.hits if pcache is not None else 0
        reused0 = pcache.tokens_reused if pcache is not None else 0
        pool_mark = ((pool.n_allocs, pool.n_frees, pool.n_retains,
                      pool.n_cow) if pool is not None else (0, 0, 0, 0))
        # SLO scheduler: one per serve (every parked request resumes or
        # sheds before the serve returns, so the template store's
        # cross-serve state is untouched by preemption)
        slo = SLOScheduler(slo_cfg, n) if slo_cfg is not None else None

        pos = np.zeros(n, np.int32)       # cache valid length per slot
        cur = np.zeros(n, np.int32)       # pending (unfed) token per slot
        active = np.zeros(n, bool)        # decoding
        admitting = np.zeros(n, bool)     # chunked prefill in flight
        fed = np.zeros(n, np.int32)       # prompt tokens streamed so far
        # retention policies (core/retention.py):
        #   fr     'G' layers, clustered: retire behind the coverage
        #          frontier (the host cov mirror replays the device
        #          formulas step for step)
        #   quota  'G' layers, exact paged: nothing retires mid-flight; a
        #          per-slot block budget reserved at admission
        #   wr     'L' layers: retire behind the sliding window (the dense
        #          ring's overwrite reclaims the storage; wr keeps the
        #          kv_retired_window count)
        #   rr     'M'/'R' layers: fixed-size recurrent state folds every
        #          position, so nothing retires (kv_retired_recurrent 0)
        fr = (retention.FrontierRetention(n, ccfg)
              if ccfg is not None else None)
        quota = (retention.QuotaRetention(paged.block_size,
                                          pool.blocks_per_slot)
                 if pool is not None and ccfg is None else None)
        wr = (retention.WindowRetention(cfg.sliding_window, n)
              if "L" in cfg.layer_pattern and cfg.sliding_window else None)
        rr = (retention.RecurrentRetention(
                  tuple(sorted(self._families.recurrent.kinds)))
              if self._has_recurrent else None)
        sweep_policy = fr if fr is not None else quota
        cov_of = fr.frontier if fr is not None else (lambda j: 0)
        kv_retired = {"frontier": 0, "window": 0, "quota": 0}
        slot_uid = [-1] * n
        prompt_np: Dict[int, np.ndarray] = {}
        toks: Dict[int, List[int]] = {}
        pre_ms: Dict[int, float] = {}
        token_t: Dict[int, List[float]] = {}
        # tracer tenancy: one "run" span per (slot, tenancy); admission or
        # resume opens it, finish, shed or preemption closes it, and its
        # token deltas sum to the uid's final count
        seg: List[Optional[tuple]] = [None] * n

        def slot_tid(j):
            return f"slot{j}"

        def slot_ids(j):
            """Slot j's trace track: its data shard and its thread."""
            return {"pid": shard_of(j), "tid": slot_tid(j)}

        def tr_open(j, uid, t, how, p0=0):
            if tr is None:
                return
            seg[j] = (t, how, uid, len(toks.get(uid, ())), int(p0))

        def tr_close(j, t, why):
            """Close slot j's tenancy span, before its blocks are freed
            (``blocks_held`` is the tenancy's)."""
            if tr is None or seg[j] is None:
                return
            t0s, how, uid, tok0, p0 = seg[j]
            seg[j] = None
            held = pool.mapped_blocks(j) if pool is not None else 0
            tr.span("run", t0s, t, **slot_ids(j), uid=uid, start=how,
                    end=why, tokens=len(toks.get(uid, ())) - tok0, pos0=p0,
                    pos1=int(max(int(fed[j]), int(pos[j]))),
                    blocks_held=held)

        def tr_brownout(rung, why, **args):
            """Instant event naming the brownout rung taken and why."""
            if tr is not None:
                tr.event("brownout", tid="engine", rung=rung, why=why,
                         **args)

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
        kv_alloc_peak = kv_shared_peak = 0
        # byte prices of the whole engine (every kv head), from the whole
        # cache's shapes
        tail_bpt = self._tail_bytes_per_token(full) if layout else 0
        ring_state_b = layer_state.ring_state_bytes(full, n)
        # the recurrent family's byte price: the whole fixed-size state one
        # slot carries (constant over the stream, swapped whole, never
        # pool-backed), added to every victim's cost and swap payload
        rec_state_b = (layer_state.recurrent_state_bytes(full, n)
                       if self._has_recurrent else 0)
        del full
        shard_busy_steps = np.zeros(shards, np.int64)
        shard_steps = 0
        stall_retries = idle_retries = 0
        # blocking clustered admissions by _clusterize form, and its time
        n_admit_compress = n_admit_tail = 0
        clusterize_s = 0.0
        bt_cache = [None]

        def bt_device():
            """Device copy of the block table, re-uploaded only when the
            allocator changed it since the last launch."""
            if bt_cache[0] is None or pool.dirty:
                bt = pool.table_for_read()
                if self._rules is not None:
                    bt = np.ascontiguousarray(shard_rules.place_block_tables(
                        bt, self._rules, pool.pool_blocks))
                bt_cache[0] = torch.from_numpy(bt).to(dev)
                pool.dirty = False
            return bt_cache[0]

        def occupancy():
            occ = np.zeros(shards, np.int32)
            for j in range(n):
                if active[j] or admitting[j]:
                    occ[shard_of(j)] += 1
            return occ

        def sweep_covered(s):
            """Give back every block of data shard ``s`` that the retention
            policy has already retired (under FrontierRetention absorb and
            compaction do this the moment ``cov`` advances, so a sweep only
            recovers blocks under pool pressure; under QuotaRetention
            nothing retires mid-flight and the sweep frees nothing).  Each
            slot's upcoming write blocks are protected: allocated but not
            yet written, they look dead."""
            freed = 0
            for j in range(n):
                if shard_of(j) != s:
                    continue
                if admitting[j]:
                    plen = len(prompt_np[slot_uid[j]])
                    cl = int(min(chunk, plen - fed[j]))
                    t_j = int(fed[j])
                elif active[j]:
                    cl, t_j = 1, int(pos[j])
                else:
                    continue
                sweep_policy.protect_write(j, kv_pool.write_blocks(
                    t_j, cl, R, paged.block_size))
                freed += pool.free_retired(j, t_j, sweep_policy)
                sweep_policy.clear_protection(j)
            return freed

        def reclaim_all():
            """Last-resort reclaim: sweep every shard's covered blocks and
            drain the prefix cache.  Returns the blocks freed; the
            zero-progress raises fire only after this comes back empty
            twice."""
            held = pool.allocated()
            for s in range(shards):
                sweep_covered(s)
                while pcache is not None and pcache.evict_lru(s):
                    pass
            return held - pool.allocated()

        def try_ensure(j, blocks, pairs):
            """``pool.ensure`` with reclaim on exhaustion: a sweep of
            covered blocks, then prefix-cache eviction (a pinned entry is
            an optimisation, never an obligation).  False: the pool cannot
            back the write now, and the slot stalls for this step.

            ``pairs`` is the step's shared copy-on-write accumulator: a
            swap made before a mid-list exhaustion is not emitted again on
            retry (the fresh block is owned by then), so the pairs of a
            failed attempt still need their copy this step, even when the
            slot stalls."""
            while True:
                try:
                    pool.ensure(j, blocks, pairs)
                    return True
                except kv_pool.PoolExhausted:
                    # blocks are shard-local: only the slot's shard helps
                    s = shard_of(j)
                    if sweep_covered(s):
                        continue
                    if pcache is not None and pcache.evict_lru(s):
                        continue
                    return False

        # ---- SLO preemption, swap and brownout (runtime/scheduler.py) --
        # All of these run at clean step boundaries (the admission phase,
        # the post-step pass, the zero-progress backstops): mid-step a
        # victim's copy-on-write copies may not have landed, and a
        # swap-out gather would read unwritten fresh blocks.  Victims are
        # always decoding slots: an admitting slot may hold a prefix-cache
        # pin between lookup and restore, and waits by deferral instead.

        def victim_candidates(shard=None):
            """(priority, swap cost in bytes, slot) for every decoding
            slot (of data shard ``shard`` only, when given: blocks are
            shard-local, so pool pressure needs a victim on its shard):
            its mapped tail blocks, plus the recurrent state."""
            return [(by_uid[slot_uid[j]].priority,
                     pool.mapped_blocks(j) * paged.block_size * tail_bpt
                     + rec_state_b, j)
                    for j in range(n) if active[j]
                    and (shard is None or shard_of(j) == shard)]

        # the data shard each parked request was swapped out of: its ranks
        # hold the record's payload (the others keep snap / tails None)
        swapped_from: Dict[int, int] = {}

        def preempt(j):
            """Swap slot j out to host memory: its slot snapshot and the
            tail blocks its table maps, copied off the device before
            ``release_slot`` hands the blocks on (remembering each
            block's (gid, generation) for re-adoption); the request parks
            on the swap backlog.  The slot's state is a function of its
            own token stream, and the swap carries it exactly, so a
            resumed request's tokens are an uninterrupted run's.  On a
            mesh only slot j's ranks gather (their head block of it)."""
            uid = slot_uid[j]
            r = by_uid[uid]
            t_sw0 = time.perf_counter()
            snap = tails = None
            if mine(j):
                snap, tails = self._swap_out(
                    cache, idx_of(j),
                    pool.row_for_read(j) - pool.shard_base(j))
            swapped_from[uid] = shard_of(j)
            held = pool.release_slot(j)
            rec = SwapRecord(
                uid=uid, priority=r.priority, pos=int(pos[j]),
                cur=int(cur[j]), fed=int(fed[j]),
                since_tok=int(since_tok[j]), cov=int(cov_of(j)),
                max_new_tokens=r.max_new_tokens,
                deadline_ms=r.deadline_ms, held=held, snap=snap,
                tails=tails, epoch=self._store_epoch, seq=0,
                n_blocks_swapped=len(held), state_bytes=rec_state_b)
            slo.record_swap(rec)
            slo.swap_bytes += (len(held) * paged.block_size * tail_bpt
                               + rec_state_b)
            if tr is not None:
                t_now = time.perf_counter()
                tr.span("swap_out", t_sw0, t_now, **slot_ids(j), uid=uid,
                        blocks=len(held), pos=int(pos[j]),
                        state_bytes=rec_state_b)
                tr_close(j, t_now, "preempt")
            active[j] = False
            slot_uid[j] = -1
            since_tok[j] = 0
            return rec

        def resume_swapped(j, rec) -> bool:
            """Re-admit a parked request mid-stream into slot j (any free
            slot: the host payload is slot-agnostic).  Blocks whose (gid,
            generation) survived are re-adopted without an upload; the
            rest are allocated afresh and scattered back from the host
            copy.  False: the pool cannot back it now (the caller defers
            the resume; nothing is half-restored)."""
            assert rec.epoch == self._store_epoch, (
                "swap record from another config epoch: a parked request "
                "cannot outlive the serve that preempted it")
            # headroom gate: a resume that takes the last free blocks
            # recreates the starvation that parked it (the blocks bounce
            # straight back and the engine thrashes without decoding), so
            # resume only when the pool can take the re-upload and still
            # hand one write block to the resumed slot and to each
            # decoding slot.  Only truly fresh blocks count: held blocks
            # whose (gid, gen) survived re-adopt for free
            s = shard_of(j)
            t_r0 = time.perf_counter()
            headroom = 1 + sum(1 for jj in range(n)
                               if active[jj] and shard_of(jj) == s)
            fresh_demand = pool.resume_demand(j, rec.held)
            if pool.free_blocks(s) < fresh_demand + headroom:
                slo.deferrals += 1
                tr_brownout("defer", "resume_headroom", uid=rec.uid,
                            free=pool.free_blocks(s), fresh=fresh_demand,
                            held=len(rec.held), headroom=headroom)
                return False
            pool.free_slot(j)   # recycle any previous occupant's blocks
            readopted, fresh = [], []
            for bi, (gid, gen) in rec.held.items():
                (readopted if pool.readopt(j, bi, gid, gen)
                 else fresh).append(bi)
            if fresh and not try_ensure(j, fresh, []):
                pool.free_slot(j)       # drop the re-adoptions too
                slo.deferrals += 1
                tr_brownout("defer", "resume_alloc", uid=rec.uid,
                            fresh=len(fresh))
                return False
            slo.readopted_blocks += len(readopted)
            slo.reuploaded_blocks += len(fresh)
            # only the fresh blocks take the host bytes: a re-adopted block
            # may be shared, and writing it (even with equal bytes) would
            # break copy-on-write.  Ids local to the shard's pool block;
            # the others point past it
            row = np.full(pool.blocks_per_slot, pool.pool_blocks, np.int32)
            for bi in fresh:
                row[bi] = pool.table[j, bi] - pool.shard_base(j)
            snap, tails = rec.snap, rec.tails
            src = swapped_from.pop(rec.uid)
            if src != s:
                # resumed on another data shard: the payload travels from
                # the ranks that swapped it out to those of the same model
                # index here (a receiving rank's own rows give the shapes)
                if me == s:
                    snap, tails = self._swap_out(
                        cache, idx_of(j),
                        pool.row_for_read(j) - pool.shard_base(j))
                if me in (src, s):
                    snap, tails = shard_rules.move_payload(
                        (snap, tails), self._data_group, src, s,
                        self.device)
            if mine(j):
                self._swap_in(cache, snap, tails, idx_of(j), row)
            pos[j] = rec.pos
            cur[j] = rec.cur
            fed[j] = rec.fed
            since_tok[j] = rec.since_tok
            active[j] = True
            slot_uid[j] = rec.uid
            fr.set_frontier(j, rec.cov)
            slo.pop_record(rec)
            slo.swap_bytes -= (rec.n_blocks_swapped * paged.block_size
                               * tail_bpt + rec.state_bytes)
            if tr is not None:
                t_now = time.perf_counter()
                tr_open(j, rec.uid, t_r0, "resume", p0=rec.pos)
                tr.span("resume", t_r0, t_now, **slot_ids(j), uid=rec.uid,
                        readopted=len(readopted), reuploaded=len(fresh),
                        demand=fresh_demand)
            return True

        def shed_active(j):
            """Drop a decoding best-effort request outright (its partial
            tokens are returned, its blocks freed)."""
            uid = slot_uid[j]
            slo.shed_uid(uid, by_uid[uid].priority)
            if tr is not None:
                t_now = time.perf_counter()
                tr.event("shed", **slot_ids(j), uid=uid, t=t_now,
                         where="active", why="brownout")
                tr_close(j, t_now, "shed")
            active[j] = False
            admitting[j] = False
            slot_uid[j] = -1
            since_tok[j] = 0
            pool.free_slot(j)

        def brownout_shed() -> bool:
            """The last rung before ``PoolExhausted``: shed best-effort
            work so the engine can progress again, cheapest first (a
            parked record, whose blocks are already free; the queue head
            it cannot admit; a decoding slot).  The protected class is
            never shed: False means only it remains, and the exhaustion
            is real."""
            nonlocal qi
            if not slo_cfg.shed_on_exhaustion:
                return False
            rec = slo.pick_shed()
            if rec is not None:
                slo.shed_record(rec)
                swapped_from.pop(rec.uid, None)
                slo.swap_bytes -= (rec.n_blocks_swapped * paged.block_size
                                   * tail_bpt + rec.state_bytes)
                tr_brownout("shed", "parked_record", uid=rec.uid)
                if tr is not None:
                    tr.event("shed", tid="engine", uid=rec.uid,
                             where="parked", why="pool_exhausted")
                return True
            if qi < len(order):
                r = by_uid[order[qi]]
                if not slo.is_high(r.priority):
                    slo.shed_uid(r.uid, r.priority)
                    tr_brownout("shed", "queue_head", uid=r.uid)
                    if tr is not None:
                        tr.event("shed", tid="queue", uid=r.uid,
                                 where="queue", why="pool_exhausted")
                    qi += 1
                    return True
            v = slo.pick_victim(victim_candidates(), slo_cfg.high_class)
            if v is not None:
                tr_brownout("shed", "active_victim", victim=int(v))
                shed_active(v)
                return True
            return False

        def brownout_reclaim() -> bool:
            """Zero progress: preempt the lowest-priority decoding slot
            when a higher-priority one needs its blocks (the swap rung),
            else shed (the last rung).  At zero progress only, a slot of
            the same class may be preempted too (with at least two
            decoding: swapping the only one out would resume it into the
            same wall), held until real tokens decode again."""
            cands = victim_candidates()
            if cands and slo.can_swap():
                v = slo.pick_victim(cands, max(c[0] for c in cands))
                within_class = v is None
                if within_class and len(cands) >= 2:
                    v = slo.pick_victim(cands,
                                        max(c[0] for c in cands) + 1)
                if v is not None:
                    if tr is not None:
                        vp, vcost, _ = next(c for c in cands if c[2] == v)
                        tr_brownout("preempt", "zero_progress",
                                    victim=int(v), victim_priority=vp,
                                    victim_cost_bytes=int(vcost),
                                    within_class=within_class)
                    rec = preempt(v)
                    # held until real tokens decode again, or the freed
                    # blocks bounce straight back (live-lock)
                    rec.hold = within_class
                    return True
            return brownout_shed()

        # per-request candidate digests, hashed once a serve; the memo is
        # keyed by uid but checks the prompt before reuse (a uid recycled
        # for another prompt must not steer or adopt with old digests).
        # The template store assigns a request its cluster on first
        # hashing, during slot choice, as the reference does.
        dig_by_uid: Dict[int, tuple] = {}
        cid_by_uid: Dict[int, int] = {}

        def prefix_digests(uid):
            po = prompts[uid]
            memo = dig_by_uid.get(uid)
            if memo is not None and (memo[0] is po or np.array_equal(
                    np.asarray(memo[0]), np.asarray(po))):
                return memo[1]
            p = np.asarray(po, np.int32)[-scfg.max_seq:]
            d = pcache.prefix_digests(p, chunk)
            dig_by_uid[uid] = (po, d)
            if store is not None:
                cid_by_uid[uid] = store.assign(p, d)
            return d

        def start_admission(j, uid) -> bool:
            """Start a chunked admission into slot j.  False: the pool
            cannot supply a quota request's blocks now, and the request
            stays queued."""
            p = np.asarray(prompts[uid], np.int32)[-scfg.max_seq:]
            prompt_np[uid] = p
            if pool is not None:
                pool.free_slot(j)   # recycle the previous occupant's blocks
            if quota is not None:
                # QuotaRetention's contract: reserve the whole block budget
                # up front (admitted means completable, since nothing
                # retires mid-flight) and defer the request on shortage
                if not try_ensure(j, range(quota.admit_blocks(
                        len(p), by_uid[uid].max_new_tokens)), []):
                    pool.free_slot(j)
                    return False
            admitting[j] = True
            fed[j] = 0
            if fr is not None:
                fr.set_frontier(j, 0)
            if wr is not None:
                wr.on_slot_free(j)
            slot_uid[j] = uid
            hit = (pcache.lookup(shard_of(j), p, chunk,
                                 digests=prefix_digests(uid))
                   if pcache is not None else None)
            if hit is not None:
                # prefix hit: adopt the registered ring blocks (a write
                # into one still shared copies it first) and restore the
                # prompt centroids and frontier; admission resumes at
                # hit.fed.  The entry lives on slot j's shard, whose ranks
                # hold its snapshot (their head block of it).  The paged
                # bucket never shrinks, so idx_of(j) is the slot's row.
                assert pool is not None and bucket == per_shard
                for bi, gid in hit.blocks.items():
                    pool.adopt(j, bi, gid)
                if mine(j):
                    tfm.restore_clustered_slot_state(cache, hit.snap,
                                                     idx_of(j))
                fed[j] = hit.fed
                fr.set_frontier(j, hit.cov)
                # the slot holds its own refs now: the entry may be
                # evicted again
                pcache.adoption_done(hit)
            elif (layout is not None or self._has_recurrent) and mine(j):
                # the previous occupant's counts would unmask its stale
                # centroids, and a recurrent leaf has no mask at all (its
                # state feeds the next step); ring entries are hidden by
                # the position mask
                self._reset_slot(cache, idx_of(j))
            if tr is not None:
                tr_open(j, uid, time.perf_counter(), "admit",
                        p0=int(fed[j]))
            return True

        def admit_blocking(j, uid) -> bool:
            """One prefill of the whole (bucket-padded) prompt, then the
            B=1 cache goes into slot j.  False: the pool cannot supply the
            prompt's live blocks now, and the request stays queued."""
            nonlocal pad_toks, useful_toks, clusterize_s
            nonlocal n_admit_compress, n_admit_tail
            r = by_uid[uid]
            p = np.asarray(prompts[uid], np.int32)[-scfg.max_seq:]
            plen = len(p)
            cov0 = fr.target(plen) if fr is not None else 0
            if pool is not None and r.max_new_tokens > 1:
                # claim blocks before the prefill, so an exhausted pool
                # defers the request instead of wasting its prefill: under
                # FrontierRetention those of the live (uncovered) prompt
                # positions (covered offsets stay unmapped and the slot
                # write drops them), under QuotaRetention the request's
                # whole block budget
                pool.free_slot(j)
                need = (range(quota.admit_blocks(plen, r.max_new_tokens))
                        if quota is not None else
                        kv_pool.live_blocks(plen, cov0, R,
                                            paged.block_size))
                # a freed slot maps no shared block: no copy-on-write pair
                # (blocking admission and prefix sharing exclude each
                # other)
                if not try_ensure(j, need, []):
                    pool.free_slot(j)
                    return False
            bkt = min(scfg.max_seq, -(-plen // self._bucket) * self._bucket)
            padded = np.zeros((1, bkt), np.int32)
            padded[0, :plen] = p
            t0 = time.perf_counter()
            # every rank prefills (each needs the first token); the slot's
            # owners keep their block of kv heads below
            with self._mesh_ctx(whole_rows=True):
                logits1, c1 = self._prefill(self.params, cfg,
                                            torch.from_numpy(padded).to(dev),
                                            max_seq=scfg.max_seq,
                                            last_pos=plen - 1)
            first = int(torch.argmax(logits1, -1)[0])
            now = time.perf_counter()
            pre_ms[uid] = (now - t0_serve) * 1e3        # TTFT
            tr_open(j, uid, t0, "admit", p0=0)
            toks[uid] = [first]
            token_t[uid] = [now]
            if tr is not None:
                tr.span("prefill", t0, now, **slot_ids(j), uid=uid,
                        prompt_len=plen)
                tr.event("first_token", **slot_ids(j), uid=uid, t=now,
                         ttft_ms=pre_ms[uid])
            pad_toks += bkt - plen
            useful_toks += plen
            if r.max_new_tokens <= 1:
                if tr is not None:
                    t_done = time.perf_counter()
                    tr.event("finish", **slot_ids(j), uid=uid, t=t_done)
                    tr_close(j, t_done, "finish")
                if pool is not None:
                    pool.free_slot(j)   # done at prefill; slot stays free
                return True
            if mine(j) and self._rules is not None:
                c1 = shard_rules.place_admission(c1, self._rules)
            if layout is not None:
                if mine(j):
                    t_c = time.perf_counter()
                    c1 = self._clusterize(c1, plen, layout, self._kinds)
                    _sync(dev)
                    clusterize_s += time.perf_counter() - t_c
                if plen <= R - layout.refresh:
                    n_admit_tail += 1
                else:
                    n_admit_compress += 1
            if fr is not None:
                fr.set_frontier(j, cov0)
                kv_retired["frontier"] += cov0
            if wr is not None:
                wr.on_slot_free(j)
                kv_retired["window"] += wr.advance(j, plen)
            if mine(j) and pool is not None:
                self._write_slot_paged(
                    cache, c1, idx_of(j),
                    pool.row_for_write(j) - pool.shard_base(j),
                    paged.block_size)
            elif mine(j):
                self._write_slot(cache, c1, idx_of(j))
            cur[j], pos[j] = first, plen
            active[j] = True
            since_tok[j] = 0
            slot_uid[j] = uid
            return True

        while True:
            # ---- admission into the lowest free slot: chunked mode keeps
            # at most one prefill in flight, blocking mode fills every free
            # slot (a pool-deferred request stays at the queue head) -------
            while True:
                # a parked (preempted) request resumes ahead of any fresh
                # admission of equal or lower priority: it already paid
                # for its admission once
                rec = slo.peek_resume() if slo is not None else None
                if (rec is not None and qi < len(order)
                        and by_uid[order[qi]].priority > rec.priority):
                    rec = None
                if rec is None and qi >= len(order):
                    break
                occ = occupancy()
                if rec is not None:
                    # the emptiest data shard's lowest free index (the
                    # payload is slot-agnostic; another shard's ranks
                    # receive it)
                    rcands = []
                    for sh in range(shards):
                        sh_free = [jj for jj in shard_slots(sh)
                                   if not (active[jj] or admitting[jj])]
                        if sh_free:
                            rcands.append((occ[sh], sh, sh_free[0]))
                    if rcands:
                        if resume_swapped(min(rcands)[-1], rec):
                            continue
                        break   # pool-deferred resume: retry later
                    # slot pressure on a resume: preempt a strictly
                    # lower-priority decoding slot to make room
                    v = (slo.pick_victim(victim_candidates(), rec.priority)
                         if slo.can_swap() else None)
                    if v is not None:
                        tr_brownout("preempt", "resume_slot_pressure",
                                    victim=int(v), for_uid=rec.uid)
                        preempt(v)
                        continue
                    break
                uid = order[qi]
                # the emptiest data shard's lowest free index (a burst
                # spreads across shards and keeps indices low for tight
                # launch buckets); with prefix sharing, occupancy ties
                # prefer the shard holding the longest match (block ids
                # are shard-local, so reuse cannot cross shards), then
                # the one holding the request's traffic cluster; chunked
                # mode keeps at most one prefill in flight a shard
                p_next = (np.asarray(prompts[uid], np.int32)[-scfg.max_seq:]
                          if pcache is not None else None)
                cands = []
                for sh in range(shards):
                    slots = shard_slots(sh)
                    if chunk and any(admitting[jj] for jj in slots):
                        continue
                    sh_free = [jj for jj in slots
                               if not (active[jj] or admitting[jj])]
                    if sh_free:
                        match = (pcache.match_len(
                            sh, p_next, chunk, digests=prefix_digests(uid))
                                 if pcache is not None else 0)
                        aff = (store.shard_affinity(
                            sh, cid_by_uid.get(uid, -1))
                               if store is not None else 0)
                        cands.append((occ[sh], -match, -aff, sh,
                                      sh_free[0]))
                if not cands:
                    # slot pressure: a higher-priority head preempts the
                    # cheapest strictly-lower-priority decoding slot on a
                    # shard that could admit (chunked mode: a shard
                    # already feeding a prefill cannot, free slot or not)
                    if slo is not None and slo.can_swap():
                        adm = [sh for sh in range(shards)
                               if not (chunk and any(
                                   admitting[jj] for jj in shard_slots(sh)))]
                        v = slo.pick_victim(
                            [c for c in victim_candidates()
                             if shard_of(c[2]) in adm],
                            by_uid[uid].priority)
                        if v is not None:
                            tr_brownout("preempt", "slot_pressure",
                                        victim=int(v), for_uid=uid)
                            preempt(v)
                            continue
                    break
                j = min(cands)[-1]
                ok = (start_admission(j, uid) if chunk
                      else admit_blocking(j, uid))
                if ok:
                    qi += 1
                    continue
                # pool-deferred admission: count it, then walk the
                # brownout ladder: shed a best-effort request already past
                # its TTFT deadline (it can no longer meet it; its blocks
                # serve requests that still can), or preempt a
                # lower-priority slot
                if slo is not None:
                    slo.deferrals += 1
                    r = by_uid[uid]
                    # the clock is read once, on rank 0 (ranks whose
                    # clocks disagree would part the world here)
                    if (not slo.is_high(r.priority) and r.deadline_ms > 0
                            and self._rank0_verdict(
                                (time.perf_counter() - t0_serve) * 1e3
                                > r.deadline_ms)):
                        slo.shed_uid(uid, r.priority)
                        if tr is not None:
                            tr.event("shed", tid="queue", uid=uid,
                                     where="queue", why="deadline")
                        qi += 1
                        continue
                    if slo.can_swap():
                        v = slo.pick_victim(victim_candidates(shard_of(j)),
                                            r.priority)
                        if v is not None:
                            tr_brownout("preempt", "admission_pool",
                                        victim=int(v), for_uid=uid)
                            preempt(v)
                            continue
                tr_brownout("defer", "admission_pool", uid=uid)
                break   # pool-deferred: retry after a give-back
            if not (active.any() or admitting.any()):
                if qi >= len(order) and (slo is None
                                         or slo.backlog_size() == 0):
                    break
                # an admission (or a parked request's resume) deferred on
                # an idle engine: reclaim covered blocks and prefix-cache
                # pins and retry; then the brownout ladder sheds
                # best-effort work; twice with nothing freed is no
                # progress, and only then does protected work raise
                freed = reclaim_all() if pool is not None else 0
                idle_retries += 1
                if idle_retries > 1 and freed == 0:
                    if slo is not None and brownout_reclaim():
                        idle_retries = 0
                        continue
                    raise kv_pool.PoolExhausted(
                        "zero forward progress: an idle engine cannot "
                        "admit the next request even with every "
                        "reclaimable block returned — raise pool_blocks "
                        "(one slot's live window no longer fits)")
                continue
            idle_retries = 0

            # ---- bucketed launch: shrink to live occupancy ----------------
            if pool is None and qi >= len(order) and not admitting.any():
                busy = [idx_of(j) for j in range(n)
                        if active[j] or admitting[j]]
                desired = min(per_shard, _pow2ceil(max(busy) + 1))
                if desired < bucket:
                    cache = self._shrink_cache(cache, desired)
                    bucket = desired
            bp = shards * bucket

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
                    t_ab0 = time.perf_counter()
                    if mine(j):
                        self._absorb(cache, idx_of(j), int(fed[j]), target,
                                     ccfg, self._row_for_read(pool, j, dev))
                    fr.set_frontier(j, target)
                    if pool is not None:
                        pool.free_retired(j, int(fed[j]), fr)
                    n_absorbs += 1
                    if tr is not None:
                        tr.span("absorb", t_ab0, time.perf_counter(),
                                **slot_ids(j), uid=slot_uid[j],
                                target=int(target))

            # ---- build the launch -----------------------------------------
            mixed = bool(step_chunks)
            width = chunk if mixed else 1
            real_rows = int(active.sum()) + sum(step_chunks.values())
            stalled_decode = set()
            stalled_admit = set()
            if pool is not None:
                # paged packed launch: the blocks this step's ring writes
                # land in are allocated first; a slot the pool cannot back
                # even after reclaim stalls for the step (its rows are not
                # packed) and retries after the next give-back.  A shared
                # block about to be written is swapped for a copy, and the
                # copies run before the step's ring writes
                cow_pairs = []
                for j in range(n):
                    if admitting[j]:
                        if not try_ensure(j, kv_pool.write_blocks(
                                int(fed[j]), step_chunks[j], R,
                                paged.block_size), cow_pairs):
                            del step_chunks[j]
                            stalled_admit.add(j)
                    elif active[j]:
                        if not try_ensure(j, kv_pool.write_blocks(
                                int(pos[j]), 1, R, paged.block_size),
                                cow_pairs):
                            stalled_decode.add(j)
                if shards > 1:
                    # a pair lives on one data shard: this rank copies its
                    # own shard's, in its pool block's local ids
                    base = me * pool.pool_blocks
                    cow_pairs = [(a - base, b - base) for a, b in cow_pairs
                                 if a // pool.pool_blocks == me]
                if cow_pairs:
                    self._cow_impl(cache, cow_pairs)
                mixed = bool(step_chunks)
                width = chunk if mixed else 1
                real_rows = (int(active.sum()) - len(stalled_decode)
                             + sum(step_chunks.values()))
                if real_rows > 0 and slo is not None:
                    # progress this step: records parked by a zero-progress
                    # preemption may resume again
                    slo.clear_holds()
                if real_rows == 0:
                    # every slot is stalled and nothing runs to give blocks
                    # back: twice with nothing to reclaim is no progress
                    freed = reclaim_all()
                    stall_retries += 1
                    if stall_retries > 1 and freed == 0:
                        # brownout before the raise: swap the
                        # lowest-priority stalled slot out so its blocks
                        # unstick the others, else shed best-effort work
                        if slo is not None and brownout_reclaim():
                            stall_retries = 0
                            continue
                        raise kv_pool.PoolExhausted(
                            "zero forward progress: every slot's next "
                            "ring write needs a block and no block is "
                            "reclaimable — raise pool_blocks or shorten "
                            "refresh_every")
                    continue
                stall_retries = 0
                # one row per real (slot, position) pair: (slot, token,
                # position, ring watermark, index in chunk), padded per
                # data shard to a power-of-two bucket with rows on the
                # shard's first slot at position -1 (paged slots never
                # shrink, so slot j is row j of the table); a sixth row
                # carries the attention kernel's row groups in the same
                # host-to-device copy
                rows_by_shard = [[] for _ in range(shards)]
                for j in range(n):
                    rs = rows_by_shard[shard_of(j)]
                    if j in step_chunks:
                        cl = step_chunks[j]
                        p = prompt_np[slot_uid[j]]
                        f = int(fed[j])
                        rs += [(j, int(p[f + i]), f + i, f + cl, i)
                               for i in range(cl)]
                    elif active[j] and j not in stalled_decode:
                        rs.append((j, int(cur[j]), int(pos[j]),
                                   int(pos[j]) + 1, 0))
                row_bucket = _pow2ceil(max(max(map(len, rows_by_shard)), 1))
                compute_rows = shards * row_bucket
                last_row = {}
                # this rank's block of the rows: local slots, rows 6-7 the
                # recurrent layers' rounds, planned here
                packed = np.zeros((8 if self._has_recurrent else 6,
                                   row_bucket), np.int32)
                packed[2] = -1
                for sh, rs in enumerate(rows_by_shard):
                    last_row.update((r[0], sh * row_bucket + i)
                                    for i, r in enumerate(rs))
                rs = rows_by_shard[me]
                if rs:
                    packed[:5, :len(rs)] = np.asarray(rs, np.int32).T
                    packed[0, :len(rs)] -= me * bucket
                packed[5] = pcd.group_rows(packed[0], packed[2] + 1,
                                           packed[3],
                                           cfg.n_heads // cfg.n_kv_heads)
                if self._has_recurrent:
                    idx, sizes = tfm.recurrent_round_plan(
                        packed[0], packed[2], packed[4], width)
                    packed[6:, :idx.shape[1]] = idx
                bt_d = bt_device()
                t0 = time.perf_counter()
                packed_d = torch.from_numpy(packed).to(dev)
                rslot, tokp, rpos, rtw, rcidx, rgrp = packed_d[:6]
                rounds = (tfm.recurrent_rounds(
                    packed_d[6:, :idx.shape[1]], sizes)
                    if self._has_recurrent else None)
                with _annot("decode_packed"), self._mesh_ctx():
                    logits, cache = tfm.decode_step_packed(
                        self.params, cfg, cache, tokp, rslot, rpos, rtw,
                        rcidx, bt_d, block_size=paged.block_size,
                        width=width, row_group=rgrp, rounds=rounds)
                nxt = self._gather_rows(
                    torch.argmax(logits, -1).to(torch.int32)).cpu().numpy()
                nxt_of = lambda jj: nxt[last_row[jj]]      # noqa: E731
            else:
                # this rank's rows: its data shard's bucket
                tok = np.zeros((bucket, width), np.int32)
                t_vec = np.zeros(bucket, np.int32)
                cl_vec = np.ones(bucket, np.int32)
                for j in range(n):
                    if not mine(j) or idx_of(j) >= bucket:
                        continue
                    i = idx_of(j)
                    if admitting[j]:
                        cl = step_chunks[j]
                        p = prompt_np[slot_uid[j]]
                        tok[i, :cl] = p[fed[j]:fed[j] + cl]
                        t_vec[i] = fed[j]
                        cl_vec[i] = cl
                    else:
                        tok[i, 0] = cur[j]
                        t_vec[i] = pos[j]

                t0 = time.perf_counter()
                tok_d = torch.from_numpy(tok).to(dev)
                t_d = torch.from_numpy(t_vec).to(dev)
                if mixed:
                    with _annot("mixed_step"), self._mesh_ctx():
                        logits, cache = self._decode(
                            self.params, cfg, cache, tok_d, t_d,
                            chunk_len=torch.from_numpy(cl_vec).to(dev))
                else:
                    with _annot("decode_step"), self._mesh_ctx():
                        logits, cache = self._decode(
                            self.params, cfg, cache, tok_d, t_d)
                nxt = self._gather_rows(
                    torch.argmax(logits, -1).to(torch.int32)).cpu().numpy()
                nxt_of = lambda jj: nxt[phys(jj)]          # noqa: E731
                compute_rows = bp * width
            now = time.perf_counter()
            dec_s += now - t0
            decode_steps += 1
            rows_launched += bp
            launch_real += real_rows
            launch_padded += compute_rows
            wasted_slots += int(n - (active | admitting).sum())
            if tr is not None:
                kind = ("decode" if not step_chunks else
                        ("mixed" if real_rows > sum(step_chunks.values())
                         else "prefill"))
                tr.span("engine_step", t0, now, tid="engine", kind=kind,
                        width=int(width), rows=int(compute_rows),
                        real_rows=int(real_rows),
                        occupancy=[int(x) for x in occupancy()],
                        pool_free=([pool.free_blocks(sh)
                                    for sh in range(shards)]
                                   if pool is not None else []),
                        pool_live=(int(pool.allocated())
                                   if pool is not None else 0),
                        stalled=len(stalled_decode) + len(stalled_admit))
            advanced = active.copy()
            advanced[list(stalled_decode)] = False   # a stalled slot waits
            since_tok[advanced] += 1
            n_chunks += len(step_chunks)
            if shards > 1:
                shard_steps += 1
                for j in range(n):
                    if active[j] or admitting[j]:
                        shard_busy_steps[shard_of(j)] += 1
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
                if pool is not None:
                    kv_shared_peak = max(kv_shared_peak,
                                         pool.shared_extra())

            # ---- host update ---------------------------------------------
            for j in range(n):
                if idx_of(j) >= bucket:
                    continue
                uid = slot_uid[j]
                if admitting[j]:
                    if j not in step_chunks:
                        continue        # pool-stalled this step
                    cl = step_chunks[j]
                    fed[j] += cl
                    if tr is not None:
                        tr.event("prefill_chunk", **slot_ids(j), uid=uid,
                                 t=now, fed=int(fed[j]), chunk=cl)
                    if wr is not None:
                        kv_retired["window"] += wr.advance(j, int(fed[j]))
                    plen = len(prompt_np[uid])
                    useful_toks += cl
                    if fed[j] < plen:
                        # chunk-boundary state is prefix-pure (a function
                        # of tokens[:fed] alone: per-slot compaction keeps
                        # neighbours out of it), so register it for later
                        # requests with the same prefix
                        if (pcache is not None and fed[j] % chunk == 0
                                and fed[j] >= max(self._pshare.min_prefix,
                                                  chunk)):
                            blocks = {
                                bi: int(pool.table[j, bi])
                                for bi in kv_pool.live_blocks(
                                    int(fed[j]), cov_of(j), R,
                                    paged.block_size)
                                if pool.table[j, bi] >= 0}
                            # every rank keeps the host entry (its maps
                            # and LRU stay the same everywhere); only
                            # slot j's ranks hold the snapshot
                            pcache.register(
                                shard_of(j), prompt_np[uid], int(fed[j]),
                                cov_of(j), blocks,
                                tfm.clustered_slot_state(cache, idx_of(j))
                                if mine(j) else None,
                                cluster=cid_by_uid.get(uid, -1))
                        continue
                    # final chunk landed: its last row's logits are the
                    # request's first generated token
                    if fr is not None:
                        target_end = fr.target(plen)
                        if fr.frontier(j) < target_end:
                            kv_retired["frontier"] += (target_end
                                                       - fr.frontier(j))
                            t_ab0 = time.perf_counter()
                            if mine(j):
                                self._absorb(
                                    cache, idx_of(j), plen, target_end, ccfg,
                                    self._row_for_read(pool, j, dev))
                            fr.set_frontier(j, target_end)
                            if pool is not None:
                                pool.free_retired(j, plen, fr)
                            n_absorbs += 1
                            if tr is not None:
                                tr.span("absorb", t_ab0,
                                        time.perf_counter(),
                                        **slot_ids(j), uid=uid,
                                        target=int(target_end))
                    first = int(nxt_of(j))
                    toks[uid] = [first]
                    token_t[uid] = [now]
                    pre_ms[uid] = (now - t0_serve) * 1e3    # TTFT
                    if tr is not None:
                        tr.event("first_token", **slot_ids(j), uid=uid,
                                 t=now, ttft_ms=pre_ms[uid])
                    admitting[j] = False
                    if by_uid[uid].max_new_tokens <= 1:
                        if tr is not None:
                            tr.event("finish", **slot_ids(j), uid=uid,
                                     t=now)
                            tr_close(j, now, "finish")
                        slot_uid[j] = -1
                        if pool is not None:
                            if quota is not None:
                                kv_retired["quota"] += (
                                    int((pool.table[j] >= 0).sum())
                                    * paged.block_size)
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
                    if wr is not None:
                        kv_retired["window"] += wr.advance(j, int(pos[j]))
                    cur[j] = nxt_of(j)
                    if len(toks[uid]) >= by_uid[uid].max_new_tokens:
                        active[j] = False
                        since_tok[j] = 0
                        if tr is not None:
                            tr.event("finish", **slot_ids(j), uid=uid,
                                     t=now)
                            tr_close(j, now, "finish")
                        if pool is not None:
                            if quota is not None:
                                # an exact-KV slot retires its whole
                                # footprint at once, at request exit
                                kv_retired["quota"] += (
                                    int((pool.table[j] >= 0).sum())
                                    * paged.block_size)
                            pool.free_slot(j)   # recycling on exit

            # ---- compaction: per-slot cadence -----------------------------
            # a slot is due after ``refresh`` of its OWN decode tokens; one
            # batched call refreshes every due slot (others pass length 0
            # and recompact_clustered's gate keeps them bit-identical)
            due = [j for j in range(n)
                   if ccfg is not None and active[j]
                   and since_tok[j] >= ccfg.refresh and idx_of(j) < bucket]
            if due:
                t_c0 = time.perf_counter()
                # rank-local: this rank's due slots on its own rows (a
                # rank with none would leave every slot bit-identical)
                lengths = np.zeros(bucket, np.int32)
                for j in due:
                    if mine(j):
                        lengths[idx_of(j)] = pos[j]
                if lengths.any():
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
                if tr is not None:
                    tr.span("compact", t_c0, time.perf_counter(),
                            tid="engine", slots=[int(j) for j in due])

            # ---- post-step priority pass ----------------------------------
            # a pool-stalled slot whose priority exceeds a neighbour's gets
            # that neighbour's blocks next step: swap the shard's cheapest
            # lower-priority decoding slot out (one victim a shard a step,
            # at a clean boundary: this step's copy-on-write copies have
            # landed)
            if slo is not None and (stalled_decode or stalled_admit):
                for sh in range(shards):
                    sp = [by_uid[slot_uid[j]].priority
                          for j in stalled_decode | stalled_admit
                          if shard_of(j) == sh]
                    if not sp or not slo.can_swap():
                        continue
                    v = slo.pick_victim(victim_candidates(sh), max(sp))
                    if v is not None:
                        preempt(v)

        if pcache is not None:
            if store is None:
                # a per-serve cache: release every pinned block, so the
                # pool drains with the request stream
                pcache.clear()
            else:
                # the store's entries and pins survive the drain: the pool
                # and the device cache park on the store (epoch-keyed),
                # mirrored on the server; the drain target weakens to
                # allocated() == pinned_blocks()
                self._tmpl_pool, self._tmpl_cache = pool, cache
                store.parked = (pool, cache, self._store_epoch, shards)
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
                  ).set(rows_launched / max(decode_steps * shards, 1))
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
        self.last_admission = (
            {"kv_admit_compress": float(n_admit_compress),
             "kv_admit_tail": float(n_admit_tail),
             "clusterize_s": clusterize_s}
            if layout is not None and not chunk else {})
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
                    ).add(rr.diagnostics()["kv_retired_recurrent"]
                          if rr is not None else 0)
        reg.gauge("state_bytes_ring",
                  "dense ring-family state bytes per slot (tails excluded)"
                  ).set(float(ring_state_b))
        reg.gauge("state_bytes_recurrent",
                  "recurrent-family state bytes per slot"
                  ).set(float(rec_state_b))
        if layout is not None:
            reg.gauge("kv_frag",
                      "1 - live ring tokens / allocated ring capacity"
                      ).set(1.0 - kv_live_sum / max(kv_alloc_sum, 1))
            reg.gauge("kv_alloc_tokens_peak",
                      "peak allocated ring tokens"
                      ).set(float(kv_alloc_peak))
            if pool is not None:
                # kv_bytes_peak_per_shard, pool_blocks_*, pool_allocs /
                # frees / retains / cow as deltas against the serve-start
                # mark (a persistent pool carries lifetime counters)
                pool.publish(reg, pool_mark, paged.block_size * tail_bpt)
                reg.gauge("kv_shared_blocks",
                          "peak logical mappings beyond physical blocks"
                          ).set(float(kv_shared_peak))
                reg.gauge("kv_bytes_saved",
                          "tail KV bytes prefix sharing avoided"
                          ).set(float(kv_shared_peak * paged.block_size
                                      * tail_bpt))
                # every request completed → every block recycled, but for
                # what the template store pins across serves
                reg.gauge("pool_blocks_end",
                          "blocks live beyond store pins (>0 = leak)"
                          ).set(float(pool.allocated()
                                      - (store.pinned_blocks()
                                         if store is not None else 0)))
                if pcache is not None:
                    reg.counter("prefix_hits",
                                "prefix-cache adoptions this serve"
                                ).add(pcache.hits - hits0)
                    reg.counter("prefix_tokens_reused",
                                "prompt tokens adopted this serve"
                                ).add(pcache.tokens_reused - reused0)
                if store is not None:
                    # lifetime store view and per-cluster traffic
                    store.publish(reg, paged.block_size * tail_bpt)
            else:
                reg.gauge("kv_bytes_peak_per_shard",
                          "peak live tail-KV bytes on the busiest shard"
                          ).set(float(per_shard * R * tail_bpt))
                reg.gauge("pool_occupancy_peak",
                          "peak live blocks / capacity").set(1.0)
        if slo is not None:
            # brownout ladder accounting (sched_shed_high must stay 0: the
            # protected class is raised on, never shed)
            slo.publish(reg)
        if shards > 1:
            reg.gauge("n_data_shards", "data shards this serve"
                      ).set(float(shards))
            for sh in range(shards):
                reg.gauge(f"slot_waste_shard{sh}",
                          f"idle slot-step fraction on data shard {sh}"
                          ).set(1.0 - shard_busy_steps[sh]
                                / (shard_steps * per_shard)
                                if shard_steps else 0.0)
        self.last_stats = reg.flat_view()
        if tr is not None:
            self.last_trace = tr.finish()
        shed_uids = slo.shed_uids if slo is not None else ()
        return [Completion(uid=r.uid, tokens=toks.get(r.uid, []),
                           prefill_ms=pre_ms.get(r.uid, 0.0),
                           decode_ms=dec_ms_tok * len(toks.get(r.uid, [])),
                           shed=r.uid in shed_uids)
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
    def _params_digest(params) -> str:
        """Content hash of the parameter tree: leaf paths, shapes, dtypes
        and raw bytes (the template store's epoch stamps this, so a new
        tree with the same bytes keeps a warm store while any change of
        weights invalidates every snapshot)."""
        h = hashlib.blake2b(digest_size=16)

        def walk(node, path):
            if isinstance(node, dict):
                for k in sorted(node):
                    walk(node[k], f"{path}/{k}")
            elif isinstance(node, (list, tuple)):
                for i, v in enumerate(node):
                    walk(v, f"{path}/{i}")
            else:
                t = node.detach()
                h.update(path.encode())
                h.update(repr((tuple(t.shape), str(t.dtype))).encode())
                # numpy has no bf16: hash the bytes, in place
                h.update(t.contiguous().reshape(-1).view(torch.uint8)
                         .cpu().numpy())

        walk(params, "")
        return h.hexdigest()

    def _world_digest(self, digest: str) -> str:
        """One digest for the whole world: every rank's ``digest`` (hex),
        gathered in rank order and hashed together."""
        mine = torch.tensor(list(bytes.fromhex(digest)), dtype=torch.uint8,
                            device=self.device)
        parts = [torch.empty_like(mine)
                 for _ in range(dist.get_world_size())]
        dist.all_gather(parts, mine)
        return hashlib.blake2b(torch.cat(parts).cpu().numpy().tobytes(),
                               digest_size=16).hexdigest()

    def _rank0_verdict(self, flag: bool) -> bool:
        """Rank 0's ``flag``, broadcast over the world (one device: the
        flag itself): a host decision that reads a rank-local value (a
        clock) is taken once, so no two ranks part."""
        if self._rules is None:
            return flag
        t = torch.tensor([int(flag)], dtype=torch.int32, device=self.device)
        dist.broadcast(t, src=0)
        return bool(t.item())

    @staticmethod
    def _cow_impl(cache, pairs) -> None:
        """Device half of copy-on-write, in place: copy pool blocks
        ``src → dst`` (``pairs`` [(src, dst)] global ids) in every
        clustered tail leaf.  The allocator already pointed the writing
        slot's table at ``dst`` (``kv_pool.ensure``), so the copy must
        land before the step's ring writes.  Every source is gathered
        before any write, and a repeated pair writes the same values."""
        first = next(leaf["k_tail"] for leaf in cache["layers"]
                     if _is_clustered_kv(leaf))
        src, dst = torch.tensor(pairs, dtype=torch.long,
                                device=first.device).T
        for leaf in cache["layers"]:
            if _is_clustered_kv(leaf):
                for key in ("k_tail", "v_tail"):
                    leaf[key][dst] = leaf[key][src]

    @staticmethod
    def _swap_out(cache, j: int, bt_row: np.ndarray):
        """Preemption's device half: slot j's snapshot (clustered
        summaries and recurrent state) and its tail blocks (``bt_row`` (T,) its read-sanitized table row), copied
        to host memory before the caller releases the blocks.  Returns
        (snap, tails), trees of CPU tensors."""
        dev = next(leaf["cov"].device for leaf in cache["layers"]
                   if _is_clustered_kv(leaf))
        bt = torch.from_numpy(bt_row.astype(np.int64)).to(dev)
        return (_to_device(tfm.clustered_slot_state(cache, j), "cpu"),
                _to_device(Server._gather_swap_tails(cache, bt), "cpu"))

    @staticmethod
    def _swap_in(cache, snap, tails, j: int, row: np.ndarray) -> None:
        """Resume's device half, in place: the host snapshot into slot j,
        then the host tail payloads into the fresh blocks of ``row``
        (``_scatter_swap_tails``)."""
        dev = next(leaf["cov"].device for leaf in cache["layers"]
                   if _is_clustered_kv(leaf))
        tfm.restore_clustered_slot_state(cache, _to_device(snap, dev), j)
        Server._scatter_swap_tails(cache, tails, row)

    @staticmethod
    def _gather_swap_tails(cache, bt_row: torch.Tensor):
        """Swap-out gather: every clustered leaf's tail blocks for one slot,
        in ring-block order, as a new tensor (advanced indexing copies, so
        the blocks may be handed on once it is made).  ``bt_row`` is the
        slot's (T,) read-sanitized table row on the cache's device
        (unmapped entries point at the shard base: those rows gather bytes
        the cov and position masks already exclude, and the swap-in never
        scatters them back).  A leaf that is not clustered yields None:
        an 'M' / 'R' layer's state rides the slot snapshot whole."""
        return {"layers": [
            {key: leaf[key][bt_row] for key in ("k_tail", "v_tail")}
            if _is_clustered_kv(leaf) else None
            for leaf in cache["layers"]]}

    @staticmethod
    def _scatter_swap_tails(cache, tails, bt_row: np.ndarray) -> None:
        """Swap-in scatter, in place: a resuming slot's host tail payloads
        (``_gather_swap_tails``'s, on the CPU) go into its freshly
        allocated pool blocks.  ``bt_row`` (T,) holds real ids only for
        fresh allocations; re-adopted and never-mapped ring blocks point
        past the pool (``n_blocks``) and are left out here, where the
        reference's scatter drops them: a re-adopted block may be shared
        (ref > 1) and its bytes already equal the host copy, so writing it
        would break copy-on-write for nothing.  Only the fresh blocks
        travel to the device."""
        first = next(leaf["k_tail"] for leaf in cache["layers"]
                     if _is_clustered_kv(leaf))
        keep = np.nonzero((bt_row >= 0) & (bt_row < first.shape[0]))[0]
        if not len(keep):
            return
        ids = torch.from_numpy(bt_row[keep].astype(np.int64)).to(first.device)
        sel = torch.from_numpy(keep)
        for leaf, tl in zip(cache["layers"], tails["layers"]):
            if _is_clustered_kv(leaf):
                for key in ("k_tail", "v_tail"):
                    leaf[key][ids] = tl[key][sel].to(leaf[key].device,
                                                     leaf[key].dtype)

    @staticmethod
    def _shrink_cache(cache, nb: int):
        """Keep the first nb slots of every leaf (the dropped high slots
        hold no live request)."""
        return {"layers": [{k: v[:nb] for k, v in leaf.items()}
                           for leaf in cache["layers"]]}

    @staticmethod
    def _reset_slot(cache, j: int) -> None:
        """Zero slot j's clustered bookkeeping (counts + cov) and its
        recurrent state, in place, ahead of a fresh chunked admission.
        Ring and centroid payloads need no wipe (the position mask hides
        ring entries until the chunks overwrite them, and zero-count
        centroids are masked); a recurrent leaf has no mask, so the last
        occupant's (conv, ssm) / (conv, h) is zeroed outright."""
        for leaf in cache["layers"]:
            if _is_clustered_kv(leaf):
                leaf["counts"][j] = 0.0
                leaf["cov"][j] = 0
            elif layer_state.is_recurrent_leaf(leaf):
                for v in leaf.values():
                    v[j] = 0

    @staticmethod
    def _row_for_read(pool, j: int, device):
        """Slot j's read-sanitized block-table row on ``device`` (paged),
        its ids local to the rank holding slot j's data shard of the pool
        (one device: global), or None (dense)."""
        if pool is None:
            return None
        return torch.from_numpy(pool.row_for_read(j)
                                - pool.shard_base(j)).to(device)

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
        if not leaves:
            return      # no 'G' layer: the frontier is bookkeeping only
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

    # ------------------------------------------------------------------
    # blocking admission: the B=1 prefill cache into a slot
    # ------------------------------------------------------------------

    @staticmethod
    def _clusterize(c1, plen: int, ccfg, kinds):
        """A fresh B=1 exact prefill cache in the engine's clustered
        layout: the exact k/v leaves of 'G' layers (``kinds``: each
        layer's kind) are clustered, an 'L' leaf's window ring and an MLA
        layer's latent pass through.  A prompt
        that fits the ring with ``refresh`` positions to spare goes in as
        the ring alone (cov 0: every position survives until the first
        compaction; a quota layout's ring of max_seq takes every prompt
        so); a longer one builds centroids now, every 'G' layer in one fit
        (``_compress_exact_layers``)."""
        C, R = ccfg.n_clusters, ccfg.keep_recent
        layers = list(c1["layers"])
        # an MLA 'G' layer's latent leaf {"ckv", "kpe"} stays exact
        idx = [i for i, kind in enumerate(kinds)
               if kind == "G" and _is_exact_kv(layers[i])]
        if not idx:
            return c1   # no GQA 'G' layer: nothing takes the clustered form
        leaves = [layers[i] for i in idx]
        if plen <= R - ccfg.refresh:
            out = []
            for leaf in leaves:
                k, v = leaf["k"], leaf["v"]
                if k.shape[1] < R:
                    # the pad sits at offsets >= plen, masked until
                    # decode writes them
                    pad = (0, 0, 0, 0, 0, R - k.shape[1])
                    k = torch.nn.functional.pad(k, pad)
                    v = torch.nn.functional.pad(v, pad)
                b, _, h, dh = k.shape
                z = lambda shape, dt: torch.zeros(  # noqa: E731
                    shape, dtype=dt, device=k.device)
                out.append({"k_cents": z((b, C, h, dh), k.dtype),
                            "v_cents": z((b, C, h, dh), k.dtype),
                            "counts": z((b, C, h), torch.float32),
                            # positions 0..plen-1 sit at ring slots 0..plen-1
                            "k_tail": k[:, :R], "v_tail": v[:, :R],
                            "cov": z((b,), torch.int32)})
        else:
            lengths = torch.tensor([plen], dtype=torch.int32,
                                   device=leaves[0]["k"].device)
            out = _compress_exact_layers(leaves, lengths, ccfg)
        for i, leaf in zip(idx, out):
            layers[i] = leaf
        return {"layers": layers}

    @staticmethod
    def _write_slot(cache, c1, j: int) -> None:
        """Write a B=1 cache into slot j of the engine cache, in place."""
        for dst, src in zip(cache["layers"], c1["layers"]):
            for key, val in dst.items():
                val[j] = src[key][0].to(val.dtype)

    @staticmethod
    def _write_slot_paged(cache, c1, j: int, bt_row: np.ndarray,
                          blk: int) -> None:
        """Paged twin of ``_write_slot``, in place: a clustered leaf's
        centroids, counts and cov go to slot j, and its B=1 dense ring
        goes block by block into the pool blocks of the slot's write row
        ``bt_row`` (T,); any other leaf (an 'L' window ring) takes the
        dense slot write (an 'M' / 'R' layer's state too).  Unmapped
        entries (covered ring blocks, ``n_blocks``) are left out here: the
        reference's scatter drops them, and an index past the pool would
        raise."""
        ids = sel = None
        for dst, src in zip(cache["layers"], c1["layers"]):
            if not _is_clustered_kv(dst):
                for key, val in dst.items():
                    val[j] = src[key][0].to(val.dtype)
                continue
            if ids is None:     # every clustered leaf shares the table row
                first = dst["k_tail"]
                keep = np.nonzero((bt_row >= 0)
                                  & (bt_row < first.shape[0]))[0]
                ids = torch.from_numpy(bt_row[keep].astype(np.int64)).to(
                    first.device)
                sel = torch.from_numpy(keep).to(first.device)
            for key in ("k_cents", "v_cents", "counts", "cov"):
                dst[key][j] = src[key][0].to(dst[key].dtype)
            for key in ("k_tail", "v_tail"):
                pool_arr = dst[key]
                blocks = src[key][0].reshape((-1, blk) + pool_arr.shape[2:])
                pool_arr[ids] = blocks[sel].to(pool_arr.dtype)

    # ------------------------------------------------------------------
    # memory management: batched clustered-KV compaction
    # ------------------------------------------------------------------

    def compact_kv(self, cache, t, ccfg: kv_compress.KVCompressConfig,
                   bt=None):
        """Compress every global-attention ('G') layer's KV into clustered
        form (an 'L' layer's window ring is never touched);
        ``t`` is a scalar length or a per-slot (B,) vector (0 = leave the
        slot alone).  Returns a new ``{"layers": [...]}``; tail rings and
        the input's leaves are not modified.

        Already-clustered leaves are re-compacted with warm-started
        k-medians, all of them in one batched call over (layer, slot,
        head); paged (``bt`` (B, T) the read-sanitized block table), every
        slot's blocks are gathered into ring order first.  Exact leaves
        longer than C + R positions are compressed from scratch, all in
        one ``compress_cache_batched`` call; shorter ones, and int8
        leaves, pass through."""
        layers = list(cache["layers"])
        dev = self.device

        def lengths_for(b):
            return torch.broadcast_to(
                torch.as_tensor(t, dtype=torch.int32, device=dev), (b,))

        def rows(leaf, k):
            if bt is not None and k in ("k_tail", "v_tail"):
                return _gather_tail_rows(leaf[k], bt)
            return leaf[k]

        clus = [i for i, leaf in enumerate(layers) if _is_clustered_kv(leaf)]
        if clus:
            b = layers[clus[0]]["cov"].shape[0]
            keys = list(layers[clus[0]])
            flat = {k: torch.cat([rows(layers[i], k) for i in clus])
                    for k in keys}
            out = kv_compress.recompact_clustered(
                flat, lengths_for(b).repeat(len(clus)), ccfg)
            for n_i, i in enumerate(clus):
                layers[i] = dict(layers[i], **{
                    k: out[k][n_i * b:(n_i + 1) * b]
                    for k in ("k_cents", "v_cents", "counts", "cov")})
        exact = [i for i, leaf in enumerate(layers)
                 if self._kinds[i] == "G"
                 and _is_exact_kv(leaf) and leaf["k"].dim() == 4
                 and leaf["k"].shape[1] > ccfg.n_clusters + ccfg.keep_recent]
        if exact:
            b = layers[exact[0]]["k"].shape[0]
            out = _compress_exact_layers([layers[i] for i in exact],
                                         lengths_for(b), ccfg)
            for i, leaf in zip(exact, out):
                layers[i] = leaf
        return {"layers": layers}

    # ------------------------------------------------------------------
    # static batch-at-a-time path (baseline for the serve benchmark)
    # ------------------------------------------------------------------

    def _serve_static(self, requests, prompts) -> List[Completion]:
        plan = self._plan(requests)
        by_uid = {r.uid: r for r in requests}
        out: List[Completion] = []
        for batch_uids in plan.batches:
            out.extend(self._serve_batch(batch_uids, by_uid, prompts))
        self.metrics.begin_serve()
        self.metrics.gauge(
            "plan_waste", "padding waste of the static batch plan"
        ).set(plan.waste)
        self.last_stats = self.metrics.flat_view()
        self.last_admission = {}
        return out

    def _serve_batch(self, uids, by_uid, prompts) -> List[Completion]:
        """One static batch: prompts left-padded with token 0 to the
        longest (the pad is context, as in the reference), one prefill,
        then decode steps until the longest budget is spent.  Requests
        carry tokens only, so an encoder-decoder's prefill raises its
        ValueError for the missing encoder inputs (the reference's static
        engine reaches its encoder with None and fails there); a frontend
        model serves text-only, as in the reference."""
        cfg, dev = self.cfg, self.device
        reqs = [by_uid[u] for u in uids]
        plen = max(r.prompt_len for r in reqs)
        gen = max(r.max_new_tokens for r in reqs)
        b = len(reqs)
        toks = np.zeros((b, plen), np.int32)
        for i, r in enumerate(reqs):
            p = prompts[r.uid][-plen:]
            toks[i, plen - len(p):] = p  # left-pad

        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, cfg,
                                      torch.from_numpy(toks).to(dev),
                                      max_seq=self.scfg.max_seq,
                                      last_pos=plen - 1)
        _sync(dev)
        t1 = time.perf_counter()

        new = torch.argmax(logits, -1).to(torch.int32)[:, None]
        gen_toks = [new]
        for i in range(gen - 1):
            logits, cache = self._decode(self.params, cfg, cache, new,
                                         plen + i)
            new = torch.argmax(logits, -1).to(torch.int32)[:, None]
            gen_toks.append(new)
        gen_arr = torch.cat(gen_toks, dim=1).cpu().numpy()
        t2 = time.perf_counter()

        return [Completion(uid=r.uid,
                           tokens=gen_arr[i, :r.max_new_tokens].tolist(),
                           prefill_ms=(t1 - t0) * 1e3 / b,
                           decode_ms=(t2 - t1) * 1e3 / b)
                for i, r in enumerate(reqs)]


def _zeros_on(tree, device):
    """A tree of zero tensors on ``device`` shaped like ``tree``'s (a
    fresh engine cache is all zeros)."""
    if isinstance(tree, dict):
        return {k: _zeros_on(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_on(v, device) for v in tree]
    return torch.zeros(tree.shape, dtype=tree.dtype, device=device)


def _to_device(tree, device):
    """A tree of tensors (dicts, lists, None leaves) on ``device``; a move
    to the CPU is synchronous."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_to_device(v, device) for v in tree]
    return tree.to(device)
