"""Serving launcher (port of ``repro.launch.serve``).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \\
        --reduced --requests 24 --batch-size 4 [--device cpu]

Sliding-window models (gemma2/3-style 'L' layers) serve chunked + paged
through the retention-policy layer — ``--config`` is an alias for
``--arch`` that reads naturally when picking one:

    PYTHONPATH=src python -m repro_torch.launch.serve --config gemma2-27b \\
        --reduced --requests 24 --prefill-chunk 16 --paged --kv-clusters 8

Mesh-sharded (slots over data, heads over model), e.g. on the CPU:

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --reduced --requests 24 --batch-size 8 --mesh 2x2 --device cpu

Drives the full request-processing path: request queue → bit-serial
k-medians batcher → prefill → decode loop; reports padding waste
(clustered vs FIFO) and throughput, and prints the reference launcher's
lines.  Runs on the card unless ``--device`` names another device.  On
the card, any ``--kv-*`` flag without ``--paged`` serves through the
``clustered_decode`` kernel, ``--paged`` through
``paged_clustered_decode``, and both run the memory manager's medians
through ``bitserial_median``; exact KV served in blocking mode (the
default) launches no kernel.

``--mesh DATAxMODEL`` serves on a (data, model) mesh of ranks, one process
each (runtime/server.py): run as ``python -m``, the launcher starts the
D × M ranks itself (``launch.preboot``: gloo for ``--device cpu``; on CUDA
NCCL, one rank a card, so a world larger than the visible card count is
refused) and rank 0 prints; under ``torchrun`` each process already is a
rank and joins the world it names.  ``main`` called in a process with no
world refuses the mesh.

``main(argv, params=...)`` serves given weights (the port's parameter
dict, e.g. ``bridge.params_from_numpy`` of the reference's) instead of
drawing them from ``--seed``, and returns the ``Server``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from repro_torch import configs
from repro_torch.core import kv_compress
from repro_torch.core.request_cluster import Request, plan_batches, plan_fifo
from repro_torch.launch import preboot
from repro_torch.launch.mesh import make_serving_mesh, mesh_sizes
from repro_torch.models import transformer as tfm
from repro_torch.models.layers import resolve_device
from repro_torch.runtime.kv_pool import PagedKVConfig
from repro_torch.runtime.prefix_cache import PrefixShareConfig
from repro_torch.runtime.scheduler import SLOConfig
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.runtime.telemetry import TelemetryConfig, phase_breakdown
from repro_torch.runtime.template_store import TemplateStoreConfig


def parser() -> argparse.ArgumentParser:
    """The reference launcher's flags, plus ``--device``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", "--config", dest="arch", required=True,
                    choices=list(configs.ARCH_IDS),
                    help="model config to serve; windowed configs "
                         "(gemma2-27b, gemma3-4b) run their 'L' layers "
                         "under WindowRetention")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=16)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=256)
    ap.add_argument("--no-clustering", action="store_true")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--mesh", default=None,
                    help="DATAxMODEL serving mesh, e.g. 2x4 (slots shard "
                         "over data, heads over model)")
    ap.add_argument("--prefill-chunk", type=int, default=0,
                    help="chunked prefill interleaved with decode: feed "
                         "admission prompts in chunks of this many tokens "
                         "fused into the decode launch (0 = blocking "
                         "prefill); hides admission latency under load")
    ap.add_argument("--paged", action="store_true",
                    help="paged clustered-KV memory manager: tail rings "
                         "live in a per-shard block pool behind per-slot "
                         "block tables, decode runs as packed ragged "
                         "launches (compute ∝ real tokens); implies "
                         "clustered-KV serving (--kv-clusters et al.)")
    ap.add_argument("--prefix-share", action="store_true",
                    help="prefix-sharing paged admission: prompts "
                         "sharing a prefix adopt the same tail-ring "
                         "blocks (copy-on-write) and reuse absorbed "
                         "prompt centroids instead of re-prefilling; "
                         "requires --paged and --prefill-chunk")
    ap.add_argument("--persist-templates", action="store_true",
                    help="persistent cross-serve template store "
                         "(subsumes --prefix-share): registered prefix "
                         "boundaries and their pinned pool blocks "
                         "survive between serve() calls, and request "
                         "traffic is clustered online onto template "
                         "medoids; the demo serves the queue twice to "
                         "show the warm second serve (size the pool "
                         "with --pool-blocks headroom or pressure "
                         "evicts every entry before the drain)")
    ap.add_argument("--block-size", type=int, default=16,
                    help="paged: ring positions per pool block (must "
                         "divide --keep-recent)")
    ap.add_argument("--pool-blocks", type=int, default=0,
                    help="paged: blocks per data shard (0 = full "
                         "provisioning; less oversubscribes and relies "
                         "on compaction give-back)")
    ap.add_argument("--kv-clusters", type=int, default=None,
                    help="clustered serving: centroids per slot/head "
                         "(setting any --kv-* flag enables clustered-KV "
                         "serving; default 32)")
    ap.add_argument("--keep-recent", type=int, default=None,
                    help="clustered serving: exact tail ring length "
                         "(default 64)")
    ap.add_argument("--refresh-every", type=int, default=None,
                    help="clustered serving: decode steps between "
                         "compactions (default 32)")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a request-lifecycle Chrome trace-event "
                         "JSON here (load in Perfetto / chrome://tracing: "
                         "one process per data shard, one thread per "
                         "decode slot) and print the engine-step phase "
                         "breakdown; tracing is host-side only and "
                         "leaves tokens bit-identical")
    ap.add_argument("--priority-demo", action="store_true",
                    help="SLO scheduling demo (requires --paged): mark "
                         "the last quarter of the queue priority-1, "
                         "shrink the pool below full provisioning, and "
                         "serve under the brownout ladder (defer -> "
                         "preempt/swap -> shed); prints per-class TTFT "
                         "and the sched_* counters")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: cuda)")
    return ap


def main(argv=None, *, params=None, say=print) -> Server:
    """Serve as the reference launcher does, printing its lines through
    ``say``.  ``params``: the port's parameter dict to serve (None draws
    ``init_params`` from ``--seed`` on ``--device``).  Returns the Server
    (``last_stats``, ``last_trace``)."""
    ap = parser()
    args = ap.parse_args(argv)

    cfg = (configs.get_reduced(args.arch) if args.reduced
           else configs.get_config(args.arch))
    dev = resolve_device(args.device)
    mesh = None
    if args.mesh:
        try:
            preboot.init_world(dev)
            mesh = make_serving_mesh(args.mesh)
        except ValueError as e:
            ap.error(f"--mesh {args.mesh}: {e}")
        if not preboot.is_rank_zero():
            say = lambda *_: None  # noqa: E731  (rank 0 prints)
    if cfg.is_encdec or cfg.attention_free:
        say(f"[serve] note: {args.arch} decode path exercised via its "
            f"own cache family")
    if args.prefill_chunk or args.paged:
        report = cfg.serving_gate_report()
        if report is not None:
            ap.error(f"{args.arch} cannot serve chunked/paged: {report}")
    if cfg.sliding_window and "L" in cfg.layer_pattern:
        n_local = sum(cfg.pattern_for_layer(i) == "L"
                      for i in range(cfg.n_layers))
        say(f"[serve] windowed model: {n_local}/{cfg.n_layers} local "
            f"layers under WindowRetention(window="
            f"{cfg.sliding_window}); global layers retire at the "
            f"cov frontier")
    # the reference's draw order: lengths, then the prompts request by
    # request, then the template (the weights come from their own seed)
    rng = np.random.default_rng(args.seed)
    lens = np.where(rng.random(args.requests) < 0.5,
                    rng.integers(8, 24, args.requests),
                    rng.integers(64, min(160, args.max_seq - args.max_new),
                                 args.requests))
    reqs = [Request(i, int(l), args.max_new) for i, l in enumerate(lens)]
    if args.priority_demo:
        if not args.paged:
            ap.error("--priority-demo needs the paged clustered engine "
                     "(add --paged)")
        if any(cfg.pattern_for_layer(i) != "G" for i in range(cfg.n_layers)):
            ap.error(f"--priority-demo: {args.arch} has windowed layers; "
                     f"the SLO scheduler serves all-global clustered "
                     f"models only")
        # protected class arrives LAST — the worst case for FIFO, and
        # exactly what priority preemption exists to fix
        n_high = max(len(reqs) // 4, 1)
        reqs = [Request(r.uid, r.prompt_len, r.max_new_tokens,
                        priority=1 if r.uid >= len(reqs) - n_high else 0)
                for r in reqs]
        say(f"[serve] priority demo: {n_high}/{len(reqs)} requests "
            f"priority-1 at the queue tail")
    prompts = {r.uid: rng.integers(0, cfg.vocab, size=(r.prompt_len,)).astype(
        np.int32) for r in reqs}
    if args.persist_templates:
        # the long half of the queue shares a 64-token template, so its
        # boundary entries earn hits (all-distinct prompts never recur)
        tpl = rng.integers(0, cfg.vocab, size=(64,)).astype(np.int32)
        tpl_n = sum(1 for r in reqs if r.prompt_len >= 64)
        for r in reqs:
            if r.prompt_len >= 64:
                prompts[r.uid][:64] = tpl
        say(f"[serve] template traffic: {tpl_n}/{len(reqs)} prompts "
            f"share a 64-token template prefix")

    fifo = plan_fifo(reqs, args.batch_size)
    clus = plan_batches(reqs, args.batch_size)
    say(f"[serve] padding waste: fifo {fifo.waste * 100:.1f}% → "
        f"clustered {clus.waste * 100:.1f}%")
    shards = 1
    if mesh is not None:
        sizes = mesh_sizes(mesh)
        shards = sizes["data"]
        say(f"[serve] mesh {args.mesh}: slots over data={sizes['data']}, "
            f"heads over model={sizes['model']}")

    ccfg = paged = None
    clustered = args.paged or any(
        v is not None for v in (args.kv_clusters, args.keep_recent,
                                args.refresh_every))
    if clustered:
        ccfg = kv_compress.KVCompressConfig(
            n_clusters=args.kv_clusters or 32, iters=4,
            keep_recent=args.keep_recent or 64,
            refresh_every=args.refresh_every or 32)
        say(f"[serve] clustered KV: C={ccfg.n_clusters} "
            f"R={ccfg.keep_recent} refresh={ccfg.refresh_every}")
    if args.paged:
        pool_blocks = args.pool_blocks
        per_slot = (ccfg.keep_recent + args.block_size - 1) \
            // args.block_size
        slots = max(args.batch_size // shards, 1)
        if args.persist_templates and not pool_blocks:
            # the store pins entry blocks between serves: double the ring
            # footprint so the pins live in the surplus
            pool_blocks = 2 * slots * per_slot
        if args.priority_demo and not pool_blocks:
            # undersubscribe on purpose: the scheduler only has work to
            # do when the pool can't hold every slot's tail ring at once
            pool_blocks = max(per_slot + 1, (3 * slots * per_slot) // 4)
        paged = PagedKVConfig(block_size=args.block_size,
                              pool_blocks=pool_blocks)
        say(f"[serve] paged KV: {args.block_size}-position blocks, "
            f"{pool_blocks or 'auto'} blocks/shard"
            + (" (auto-doubled for template-store headroom)"
               if args.persist_templates
               and pool_blocks != args.pool_blocks else "")
            + (" (auto-tightened to force brownout pressure)"
               if args.priority_demo
               and pool_blocks != args.pool_blocks else ""))
    pshare = tstore = None
    if args.persist_templates:
        # cap entries near the pool headroom: a store pinning more than
        # the surplus above the live rings churns under pool pressure
        tstore = TemplateStoreConfig(max_entries=2 * args.batch_size)
        say("[serve] template store: persistent cross-serve prefix "
            "boundaries + online traffic clustering"
            + (" (subsumes --prefix-share)" if args.prefix_share else ""))
    elif args.prefix_share:
        pshare = PrefixShareConfig()
        say("[serve] prefix sharing: block-granular prompt-prefix "
            "admission (copy-on-write)")
    if params is None:
        params = tfm.init_params(args.seed, cfg, device=dev)
    srv = Server(cfg, ServerConfig(
        batch_size=args.batch_size, max_seq=args.max_seq,
        use_clustered_batching=not args.no_clustering, mesh=mesh,
        prefill_chunk=args.prefill_chunk, kv_compress=ccfg,
        paged=paged, prefix_share=pshare, template_store=tstore,
        scheduler=SLOConfig() if args.priority_demo else None,
        telemetry=(TelemetryConfig(trace=True) if args.trace_out
                   else None)), params, device=dev)
    t0 = time.perf_counter()
    outs = srv.serve(reqs, prompts)
    dt = time.perf_counter() - t0
    toks = sum(len(o.tokens) for o in outs)
    say(f"[serve] {len(outs)} completions, {toks} tokens in {dt:.1f}s "
        f"({toks / dt:.1f} tok/s), mean decode "
        f"{np.mean([o.decode_ms for o in outs]):.1f} ms/req")
    st = srv.last_stats
    if "ttft_p95_ms" in st:
        mode = (f"chunked prefill ({args.prefill_chunk}-token chunks, "
                f"{st['prefill_chunks']:.0f} chunks)"
                if args.prefill_chunk else "blocking prefill")
        say(f"[serve] {mode}: TTFT p50/p95 {st['ttft_p50_ms']:.0f}/"
            f"{st['ttft_p95_ms']:.0f} ms, ITL p50/p95 "
            f"{st['itl_p50_ms']:.1f}/{st['itl_p95_ms']:.1f} ms")
        say(f"[serve] bucketed launches: mean bucket "
            f"{st['launch_bucket_mean']:.2f} slots/shard, launched "
            f"{st['launch_rows_frac'] * 100:.0f}% of {args.batch_size} "
            f"slots per step")
    if "pool_occupancy_peak" in st and args.paged:
        say(f"[serve] paged pool: peak occupancy "
            f"{st['pool_occupancy_peak'] * 100:.0f}%, "
            f"{st['pool_allocs']:.0f} allocs / {st['pool_frees']:.0f} "
            f"frees, launch padding {st['launch_pad_frac'] * 100:.0f}%, "
            f"peak KV {st['kv_bytes_peak_per_shard'] / 1024:.0f} "
            f"KiB/shard (frag {st['kv_frag'] * 100:.0f}%)")
    retired = {k: st[k] for k in ("kv_retired_frontier", "kv_retired_window",
                                  "kv_retired_quota")
               if st.get(k)}
    if retired:
        say("[serve] retention: " + ", ".join(
            f"{k.removeprefix('kv_retired_')} retired {v:.0f} positions"
            for k, v in retired.items()))
    if ((args.prefix_share or args.persist_templates)
            and "prefix_hits" in st):
        say(f"[serve] prefix sharing: {st['prefix_hits']:.0f} hits, "
            f"{st['prefix_tokens_reused']:.0f} prompt tokens reused, "
            f"{st['kv_bytes_saved'] / 1024:.1f} KiB tail KV shared "
            f"({st['pool_cow']:.0f} copy-on-write swaps)")
    if args.priority_demo:
        prio = {r.uid: r.priority for r in reqs}
        shed = [o.uid for o in outs if o.shed]

        def p95(cls):
            vals = [o.prefill_ms for o in outs
                    if prio[o.uid] == cls and not o.shed]
            return float(np.percentile(vals, 95)) if vals else float("nan")

        say(f"[serve] SLO scheduling: TTFT p95 priority-1 "
            f"{p95(1):.0f} ms vs best-effort {p95(0):.0f} ms; "
            f"{st['sched_preemptions']:.0f} preemptions, "
            f"{st['sched_swaps_in']:.0f} swap-ins "
            f"({st['sched_reuploaded_blocks']:.0f} blocks re-uploaded, "
            f"{st['sched_readopted_blocks']:.0f} re-adopted), "
            f"{st['sched_deferrals']:.0f} deferrals, "
            f"{st['sched_sheds']:.0f} shed {shed}")
    if mesh is not None:
        if "n_data_shards" in st:
            ws = [f"{st[f'slot_waste_shard{s}']:.2f}"
                  for s in range(int(st['n_data_shards']))]
            say(f"[serve] per-data-shard slot waste: {' '.join(ws)}")
        elif shards > 1:
            say(f"[serve] note: batch size {args.batch_size} does not "
                f"divide the data axis — slots replicated (no slot "
                f"sharding); pick a batch size divisible by {shards}")

    if args.trace_out:
        srv.export_trace(args.trace_out)
        ph = phase_breakdown(srv.last_trace)
        say(f"[serve] trace: {len(srv.last_trace)} events → "
            f"{args.trace_out} (Perfetto-loadable)")
        if ph:
            say("[serve] phase breakdown: " + ", ".join(
                f"{k.removeprefix('phase_').removesuffix('_ms')} "
                f"{v:.1f} ms" for k, v in ph.items()))

    if args.persist_templates:
        # repeat-serve demo: the store survived the drain, so re-serving
        # the same queue adopts every registered boundary from token 0
        ttft_cold = st.get("ttft_p95_ms", 0.0)
        t0 = time.perf_counter()
        outs2 = srv.serve(reqs, prompts)
        dt2 = time.perf_counter() - t0
        st2 = srv.last_stats
        same = ({o.uid: o.tokens for o in outs}
                == {o.uid: o.tokens for o in outs2})
        say(f"[serve] warm re-serve: "
            f"{sum(len(o.tokens) for o in outs2)} tokens in {dt2:.1f}s, "
            f"TTFT p95 {st2.get('ttft_p95_ms', 0.0):.0f} ms "
            f"(cold {ttft_cold:.0f} ms), "
            f"{st2.get('prefix_hits', 0.0):.0f} store hits, "
            f"tokens identical: {same}")
        say(f"[serve] template store: "
            f"{st2.get('template_entries', 0.0):.0f} entries pinning "
            f"{st2.get('template_pinned_blocks', 0.0):.0f} blocks "
            f"({st2.get('template_bytes_pinned', 0.0) / 1024:.1f} KiB), "
            f"{st2.get('template_clusters', 0.0):.0f} traffic clusters, "
            f"cohesion {st2.get('template_cohesion_mean', 0.0):.2f}")
        srv.invalidate_templates()
        say("[serve] invalidate_templates(): store dropped, pool "
            "drained to zero")
    return srv


if __name__ == "__main__":
    code = preboot.start_mesh_ranks(sys.argv[1:], "repro_torch.launch.serve")
    if code is not None:
        sys.exit(code)
    main()
    preboot.leave_world()
