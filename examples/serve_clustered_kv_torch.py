"""Serving example of the PyTorch / CUDA port: continuous batching +
clustered-KV compression, section for section the twin of
examples/serve_clustered_kv.py, with the same configs and draws.

1. a queue of mixed-length requests is clustered into a padding-minimal
   admission order (bit-serial k-medians over (prompt_len, gen_len)
   features) — padding waste vs FIFO is reported,
2. a slot-based continuous batcher admits requests as decode slots free
   and serves them with a small dense LM (per-slot positions, early exit
   at each request's own token budget),
3. the same queue is re-served from a clustered KV cache that is
   re-compacted mid-stream — the "memory management" half of the title —
   then paged, prefix-shared, through the persistent template store,
   under the SLO scheduler, traced, and on a sliding-window ('GL') and a
   recurrent hybrid ('GM') model; the standalone compression error vs
   exact attention is reported alongside the memory ratio,
4. in a world of more than one rank (``torchrun``), the same queue runs
   once more on a (data, model) serving mesh — decode slots shard over
   `data`, attention heads over `model` — and token parity with the
   single-device run is reported.

On the card the clustered serves decode through the ``clustered_decode``
CUDA kernel, the paged ones through ``paged_clustered_decode``, and every
k-medians fit of the memory manager (absorbs, compactions and the
``[kv]`` section's ``compress_cache``) takes its grouped medians through
``bitserial_median``.

Run: PYTHONPATH=src python examples/serve_clustered_kv_torch.py
[--device cpu]

Mesh-enabled run (8 CPU ranks → a 2x4 serving mesh; rank 0 prints):

    PYTHONPATH=src torchrun --nproc-per-node 8 \
        examples/serve_clustered_kv_torch.py --device cpu
"""

import argparse
import dataclasses as dc

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import kv_compress
from repro_torch.core.request_cluster import Request, plan_batches, plan_fifo
from repro_torch.launch import preboot
from repro_torch.launch.mesh import make_serving_mesh
from repro_torch.models import transformer as tfm
from repro_torch.models.config import ModelConfig, SSMConfig
from repro_torch.models.layers import resolve_device
from repro_torch.runtime.kv_pool import PagedKVConfig
from repro_torch.runtime.prefix_cache import PrefixShareConfig
from repro_torch.runtime.scheduler import SLOConfig
from repro_torch.runtime.server import Server, ServerConfig
from repro_torch.runtime.telemetry import (TelemetryConfig, phase_breakdown,
                                           validate_trace)
from repro_torch.runtime.template_store import TemplateStoreConfig

SMALL = ModelConfig(name="serve-lm", family="dense", n_layers=4, d_model=128,
                    n_heads=4, n_kv_heads=4, head_dim=32, d_ff=512,
                    vocab=512, pad_vocab_multiple=128, dtype="float32")
GLWIN = dc.replace(SMALL, name="serve-lm-gl", layer_pattern="GL",
                   sliding_window=16)
GMREC = ModelConfig(name="serve-lm-gm", family="hybrid", n_layers=2,
                    d_model=64, n_heads=4, n_kv_heads=2, head_dim=16,
                    d_ff=128, vocab=512, pad_vocab_multiple=128,
                    dtype="float32", layer_pattern="GM",
                    ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                  head_dim=32, n_groups=1, chunk=32))
# the weights' seeds, as the reference draws them (PRNGKey 0, 1, 2)
SEEDS = {"SMALL": 0, "GLWIN": 1, "GMREC": 2}


def _by_uid(outs):
    return sorted(outs, key=lambda o: o.uid)


def _same(a, b) -> bool:
    return all(x.tokens == y.tokens for x, y in zip(_by_uid(a), _by_uid(b)))


def _word(same: bool) -> str:
    return "identical" if same else "DIVERGED"


def run(device=None, say=print, params=None) -> dict:
    """Every section of the reference example on ``device`` (None: the
    card), its lines through ``say``; the mesh section serves when this
    process is a rank of a world of more than one (``torchrun``).  ``params`` maps
    "SMALL", "GLWIN" and "GMREC" to the port's parameter dicts (None
    draws each from its seed in ``SEEDS``).  Returns the invariants the
    lines report: each serve's blocks held at drain, the trace's schema
    problems, the protected requests shed, the ``[kv]`` rel-err."""
    dev = resolve_device(device)
    if params is None:
        params = {k: tfm.init_params(SEEDS[k], cfg, device=dev)
                  for k, cfg in (("SMALL", SMALL), ("GLWIN", GLWIN),
                                 ("GMREC", GMREC))}
    p_small = params["SMALL"]
    out = {"pool_blocks_end": {}}

    def server(cfg, p, **kw):
        return Server(cfg, ServerConfig(**kw), p, device=dev)

    rng = np.random.default_rng(0)

    # --- request processing: clustered batching ---
    lens = np.where(rng.random(24) < 0.5,
                    rng.integers(8, 24, 24), rng.integers(96, 160, 24))
    reqs = [Request(i, int(l), 8) for i, l in enumerate(lens)]
    fifo = plan_fifo(reqs, batch_size=4)
    clus = plan_batches(reqs, batch_size=4)
    say(f"[batcher] padding waste: fifo {fifo.waste * 100:.1f}% → "
        f"clustered {clus.waste * 100:.1f}%")

    srv = server(SMALL, p_small, batch_size=4, max_seq=256)
    prompts = {r.uid: rng.integers(0, 512, size=(r.prompt_len,)).astype(
        np.int32) for r in reqs}
    outs = srv.serve(reqs, prompts)
    st = srv.last_stats
    say(f"[server] continuous batching: {len(outs)} completions, "
        f"{st['tokens_per_s']:.1f} tok/s, slot waste "
        f"{st['slot_waste'] * 100:.1f}%")

    # --- chunked prefill interleaved with decode (--prefill-chunk) ---
    # each engine step feeds one 16-token prompt chunk fused into the
    # decode launch; greedy tokens stay identical to blocking admission
    srv_k = server(SMALL, p_small, batch_size=4, max_seq=256,
                   prefill_chunk=16)
    outs_k = srv_k.serve(reqs, prompts)
    st = srv_k.last_stats
    say(f"[server] chunked prefill (--prefill-chunk 16): "
        f"{st['tokens_per_s_wall']:.1f} tok/s wall, TTFT p50/p95 "
        f"{st['ttft_p50_ms']:.0f}/{st['ttft_p95_ms']:.0f} ms, "
        f"{st['prefill_chunks']:.0f} chunks, tokens "
        f"{_word(_same(outs_k, outs))} vs blocking admission")
    say(f"[server] bucketed launches: mean bucket "
        f"{st['launch_bucket_mean']:.2f} slots/shard "
        f"({st['launch_rows_frac'] * 100:.0f}% of slots launched per "
        f"step; the drain tail stops paying for empty slots)")

    # the same queue from a clustered KV cache with mid-stream compaction
    # (clustered_decode on the card); chunked admission streams long
    # prompts straight into clustered form via kv_compress.absorb_chunk
    ccfg = kv_compress.KVCompressConfig(n_clusters=24, iters=4,
                                        keep_recent=32, refresh_every=16)
    srv_c = server(SMALL, p_small, batch_size=4, max_seq=256,
                   kv_compress=ccfg, prefill_chunk=16)
    outs_c = srv_c.serve(reqs, prompts)
    agree = np.mean([np.mean(np.array(a.tokens[:len(b.tokens)])
                             == np.array(b.tokens[:len(a.tokens)]))
                     for a, b in zip(_by_uid(outs_c), _by_uid(outs))])
    say(f"[server] clustered-KV + compaction (+chunked admission, "
        f"{srv_c.last_stats['kv_absorbs']:.0f} absorbs): "
        f"{srv_c.last_stats['tokens_per_s']:.1f} tok/s, token agreement "
        f"vs exact serving {agree * 100:.0f}%")

    # --- paged clustered-KV memory manager (ServerConfig.paged) ---
    # tail rings in a block pool behind per-slot block tables, decoded by
    # packed ragged launches (paged_clustered_decode on the card); greedy
    # tokens stay bit-identical to the dense clustered engine
    srv_p = server(SMALL, p_small, batch_size=4, max_seq=256,
                   kv_compress=ccfg, prefill_chunk=16,
                   paged=PagedKVConfig(block_size=8))
    outs_p = srv_p.serve(reqs, prompts)
    stp, stc = srv_p.last_stats, srv_c.last_stats
    out["pool_blocks_end"]["paged"] = stp["pool_blocks_end"]
    say(f"[server] paged KV (8-pos blocks): tokens "
        f"{_word(_same(outs_p, outs_c))} vs dense clustered; "
        f"launch padding {stp['launch_pad_frac'] * 100:.0f}% vs dense "
        f"{stc['launch_pad_frac'] * 100:.0f}%, pool peak "
        f"{stp['pool_occupancy_peak'] * 100:.0f}% of "
        f"{stp['pool_blocks_total']:.0f} blocks "
        f"({stp['pool_allocs']:.0f} allocs / {stp['pool_frees']:.0f} "
        f"frees, {stp['pool_blocks_end']:.0f} still held at drain)")

    # --- prefix-shared paged admission (ServerConfig.prefix_share) ---
    # prompts = one shared 96-token template + a short unique suffix: a
    # later admission adopts the template's registered blocks and state
    # instead of re-streaming it (copy-on-write at the first divergent
    # ring write); tokens stay bit-identical to unshared paged serving
    tpl = rng.integers(0, 512, size=(96,)).astype(np.int32)
    tpl_reqs, tpl_prompts = [], {}
    for i in range(12):
        sfx = rng.integers(0, 512, size=(int(rng.integers(4, 12)),))
        tpl_prompts[i] = np.concatenate([tpl, sfx]).astype(np.int32)
        tpl_reqs.append(Request(i, len(tpl_prompts[i]), 8))
    srv_u = server(SMALL, p_small, batch_size=4, max_seq=256,
                   kv_compress=ccfg, prefill_chunk=16,
                   paged=PagedKVConfig(block_size=8))
    outs_u = srv_u.serve(tpl_reqs, tpl_prompts)
    srv_s = server(SMALL, p_small, batch_size=4, max_seq=256,
                   kv_compress=ccfg, prefill_chunk=16,
                   paged=PagedKVConfig(block_size=8),
                   prefix_share=PrefixShareConfig())
    outs_s = srv_s.serve(tpl_reqs, tpl_prompts)
    stu, sts = srv_u.last_stats, srv_s.last_stats
    out["pool_blocks_end"]["unshared"] = stu["pool_blocks_end"]
    out["pool_blocks_end"]["prefix_share"] = sts["pool_blocks_end"]
    say(f"[server] prefix sharing (96-token template x "
        f"{len(tpl_reqs)} requests): tokens "
        f"{_word(_same(outs_s, outs_u))} vs unshared paged; "
        f"{sts['prefix_hits']:.0f} hits reused "
        f"{sts['prefix_tokens_reused']:.0f} prompt tokens, TTFT p95 "
        f"{sts['ttft_p95_ms']:.0f} vs {stu['ttft_p95_ms']:.0f} ms, "
        f"{sts['kv_bytes_saved'] / 1024:.0f} KiB of tail KV shared, "
        f"{sts['pool_cow']:.0f} copy-on-write swaps (physical peak "
        f"{sts['kv_bytes_peak_per_shard'] / 1024:.0f} vs "
        f"{stu['kv_bytes_peak_per_shard'] / 1024:.0f} KiB/shard — "
        f"faster admission keeps more requests in flight)")

    # --- persistent template store (ServerConfig.template_store) ---
    # entries and the pool blocks they pin survive the drain, so a later
    # serve of the same templated traffic starts warm; tokens stay
    # bit-identical to a cold store
    tpl_reqs2, tpl_prompts2 = [], {}
    for i in range(12):
        sfx = rng.integers(0, 512, size=(int(rng.integers(4, 12)),))
        tpl_prompts2[i] = np.concatenate([tpl, sfx]).astype(np.int32)
        tpl_reqs2.append(Request(i, len(tpl_prompts2[i]), 8))
    srv_t = server(SMALL, p_small, batch_size=4, max_seq=256,
                   kv_compress=ccfg, prefill_chunk=16,
                   paged=PagedKVConfig(block_size=8, pool_blocks=24),
                   template_store=TemplateStoreConfig(max_entries=2))
    srv_t.serve(tpl_reqs, tpl_prompts)        # serve #1 fills the store
    st1 = dict(srv_t.last_stats)
    outs_t = srv_t.serve(tpl_reqs2, tpl_prompts2)   # serve #2: warm
    st2 = srv_t.last_stats
    srv_ref = server(SMALL, p_small, batch_size=4, max_seq=256,
                     kv_compress=ccfg, prefill_chunk=16,
                     paged=PagedKVConfig(block_size=8, pool_blocks=24))
    outs_ref = srv_ref.serve(tpl_reqs2, tpl_prompts2)  # cold reference
    ref_uid = {o.uid: o.tokens for o in outs_ref}
    same_t = all(o.tokens == ref_uid[o.uid] for o in outs_t)
    say(f"[server] template store (persistent across serves): warm "
        f"serve TTFT p95 {st2['ttft_p95_ms']:.0f} ms vs "
        f"{st1['ttft_p95_ms']:.0f} ms for the store-filling serve, "
        f"{st2['prefix_hits']:.0f} warm hits reused "
        f"{st2['prefix_tokens_reused']:.0f} prompt tokens, tokens "
        f"{_word(same_t)} vs a cold store")
    say(f"[server] store state: {st2['template_entries']:.0f} entries "
        f"pinning {st2['template_pinned_blocks']:.0f} blocks between "
        f"serves ({st2['template_bytes_pinned'] / 1024:.0f} KiB), "
        f"{st2['template_clusters']:.0f} traffic clusters, cohesion "
        f"{st2['template_cohesion_mean']:.2f}")
    srv_t.invalidate_templates()              # drains the pool to zero

    # --- SLO-aware scheduling (ServerConfig.scheduler) ---
    # the priority-tagged queue (high class arriving LAST) over a pool
    # ~40% under full provisioning: defer, then preempt and swap a
    # lower-priority slot to the host, then shed best-effort work; the
    # protected class is never shed, and non-shed tokens match the
    # unpressured paged serve
    sreqs = [Request(r.uid, r.prompt_len, r.max_new_tokens,
                     priority=1 if r.uid >= 18 else 0) for r in reqs]
    srv_s = server(SMALL, p_small, batch_size=4, max_seq=256,
                   kv_compress=ccfg, prefill_chunk=16,
                   paged=PagedKVConfig(block_size=8, pool_blocks=10),
                   scheduler=SLOConfig())
    outs_s = srv_s.serve(sreqs, prompts)
    sts = srv_s.last_stats
    out["pool_blocks_end"]["slo"] = sts["pool_blocks_end"]
    out["protected_shed"] = sts["sched_shed_high"]
    p_uid = {o.uid: o.tokens for o in outs_p}
    same_s = all(o.tokens == p_uid[o.uid] for o in outs_s if not o.shed)
    hi_ttft = [o.prefill_ms for o in outs_s if o.uid >= 18 and not o.shed]
    say(f"[server] SLO scheduling (pool 10/16 blocks, 6 priority-1 at "
        f"the tail): {sts['sched_preemptions']:.0f} preemptions, "
        f"{sts['sched_swaps_in']:.0f} swap-ins, "
        f"{sts['sched_deferrals']:.0f} deferrals, "
        f"{sts['sched_sheds']:.0f} best-effort shed "
        f"({sts['sched_shed_high']:.0f} protected shed); priority-1 "
        f"TTFT p95 {np.percentile(hi_ttft, 95):.0f} ms; non-shed "
        f"tokens {_word(same_s)} vs the unpressured paged serve")

    # --- observability (ServerConfig.telemetry) ---
    # the request lifecycle as spans and events; host-side only, so
    # greedy tokens are bit-identical with tracing on or off
    srv_o = server(SMALL, p_small, batch_size=4, max_seq=256,
                   kv_compress=ccfg, prefill_chunk=16,
                   paged=PagedKVConfig(block_size=8, pool_blocks=10),
                   scheduler=SLOConfig(),
                   telemetry=TelemetryConfig(trace=True))
    outs_o = srv_o.serve(sreqs, prompts)
    traced_same = ({o.uid: o.tokens for o in outs_o}
                   == {o.uid: o.tokens for o in outs_s})
    evs = srv_o.last_trace
    problems = validate_trace(evs, totals=srv_o.last_stats)
    out["schema_problems"] = len(problems)
    out["pool_blocks_end"]["traced"] = srv_o.last_stats["pool_blocks_end"]
    kinds = sorted({e["name"] for e in evs})
    ph = phase_breakdown(evs)
    say(f"[telemetry] traced serve: {len(evs)} events "
        f"({', '.join(kinds)}), schema problems: {len(problems)}, "
        f"tokens {_word(traced_same)} vs the untraced serve")
    say("[telemetry] phase breakdown: " + ", ".join(
        f"{k.removeprefix('phase_').removesuffix('_ms')} {v:.0f} ms"
        for k, v in ph.items()))
    # the registry documents itself — the serving metrics reference:
    table = srv_o.metrics.reference_table()
    say(f"[telemetry] metrics reference ({len(table.splitlines()) - 2} "
        f"metrics; first rows):")
    for line in table.splitlines()[:6]:
        say("    " + line)

    # --- sliding-window serving ('GL': WindowRetention on 'L' layers) ---
    # 'G' layers keep the clustered frontier; each 'L' layer holds a
    # window-sized ring whose positions retire (and whose blocks return
    # to the pool) once they fall out of the window; tokens stay
    # bit-identical to blocking dense admission
    params_w = params["GLWIN"]
    w_reqs = [Request(i, int(rng.integers(8, 28)), 8) for i in range(12)]
    w_prompts = {r.uid: rng.integers(0, 512, size=(r.prompt_len,)).astype(
        np.int32) for r in w_reqs}
    ccfg_w = kv_compress.KVCompressConfig(n_clusters=8, iters=4,
                                          keep_recent=32, refresh_every=8)
    srv_wb = server(GLWIN, params_w, batch_size=4, max_seq=96,
                    kv_compress=ccfg_w)
    outs_wb = srv_wb.serve(w_reqs, w_prompts)
    srv_w = server(GLWIN, params_w, batch_size=4, max_seq=96,
                   kv_compress=ccfg_w, prefill_chunk=8,
                   paged=PagedKVConfig(block_size=8))
    outs_w = srv_w.serve(w_reqs, w_prompts)
    stw = srv_w.last_stats
    out["pool_blocks_end"]["window"] = stw["pool_blocks_end"]
    say(f"[server] sliding-window model ('GL' x2, window=16, chunked + "
        f"paged): tokens {_word(_same(outs_w, outs_wb))} vs "
        f"blocking dense; window retired {stw['kv_retired_window']:.0f} "
        f"positions, frontier retired {stw['kv_retired_frontier']:.0f}, "
        f"{stw['pool_blocks_end']:.0f} blocks held at drain")

    # --- recurrent-state serving ('GM': an 'M' layer's fixed-size state
    # rides along the clustered, paged 'G' layer) ---
    params_r = params["GMREC"]
    r_reqs = [Request(i, int(rng.integers(8, 28)), 8) for i in range(8)]
    r_prompts = {r.uid: rng.integers(0, 512, size=(r.prompt_len,)).astype(
        np.int32) for r in r_reqs}
    srv_rb = server(GMREC, params_r, batch_size=1, engine="static",
                    use_clustered_batching=False)
    outs_rb = srv_rb.serve(r_reqs, r_prompts)
    srv_r = server(GMREC, params_r, batch_size=4, max_seq=96,
                   kv_compress=ccfg_w, prefill_chunk=8,
                   paged=PagedKVConfig(block_size=8))
    outs_r = srv_r.serve(r_reqs, r_prompts)
    str_ = srv_r.last_stats
    out["pool_blocks_end"]["recurrent"] = str_["pool_blocks_end"]
    say(f"[server] hybrid recurrent model ('GM', chunked + paged): tokens "
        f"{_word(_same(outs_r, outs_rb))} vs blocking decode; "
        f"state bytes/slot ring {str_['state_bytes_ring']:.0f} / "
        f"recurrent {str_['state_bytes_recurrent']:.0f}, recurrent "
        f"retired {str_['kv_retired_recurrent']:.0f} (fixed-size state "
        f"never retires), {str_['pool_blocks_end']:.0f} blocks at drain")

    # --- mesh-sharded serving (slots x tensor parallel) ---
    # In a world of more than one rank (torchrun) the same queue is served
    # on a (data, model) mesh: each rank holds its slots' caches, its kv
    # heads' blocks, and greedy tokens stay identical to the single-device
    # run.  One process is one device: the reference's one-device line.
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world > 1:
        model_par = 4 if world % 8 == 0 else 2
        spec = f"{world // model_par}x{model_par}"
        srv_m = server(SMALL, p_small, batch_size=4, max_seq=256,
                       kv_compress=ccfg, prefill_chunk=16,
                       mesh=make_serving_mesh(spec))
        outs_m = srv_m.serve(reqs, prompts)
        say(f"[server] mesh {spec}: "
            f"{srv_m.last_stats['tokens_per_s']:.1f} tok/s, tokens "
            f"{'bit-identical' if _same(outs_m, outs_c) else 'DIVERGED'} "
            f"vs single-device")
    else:
        say("[server] mesh serving skipped (1 device; set XLA_FLAGS="
            "--xla_force_host_platform_device_count=8 to try a 2x4 mesh)")

    # --- memory management: clustered-KV compression ---
    long_prompt = rng.integers(0, 512, size=(1, 192)).astype(np.int32)
    with torch.inference_mode():
        _, cache = tfm.prefill(p_small, SMALL,
                               torch.from_numpy(long_prompt).to(dev),
                               max_seq=256)
        kc = cache["layers"][0]["k"][0]        # (S, H, Dh) layer 0
        vc = cache["layers"][0]["v"][0]
        kj, vj = kc[:192], vc[:192]
        cfg = kv_compress.KVCompressConfig(n_clusters=24, iters=8,
                                           keep_recent=32)
        ckv = kv_compress.compress_cache(kj, vj, cfg)
        q = torch.from_numpy(rng.normal(size=(
            SMALL.n_kv_heads, SMALL.head_dim)).astype(np.float32)).to(dev)
        scale = SMALL.head_dim ** -0.5
        out_c = kv_compress.clustered_attention(q, ckv, scale=scale)
        out_e = kv_compress.exact_attention(q, kj, vj, scale=scale)
        err = float(torch.linalg.norm(out_c - out_e)
                    / torch.linalg.norm(out_e))
    out["rel_err"] = err
    say(f"[kv] 192 keys → {cfg.n_clusters} median centroids + "
        f"{cfg.keep_recent} exact tail: memory "
        f"{kv_compress.memory_ratio(192, cfg):.1f}× smaller, "
        f"attention rel-err {err:.3f}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    device = ap.parse_args(argv).device
    # under torchrun every rank runs the example and rank 0 prints
    preboot.init_world(resolve_device(device))
    run(device, print if preboot.is_rank_zero() else (lambda *_: None))
    preboot.leave_world()


if __name__ == "__main__":
    main()
