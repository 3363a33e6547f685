#!/usr/bin/env python3
"""The mesh engine on several cards: a model served on a (data, model)
NCCL mesh, against the same serve on one card.

    torchrun --nproc-per-node 4 benchmarks/mesh_serve_torch.py \\
        [--mesh 2x2] [--arch qwen3-4b|qwen2-moe-a2.7b|reduced-moe-a2a]

Each rank holds one card.  Every rank draws the same weights on its card
and serves the same requests alone on its card, dense and then paged
(``PagedKVConfig``), then the same through
``ServerConfig(mesh=make_serving_mesh(...))``: slots over ``data``, kv
heads over ``model``, MoE routed experts over ("model", "data") where
their count divides.

* ``qwen3-4b`` (the default): ``chip_smoke.py``'s weights and 8 requests
  (``serve_workload``, bf16).  Every rank's mesh tokens must equal its
  one-card tokens (the run exits 1 otherwise).
* ``qwen2-moe-a2.7b``: full width and depth, ``chip_smoke.py`` 5n's
  weights, requests and ServerConfig.  On 2x2 its 60 experts are 15 a
  rank.  A data shard's MoE capacity is ``capacity(T / 2)``, not
  ``capacity(T)``, so tokens may part from the one-card serve: the count
  of equal requests is printed, not gated.
* ``reduced-moe-a2a``: the reduced qwen2-moe (f32, 2 layers) with 4
  routed experts and ``impl="a2a"`` (4 = 2 x 2: one expert a rank),
  served chunked on 4c's requests: the a2a dispatch on the cards.
  Tokens printed, not gated.

With ``--store`` or ``--slo`` (qwen3-4b), the runtime modes instead:
``--store`` serves ``chip_smoke.py`` 5j's two templated bursts through
one Server with ``TemplateStoreConfig(max_entries=2)`` over 5j's pool (a
data shard's), on one card and on the mesh, and gates each burst's mesh
tokens equal to the card's; ``--slo`` serves 5k's stream unpressured on
one card and scheduled on the mesh (``SLOConfig(priority_admission=
False)``, traced) over its slots' own blocks a data shard (2 x 16 on 2 x
2: a data shard of 2 slots has no slot to preempt within its class when
one of them admits, so 5k's 62.5 % raises PoolExhausted there, in the
reference's engine as in the port's; the full pool still preempts), and
gates every unshed mesh request's tokens equal to the unpressured ones;
it prints the sched_* counters and the resumes that landed on another
data shard than their swap-out (their payloads moved between cards).

Rank 0 prints, beside the card's name and power limit, each serve's wall,
ITL p50, engine steps, decode-kernel launches and MoE branch counts and
each rank's parameter and expert-bank bytes on every rank, and appends
them as JSON lines to ``chiprun_out/mesh_serve_torch.jsonl``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("qwen3-4b", "qwen2-moe-a2.7b", "reduced-moe-a2a")


def workload(torch, dev, arch):
    """(cfg, params, requests, prompts, {mode: ServerConfig fields}, whether
    mesh tokens are gated equal to the card's)."""
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.core.kv_compress import KVCompressConfig
    from repro_torch.models import transformer as tfm
    from repro_torch.runtime.kv_pool import PagedKVConfig

    if arch == "qwen3-4b":
        cfg, srv, reqs, prompts = cs.serve_workload(torch, dev)
        base = dict(batch_size=4, max_seq=2048, prefill_chunk=64,
                    kv_compress=cs.smoke_kv_compress())
        modes = {"dense": base,
                 "paged": dict(base, paged=PagedKVConfig(block_size=cs.BS))}
        return cfg, srv.params, reqs, prompts, modes, True
    if arch == "qwen2-moe-a2.7b":
        cfg = configs.get_config(arch)
        params = cs.full_width_params(torch, dev, cfg)[0]
        reqs, prompts = cs.draw_requests(cfg.vocab, **cs.MOE_STREAM)
        base = dict(batch_size=4, max_seq=cs.MOE_MAX_SEQ,
                    prefill_chunk=cs.REC_CHUNK,
                    kv_compress=cs.smoke_kv_compress())
        modes = {"dense": base,
                 "paged": dict(base, paged=PagedKVConfig(block_size=cs.BS))}
        return cfg, params, reqs, prompts, modes, False
    cfg = dataclasses.replace(configs.get_reduced("qwen2-moe-a2.7b"),
                              dtype="float32")
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, n_routed=4, impl="a2a"))
    params = tfm.init_params(0, cfg, device=dev)
    reqs, prompts = cs.draw_requests(cfg.vocab, **cs.MOE_TINY_STREAM)
    modes = {"dense": dict(batch_size=4, max_seq=96, prefill_chunk=8,
                           kv_compress=KVCompressConfig(**cs.MOE_TINY_CC))}
    return cfg, params, reqs, prompts, modes, False


def runtime_serves(torch, dev, cfg, params, mesh, store):
    """``--store`` / ``--slo``: (records, whether the mesh tokens equal the
    one card's)."""
    import chip_smoke as cs
    from repro_torch.launch.mesh import mesh_sizes
    from repro_torch.runtime.telemetry import validate_trace
    from repro_torch.runtime.template_store import TemplateStoreConfig

    if store:
        recs = {}
        for where, m in (("card", None), ("mesh", mesh)):
            srv = cs.templated_server(
                cfg, params, dev, cs.TPL_POOL, mesh=m,
                template_store=TemplateStoreConfig(max_entries=2))
            recs[where] = [cs.run_serve(torch, srv,
                                        *cs.templated_stream(cfg.vocab, seed),
                                        f"{where} store burst {seed}")
                           for seed in (1, 2)]
            srv.invalidate_templates()
            del srv
        equal = all(a["tokens"] == b["tokens"]
                    for a, b in zip(recs["card"], recs["mesh"]))
        return {where: [{"wall_s": r["wall_s"],
                         "itl_p50_ms": r["stats"]["itl_p50_ms"],
                         "engine_steps": r["engine_steps"],
                         "prefix_hits": r["stats"]["prefix_hits"],
                         "template_pinned_blocks":
                             r["stats"]["template_pinned_blocks"]}
                        for r in rs] for where, rs in recs.items()}, equal
    reqs, prompts = cs.slo_stream(cfg.vocab)
    free = cs.slo_serve(torch, dev, cfg, params, reqs, prompts, False)
    per_shard = 4 // mesh_sizes(mesh)["data"]
    sched = cs.slo_serve(torch, dev, cfg, params, reqs, prompts, True,
                         mesh=mesh, pool_blocks=per_shard * (cs.R // cs.BS))
    last, moved = {}, []
    for e in sched["trace"]:
        if e["name"] == "swap_out":
            last[e["uid"]] = e["pid"]
        elif e["name"] == "resume" and last[e["uid"]] != e["pid"]:
            moved.append((e["uid"], last[e["uid"]], e["pid"]))
    equal = all(t == free["tokens"][u] for u, t in sched["tokens"].items()
                if not sched["shed"][u])
    st = sched["stats"]
    return {"card_unpressured": {"wall_s": free["wall_s"],
                                 "itl_p50_ms": free["stats"]["itl_p50_ms"]},
            "mesh": {"wall_s": sched["wall_s"],
                     "itl_p50_ms": st["itl_p50_ms"],
                     "engine_steps": sched["engine_steps"],
                     "sched": {k: v for k, v in st.items()
                               if k.startswith("sched_")},
                     "cross_shard_resumes": moved,
                     "shed": [u for u, v in sched["shed"].items() if v],
                     "trace_problems": validate_trace(sched["trace"],
                                                      totals=st)[:5]},
            }, equal


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2x2")
    ap.add_argument("--arch", default="qwen3-4b", choices=ARCHS)
    ap.add_argument("--store", action="store_true",
                    help="5j's template-store bursts, card against mesh")
    ap.add_argument("--slo", action="store_true",
                    help="5k's stream scheduled on the mesh against "
                         "unpressured on one card")
    args = ap.parse_args()
    if (args.store or args.slo) and (args.arch != "qwen3-4b"
                                     or args.store == args.slo):
        ap.error("--store or --slo (one of them) serves qwen3-4b")
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch import preboot
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.models import moe
    from repro_torch.runtime.server import Server, ServerConfig

    dev = torch.device("cuda")
    preboot.init_world(dev)
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    _build.build_all()
    cfg, params, reqs, prompts, modes, gated = workload(torch, dev,
                                                        args.arch)
    mesh = make_serving_mesh(args.mesh)
    equal = True
    out = ROOT / "chiprun_out" / "mesh_serve_torch.jsonl"
    if args.store or args.slo:
        modes = {}
        rec, equal = runtime_serves(torch, dev, cfg, params, mesh,
                                    args.store)
        rec = {"rank": rank, "arch": args.arch, "mesh": args.mesh,
               "mode": "store" if args.store else "slo", "smi": smi,
               "tokens_equal": equal, **rec}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rec)
        equal = all(r["tokens_equal"] for r in every)
        if rank == 0:
            out.parent.mkdir(exist_ok=True)
            with out.open("a") as f:
                for r in every:
                    print(json.dumps(r))
                    f.write(json.dumps(r) + "\n")
    for mode, kw in modes.items():
        kernel = ("paged_clustered_decode" if "paged" in kw
                  else "clustered_decode")
        recs = {}
        for where, m in (("card", None), ("mesh", mesh)):
            srv = Server(cfg, ServerConfig(mesh=m, **kw), params,
                         device=dev)
            dist.barrier()
            moe.reset_mesh_dispatches()
            recs[where] = cs.run_serve(torch, srv, reqs, prompts,
                                       f"{where} {mode}")
            recs[where]["mesh_dispatches"] = dict(moe.mesh_dispatches)
            recs[where]["param_bytes"] = srv.param_bytes()
            del srv
        card, on_mesh = recs["card"]["tokens"], recs["mesh"]["tokens"]
        rec = {"rank": rank, "arch": args.arch, "mode": mode,
               "mesh": args.mesh, "smi": smi,
               "tokens_equal": on_mesh == card,
               "requests_equal": sum(on_mesh[u] == t
                                     for u, t in card.items()),
               "requests": len(card),
               "tokens_sha256": recs["mesh"]["tokens_sha256"]}
        for where, r in recs.items():
            rec[where] = {"wall_s": r["wall_s"],
                          "itl_p50_ms": r["stats"]["itl_p50_ms"],
                          "engine_steps": r["engine_steps"],
                          kernel: r["launches"][kernel],
                          "n_data_shards": r["stats"].get("n_data_shards",
                                                          1.0),
                          "moe_branches": r["mesh_dispatches"],
                          "param_bytes": r["param_bytes"]}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rec)
        equal = equal and all(r["tokens_equal"] for r in every)
        if rank == 0:
            out.parent.mkdir(exist_ok=True)
            with out.open("a") as f:
                for r in every:
                    print(json.dumps(r))
                    f.write(json.dumps(r) + "\n")
    if rank == 0:
        print(f"[{smi}] {args.arch} mesh {args.mesh}: mesh tokens "
              f"{'equal' if equal else 'DIFFER from'} the one-card tokens "
              f"on every rank" + ("" if gated else " (not gated)"))
    preboot.leave_world()
    return 0 if equal or not gated else 1


if __name__ == "__main__":
    sys.exit(main())
