#!/usr/bin/env python3
"""The mesh engine on several cards: qwen3-4b at full width served on a
(data, model) NCCL mesh, against the same serve on one card.

    torchrun --nproc-per-node 4 benchmarks/mesh_serve_torch.py [--mesh 2x2]

Each rank holds one card.  Every rank draws ``chip_smoke.py``'s weights
(``serve_workload``: qwen3-4b, seed 0 on its card's generator, bf16) and
serves its 8 requests alone on its card, dense and then paged
(``PagedKVConfig(block_size=16)``), then the same through
``ServerConfig(mesh=make_serving_mesh(...))``: slots over ``data``, kv
heads over ``model``.  Every rank's mesh tokens must equal its one-card
tokens.  Rank 0 prints, beside the card's name and power limit, each
serve's wall, ITL p50, engine steps and decode-kernel launches on every
rank, appends them as JSON lines to ``chiprun_out/mesh_serve_torch.jsonl``,
and the run exits 1 on a mismatch.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--mesh", default="2x2")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import torch
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch.kernels import _build
    from repro_torch.launch import preboot
    from repro_torch.launch.mesh import make_serving_mesh
    from repro_torch.runtime.kv_pool import PagedKVConfig

    dev = torch.device("cuda")
    preboot.init_world(dev)
    rank = dist.get_rank()
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = cs.smi_line()
    _build.build_all()
    params = cs.serve_workload(torch, dev)[1].params
    mesh = make_serving_mesh(args.mesh)
    ok = True
    out = ROOT / "chiprun_out" / "mesh_serve_torch.jsonl"
    for mode, paged in (("dense", None), ("paged", PagedKVConfig(16))):
        kernel = "paged_clustered_decode" if paged else "clustered_decode"
        recs = {}
        for where, m in (("card", None), ("mesh", mesh)):
            _, srv, reqs, prompts = cs.serve_workload(torch, dev, paged,
                                                      params, mesh=m)
            dist.barrier()
            recs[where] = cs.run_serve(torch, srv, reqs, prompts,
                                       f"{where} {mode}")
        rec = {"rank": rank, "mode": mode, "mesh": args.mesh, "card": smi,
               "tokens_equal": recs["mesh"]["tokens"]
               == recs["card"]["tokens"],
               "tokens_sha256": recs["mesh"]["tokens_sha256"]}
        for where, r in recs.items():
            rec[where] = {"wall_s": r["wall_s"],
                          "itl_p50_ms": r["stats"]["itl_p50_ms"],
                          "engine_steps": r["engine_steps"],
                          kernel: r["launches"][kernel],
                          "n_data_shards": r["stats"].get("n_data_shards",
                                                          1.0)}
        every = [None] * dist.get_world_size()
        dist.all_gather_object(every, rec)
        ok = ok and all(r["tokens_equal"] for r in every)
        if rank == 0:
            out.parent.mkdir(exist_ok=True)
            with out.open("a") as f:
                for r in every:
                    print(json.dumps(r))
                    f.write(json.dumps(r) + "\n")
    if rank == 0:
        print(f"[{smi}] mesh {args.mesh}: tokens "
              f"{'equal' if ok else 'DIFFER'} on every rank")
    preboot.leave_world()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
