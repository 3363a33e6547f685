#!/usr/bin/env python3
"""Training on several cards: ``launch.train --mesh host`` on a (world, 1)
NCCL mesh against the same run on one card.

    python3 benchmarks/mesh_train_torch.py [--one-card] [train options]
    torchrun --nproc-per-node 4 benchmarks/mesh_train_torch.py [options]
    python3 benchmarks/mesh_train_torch.py --compare [--rtol 1e-3]

Each process runs ``repro_torch.launch.train.main`` with ``--arch
qwen3-4b --mesh host --batch 4 --seq 1024 --steps 10 --lr 3e-4`` (full
width and depth, bf16 weights from ``--seed`` 0) and a checkpoint
directory of its own under the system's temp dir (removed after), and
writes what its Trainer saw to ``chiprun_out/mesh_train_torch/``: each
step's loss, gradient norm and seconds (the slowest rank's on a mesh),
the peak memory allocated on its card, the card's name and power limit.
Under ``torchrun`` each process is a rank of the mesh (one card a rank,
one row of the 4 a rank); alone it is the one-card run.  ``--compare``
reads the files and prints, for each step, the mesh's loss on every rank
and the one card's, and exits 1 unless every rank's losses are equal and
each within ``--rtol`` (relative) of the one card's.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
OUT = ROOT / "chiprun_out" / "mesh_train_torch"
TRAIN_ARGS = ["--arch", "qwen3-4b", "--mesh", "host", "--batch", "4",
              "--seq", "1024", "--steps", "10", "--lr", "3e-4"]


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def run() -> None:
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.launch import train

    ckdir = tempfile.mkdtemp(prefix="mesh_train_torch_")
    try:
        tr = train.main(TRAIN_ARGS + ["--ckpt-dir", ckdir])
        rank = dist.get_rank() if dist.is_initialized() else None
        world = dist.get_world_size() if dist.is_initialized() else 1
        rec = {"rank": rank, "world": world, "losses": tr.losses,
               "grad_norms": tr.grad_norms, "step_s": tr.step_times,
               "peak_bytes": torch.cuda.max_memory_allocated(),
               "card": smi_line(), "kind": torch.cuda.get_device_name(0)}
        OUT.mkdir(parents=True, exist_ok=True)
        name = "one_card.json" if rank is None else f"rank{rank}.json"
        (OUT / name).write_text(json.dumps(rec))
        print(f"[mesh_train] {name}: losses {tr.losses}, seconds a step "
              f"{tr.step_times}, peak {rec['peak_bytes'] / 2**30:.2f} GiB "
              f"({rec['card']})", flush=True)
    finally:
        if dist.is_initialized():
            dist.barrier()
        shutil.rmtree(ckdir, ignore_errors=True)
        if dist.is_initialized():
            dist.destroy_process_group()


def compare(rtol: float) -> int:
    one = json.loads((OUT / "one_card.json").read_text())
    ranks = [json.loads(p.read_text())
             for p in sorted(OUT.glob("rank*.json"))]
    ok = bool(ranks) and all(r["losses"] == ranks[0]["losses"]
                             for r in ranks)
    print(f"[mesh_train] {len(ranks)} ranks, {one['card']}")
    for s, want in enumerate(one["losses"]):
        got = ranks[0]["losses"][s]
        rel = abs(got - want) / abs(want)
        ok = ok and rel <= rtol
        print(f"[mesh_train] step {s + 1}: one card {want:.6f}, mesh "
              f"{[r['losses'][s] for r in ranks]} (relative {rel:.3g}); "
              f"seconds one card {one['step_s'][s]:.3f}, mesh "
              f"{ranks[0]['step_s'][s]:.3f}")
    print(f"[mesh_train] peak memory one card "
          f"{one['peak_bytes'] / 2**30:.2f} GiB, ranks "
          f"{[round(r['peak_bytes'] / 2**30, 2) for r in ranks]} GiB")
    print(json.dumps({"ok": ok, "rtol": rtol}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--one-card", action="store_true")
    ap.add_argument("--compare", action="store_true")
    ap.add_argument("--rtol", type=float, default=1e-3)
    args = ap.parse_args()
    if args.compare:
        return compare(args.rtol)
    if args.one_card:
        os.environ.pop("RANK", None)
    run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
