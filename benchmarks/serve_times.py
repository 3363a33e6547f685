#!/usr/bin/env python3
"""End-to-end numbers of the port's qwen3-4b clustered-KV serve, for
comparing commits on one CUDA card.

    python3 benchmarks/serve_times.py [--src DIR] [--label NAME] [--repeats N]

Serves ``chip_smoke.py``'s workload (``serve_workload``: qwen3-4b at full
width, random weights from seed 0, bf16, 8 requests) with the
``repro_torch`` package under ``DIR`` (default: this checkout's ``src``;
point it at the ``src`` of another commit unpacked with ``git archive``),
through the dense and then the paged engine (``PagedKVConfig(block_size=
16)``): once to warm up, then ``N`` timed serves each.  Prints per timed
serve its wall time, decode tokens/s, TTFT and ITL percentiles and the
sha256 of its tokens, and appends the same as JSON lines to
``chiprun_out/serve_times.jsonl``.  The serve is host-bound and moves
with its machine: compare commits only within one command, in turns
(parent, change, change, parent).
"""

from __future__ import annotations

import argparse
import hashlib
import importlib.util
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
KEYS = ("tokens_per_s", "tokens_per_s_wall", "ttft_p50_ms", "ttft_p95_ms",
        "itl_p50_ms", "itl_p95_ms")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default=None)
    ap.add_argument("--repeats", type=int, default=1)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("serve_times: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import _build
    from repro_torch.runtime.kv_pool import PagedKVConfig

    if not Path(_build.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch imported from {_build.__file__}, "
                           f"not from {src}")
    _build.build_all()
    dev = torch.device("cuda")
    card = smoke.smi_line()
    label = args.label or str(src)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    params = None
    for mode, paged in (("dense", None), ("paged", PagedKVConfig(block_size=16))):
        _, srv, reqs, prompts = smoke.serve_workload(torch, dev, paged,
                                                     params)
        params = srv.params
        srv.serve(reqs, prompts)                        # warm-up serve
        for rep in range(args.repeats):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = srv.serve(reqs, prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = srv.last_stats
            tokens = {o.uid: list(map(int, o.tokens)) for o in outs}
            sha = hashlib.sha256(json.dumps(tokens, sort_keys=True)
                                 .encode()).hexdigest()[:16]
            rec = {"label": label, "card": card, "mode": mode, "repeat": rep,
                   "wall_s": wall, "tokens_sha256": sha,
                   **{k: float(st[k]) for k in KEYS}}
            with open(out / "serve_times.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[{card}] {label} {mode}: wall_s {wall:.3f} "
                  + " ".join(f"{k} {rec[k]:.2f}" for k in KEYS)
                  + f" tokens sha256 {sha}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
