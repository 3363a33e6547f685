#!/usr/bin/env python3
"""End-to-end numbers of the port's qwen3-4b clustered-KV serve, for
comparing commits on one CUDA card.

    python3 benchmarks/serve_times.py [--src DIR] [--label NAME] [--repeats N]
                                      [--blocking]

Serves ``chip_smoke.py``'s workload (``serve_workload``: qwen3-4b at full
width, random weights from seed 0, bf16, 8 requests) with the
``repro_torch`` package under ``DIR`` (default: this checkout's ``src``;
point it at the ``src`` of another commit unpacked with ``git archive``),
through the dense and then the paged engine (``PagedKVConfig(block_size=
16)``): once to warm up, then ``N`` timed serves each.  ``--blocking``
adds the same two serves with blocking admission (``prefill_chunk=0``);
a ``--src`` tree whose Server refuses it (before blocking admission was
ported) skips them and says so.  Prints per timed serve its wall time,
decode tokens/s, TTFT and ITL percentiles, blocking admission's
``prefill_pad_frac`` and seconds in ``_clusterize``, the
``bitserial_median`` launches and the sha256 of its tokens, and appends
the same as JSON lines to ``chiprun_out/serve_times.jsonl``.  The serve is host-bound and moves
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
        "itl_p50_ms", "itl_p95_ms", "decode_steps")
# published by blocking clustered admission only
BLOCKING_KEYS = ("prefill_pad_frac", "clusterize_s", "kv_admit_compress",
                 "kv_compactions")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default=None)
    ap.add_argument("--repeats", type=int, default=1)
    ap.add_argument("--blocking", action="store_true",
                    help="also serve with blocking admission")
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
    from repro_torch.kernels import _build, ops
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
    modes = [("dense", None, 64), ("paged", PagedKVConfig(block_size=16), 64)]
    if args.blocking:
        modes += [("dense blocking", None, 0),
                  ("paged blocking", PagedKVConfig(block_size=16), 0)]
    for mode, paged, chunk in modes:
        try:
            _, srv, reqs, prompts = smoke.serve_workload(torch, dev, paged,
                                                         params, chunk)
        except NotImplementedError as e:
            print(f"[{card}] {label} {mode}: skipped, this tree refuses "
                  f"it: {e}", flush=True)
            continue
        params = srv.params
        srv.serve(reqs, prompts)                        # warm-up serve
        for rep in range(args.repeats):
            ops.reset_launches()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            outs = srv.serve(reqs, prompts)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            st = dict(srv.last_stats)
            st.update(srv.last_admission)
            tokens = {o.uid: list(map(int, o.tokens)) for o in outs}
            sha = hashlib.sha256(json.dumps(tokens, sort_keys=True)
                                 .encode()).hexdigest()[:16]
            rec = {"label": label, "card": card, "mode": mode, "repeat": rep,
                   "wall_s": wall, "tokens_sha256": sha,
                   "bitserial_median": ops.launch_counts()[
                       "bitserial_median"],
                   **{k: float(st[k]) for k in KEYS + BLOCKING_KEYS
                      if k in st}}
            with open(out / "serve_times.jsonl", "a") as f:
                f.write(json.dumps(rec) + "\n")
            print(f"[{card}] {label} {mode}: wall_s {wall:.3f} "
                  + " ".join(f"{k} {rec[k]:.4f}" for k in
                             KEYS + BLOCKING_KEYS if k in rec)
                  + f" bitserial_median {rec['bitserial_median']}"
                  + f" tokens sha256 {sha}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
