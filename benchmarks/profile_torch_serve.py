#!/usr/bin/env python3
"""Where the time of the port's qwen3-4b clustered-KV serve goes, on one
CUDA card.

    python3 benchmarks/profile_torch_serve.py [--paged]

Serves the workload of ``chip_smoke.py`` (its ``serve_workload``:
qwen3-4b, random weights from seed 0, bf16, 8 requests through a
clustered-KV Server) once to warm up, then again under
``torch.profiler``.  Prints the host wall time split into engine
launches, streaming absorbs and compactions (each wrapped in a
``record_function`` range), the device busy and idle share of the serve,
and the CUDA kernels and host ops that take the most time.  With
``--paged`` the same requests go through the paged engine
(``PagedKVConfig(block_size=16)``, packed ragged launches).  The full
tables go to ``chiprun_out/profile_torch_serve[_paged].txt``.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--paged", action="store_true",
                    help="serve through the paged engine")
    paged = ap.parse_args().paged
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_serve: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import serve_workload
    from repro_torch.runtime import server as server_mod
    from repro_torch.runtime.kv_pool import PagedKVConfig

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    cfg, srv, reqs, prompts = serve_workload(
        torch, torch.device("cuda"),
        PagedKVConfig(block_size=16) if paged else None)
    step = "decode_step_packed" if paged else "decode_step"

    # label the three kinds of device work the engine issues
    host_s = {step: 0.0, "absorb": 0.0, "compact": 0.0}

    def wrap(obj, name, label):
        fn = getattr(obj, name)

        def inner(*a, **k):
            t0 = time.perf_counter()
            with record_function(label):
                out = fn(*a, **k)
            host_s[label] += time.perf_counter() - t0
            return out
        setattr(obj, name, inner)

    srv.serve(reqs, prompts)                       # warm-up serve
    wrap(server_mod.tfm, step, step)
    wrap(srv, "_absorb", "absorb")
    wrap(srv, "compact_kv", "compact")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        srv.serve(reqs, prompts)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    st = srv.last_stats
    events = prof.key_averages()
    # kernels only: the three ranges above also appear as device-side
    # annotations spanning their kernels
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and e.key not in host_s)
    lines = [f"card: {smi}", f"torch {torch.__version__}",
             f"qwen3-4b {cfg.n_layers} layers, "
             f"{'paged' if paged else 'dense'} serve wall {wall:.3f} s, "
             f"{int(st['decode_steps'])} engine steps, "
             f"{int(st['kv_absorbs'])} absorbs, "
             f"{int(st['kv_compactions'])} compactions",
             "host seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in host_s.items()),
             f"device busy {dev_us / 1e6:.3f} s of {wall:.3f} s wall: idle "
             f"share {1 - dev_us / 1e6 / wall:.3f}",
             f"tokens_per_s {st['tokens_per_s']:.2f} ttft_p50_ms "
             f"{st['ttft_p50_ms']:.1f} itl_p50_ms {st['itl_p50_ms']:.2f}"]
    by_dev = events.table(sort_by="self_device_time_total", row_limit=25)
    by_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    print("\n".join(lines), flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=12))
    out = ROOT / "chiprun_out"
    out.mkdir(parents=True, exist_ok=True)
    (out / f"profile_torch_serve{'_paged' if paged else ''}.txt").write_text(
        "\n".join(lines) + "\n\nby device time\n" + by_dev
        + "\n\nby host time\n" + by_cpu + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
