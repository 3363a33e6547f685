#!/usr/bin/env python3
"""The engine schedule of ``chip_smoke.py``'s phase 5k (the SLO scheduler
over an oversubscribed pool) at reduced width on the CPU.

    PYTHONPATH=src python3 benchmarks/slo_schedule.py

Serves 5k's stream (``slo_stream``: 16 requests, the last 4 priority 1)
through 5k's two Server configs (``slo_serves``: unpressured over the
slots' 64 blocks, then 40 blocks with ``SLOConfig(priority_admission=
False)`` and tracing) on the reduced qwen3-4b (``configs.get_reduced``,
random weights from seed 0) on the CPU, and prints, per serve, the counts
that depend only on the request lengths and the ServerConfig, not on the
widths or the device: engine steps, prefill chunks, absorbs,
compactions, the pool's peak, allocs and frees, every ``sched_*``
counter, and the trace's span counts.  Launch counts follow: on the card
each engine step launches paged_clustered_decode once a layer (36 at
full width).  The swap bytes peak at full width is the peak of parked
blocks times qwen3-4b's 2,359,296 bytes a block (16 positions x 36
layers x k and v x 8 kv heads x 128 x 2 bytes).  Times are not printed.
The gates of the smoke are not applied here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("decode_steps", "prefill_chunks", "kv_absorbs", "kv_compactions",
          "gen_tokens", "pool_blocks_peak", "pool_allocs", "pool_frees",
          "pool_blocks_end")
# bytes of one qwen3-4b pool block at full width, bf16
FULL_BLOCK_BYTES = 16 * 36 * 2 * 8 * 128 * 2


def main() -> int:
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    dev = torch.device("cpu")
    cfg = configs.get_reduced("qwen3-4b")
    params = tfm.init_params(torch.Generator().manual_seed(0), cfg,
                             device=dev)
    reqs, free, sched = smoke.slo_serves(torch, dev, cfg, params)
    for mode, rec in (("5k unpressured", free), ("5k scheduled", sched)):
        st = rec["stats"]
        counts = {k: int(st[k]) for k in COUNTS}
        counts.update({k: int(v) for k, v in st.items()
                       if k.startswith("sched_")})
        print(f"{mode}: " + json.dumps(counts), flush=True)
    st = sched["stats"]
    spans = {}
    for e in sched["trace"]:
        spans[e["name"]] = spans.get(e["name"], 0) + 1
    print("5k scheduled trace: " + json.dumps(spans))
    same = sum(sched["tokens"][r.uid] == free["tokens"][r.uid]
               for r in reqs if not sched["shed"][r.uid])
    shed = [r.uid for r in reqs if sched["shed"][r.uid]]
    print(f"5k unshed requests with the unpressured tokens: {same} of "
          f"{len(reqs) - len(shed)}; shed uids {shed}")
    print(f"5k swap bytes peak at full width: "
          f"{int(st['sched_swapped_peak_blocks'])} blocks x "
          f"{FULL_BLOCK_BYTES} B = "
          f"{int(st['sched_swapped_peak_blocks']) * FULL_BLOCK_BYTES} B")
    return 0


if __name__ == "__main__":
    sys.exit(main())
