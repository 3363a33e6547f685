#!/usr/bin/env python3
"""The engine schedule of ``chip_smoke.py``'s templated phases (5i prefix
sharing, 5j the template store) at reduced width on the CPU.

    PYTHONPATH=src python3 benchmarks/templated_schedule.py

Serves the smoke's templated streams (``templated_stream``: a
1,024-token template, 8 requests a burst) under the smoke's Server
configs (``templated_server``) through the reduced qwen3-4b
(``configs.get_reduced``: 2 layers of 2 kv heads of 16, random weights
from seed 0) on the CPU, and prints, per serve, the counts that depend
only on the request lengths and the ServerConfig, not on the widths or
the device: engine steps, prefill chunks, absorbs, compactions, prefix
hits and tokens reused, the pool's peak, allocs, frees, copy-on-write
swaps, retains and end, and the store's pins and hit totals.  Launch
counts follow: on the card each engine step launches
paged_clustered_decode once a layer (36 at full width).  Byte counts
(``kv_bytes_saved``) and times depend on the widths and the device and
are not printed.  The gates of the smoke are not applied here.
"""

from __future__ import annotations

import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("decode_steps", "prefill_chunks", "kv_absorbs", "kv_compactions",
          "prefix_hits", "prefix_tokens_reused", "kv_shared_blocks",
          "pool_blocks_peak", "pool_allocs", "pool_frees", "pool_cow",
          "pool_retains", "pool_blocks_end", "template_entries",
          "template_pinned_blocks", "template_hits_total",
          "template_clusters")


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

    def show(mode, rec):
        st = rec["stats"]
        counts = {k: int(st[k]) for k in COUNTS if k in st}
        print(f"{mode}: " + json.dumps(counts), flush=True)

    unshared, shared = smoke.prefix_share_serves(torch, dev, cfg, params)
    show("5i unshared", unshared)
    show("5i prefix-shared", shared)
    same = unshared["tokens"] == shared["tokens"]
    print(f"5i tokens shared == unshared: {same}")
    rec = smoke.template_store_serves(torch, dev, cfg, params)
    show("5j store serve 1", rec["serves"][0])
    show("5j store serve 2", rec["serves"][1])
    show("5j cold serve 2", rec["cold"])
    print(f"5j after serve 1: {rec['after_serve_1']}; pool after "
          f"invalidate_templates(): {rec['drained']} blocks; warm == cold: "
          f"{rec['serves'][1]['tokens'] == rec['cold']['tokens']}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
