#!/usr/bin/env python3
"""The engine schedule and the host dispatches of ``chip_smoke.py``'s
recurrent phases (4b, 5l, 5m) on the CPU.

    PYTHONPATH=src python3 benchmarks/recurrent_schedule.py [--only 4b 5l 5m]

4b serves TINY 'GM' and 'GR' exactly as the smoke does (``rec_tiny_serves``,
port weights from seed 0) and prints each serve's counts.  5l and 5m serve
the smoke's requests (``draw_requests`` of ``RG_STREAM``, ``MAMBA_STREAM``)
through the smoke's ServerConfigs (``recurrent_serves``) on recurrentgemma-9b
and mamba2-2.7b at the smoke's depth (recurrentgemma-9b cut to
``RG_LAYERS``) and layer pattern but narrow widths (d_model
64, heads of 16, RG-LRU width 64, Mamba2 heads of 32 over d_state 16, vocab
256; bf16, random weights from seed 0), and counts the non-view aten ops of
one mixed and one decode step (``step_dispatches``).  These counts depend
only on the request lengths, the ServerConfig and the layer pattern, not on
the widths or the device (no kernel wrapper runs in these models), so they
predict the card's.  Times are printed as measured here, on the CPU, and
are not the card's.  The gates of the smoke are not applied here.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib.util
import json
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
COUNTS = ("decode_steps", "prefill_chunks", "kv_absorbs", "kv_compactions",
          "gen_tokens", "kv_retired_window", "kv_retired_frontier",
          "kv_retired_recurrent", "state_bytes_recurrent", "pool_blocks_peak",
          "pool_allocs", "pool_frees", "pool_blocks_end", "kv_admit_compress",
          "sched_preemptions", "sched_swaps_in")


def narrow(arch):
    """The full config's depth and layer pattern at narrow widths."""
    from repro_torch import configs
    from repro_torch.models.config import SSMConfig

    cfg = configs.get_config(arch)
    kw = dict(d_model=64, n_heads=4, head_dim=16, d_ff=128, vocab=256)
    if cfg.ssm is not None:
        kw.update(n_kv_heads=4, ssm=SSMConfig(d_state=16, d_conv=4, expand=2,
                                              head_dim=32, n_groups=1,
                                              chunk=32))
    else:
        kw.update(n_kv_heads=1, lru_width=64)
    return dataclasses.replace(cfg, **kw).validate()


def counts(rec):
    st = rec["stats"]
    return {k: int(st[k]) for k in COUNTS if k in st}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=["4b", "5l", "5m"])
    args = ap.parse_args()
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.models import transformer as tfm

    dev = torch.device("cpu")
    if "4b" in args.only:
        for pattern in ("GM", "GR"):
            cfg = smoke.rec_tiny_cfg(pattern)
            params = tfm.init_params(0, cfg, device="cpu")
            for name, rec in smoke.rec_tiny_serves(torch, dev, cfg,
                                                   params).items():
                print(f"4b {pattern} {name}: " + json.dumps(counts(rec)),
                      flush=True)
    for phase, arch, max_seq, stream, modes in (
            ("5l", "recurrentgemma-9b", smoke.RG_MAX_SEQ,
             smoke.RG_STREAM, ("chunked", "paged", "blocking")),
            ("5m", "mamba2-2.7b", smoke.MAMBA_MAX_SEQ, smoke.MAMBA_STREAM,
             ("chunked", "blocking"))):
        if phase not in args.only:
            continue
        cfg = narrow(arch)
        if phase == "5l":       # the smoke cuts recurrentgemma's depth
            cfg = dataclasses.replace(cfg, n_layers=smoke.RG_LAYERS)
        params = tfm.init_params(0, cfg, device="cpu")
        reqs, prompts = smoke.draw_requests(cfg.vocab, **stream)
        print(f"{phase} {arch} (narrow): prompts "
              f"{[r.prompt_len for r in reqs]}, new tokens "
              f"{[r.max_new_tokens for r in reqs]}", flush=True)
        steps = smoke.step_dispatches(torch, dev, cfg, params, max_seq)
        print(f"{phase} {arch}: dispatches a mixed step "
              f"{steps['mixed']['dispatches']}, a decode step "
              f"{steps['decode']['dispatches']}", flush=True)
        t0 = time.perf_counter()
        recs = smoke.recurrent_serves(torch, dev, cfg, params, max_seq, reqs,
                                      prompts, modes)
        for mode, rec in recs.items():
            print(f"{phase} {arch} {mode}: " + json.dumps(counts(rec))
                  + f" (CPU wall {rec['wall_s']:.1f} s)", flush=True)
        print(f"{phase} total CPU seconds {time.perf_counter() - t0:.1f}",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
