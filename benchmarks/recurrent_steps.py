#!/usr/bin/env python3
"""Host dispatches and walls of one engine step of the recurrent models
on the card, at narrow and full width.

    python3 benchmarks/recurrent_steps.py

For recurrentgemma-9b and mamba2-2.7b: ``chip_smoke.step_dispatches``
(one mixed step, a 64-token chunk beside 3 decode rows, and one decode
step, at batch 4) on the narrow configs of
``benchmarks/recurrent_schedule.py``, then on the full configs with bf16
weights from seed 0 (twice), and a 256-token sequential prefill at batch 1
(twice), with the peak memory allocated.  Needs a CUDA card; sizes the
smoke's recurrent workloads (phases 5l and 5m).
"""

import importlib.util
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT / "benchmarks"))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    import recurrent_schedule as rs
    from repro_torch import configs
    from repro_torch.models import transformer as tfm

    if not torch.cuda.is_available():
        print("recurrent_steps: needs a CUDA card", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    print(smoke.smi_line(), torch.__version__, flush=True)
    for arch, ms in (("recurrentgemma-9b", smoke.RG_MAX_SEQ),
                     ("mamba2-2.7b", smoke.MAMBA_MAX_SEQ)):
        cfg = rs.narrow(arch)
        p = tfm.init_params(0, cfg, device=dev)
        st = smoke.step_dispatches(torch, dev, cfg, p, ms)
        print("narrow", arch, st, flush=True)
        del p
        cfg = configs.get_config(arch)
        p, _, _ = smoke.full_width_params(torch, dev, cfg)
        for _ in range(2):
            st = smoke.step_dispatches(torch, dev, cfg, p, ms)
            print("full", arch, st, flush=True)
        tok = torch.from_numpy(np.random.default_rng(0).integers(
            0, cfg.vocab, size=(1, 256)).astype(np.int32)).to(dev)
        with torch.inference_mode():
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                tfm.prefill(p, cfg, tok, max_seq=ms,
                            recurrent_mode="sequential")
                torch.cuda.synchronize()
                print("full", arch, "sequential prefill 256 tokens s",
                      time.perf_counter() - t0, flush=True)
        print("peak GiB", torch.cuda.max_memory_allocated() / 2**30,
              flush=True)
        del p
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
