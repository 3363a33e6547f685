#!/usr/bin/env python3
"""Where the time of the port's qwen3-4b training step goes, on one CUDA
card.

    python3 benchmarks/profile_torch_train.py [--steps 3]

Builds ``chip_smoke.py``'s phase-5r step: qwen3-4b at full width and
depth, bf16 weights from ``init_params`` seed 0, f32 AdamW moments,
``SyntheticLM`` batches of 2 x 1,024 tokens, remat, loss chunks of 256.
Runs ``--steps`` steps to warm up, then one more under ``torch.profiler``,
its forward + backward (``train_loss`` under autograd) and its AdamW
update each in a ``record_function`` range.  Prints the host seconds of
each range, the device busy and idle share of the step, the kernels that
take the most device time, and the host dispatches (non-view aten ops) of
the step.  The full tables go to ``chiprun_out/profile_torch_train.txt``.
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
    ap.add_argument("--steps", type=int, default=3,
                    help="warm-up steps before the profiled one")
    args = ap.parse_args()
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    if not torch.cuda.is_available():
        print("profile_torch_train: no CUDA device", file=sys.stderr)
        return 1
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from chip_smoke import TRAIN5R, TRAIN5R_AW, full_width_params
    from repro_torch import configs
    from repro_torch.core import tree
    from repro_torch.data import pipeline
    from repro_torch.launch import steps
    from repro_torch.models import transformer as tfm
    from repro_torch.optim import adamw

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = configs.get_config("qwen3-4b")
    params, _, _ = full_width_params(torch, dev, cfg)
    data = pipeline.SyntheticLM(cfg, pipeline.DataConfig(
        seed=0, global_batch=TRAIN5R["batch"], seq_len=TRAIN5R["seq"]))
    aw = adamw.AdamWConfig(**TRAIN5R_AW)
    opt = adamw.init(params)

    def loss_fn(p, b):
        return tfm.train_loss(p, cfg, b, remat=True,
                              loss_chunk=TRAIN5R["loss_chunk"])

    host_s = {"forward+backward": 0.0, "adamw": 0.0}

    def step(i):
        nonlocal params, opt
        b = steps.batch_to(data.batch_at(i), dev)
        t0 = time.perf_counter()
        with record_function("forward+backward"):
            loss, _, flat = steps._loss_and_grads(loss_fn, params, b)
        host_s["forward+backward"] += time.perf_counter() - t0
        t0 = time.perf_counter()
        with record_function("adamw"):
            params, opt, _ = adamw.update(tree.unflatten(params, flat), opt,
                                          params, aw)
        host_s["adamw"] += time.perf_counter() - t0
        return loss

    for i in range(args.steps):
        step(i)
    torch.cuda.synchronize()
    host_s = dict.fromkeys(host_s, 0.0)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        loss = step(args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(e.self_device_time_total for e in events
                 if e.device_type == cuda and e.key not in host_s)
    aten = sum(e.count for e in events
               if e.device_type != cuda and e.key.startswith("aten::")
               and e.key not in ("aten::view", "aten::_unsafe_view",
                                 "aten::as_strided", "aten::reshape",
                                 "aten::expand", "aten::t", "aten::permute",
                                 "aten::transpose", "aten::slice",
                                 "aten::select", "aten::unsqueeze",
                                 "aten::squeeze", "aten::alias",
                                 "aten::detach", "aten::lift_fresh"))
    lines = [f"card: {smi}", f"torch {torch.__version__}",
             f"qwen3-4b {cfg.n_layers} layers, a step of "
             f"{TRAIN5R['batch']} x {TRAIN5R['seq']} tokens: wall "
             f"{wall:.3f} s, loss {float(loss):.4f}",
             "host seconds: " + ", ".join(f"{k} {v:.3f}"
                                          for k, v in host_s.items()),
             f"device busy {dev_us / 1e6:.3f} s of {wall:.3f} s wall: idle "
             f"share {1 - dev_us / 1e6 / wall:.3f}",
             f"host dispatches (non-view aten ops, nested ones included) "
             f"{aten}",
             f"peak memory allocated "
             f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB"]
    by_dev = events.table(sort_by="self_device_time_total", row_limit=30)
    by_cpu = events.table(sort_by="self_cpu_time_total", row_limit=25)
    print("\n".join(lines), flush=True)
    print(events.table(sort_by="self_device_time_total", row_limit=15))
    out = ROOT / "chiprun_out"
    out.mkdir(parents=True, exist_ok=True)
    (out / "profile_torch_train.txt").write_text(
        "\n".join(lines) + "\n\nby device time\n" + by_dev
        + "\n\nby host time\n" + by_cpu + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
