#!/usr/bin/env python3
"""Device times of the port's two decode kernels, for comparing commits on
one CUDA card.

    python3 benchmarks/time_decode_kernels.py [--src DIR] [--label NAME]

Builds ``clustered_decode`` and ``paged_clustered_decode`` from the
``repro_torch`` package under ``DIR`` (default: this checkout's ``src``;
point it at the ``src`` of another commit unpacked with ``git archive`` to
time that commit's kernels) and times them with ``chip_smoke.py``'s phase
7 (``decode_times``): per form, the median device time of 50 launches
read from torch.profiler with L2 flushed before each launch, the
wrapper's call time, the SDPA yardstick's device time and the bound.  The
plain versions are not timed.  Prints one JSON line ``{"label": ...,
"card": ..., "times": {form: {...}}}`` and appends it to
``chiprun_out/time_decode_kernels.jsonl``.  Run two commits in turns in
one command (parent, change, change, parent) to compare them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default=None)
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_decode_kernels: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import _build
    from repro_torch.kernels import clustered_decode as cd
    from repro_torch.kernels import paged_clustered_decode as pcd

    if not Path(cd.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch imported from {cd.__file__}, not "
                           f"from {src}")
    _build.build_all()
    dev = torch.device("cuda")
    card = smoke.smi_line()
    times = smoke.decode_times(torch, cd, pcd, dev, plain=False)
    rec = {"label": args.label or str(src), "card": card,
           "grouped": hasattr(pcd, "group_rows"), "times": times}
    line = json.dumps(rec, default=float)
    print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "time_decode_kernels.jsonl", "a") as f:
        f.write(line + "\n")
    for form, v in times.items():
        print(f"[{card}] {rec['label']} {form}: kernel_ms {v['ms']:.4f} "
              f"call_ms {v['call_ms']:.4f} sdpa_ms {v['library_ms']:.4f} "
              f"bound_ms {v['bound_ms']:.4f} ({v['bound_by']})", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
