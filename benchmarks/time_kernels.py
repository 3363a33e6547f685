#!/usr/bin/env python3
"""Device times of the port's hand-written kernels, for comparing commits
on one CUDA card.

    python3 benchmarks/time_kernels.py [--src DIR] [--label NAME]
        [--only decode|median|flash|distance|fit ...]

Builds the kernels of the ``repro_torch`` package under ``DIR`` (default:
this checkout's ``src``; point it at the ``src`` of another commit
unpacked with ``git archive`` to time that commit's kernels) and times
them with ``chip_smoke.py``'s phase 7:

- ``decode`` (``decode_times``): clustered_decode mixed, serve-like mixed
  and one-token, paged_clustered_decode mixed and decode-only (qwen3-4b
  shapes, bf16), each beside its SDPA yardstick;
- ``median`` (``time_median``): bitserial_median resident at the serve's
  compaction (1,152 members) and absorb (288 members) shapes (320 points
  x 128 dims, K = 64 / 32, 16 bits, count and mask weights) and streamed
  at the fit's shape (2^20 x 16, K = 64, 32 bits);
- ``flash`` (``time_flash_decode``): flash_decode in bf16 at B = 4,
  S = 2,048, t = 1,500, Hq = 32, Hkv = 8, Dh = 128, beside SDPA;
- ``distance`` (``time_distance``): distance_argmin in L1 and L2 at the
  fit's shape (2^20 x 16 points, K = 64) and at two of the quickstart's
  (4,595 x 12, K = 3; 5,000 x 8, K = 5), beside ``torch.cdist`` then
  ``.min(1)``, with sha256 digests of assign and mind, so two commits'
  lines show whether their outputs are bit-equal;
- ``fit`` (``kmedians``): the k-medians fit of ``chip_smoke.py`` phase 6
  (seconds, iterations, launches, inertia and digests of its assignment
  and centroids), under ``"fit"`` in the JSON line.

Per form the median device time of 50 launches read from torch.profiler
with L2 flushed before each launch, the wrapper's call time and the
bound; the plain versions are not timed.  Prints one JSON line
``{"label": ..., "card": ..., "times": {form: {...}}}`` and appends it to
``chiprun_out/time_kernels.jsonl``.  Run two commits in turns in one
command (parent, change, change, parent) to compare them.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
GROUPS = ("decode", "median", "flash", "distance", "fit")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--src", default=str(ROOT / "src"),
                    help="directory holding the repro_torch package")
    ap.add_argument("--label", default=None)
    ap.add_argument("--only", nargs="+", choices=GROUPS, default=GROUPS,
                    help="kernel groups to time (default: all)")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("time_kernels: no CUDA device", file=sys.stderr)
        return 1
    src = Path(args.src).resolve()
    sys.path.insert(0, str(src))
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from repro_torch.kernels import _build
    from repro_torch.kernels import bitserial_median as bsm
    from repro_torch.kernels import clustered_decode as cd
    from repro_torch.kernels import distance_argmin as da
    from repro_torch.kernels import flash_decode as fd
    from repro_torch.kernels import paged_clustered_decode as pcd

    if not Path(cd.__file__).resolve().is_relative_to(src):
        raise RuntimeError(f"repro_torch imported from {cd.__file__}, not "
                           f"from {src}")
    _build.build_all()
    dev = torch.device("cuda")
    card = smoke.smi_line()
    times = {}
    if "decode" in args.only:
        times.update(smoke.decode_times(torch, cd, pcd, dev, plain=False))
    if "median" in args.only:
        for name, m, k, bits in smoke.MED_CASES:
            u, a, w = smoke.median_inputs(torch, dev, m, k, bits)
            times[f"bitserial_median {name}"] = smoke.time_median(
                torch, bsm, u, a, k, w, bits, plain_n=0)
            del u, a, w
        u, a = smoke.stream_inputs(torch, dev)
        times["bitserial_median streamed"] = smoke.time_median(
            torch, bsm, u, a, smoke.K_PTS, None, 32, plain_n=0)
        del u, a
    if "flash" in args.only:
        times["flash_decode"] = smoke.time_flash_decode(torch, fd, dev,
                                                        plain=False)
    if "distance" in args.only:
        fit = (smoke.N_PTS, smoke.D_PTS, smoke.K_PTS)
        for shape in (fit, smoke.DA_QUICKSTART[0], smoke.DA_L2_TIMED):
            x, c = smoke.da_inputs(torch, dev, *shape)
            for metric in ("l1", "l2"):
                name = f"distance_argmin {metric}"
                if shape != fit:
                    name += " {} x {}, K {}".format(*shape)
                times[name] = smoke.time_distance(torch, da, x, c, metric,
                                                  plain=False)
            del x, c
    rec = {"label": args.label or str(src), "card": card, "times": times}
    if "fit" in args.only:
        rec["fit"] = smoke.kmedians(torch, dev)
    line = json.dumps(rec, default=float)
    print(line, flush=True)
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    with open(out / "time_kernels.jsonl", "a") as f:
        f.write(line + "\n")
    for form, v in times.items():
        lib = v["library_ms"]
        sha = (f" assign {v['assign_sha256']} mind {v['mind_sha256']}"
               if "assign_sha256" in v else "")
        print(f"[{card}] {rec['label']} {form}: kernel_ms {v['ms']:.4f} "
              f"call_ms {v['call_ms']:.4f} library_ms "
              f"{'None' if lib is None else f'{lib:.4f}'} bound_ms "
              f"{v['bound_ms']:.4f} ({v['bound_by']}){sha}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
