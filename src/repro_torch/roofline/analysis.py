"""Three-term roofline analysis over the dry-run records (port of
``repro.roofline.analysis``, for one H100).

Per (arch × shape × mesh), per card:
    compute term    = step FLOPs / peak bf16 FLOP/s
    memory term     = step HBM bytes / HBM bandwidth
    collective term = collective wire bytes / link bandwidth (0 on one
                      card, which has no collective; the key stays)

The step's FLOPs and bytes are ``op_stats``, the count of
``roofline/op_count.py`` over the eager step (every aten op plus the
kernels' work models), in ``hlo_stats``' place; a mesh record's
(``--mesh pod|multipod``) are one rank's, its collectives the bytes each
kind's results hold, weighted as the reference weighs them (a ring
all-reduce moves about twice its tensor).  The port's rank computes its
row shard at whole width (``launch.steps``: the model axis shards
storage), so a mesh record's FLOPs and MODEL/HLO ratio are its own, not
the reference's (data x model) split.

Hardware model: NVIDIA's data sheet for the H100 SXM at 700 W, 989e12
dense bf16 FLOP/s and 3.35e12 HBM bytes/s (``roofline/work.py``), 80 GB
of HBM, 450e9 NVLink bytes/s each way (a card's 900 GB/s to the other
cards of its host; a 16 x 16 mesh spans hosts, whose network is slower,
so the collective term is a floor).  The terms, the ideal and
``fits_80gb`` are computed from these spec constants, not measured.

MODEL_FLOPS uses 6·N·D (train) or 2·N·D (forward-only), with N = active
params for MoE; the ratio MODEL_FLOPS / counted FLOPs exposes remat and
redundancy waste.  A record that holds a run on the card
(``measured_step_s``) also gives ``measured_s`` and ``measured_fraction``
= ideal / measured.
"""

from __future__ import annotations

import glob
import json
import os
from typing import Optional

from repro_torch.roofline.work import PEAK_BF16_FLOP_PER_S, PEAK_BYTES_PER_S

PEAK_FLOPS = PEAK_BF16_FLOP_PER_S   # bf16 / card
HBM_BW = PEAK_BYTES_PER_S           # B/s / card
HBM_BYTES = 80e9                    # one card's HBM
LINK_BW = 450e9                     # NVLink B/s / card, each way
WIRE_FACTOR = {"all-reduce": 2.0, "all-gather": 1.0, "reduce-scatter": 1.0,
               "all-to-all": 1.0, "collective-permute": 1.0}


def _cell(rec: dict):
    """The record's ShapeCell: ``SHAPES``' own, or the one it carries
    (a dry run of a cell outside ``SHAPES``)."""
    from repro_torch.models.config import SHAPES, ShapeCell
    if "cell" in rec:
        return ShapeCell(**rec["cell"])
    return SHAPES[rec["shape"]]


def model_flops_global(rec: dict) -> float:
    """Analytic MODEL_FLOPS for the whole step."""
    cell = _cell(rec)
    n_active = rec["info"]["active_params"]
    if cell.step == "train":
        tokens = cell.global_batch * cell.seq_len
        return 6.0 * n_active * tokens
    if cell.step == "prefill":
        tokens = cell.global_batch * cell.seq_len
        return 2.0 * n_active * tokens
    # decode: one token per sequence
    return 2.0 * n_active * cell.global_batch


def ideal_step_s(rec: dict) -> float:
    """Compute floor, and for decode also the unavoidable HBM floor
    (params + cache read once per step)."""
    chips = rec["n_devices"]
    t_ideal = (model_flops_global(rec) / chips) / PEAK_FLOPS
    if _cell(rec).step == "decode":
        floor_bytes = (2.0 * rec["info"]["active_params"]
                       + rec["info"].get("cache_bytes", 0)) / chips
        t_ideal = max(t_ideal, floor_bytes / HBM_BW)
    return t_ideal


def analyze_record(rec: dict) -> Optional[dict]:
    if "skipped" in rec or "error" in rec:
        return None
    hs = rec["op_stats"]
    chips = rec["n_devices"]
    flops_dev = hs["flops"]
    t_compute = flops_dev / PEAK_FLOPS
    t_memory = hs["hbm_bytes"] / HBM_BW
    wire = sum(WIRE_FACTOR.get(k, 1.0) * v
               for k, v in hs["collectives"].items())
    terms = {"compute": t_compute, "memory": t_memory,
             "collective": wire / LINK_BW}
    dominant = max(terms, key=terms.get)
    mf = model_flops_global(rec)
    hlo_global = flops_dev * chips
    useful = mf / hlo_global if hlo_global else 0.0
    t_ideal = ideal_step_s(rec)
    # roofline fraction: ideal over the dominant term's cost
    t_dom = terms[dominant]
    frac = t_ideal / t_dom if t_dom > 0 else 0.0
    mem = rec["memory_analysis"]
    hbm_per_dev = (mem["argument_bytes"] + mem["output_bytes"]
                   + (mem["temp_bytes"] or 0) - mem["alias_bytes"])
    row = {
        "arch": rec["arch"], "shape": rec["shape"], "mesh": rec["mesh"],
        "terms_s": {k: round(v, 6) for k, v in terms.items()},
        "dominant": dominant,
        "model_flops": mf,
        "hlo_flops_global": hlo_global,
        "useful_ratio": round(useful, 4),
        "roofline_fraction": round(frac, 4),
        "device_bytes": hbm_per_dev,
        "fits_80gb": hbm_per_dev < HBM_BYTES,
        "collectives_dev": hs["collectives"],
        "unknown_trip_loops": hs.get("unknown_trip_loops", 0),
    }
    if rec.get("measured_step_s"):
        row["ideal_s"] = t_ideal
        row["measured_s"] = rec["measured_step_s"]
        row["measured_fraction"] = round(t_ideal / rec["measured_step_s"], 4)
    return row


def suggestion(row: dict) -> str:
    d = row["dominant"]
    if d == "compute":
        if row["useful_ratio"] < 0.35:
            return ("compute-bound with low useful ratio — cut remat "
                    "recompute / causal-chunk waste")
        return "compute-bound near peak — only algorithmic changes help"
    if d == "collective":
        return ("collective-bound — gather per layer, split compute over "
                "model, or compress cross-pod traffic")
    return ("memory-bound — fuse/cast (bf16 cache, wider blocks), "
            "raise arithmetic intensity per HBM byte")


def load_all(art_dir: str = "artifacts/dryrun_torch") -> list[dict]:
    recs = []
    for p in sorted(glob.glob(os.path.join(art_dir, "*.json"))):
        with open(p) as f:
            recs.append(json.load(f))
    return recs


def table(art_dir: str = "artifacts/dryrun_torch", mesh: str = "1") -> str:
    """Markdown roofline table of the records of ``mesh`` ("1": one card;
    "16x16", "2x16x16": one rank of the mesh)."""
    rows, skipped = [], []
    for rec in load_all(art_dir):
        if rec.get("mesh") != mesh:
            continue
        if "skipped" in rec:
            skipped.append(rec)
            continue
        r = analyze_record(rec)
        if r:
            rows.append(r)
    lines = [
        "| arch | shape | compute (s) | memory (s) | collective (s) | "
        "dominant | MODEL/HLO | roofline frac | bytes/dev | fits 80GB |",
        "|---|---|---|---|---|---|---|---|---|---|",
    ]
    for r in sorted(rows, key=lambda x: (x["arch"], x["shape"])):
        t = r["terms_s"]
        lines.append(
            f"| {r['arch']} | {r['shape']} | {t['compute']:.4f} | "
            f"{t['memory']:.4f} | {t['collective']:.4f} | {r['dominant']} | "
            f"{r['useful_ratio']:.3f} | {r['roofline_fraction']:.3f} | "
            f"{r['device_bytes'] / 1e9:.2f} GB | "
            f"{'yes' if r['fits_80gb'] else 'NO'} |")
    for s in sorted(skipped, key=lambda x: (x["arch"], x["shape"])):
        lines.append(f"| {s['arch']} | {s['shape']} | — | — | — | skipped | "
                     f"— | — | — | — |")
    return "\n".join(lines)


def pick_hillclimb_cells(art_dir: str = "artifacts/dryrun_torch") -> dict:
    """The cell of the worst roofline fraction; ``collective`` (the most
    collective-bound cell) is None: one card has no collective."""
    rows = [analyze_record(r) for r in load_all(art_dir)
            if r.get("mesh") == "1"]
    rows = [r for r in rows if r]
    worst = min(rows, key=lambda r: r["roofline_fraction"])
    return {"worst": worst, "collective": None}


def main(argv=None):
    import argparse
    ap = argparse.ArgumentParser(
        description="roofline table over the one-card dry-run records "
                    "(spec-constant terms, H100 SXM)")
    ap.add_argument("--art", default="artifacts/dryrun_torch")
    ap.add_argument("--out", default="artifacts/roofline_torch.md")
    args = ap.parse_args(argv)
    md = ["# Roofline table — one H100 (terms from the data sheet's peaks)",
          "", table(args.art, "1"), ""]
    for mesh in ("16x16", "2x16x16"):
        if any(r.get("mesh") == mesh for r in load_all(args.art)):
            md += [f"## One rank of the {mesh} mesh", "",
                   table(args.art, mesh), ""]
    rows = [analyze_record(r) for r in load_all(args.art)
            if r.get("mesh") == "1"]
    md.append("## Per-cell bottleneck notes")
    for r in sorted([x for x in rows if x],
                    key=lambda x: (x["arch"], x["shape"])):
        md.append(f"- **{r['arch']} × {r['shape']}** — dominant: "
                  f"{r['dominant']}; {suggestion(r)}")
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        f.write("\n".join(md))
    picks = pick_hillclimb_cells(args.art)
    print("worst roofline fraction:", picks["worst"]["arch"],
          picks["worst"]["shape"], picks["worst"]["roofline_fraction"])
    print("most collective-bound: none (one card)")
    print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
