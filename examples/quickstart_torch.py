"""Quickstart of the PyTorch / CUDA port: the paper's pipeline end to end
on a paper-style table, step for step the twin of examples/quickstart.py.

1. load the wine-quality-style table (paper §4 attributes),
2. convert to fixed point (paper's 2^f scaling),
3. cluster with bit-serial k-MEDIANS (the aggregations variant) and with
   plain k-means,
4. sweep k with the avgBMP loop (paper's optimal-k search),
5. report recognition rates + the median-vs-mean robustness gap.

On the card every fit (k-medians, k-means and each fit of the k sweep)
assigns through the ``distance_argmin`` CUDA kernel, and the k-medians
updates and the feature medians run ``bitserial_median``.

Run: PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""

import argparse

import numpy as np
import torch

from repro_torch.core import bitserial, clustering, quantizer
from repro_torch.core.clustering import ClusterConfig
from repro_torch.data import pipeline
from repro_torch.models.layers import resolve_device


def run(device=None, wine_n: int = 1500, census_n: int = 1200,
        say=print) -> dict:
    """The pipeline on ``device`` (None: the card); prints the reference
    script's lines through ``say`` and returns what it printed as numbers."""
    dev = resolve_device(device)
    x, y = pipeline.wine_like(n=wine_n, seed=0)
    xs = (x - x.mean(0)) / (x.std(0) + 1e-6)
    xj = torch.from_numpy(xs).to(dev)
    say(f"table: {x.shape[0]} rows × {x.shape[1]} features "
        f"({', '.join(pipeline.WINE_FEATURES[:4])}, …)")
    out = {}

    # --- fixed-point front end (paper §4) ---
    scale = quantizer.auto_scale(xj, bits=32)
    out["log2_scale"] = torch.log2(scale).cpu().numpy().astype(int)
    say(f"fixed-point scales (2^f per feature): {out['log2_scale'][:6]}…")

    # --- bit-serial median of every feature ---
    med = bitserial.median(xj, bits=32).cpu().numpy()
    out["median"] = med
    say(f"bit-serial medians ≈ {np.round(med, 3)[:4]}… "
        f"(vs numpy {np.round(np.median(xs, 0), 3)[:4]}…)")

    # --- k-medians (paper) vs k-means ---
    labels = torch.from_numpy(y).to(dev)
    for key, name, cfg in [
        ("kmedians", "k-medians (bit-serial)",
         ClusterConfig(k=3, centroid="median", metric="l1", seed=1)),
        ("kmeans", "k-means (baseline)",
         ClusterConfig(k=3, centroid="mean", metric="l2", seed=1)),
    ]:
        res = clustering.fit(xj, cfg)
        rate = clustering.recognition_rate(res.assign, labels, 3, 3)
        out[key] = {"iters": int(res.n_iters), "rate": float(rate),
                    "counts": res.counts.cpu().numpy().astype(int)}
        say(f"{name}: {int(res.n_iters)} iters, "
            f"recognition {float(rate) * 100:.1f}%, "
            f"cluster sizes {out[key]['counts']}")

    # --- optimal-k search (paper §4) on the census-style table ---
    xc, yc = pipeline.census_like(n=census_n, seed=1, outlier_frac=0.0)
    k_opt, scores = clustering.select_k(
        torch.from_numpy(xc).to(dev), 2, 8,
        ClusterConfig(k=2, centroid="mean", metric="l2"))
    out["k_opt"], out["scores"] = k_opt, scores
    say(f"avgBMP k-sweep (census-like, true k=5) scores: "
        f"{[round(s, 3) for s in scores]} → k* = {k_opt}")
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    run(ap.parse_args(argv).device)


if __name__ == "__main__":
    main()
