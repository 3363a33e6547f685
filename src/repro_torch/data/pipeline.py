"""Paper-style tabular datasets for the clustering pipeline (port of the
table generators of ``repro.data.pipeline``).

Numpy only, seeded, so the port and the reference build the same tables
from the same seed.  The reference module's token stream
(``SyntheticLM``, ``DataConfig``) is not ported here: it serves training.
"""

from __future__ import annotations

import numpy as np

WINE_FEATURES = [
    "fixed_acidity", "volatile_acidity", "citric_acid", "residual_sugar",
    "chlorides", "free_sulfur_dioxide", "total_sulfur_dioxide", "density",
    "pH", "sulphates", "alcohol", "quality",
]


def wine_like(n: int = 4595, seed: int = 0) -> tuple[np.ndarray, np.ndarray]:
    """Synthetic table matching the paper's §4 wine-quality statistics
    (means/ranges from the paper's summary table); labels = quality band."""
    rng = np.random.default_rng(seed)
    means = np.array([6.85, 0.275, 0.334, 6.39, 0.0458, 35.3, 138.4,
                      0.994, 3.19, 0.49, 10.5, 5.88], np.float64)
    stds = np.array([0.84, 0.10, 0.12, 5.07, 0.022, 17.0, 42.5,
                     0.003, 0.15, 0.11, 1.2, 0.87], np.float64)
    k = 3
    labels = rng.integers(0, k, size=(n,))
    shift = (labels[:, None] - 1) * stds[None, :] * 1.5
    x = rng.normal(size=(n, 12)) * stds[None, :] + means[None, :] + shift
    return x.astype(np.float32), labels.astype(np.int32)


def census_like(n: int = 5000, d: int = 8, seed: int = 1,
                outlier_frac: float = 0.01):
    """Census-style table (paper Table 1) with heavy-tailed outliers — the
    workload where median centroids beat means."""
    rng = np.random.default_rng(seed)
    k = 5
    centers = rng.normal(size=(k, d)) * 4.0
    labels = rng.integers(0, k, size=(n,))
    x = rng.normal(size=(n, d)) * 0.6 + centers[labels]
    n_out = int(n * outlier_frac)
    idx = rng.choice(n, n_out, replace=False)
    x[idx] += rng.normal(size=(n_out, d)) * 100.0
    return x.astype(np.float32), labels.astype(np.int32)


def gaussian_blobs(n_per: int, centers: np.ndarray, std: float = 0.4,
                   seed: int = 0):
    rng = np.random.default_rng(seed)
    k, d = centers.shape
    xs = np.concatenate([
        rng.normal(size=(n_per, d)) * std + centers[c] for c in range(k)])
    ys = np.repeat(np.arange(k, dtype=np.int32), n_per)
    perm = rng.permutation(len(xs))
    return xs[perm].astype(np.float32), ys[perm]
