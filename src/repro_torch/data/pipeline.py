"""Data pipeline (port of ``repro.data.pipeline``): deterministic,
stateless-seekable, host-sharded.

Two sources, numpy only and seeded, so the port and the reference build
the same batches and tables from the same seed:
  * ``SyntheticLM``: deterministic token streams, so any step index
    reproduces its batch exactly (restart-safe: after a resume the
    trainer asks for step k and gets the identical batch);
  * the paper's tabular clustering workloads (a wine-like quality table,
    a census-like population table, Gaussian mixtures, the UCI-style
    suite), read by the clustering pipeline.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.models.config import ModelConfig


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 0
    global_batch: int = 8
    seq_len: int = 128
    host_id: int = 0
    n_hosts: int = 1


class SyntheticLM:
    """Deterministic pseudo-corpus with local n-gram structure (so a small
    model can learn and its loss visibly falls).  ``batch_at(step)`` is a
    pure function of (seed, step, host_id, n_hosts): numpy "tokens" and
    "labels" (the tokens shifted by one), and "enc_embeds" for an
    encoder-decoder or "frontend_embeds" under a frontend, f32."""

    def __init__(self, cfg: ModelConfig, dc: DataConfig):
        self.cfg = cfg
        self.dc = dc
        assert dc.global_batch % dc.n_hosts == 0
        self.local_batch = dc.global_batch // dc.n_hosts

    def _tokens_for(self, step: int, row: int, length: int) -> np.ndarray:
        seed = (self.dc.seed * 1_000_003 + step * 8191 + row) % (2**31 - 1)
        rng = np.random.default_rng(seed)
        v = self.cfg.vocab
        # Markov-ish stream: next token = (prev * a + noise) % v
        a = 31 + (seed % 17)
        toks = np.zeros((length,), np.int32)
        toks[0] = rng.integers(0, v)
        noise = rng.integers(0, 7, size=(length,))
        for t in range(1, length):
            toks[t] = (toks[t - 1] * a + noise[t]) % v
        return toks

    def batch_at(self, step: int) -> dict:
        dc, cfg = self.dc, self.cfg
        s = dc.seq_len
        s_tok = s // 2 if cfg.is_encdec else s - cfg.n_frontend_tokens
        row0 = dc.host_id * self.local_batch
        arr = np.stack([self._tokens_for(step, row0 + r, s_tok + 1)
                        for r in range(self.local_batch)])
        batch = {"tokens": arr[:, :-1].astype(np.int32),
                 "labels": arr[:, 1:].astype(np.int32)}
        if cfg.is_encdec:
            rng = np.random.default_rng(dc.seed + step)
            batch["enc_embeds"] = rng.normal(
                size=(self.local_batch, s // 2, cfg.d_model)
            ).astype(np.float32) * 0.1
        elif cfg.n_frontend_tokens:
            rng = np.random.default_rng(dc.seed + step)
            batch["frontend_embeds"] = rng.normal(
                size=(self.local_batch, cfg.n_frontend_tokens, cfg.d_model)
            ).astype(np.float32) * 0.1
        return batch


# ---------------------------------------------------------------------------
# Paper-style tabular datasets (clustering benchmarks)
# ---------------------------------------------------------------------------

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


def uci_style_suite(seed: int = 0):
    """Synthetic stand-ins mirroring the paper's Table 3 datasets
    (Iris/Wine/Vowel/Ionosphere/Crude-oil: small labeled tables).  As in
    the reference, each table's blob seed takes ``hash(name)``, which
    varies between processes unless PYTHONHASHSEED is set."""
    rng = np.random.default_rng(seed)
    suite = {}
    specs = {
        "iris": (150, 4, 3, 2.5),
        "wine": (178, 13, 3, 1.6),
        "vowel": (871, 3, 6, 1.2),
        "ionosphere": (351, 34, 2, 1.1),
        "crude_oil": (56, 5, 3, 1.8),
    }
    for name, (n, d, k, sep) in specs.items():
        centers = rng.normal(size=(k, d)) * sep
        x, y = gaussian_blobs(max(n // k, 8), centers, std=1.0,
                              seed=seed + hash(name) % 1000)
        suite[name] = (x[:n], y[:n])
    return suite
