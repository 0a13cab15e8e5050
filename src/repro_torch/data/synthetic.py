"""Offline stand-ins for the paper's six evaluation corpora (numpy only).

The port's own copy of `repro/data/synthetic.py`: the same specs and the
same generator, so `load_dataset` returns arrays identical to the JAX
package's for the same (name, n, seed, sample). Each stand-in has the
original's dimensionality, unit-normalized rows and a Gaussian-mixture
cluster structure tuned so the negative-query portion at the paper's
evaluation eps (0.4/0.45/0.5) falls in the paper's Table III range.
Every dataset is split 8:2 into R (index side) and S (queries).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from repro_torch.utils import cache_path


@dataclass(frozen=True)
class DatasetSpec:
    """Shape and population mix of one corpus stand-in."""
    name: str
    dim: int
    n_clusters: int
    spread: float          # within-cluster noise scale (always-positive pop.)
    pair_frac: float       # "threshold pairs": NN distance inside the eps band
    pair_band: tuple       # (lo, hi) distance band for pair separation
    outlier_frac: float    # isotropic background points (always negative)
    metric: str            # paper: cosine for text, l2 for image
    kind: str              # "text" | "image"


DATASETS: dict[str, DatasetSpec] = {
    "fasttext": DatasetSpec("fasttext", 300, 24, 0.40, 0.13, (0.33, 0.52), 0.008, "cosine", "text"),
    "glove":    DatasetSpec("glove",    200, 160, 0.45, 0.24, (0.36, 0.53), 0.63, "cosine", "text"),
    "word2vec": DatasetSpec("word2vec", 300, 64, 0.42, 0.25, (0.34, 0.53), 0.06, "cosine", "text"),
    "gist":     DatasetSpec("gist",     960, 96, 0.25, 0.80, (0.38, 0.52), 0.08, "l2", "image"),
    "sift":     DatasetSpec("sift",     128, 128, 0.25, 0.46, (0.36, 0.53), 0.13, "l2", "image"),
    "nuswide":  DatasetSpec("nuswide",  500, 400, 0.28, 0.03, (0.40, 0.52), 0.945, "l2", "image"),
}


def _pair_points(rng, n_pairs: int, dim: int, band: tuple, metric: str) -> np.ndarray:
    """2*n_pairs unit vectors in isolated pairs at controlled distance."""
    u = rng.normal(size=(n_pairs, dim))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    w = rng.normal(size=(n_pairs, dim))
    w -= np.sum(w * u, axis=1, keepdims=True) * u
    w /= np.linalg.norm(w, axis=1, keepdims=True)
    dist = np.exp(rng.uniform(np.log(band[0]), np.log(band[1]), size=(n_pairs, 1)))
    if metric == "cosine":
        cos = 1.0 - dist
    else:  # l2 on the unit sphere: d^2 = 2 - 2 cos
        cos = 1.0 - dist ** 2 / 2.0
    cos = np.clip(cos, -1.0, 1.0)
    v = cos * u + np.sqrt(1.0 - cos ** 2) * w
    return np.concatenate([u, v], axis=0)


def _generate(spec: DatasetSpec, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    n_out = int(spec.outlier_frac * n)
    n_pair = int(spec.pair_frac * n) // 2 * 2
    n_clu = n - n_out - n_pair

    centers = rng.normal(size=(spec.n_clusters, spec.dim))
    centers /= np.linalg.norm(centers, axis=1, keepdims=True)
    # zipf-ish cluster weights: real embedding corpora are uneven
    w = 1.0 / np.arange(1, spec.n_clusters + 1) ** 0.8
    w /= w.sum()
    assign = rng.choice(spec.n_clusters, size=n_clu, p=w)
    noise = rng.normal(size=(n_clu, spec.dim)) * (spec.spread / np.sqrt(spec.dim))
    x_clu = centers[assign] + noise

    x_pair = _pair_points(rng, n_pair // 2, spec.dim, spec.pair_band, spec.metric)
    x_out = rng.normal(size=(n_out, spec.dim))
    x = np.concatenate([x_clu, x_pair, x_out], axis=0)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    rng.shuffle(x)
    return x.astype(np.float32)


def load_dataset(name: str, n: int = 20000, seed: int = 0, sample: int = 1,
                 split: bool = True):
    """Returns (R, S, spec) with |R|:|S| = 8:2, or (X, spec) if split=False.

    sample=2 gives the disjoint second draw used by the generalization
    experiments (same distribution, fresh draw)."""
    spec = DATASETS[name]
    path = cache_path("synthetic-torch-v1", name, n, seed, sample)
    try:
        with np.load(path) as z:
            x = z["x"]
    except (FileNotFoundError, OSError):
        x = _generate(spec, n, seed + 104729 * (sample - 1))
        np.savez_compressed(path, x=x)
    if not split:
        return x, spec
    n_train = int(0.8 * n)
    return x[:n_train], x[n_train:], spec
