"""Xling: the learned metric-space Bloom filter (paper §IV).

Composition (Fig. 1): a learned cardinality estimator + the XDT decision
threshold, trained offline on the R side of the join:

    fit:    R --(range_count kernel)--> target table over the eps grid
              --(ATCS, Alg. 1)--> s training tuples/point --> estimator
    query:  (q, eps, tau) --> predicted count  vs  XDT(eps, tau) --> +/-

XDT is computed offline per (eps, tau, mode) from training-set
predictions and Eq.-2-interpolated targets, and cached. When the engine
serves the filter, the threshold is calibrated through the SAME device
predict fn that serves (the fused MLP kernel on the card), so threshold
and online predictions share their float arithmetic.

`XlingFilter.load` reads files written by either package's `save`.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Optional

import numpy as np
import torch

from repro_torch.core import atcs as atcs_mod
from repro_torch.core import xdt as xdt_mod
from repro_torch.data.groundtruth import cardinality_table, eps_grid_for_metric
from repro_torch.kernels import ops
from repro_torch.models import load_jax_state, make_estimator
from repro_torch.utils import resolve_device


@dataclass
class XlingConfig:
    """Filter configuration (the JAX package's fields plus `device`)."""
    estimator: str = "rmi"            # registry key
    metric: str = "cosine"
    m: int = 100                      # candidate-condition grid size
    s: int = 6                        # ATCS sampling number (paper: 6)
    strategy: str = "atcs"            # "atcs" | "uniform"
    xdt_mode: str = "fpr"             # "fpr" | "mean"
    fpr_tolerance: float = 0.05
    target_mode: str = "interp"       # "interp" | "exact"
    epochs: int = 30
    lr: float = 1e-3
    batch_size: int = 512
    seed: int = 0
    backend: str = "auto"             # kernel backend for counting/inference
    device: str = "cuda"              # where the sweep and the estimator run
    estimator_kwargs: dict = field(default_factory=dict)


class XlingFilter:
    """Trained filter. Use `fit(R)` then `query(Q, eps, tau)`."""

    def __init__(self, cfg: XlingConfig):
        self.cfg = cfg
        self.eps_grid = eps_grid_for_metric(cfg.metric, cfg.m)
        self.estimator = None
        self.train_points: Optional[np.ndarray] = None
        self.target_table: Optional[np.ndarray] = None   # [n, m] ground truth
        self._train_preds_cache: dict = {}
        self._xdt_cache: dict = {}
        self.stats: dict = {}

    # ------------------------------------------------------------------ fit
    def fit(self, R: np.ndarray, *, cache_key: tuple | None = None,
            target_table: np.ndarray | None = None,
            engine=None) -> "XlingFilter":
        """Ground-truth table (unless given) -> ATCS tuples -> estimator.
        engine= reuses an already device-resident R for the sweep."""
        cfg = self.cfg
        self.train_points = np.asarray(R, np.float32)
        t0 = time.perf_counter()
        if target_table is None:
            target_table = cardinality_table(
                self.train_points, self.train_points, self.eps_grid,
                cfg.metric, backend=cfg.backend, device=cfg.device,
                cache_key=cache_key, exclude_self=True, engine=engine)
        self.target_table = target_table
        t1 = time.perf_counter()

        select = (atcs_mod.atcs_select if cfg.strategy == "atcs"
                  else atcs_mod.uniform_select)
        idx = select(self.target_table, cfg.s, seed=cfg.seed)
        X, y = atcs_mod.build_training_tuples(self.train_points, self.eps_grid,
                                              self.target_table, idx)
        din = self.train_points.shape[1] + 1
        self.estimator = make_estimator(
            cfg.estimator, din, epochs=cfg.epochs, lr=cfg.lr,
            batch_size=cfg.batch_size, seed=cfg.seed, device=cfg.device,
            **cfg.estimator_kwargs)
        loss = self.estimator.fit(X, y)   # returns a float: work is done
        # host-clock seconds of the two offline phases (the table arrives
        # as a host array, so the sweep has finished when t1 is taken)
        self.stats = {"train_tuples": len(X), "final_loss": loss,
                      "sweep_s": t1 - t0, "fit_s": time.perf_counter() - t1}
        self._train_preds_cache.clear()
        self._xdt_cache.clear()
        return self

    # ------------------------------------------------------------ prediction
    def predict_counts(self, Q: np.ndarray, eps: float) -> np.ndarray:
        """Estimator predictions for (Q, eps), float32 [q]."""
        X = np.concatenate([np.asarray(Q, np.float32),
                            np.full((len(Q), 1), eps, np.float32)], axis=1)
        return self.estimator.predict(X, backend=self.cfg.backend)

    def _train_predictions(self, eps: float, predict=None) -> np.ndarray:
        """Training-set predictions for XDT calibration. `predict` =
        (params, fn) from the estimator's `device_predict_fn()` calibrates
        through the implementation the engine serves with."""
        key = (round(float(eps), 9), "host" if predict is None else "device")
        if key not in self._train_preds_cache:
            if predict is None:
                preds = self.predict_counts(self.train_points, eps)
            else:
                params, fn = predict
                X = np.concatenate(
                    [self.train_points,
                     np.full((len(self.train_points), 1), eps, np.float32)],
                    axis=1)
                with torch.no_grad():
                    preds = fn(params, torch.as_tensor(
                        X, device=self.estimator.device)).cpu().numpy()
            self._train_preds_cache[key] = preds
        return self._train_preds_cache[key]

    def _targets_at(self, eps: float) -> np.ndarray:
        if self.cfg.target_mode == "interp":
            return xdt_mod.interp_targets(self.eps_grid, self.target_table, eps)
        # "exact": a fresh range count at this eps, clamped at 0 after the
        # self-match subtraction (an isolated point counts only itself and
        # must target 0, not -1, or it biases XDT selection low)
        p = torch.as_tensor(self.train_points,
                            device=resolve_device(self.cfg.device))
        cnt = ops.range_count(p, p, float(eps), metric=self.cfg.metric,
                              backend=self.cfg.backend).cpu().numpy()
        return np.maximum(cnt - 1, 0)

    def xdt(self, eps: float, tau: int = 0, *, mode: str | None = None,
            fpr_tolerance: float | None = None, predict=None) -> float:
        """The XDT threshold for (eps, tau), cached per configuration and
        per calibration implementation (host predict vs device fn)."""
        mode = mode or self.cfg.xdt_mode
        tol = self.cfg.fpr_tolerance if fpr_tolerance is None else fpr_tolerance
        key = (round(float(eps), 9), int(tau), mode, round(tol, 6),
               self.cfg.target_mode, "host" if predict is None else "device")
        if key not in self._xdt_cache:
            preds = self._train_predictions(eps, predict)
            targets = self._targets_at(eps)
            self._xdt_cache[key] = xdt_mod.select_xdt(preds, targets, tau,
                                                      mode=mode, fpr_tolerance=tol)
        return self._xdt_cache[key]

    def query(self, Q: np.ndarray, eps: float, tau: int = 0, *,
              mode: str | None = None, fpr_tolerance: float | None = None
              ) -> tuple[np.ndarray, np.ndarray]:
        """Returns (positive verdicts bool [q], predicted counts float [q])."""
        thr = self.xdt(eps, tau, mode=mode, fpr_tolerance=fpr_tolerance)
        preds = self.predict_counts(Q, eps)
        return preds > thr, preds

    # ---------------------------------------------------------- persistence
    def save(self, path: str) -> None:
        """Write the filter in the JAX package's npz format."""
        blob = {"eps_grid": self.eps_grid, "target_table": self.target_table,
                "train_points": self.train_points,
                "cfg_estimator": np.asarray(self.cfg.estimator),
                "cfg_metric": np.asarray(self.cfg.metric)}
        for k, v in self.estimator.state_dict().items():
            blob[f"est_{k}"] = v
        np.savez_compressed(path, **blob)

    @classmethod
    def load(cls, path: str, cfg: XlingConfig | None = None, *,
             device="cuda") -> "XlingFilter":
        """Read a filter written by either package's `save`: target table,
        train points, eps grid and estimator weights (widths read off the
        arrays). `cfg` overrides the stored estimator/metric; `device`
        applies when no cfg is given."""
        with np.load(path, allow_pickle=False) as z:
            cfg = cfg or XlingConfig(estimator=str(z["cfg_estimator"]),
                                     metric=str(z["cfg_metric"]),
                                     device=str(device))
            obj = cls(cfg)
            obj.eps_grid = z["eps_grid"]
            obj.target_table = z["target_table"]
            obj.train_points = z["train_points"]
            est_state = {k[4:]: z[k] for k in z.files if k.startswith("est_")}
        obj.estimator = load_jax_state(cfg.estimator, est_state,
                                       device=cfg.device)
        return obj
