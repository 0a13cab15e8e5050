"""Recursive Model Index estimator (Kraska et al.) — the paper's main model.

§VI-A configuration: three stages of 1 / 2 / 4 fully-connected networks,
each sub-model the 512/512/256/128 MLP. Training is the greedy
stage-by-stage procedure of the JAX package: stage k's prediction routes
each tuple to a stage k+1 child, and children train on their routed
subset as masked losses. Inference evaluates every sub-model on every
row through the fused kernel (one launch per sub-MLP); the routing and
`take_along_axis` stay plain tensor code, as they are XLA glue in the
reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.kernels import ops
from repro_torch.models.mlp import MLP, PAPER_WIDTHS, regression_target
from repro_torch.models.train import fit_regressor
from repro_torch.utils import memoize_device_fn, resolve_device


class RMIEstimator:
    """RMI over MLP sub-models; fit/predict in count space."""

    name = "rmi"

    def __init__(self, din: int, stage_sizes=(1, 2, 4), widths=PAPER_WIDTHS, *,
                 lr=1e-3, epochs=30, batch_size=512, seed=0, log_target=True,
                 device="cuda"):
        self.din = din
        self.stage_sizes = tuple(stage_sizes)
        self.widths = tuple(widths)
        self.lr, self.epochs, self.batch_size = lr, epochs, batch_size
        self.seed, self.log_target = seed, log_target
        self.device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.stages = [[MLP.init(din, widths, generator=g, device=self.device)
                        for _ in range(n)] for n in self.stage_sizes]
        self._ylo, self._yhi = 0.0, 1.0

    # -- routing ------------------------------------------------------------
    def _route_ids(self, preds: torch.Tensor, n_children: int) -> torch.Tensor:
        """Map a (transformed) prediction to a child index by target range
        (f32 arithmetic, truncation toward zero, as the reference)."""
        z = (preds - self._ylo) / max(self._yhi - self._ylo, 1e-9)
        return torch.clamp((z * n_children).to(torch.int32), 0, n_children - 1)

    def _routed_predict(self, stages_params, X: torch.Tensor, *,
                        backend: str = "auto") -> torch.Tensor:
        pred = ops.mlp_forward(stages_params[0][0], X, backend=backend)
        for si in range(1, len(self.stage_sizes)):
            kids = stages_params[si]
            route = self._route_ids(pred, len(kids))
            all_preds = torch.stack([ops.mlp_forward(p, X, backend=backend)
                                     for p in kids], dim=1)
            pred = torch.gather(all_preds, 1, route[:, None].long())[:, 0]
        return pred

    def _params(self) -> list:
        return [[m.layers() for m in stage] for stage in self.stages]

    # -- fit/predict ----------------------------------------------------------
    def fit(self, X: np.ndarray, y: np.ndarray, weights=None):
        """Greedy stage-by-stage fit; returns the root model's last loss."""
        yt = regression_target(y, self.log_target)
        self._ylo, self._yhi = float(yt.min()), float(yt.max())
        self._device_fn = None
        base_w = np.ones((len(X),), np.float32) if weights is None else weights
        Xd = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        kw = dict(lr=self.lr, epochs=self.epochs, batch_size=self.batch_size)

        loss = fit_regressor(self.stages[0][0], Xd, yt, weights=base_w,
                             seed=self.seed, **kw)
        with torch.no_grad():
            pred = ops.mlp_forward(self.stages[0][0].layers(), Xd)
        for si in range(1, len(self.stage_sizes)):
            kids = self.stages[si]
            route = self._route_ids(pred, len(kids))
            route_np = route.cpu().numpy()
            new_pred = torch.zeros_like(pred)
            for ci, child in enumerate(kids):
                mask = (route_np == ci).astype(np.float32) * base_w
                if mask.sum() < 2:      # child got (almost) nothing routed
                    continue
                fit_regressor(child, Xd, yt, weights=mask,
                              seed=self.seed + 17 * si + ci, **kw)
                with torch.no_grad():
                    cp = ops.mlp_forward(child.layers(), Xd)
                new_pred = torch.where(route == ci, cp, new_pred)
            pred = new_pred
        return loss

    def predict(self, X, *, backend: str = "auto") -> np.ndarray:
        """Predicted counts, float32 [n]."""
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        with torch.no_grad():
            raw = self._routed_predict(self._params(), Xt, backend=backend)
            out = torch.expm1(raw) if self.log_target else raw
        return out.cpu().numpy()

    def device_predict_fn(self):
        """(params, fn) for the engine's filter program: fn(params, X) is
        the routed forward in count space on device tensors. The routing
        bounds are baked in, so fn is memoized per (log_target, ylo, yhi)
        — a refit invalidates it."""
        def build():
            log = self.log_target

            def fn(params, X):
                raw = self._routed_predict(params, X)
                return torch.expm1(raw) if log else raw
            return fn
        key = (self.log_target, self._ylo, self._yhi)
        return self._params(), memoize_device_fn(self, key, build)

    # -- persistence ----------------------------------------------------------
    def state_dict(self) -> dict:
        """numpy state under the JAX package's npz keys."""
        out = {"kind": np.asarray("rmi"), "din": np.asarray(self.din),
               "stage_sizes": np.asarray(self.stage_sizes),
               "ylo": np.asarray(self._ylo), "yhi": np.asarray(self._yhi),
               "log_target": np.asarray(self.log_target)}
        for si, stage in enumerate(self.stages):
            for ci, model in enumerate(stage):
                for li, (w, b) in enumerate(model.arrays()):
                    out[f"s{si}c{ci}w{li}"] = w
                    out[f"s{si}c{ci}b{li}"] = b
        return out

    def load_state_dict(self, d: dict):
        """Load weights saved by either package (keys s{si}c{ci}w{li})."""
        self._ylo, self._yhi = float(d["ylo"]), float(d["yhi"])
        self.log_target = bool(d["log_target"])
        n_layers = len([k for k in d if k.startswith("s0c0w")])
        self.stages = [[MLP.from_arrays(
            [(d[f"s{si}c{ci}w{li}"], d[f"s{si}c{ci}b{li}"])
             for li in range(n_layers)], self.device)
            for ci in range(n)] for si, n in enumerate(self.stage_sizes)]
        self.widths = tuple(int(d[f"s0c0w{li}"].shape[1])
                            for li in range(n_layers - 1))
        self._device_fn = None
