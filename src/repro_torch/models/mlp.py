"""The paper's "NN" estimator: a plain ReLU MLP regressor.

Configuration follows §VI-A: 4 hidden layers of width 512/512/256/128
(one RMI sub-model). The weights keep the JAX package's [din, dout]
layout, so state dicts move between the packages without transposes.
Training runs the autograd forward (`MLP.forward`); inference —
`predict`, the filter program, XDT calibration — runs the fused kernel
through `kernels/ops.mlp_forward` (the CUDA kernel on the card).
"""
from __future__ import annotations

import math
import re

import numpy as np
import torch
from torch import nn

from repro_torch.kernels import ops
from repro_torch.models.train import fit_regressor
from repro_torch.utils import memoize_device_fn, resolve_device

PAPER_WIDTHS = (512, 512, 256, 128)


class MLP(nn.Module):
    """ReLU MLP din -> widths -> 1; weights [din, dout], biases [1, dout]."""

    def __init__(self, pairs):
        super().__init__()
        self.weights = nn.ParameterList([nn.Parameter(w) for w, _ in pairs])
        self.biases = nn.ParameterList([nn.Parameter(b) for _, b in pairs])

    @classmethod
    def init(cls, din: int, widths=PAPER_WIDTHS, *, generator: torch.Generator,
             device) -> "MLP":
        """He-normal weights drawn on the CPU from `generator` (the same
        numbers on every device), zero biases."""
        dims = (din,) + tuple(widths) + (1,)
        pairs = [((torch.randn(a, b, generator=generator)
                   * math.sqrt(2.0 / a)).to(device),
                  torch.zeros(1, b, device=device))
                 for a, b in zip(dims[:-1], dims[1:])]
        return cls(pairs)

    @classmethod
    def from_arrays(cls, pairs, device) -> "MLP":
        """An MLP holding copies of numpy (w, b) pairs."""
        return cls([(torch.tensor(np.asarray(w, np.float32), device=device),
                     torch.tensor(np.asarray(b, np.float32).reshape(1, -1),
                                  device=device)) for w, b in pairs])

    def layers(self) -> list:
        """The (w, b) pairs, detached: the kernel's inference params."""
        return [(w.detach(), b.detach())
                for w, b in zip(self.weights, self.biases)]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Autograd forward (training): f32 [n]."""
        h = x
        last = len(self.weights) - 1
        for i, (w, b) in enumerate(zip(self.weights, self.biases)):
            h = h @ w + b
            if i < last:
                h = torch.relu(h)
        return h[:, 0]

    def arrays(self) -> list:
        """(w, b) as numpy float32 arrays."""
        return [(w.detach().cpu().numpy(), b.detach().cpu().numpy())
                for w, b in zip(self.weights, self.biases)]


def regression_target(y: np.ndarray, log_target: bool) -> np.ndarray:
    """What the estimators regress: log1p(count), or the raw count."""
    y = y.astype(np.float32)
    return np.log1p(y) if log_target else y


def forward_counts(layers, X: torch.Tensor, log_target: bool,
                   backend: str = "auto") -> torch.Tensor:
    """Estimator inference in count space: the fused forward, then expm1
    when the model regresses log1p(count)."""
    raw = ops.mlp_forward(layers, X, backend=backend)
    return torch.expm1(raw) if log_target else raw


class MLPEstimator:
    """Estimator protocol: fit(X, y) / predict(X) in *count* space.

    Regresses log1p(count) (counts span 5 orders of magnitude), as the
    JAX package does; log_target=False for the raw behavior."""

    name = "nn"

    def __init__(self, din: int, widths=PAPER_WIDTHS, *, lr=1e-3, epochs=30,
                 batch_size=512, seed=0, log_target=True, device="cuda"):
        self.din, self.widths = din, tuple(widths)
        self.lr, self.epochs, self.batch_size = lr, epochs, batch_size
        self.seed, self.log_target = seed, log_target
        self.device = resolve_device(device)
        g = torch.Generator().manual_seed(seed)
        self.model = MLP.init(din, widths, generator=g, device=self.device)

    def fit(self, X: np.ndarray, y: np.ndarray, weights=None):
        """Fit on (point ++ eps) rows X [n, din] and counts y [n]."""
        return fit_regressor(self.model, X,
                             regression_target(y, self.log_target),
                             weights=weights,
                             lr=self.lr, epochs=self.epochs,
                             batch_size=self.batch_size, seed=self.seed)

    def predict(self, X, *, backend: str = "auto") -> np.ndarray:
        """Predicted counts, float32 [n], through the fused forward."""
        Xt = torch.as_tensor(np.asarray(X, np.float32), device=self.device)
        with torch.no_grad():
            out = forward_counts(self.model.layers(), Xt, self.log_target,
                                 backend)
        return out.cpu().numpy()

    def device_predict_fn(self):
        """(params, fn) for the engine's filter program: fn(params, X) maps
        a device tensor X [n, din] to predicted counts f32 [n] through the
        fused kernel. fn is memoized per estimator."""
        def build():
            log = self.log_target
            return lambda params, X: forward_counts(params, X, log)
        return self.model.layers(), memoize_device_fn(self, self.log_target,
                                                      build)

    # persistence -----------------------------------------------------------
    def state_dict(self) -> dict:
        """numpy state under the JAX package's npz keys."""
        out = {"kind": np.asarray("nn"), "din": np.asarray(self.din),
               "widths": np.asarray(self.widths),
               "log_target": np.asarray(self.log_target)}
        for i, (w, b) in enumerate(self.model.arrays()):
            out[f"w{i}"], out[f"b{i}"] = w, b
        return out

    def load_state_dict(self, d: dict):
        """Load weights saved by either package (keys w{i}/b{i})."""
        n = len([k for k in d if re.fullmatch(r"w\d+", k)])
        self.model = MLP.from_arrays([(d[f"w{i}"], d[f"b{i}"])
                                      for i in range(n)], self.device)
        self.widths = tuple(int(d[f"w{i}"].shape[1]) for i in range(n - 1))
        self.log_target = bool(d["log_target"])
        self._device_fn = None
