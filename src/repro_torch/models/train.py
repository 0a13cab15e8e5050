"""Minibatch trainer shared by the port's regressors (plain autograd; the
reference trains through XLA, not through a kernel)."""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from repro_torch.utils import set_fp32_precision


def fit_regressor(model: nn.Module, X, y, *, weights: Optional[np.ndarray] = None,
                  lr: float = 1e-3, epochs: int = 30, batch_size: int = 512,
                  seed: int = 0) -> float:
    """Weighted-MSE Adam fit of model(X) -> y in place; returns the last
    minibatch loss.

    Matches `repro/models/train.py`: Adam with b1 0.9, b2 0.999, eps 1e-8;
    n // batch_size minibatches per epoch (the remainder dropped), drawn
    in the order of numpy `default_rng(seed).permutation(n)` each epoch,
    so both packages see the same batches. `weights` (0/1 or soft)
    implements the masked-subset training of the RMI stages. X, y and
    weights move to the model's device once."""
    set_fp32_precision()
    dev = next(model.parameters()).device
    X = torch.as_tensor(X, dtype=torch.float32, device=dev)
    y = torch.as_tensor(y, dtype=torch.float32, device=dev)
    n = X.shape[0]
    w = (torch.ones((n,), dtype=torch.float32, device=dev) if weights is None
         else torch.as_tensor(weights, dtype=torch.float32, device=dev))
    batch_size = min(batch_size, n)
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    rng = np.random.default_rng(seed)
    nb = max(1, n // batch_size)
    loss = None
    for _ in range(epochs):
        perm = torch.as_tensor(rng.permutation(n), device=dev)
        for b in range(nb):
            idx = perm[b * batch_size:(b + 1) * batch_size]
            wb = w[idx]
            pred = model(X[idx])
            loss = (torch.sum(wb * (pred - y[idx]) ** 2)
                    / torch.clamp(torch.sum(wb), min=1.0))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
    return float("inf") if loss is None else float(loss.detach())
