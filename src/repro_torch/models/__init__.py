"""Estimator registry — Xling is generic over anything satisfying:

    fit(X [n, d+1], y [n]) -> loss
    predict(X [n, d+1]) -> counts [n] (float)
    device_predict_fn() -> (params, fn)
    state_dict() / load_state_dict(d)

where X rows are (point ++ eps). The port carries the paper's "nn" and
"rmi" estimators; "selnet" and "linear" are not ported yet.
"""
from __future__ import annotations

import numpy as np

from repro_torch.models.mlp import MLPEstimator
from repro_torch.models.rmi import RMIEstimator

ESTIMATORS = {
    "nn": MLPEstimator,
    "rmi": RMIEstimator,
}
NOT_PORTED = ("selnet", "linear")


def _estimator_class(name: str):
    if name in NOT_PORTED:
        raise ValueError(f"estimator {name!r} is not ported yet; ported: "
                         f"{sorted(ESTIMATORS)}")
    try:
        return ESTIMATORS[name]
    except KeyError:
        raise KeyError(f"unknown estimator {name!r}; have {sorted(ESTIMATORS)}") from None


def make_estimator(name: str, din: int, **kwargs):
    """Construct a registry estimator for (point ++ eps) rows of width din."""
    return _estimator_class(name)(din, **kwargs)


def load_jax_state(est_name: str, state: dict, device="cuda"):
    """The port's estimator computing the same function as a JAX
    estimator whose `state_dict()` is `state` (npz keys w{i}/b{i} for
    "nn", s{si}c{ci}w{li}/b{li} plus ylo/yhi for "rmi", and log_target).
    Widths and stage sizes are read off the arrays."""
    cls = _estimator_class(est_name)
    state = {k: np.asarray(v) for k, v in state.items()}
    din = int(state["din"])
    if cls is MLPEstimator:
        n = len([k for k in state if k[0] == "w" and k[1:].isdigit()])
        widths = tuple(int(state[f"w{i}"].shape[1]) for i in range(n - 1))
        est = MLPEstimator(din, widths, device=device)
    else:
        n = len([k for k in state if k.startswith("s0c0w")])
        widths = tuple(int(state[f"s0c0w{i}"].shape[1]) for i in range(n - 1))
        est = RMIEstimator(din, tuple(int(s) for s in state["stage_sizes"]),
                           widths, device=device)
    est.load_state_dict(state)
    return est


__all__ = ["ESTIMATORS", "make_estimator", "load_jax_state", "MLPEstimator",
           "RMIEstimator"]
