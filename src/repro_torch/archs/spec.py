"""Parameter specs: shapes, logical axes and init rules of the LM stack's
parameters, materialized as real tensors. The port of `repro/archs/spec.py`
without the mesh helpers (`logical_to_mesh_axes`, `shardings_for`), which
wait for the multi-GPU topology.

Models define their parameters once as a nested dict of ParamSpecs, the
JAX pytree's layout, layers stacked on a leading axis.
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from repro_torch.utils import resolve_device


@dataclass(frozen=True)
class ParamSpec:
    shape: tuple
    logical: tuple                 # logical axis name per dim (None = replicated)
    dtype: torch.dtype = torch.float32
    init: str = "normal"           # "normal" | "zeros" | "ones" | "scaled"
    scale: float = 0.02


def is_spec(x) -> bool:
    return isinstance(x, ParamSpec)


def flatten(tree, prefix: str = "") -> list:
    """[(dotted path, leaf)] of a nested dict, keys in sorted order (the
    order in which jax.tree.flatten walks a dict)."""
    out = []
    for key in sorted(tree):
        path = f"{prefix}{key}"
        if isinstance(tree[key], dict):
            out += flatten(tree[key], path + ".")
        else:
            out.append((path, tree[key]))
    return out


def init_params(specs, generator: torch.Generator,
                device: "str | torch.device" = "cuda", dtype_override=None):
    """Materialize a ParamSpec tree into tensors on `device` (the card
    unless the caller asks for the CPU; without a GPU "cuda" raises),
    drawing from `generator` (which must live on the same device type).
    "scaled" leaves use 1/sqrt(prod(shape[:-1])) of the spec as given, the
    stacked layer axis included, as the JAX package does; the numbers
    differ from jax.random's."""
    device = resolve_device(device)

    def one(s: ParamSpec) -> torch.Tensor:
        dt = dtype_override or s.dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=device)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=device)
        scale = s.scale
        if s.init == "scaled":           # 1/sqrt(fan_in) output-proj style
            scale = 1.0 / np.sqrt(max(int(np.prod(s.shape[:-1])), 1))
        x = torch.randn(s.shape, generator=generator, dtype=torch.float32,
                        device=device)
        return (x * scale).to(dt)

    def walk(tree):
        return {k: walk(v) if isinstance(v, dict) else one(v)
                for k, v in tree.items()}
    return walk(specs)
