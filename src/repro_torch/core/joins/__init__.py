"""Join-method registry. Every method implements:

    __init__(R, metric, **params)       # build the index on R
    query_counts(Q, eps) -> int32 [q]   # found-neighbor counts per query

plus `.exact` (bool) and `.name`. The approximate methods also expose
`candidates(Q) -> int32 [q, C]` (-1 padded) and `device_probe(eps)`. The
port carries naive, lsh and ivfpq; grid / kmeanstree / learned are not
ported yet.
"""
from repro_torch.core.joins.ivfpq import IVFPQJoin
from repro_torch.core.joins.lsh import LSHJoin
from repro_torch.core.joins.naive import NaiveJoin

JOINS = {
    "naive": NaiveJoin,
    "lsh": LSHJoin,
    "ivfpq": IVFPQJoin,
}
NOT_PORTED = ("grid", "kmeanstree", "learned")


def make_join(name: str, R, metric: str, **params):
    """Construct a registry join method over R."""
    if name in NOT_PORTED:
        raise ValueError(f"join {name!r} is not ported yet; ported: "
                         f"{sorted(JOINS)}")
    try:
        cls = JOINS[name]
    except KeyError:
        raise KeyError(f"unknown join {name!r}; have {sorted(JOINS)}") from None
    return cls(R, metric, **params)


def load_jax_index(name: str, R, metric: str, arrays: dict, **params):
    """The port's `LSHJoin` / `IVFPQJoin` over R with the index state of a
    JAX searcher, given as numpy arrays: `proj`, `bias`, `salt`,
    `tables`, `expand` (or None), `n_buckets`, `cap` for "lsh";
    `centroids`, `lists`, `codes`, `codebooks` for "ivfpq". `params` are
    the probe knobs (n_probes / W, n_probe / n_candidates) and `device`.
    With it both packages probe the same tables."""
    cls = {"lsh": LSHJoin, "ivfpq": IVFPQJoin}.get(name)
    if cls is None:
        raise ValueError(f"load_jax_index({name!r}): expected 'lsh' or "
                         "'ivfpq'")
    return cls.from_arrays(R, metric, arrays, **params)


__all__ = ["JOINS", "make_join", "load_jax_index", "NaiveJoin", "LSHJoin",
           "IVFPQJoin"]
