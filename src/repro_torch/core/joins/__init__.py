"""Join-method registry. Every method implements:

    __init__(R, metric, **params)       # build the index on R
    query_counts(Q, eps) -> int32 [q]   # found-neighbor counts per query

plus `.exact` (bool) and `.name`. The port carries the naive join;
grid / lsh / kmeanstree / ivfpq / learned are not ported yet.
"""
from repro_torch.core.joins.naive import NaiveJoin

JOINS = {
    "naive": NaiveJoin,
}
NOT_PORTED = ("grid", "lsh", "kmeanstree", "ivfpq", "learned")


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


__all__ = ["JOINS", "make_join", "NaiveJoin"]
