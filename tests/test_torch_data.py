"""PyTorch port, data layer: `load_dataset` gives arrays identical to the
JAX package's, and `cardinality_table` (with and without exclude_self)
equals the JAX table up to boundary ties on the test_data.py /
test_core.py-sized corpora. The port caches under its own key prefix."""
import numpy as np
import pytest

import repro.utils as jutils
import repro_torch.utils as tutils
from repro.data import load_dataset as jax_load
from repro.data.groundtruth import cardinality_table as jax_table
from repro.data.groundtruth import eps_grid_for_metric as jax_grid
from repro_torch.data import cardinality_table, eps_grid_for_metric, load_dataset
from torch_parity import assert_counts_match


@pytest.fixture
def caches(tmp_path, monkeypatch):
    monkeypatch.setattr(jutils, "CACHE_DIR", str(tmp_path / "jax"))
    monkeypatch.setattr(tutils, "CACHE_DIR", str(tmp_path / "torch"))
    return tmp_path


@pytest.mark.parametrize("name,n,sample", [("glove", 600, 1), ("gist", 300, 1),
                                           ("sift", 500, 2)])
def test_load_dataset_identical(caches, name, n, sample):
    R, S, spec = load_dataset(name, n=n, seed=0, sample=sample)
    jR, jS, jspec = jax_load(name, n=n, seed=0, sample=sample)
    np.testing.assert_array_equal(R, jR)
    np.testing.assert_array_equal(S, jS)
    assert spec.dim == jspec.dim and spec.metric == jspec.metric
    R2, _, _ = load_dataset(name, n=n, seed=0, sample=sample)   # cache hit
    np.testing.assert_array_equal(R, R2)


@pytest.mark.parametrize("metric,m", [("cosine", 100), ("l2", 40)])
def test_eps_grid_identical(metric, m):
    np.testing.assert_array_equal(eps_grid_for_metric(metric, m),
                                  jax_grid(metric, m))


@pytest.mark.parametrize("exclude_self", [False, True])
@pytest.mark.parametrize("name,n,m", [("sift", 400, 10), ("sift", 2000, 40),
                                      ("glove", 600, 100)])
def test_cardinality_table_matches_jax(caches, name, n, m, exclude_self):
    R, _, spec = jax_load(name, n=n, seed=0)
    grid = jax_grid(spec.metric, m)
    want = jax_table(R, R, grid, spec.metric, backend="jnp",
                     exclude_self=exclude_self)
    got = cardinality_table(R, R, grid, spec.metric, device="cpu",
                            exclude_self=exclude_self)
    assert got.shape == (len(R), m) and got.dtype == np.int32
    assert_counts_match(got, want, R, R, grid, spec.metric)
    if exclude_self:
        assert (got >= 0).all()


def test_cardinality_table_cache_is_the_ports_own(caches):
    R, _, spec = load_dataset("sift", n=400, seed=0)
    grid = eps_grid_for_metric(spec.metric, 10)
    t1 = cardinality_table(R, R, grid, spec.metric, device="cpu",
                           cache_key=("t",), exclude_self=True)
    t2 = cardinality_table(R, R, grid, spec.metric, device="cpu",
                           cache_key=("t",), exclude_self=True)
    np.testing.assert_array_equal(t1, t2)
    files = sorted(p.name for p in (caches / "torch").iterdir())
    assert len(files) == 2                  # the corpus and the table
    assert tutils.cache_path("gt-torch-v1", 1) != jutils.cache_path("gt-v1", 1)
