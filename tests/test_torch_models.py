"""PyTorch port, estimators: JAX weights moved across with
`load_jax_state` give the same predictions (nn and rmi; f32 tolerance
|a - b| <= 1e-5 + 1e-5 |b|), state dicts round-trip under the JAX npz
keys, and from the same initial weights and the same numpy batch order
the port's fit ends within 1% of the JAX fit's final loss.

An RMI prediction may differ beyond the tolerance only for a row whose
stage prediction z * n_children lies within 1e-4 of an integer: there a
float difference in the last bits may route it to the neighbouring
child."""
import numpy as np
import pytest
import torch

from repro.models.mlp import MLPEstimator as JaxMLP
from repro.models.rmi import RMIEstimator as JaxRMI
from repro_torch.kernels import ops
from repro_torch.models import MLPEstimator, RMIEstimator, load_jax_state
from torch_parity import unit  # noqa: F401  (sets the test thread count)

TOL = dict(rtol=1e-5, atol=1e-5)
WIDTHS = (32, 16)


def _data(seed, n, din):
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n, din)).astype(np.float32)
    y = np.floor(np.exp(2.0 + X[:, 0] + 0.5 * X[:, 1])).astype(np.float32)
    return X, y


def _near_route_boundary(est: RMIEstimator, X: np.ndarray, tol=1e-4):
    """Rows whose routing input z * n_children is within tol of an integer
    at some stage."""
    params = est._params()
    Xt = torch.from_numpy(X)
    pred = ops.mlp_forward(params[0][0], Xt)
    near = torch.zeros(len(X), dtype=torch.bool)
    for si in range(1, len(params)):
        n = len(params[si])
        z = (pred - est._ylo) / max(est._yhi - est._ylo, 1e-9) * n
        near |= (z - torch.round(z)).abs() <= tol
        route = est._route_ids(pred, n)
        kids = torch.stack([ops.mlp_forward(p, Xt) for p in params[si]], 1)
        pred = torch.gather(kids, 1, route[:, None].long())[:, 0]
    return near.numpy()


def test_nn_transplant_predict():
    X, _ = _data(0, 60, 17)
    jest = JaxMLP(17, WIDTHS, seed=1)
    est = load_jax_state("nn", jest.state_dict(), device="cpu")
    assert est.widths == WIDTHS and est.din == 17
    got = est.predict(X)
    np.testing.assert_allclose(got, jest.predict(X), **TOL)
    np.testing.assert_allclose(got, jest.predict(X, backend="pallas"), **TOL)


def test_rmi_transplant_predict():
    X, y = _data(1, 300, 17)
    jest = JaxRMI(17, (1, 2, 4), WIDTHS, epochs=1, batch_size=64, seed=2)
    jest.fit(X, y)                          # sets the routing range
    est = load_jax_state("rmi", jest.state_dict(), device="cpu")
    assert est.stage_sizes == (1, 2, 4) and est.widths == WIDTHS
    assert (est._ylo, est._yhi) == (jest._ylo, jest._yhi)
    got, want = est.predict(X), jest.predict(X)
    bad = ~np.isclose(got, want, **TOL)
    assert not (bad & ~_near_route_boundary(est, X)).any(), np.nonzero(bad)
    # the device predict fn (what the engine serves) is the same function
    params, fn = est.device_predict_fn()
    with torch.no_grad():
        dev = fn(params, torch.from_numpy(X)).numpy()
    np.testing.assert_array_equal(dev, got)


@pytest.mark.parametrize("kind", ["nn", "rmi"])
def test_state_dict_roundtrip_under_jax_keys(tmp_path, kind):
    if kind == "nn":
        est = MLPEstimator(9, WIDTHS, device="cpu", seed=4)
        jax_keys = set(JaxMLP(9, WIDTHS).state_dict())
    else:
        est = RMIEstimator(9, (1, 2), WIDTHS, device="cpu", seed=4)
        est._ylo, est._yhi = 0.5, 3.0
        jax_keys = set(JaxRMI(9, (1, 2), WIDTHS).state_dict())
    state = est.state_dict()
    assert set(state) == jax_keys
    np.savez(tmp_path / "est.npz", **state)
    with np.load(tmp_path / "est.npz") as z:
        back = load_jax_state(kind, dict(z), device="cpu")
    X, _ = _data(5, 40, 9)
    np.testing.assert_array_equal(back.predict(X), est.predict(X))
    for k, v in back.state_dict().items():
        np.testing.assert_array_equal(v, state[k])


def test_fit_loss_within_band_of_jax():
    """Same initial weights (moved across), same numpy permutation per
    epoch, Adam(0.9, 0.999, 1e-8): after 2 epochs the final minibatch
    loss is within 1% of the JAX trainer's."""
    X, y = _data(6, 640, 17)
    jest = JaxMLP(17, WIDTHS, epochs=2, batch_size=64, seed=3, lr=1e-3)
    est = load_jax_state("nn", jest.state_dict(), device="cpu")
    est.epochs, est.batch_size, est.seed, est.lr = 2, 64, 3, 1e-3
    j_loss = jest.fit(X, y)
    t_loss = est.fit(X, y)
    assert np.isfinite(t_loss) and abs(t_loss - j_loss) <= 0.01 * abs(j_loss), \
        (t_loss, j_loss)
    np.testing.assert_allclose(est.predict(X), jest.predict(X), rtol=1e-2,
                               atol=1e-2)
