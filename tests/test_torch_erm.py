"""Port ``repro_torch.core.erm`` against the reference ``repro.core.erm``:
losses, objectives, gradients and the Lipschitz bound on the same numpy
inputs.  Tolerance rtol 1e-5, atol 1e-6: both sides are float32, and the
port writes out the gradients the reference takes by autodiff, so sums run
in another order."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import erm as jerm
from repro_torch.core import erm as term

RTOL, ATOL = 1e-5, 1e-6
L, N, B = 97, 11, 16


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(L, N)).astype(np.float32)
    y = np.where(rng.uniform(size=L) < 0.5, 1.0, -1.0).astype(np.float32)
    w = (rng.normal(size=N) * 0.5).astype(np.float32)
    return X, y, w


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("loss", term.LOSSES)
def test_margin_losses_and_dloss(loss):
    # margins straddling every smooth-hinge branch (t <= 0, (0, 1), >= 1)
    z = np.linspace(-3.0, 3.0, 61).astype(np.float32)
    y = np.where(np.arange(61) % 2 == 0, 1.0, -1.0).astype(np.float32)
    ref = jerm._margin_losses(loss)(jnp.asarray(z), jnp.asarray(y))
    got = term._margin_losses(loss)(torch.from_numpy(z), torch.from_numpy(y))
    _close(got, ref)
    from repro.kernels.fused_erm import _dloss
    _close(term.dloss(loss, torch.from_numpy(z), torch.from_numpy(y)),
           _dloss(loss, jnp.asarray(z), jnp.asarray(y)))


@pytest.mark.parametrize("loss", term.LOSSES)
def test_objectives_and_gradients(data, loss):
    X, y, w = data
    jp, tp = jerm.ERMProblem(loss=loss, reg=1e-3), term.ERMProblem(loss=loss,
                                                                   reg=1e-3)
    jX, jy, jw = map(jnp.asarray, (X, y, w))
    tX, ty, tw = map(torch.from_numpy, (X, y, w))
    _close(tp.objective(tw, tX, ty), jp.objective(jw, jX, jy))
    _close(tp.full_grad(tw, tX, ty), jp.full_grad(jw, jX, jy))
    Xb, yb = X[:B], y[:B]
    jXb, jyb, tXb, tyb = jnp.asarray(Xb), jnp.asarray(yb), \
        torch.from_numpy(Xb), torch.from_numpy(yb)
    for name in ("data_objective", "batch_objective", "batch_grad",
                 "batch_grad_data"):
        _close(getattr(tp, name)(tw, tXb, tyb),
               getattr(jp, name)(jw, jXb, jyb))
    z = Xb @ w
    _close(tp.mean_margin_loss(torch.from_numpy(z), tyb),
           jp.mean_margin_loss(jnp.asarray(z), jyb))
    _close(tp.lipschitz(tX), jp.lipschitz(jX))


# non-negative starts only: lax.dynamic_slice counts a negative start from
# the end, while the fused kernels (and the port everywhere) clip it to 0 —
# tests/test_torch_fused_erm.py holds negative starts to the kernels
@pytest.mark.parametrize("start", [0, 40, L - B, L - B + 7, 10 * L])
def test_slice_batch_clamps_like_dynamic_slice(data, start):
    X, y, _ = data
    jXb, jyb = jerm.slice_batch(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(start), B)
    for s in (start, torch.tensor(start, dtype=torch.int32)):
        tXb, tyb = term.slice_batch(torch.from_numpy(X), torch.from_numpy(y),
                                    s, B)
        np.testing.assert_array_equal(tXb.numpy(), np.asarray(jXb))
        np.testing.assert_array_equal(tyb.numpy(), np.asarray(jyb))


def test_gather_batch_keeps_duplicates_and_order(data):
    X, y, _ = data
    idx = np.array([5, 96, 0, 5, 5, 50, 1], np.int32)
    jXb, jyb = jerm.gather_batch(jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(idx))
    tXb, tyb = term.gather_batch(torch.from_numpy(X), torch.from_numpy(y),
                                 torch.from_numpy(idx))
    np.testing.assert_array_equal(tXb.numpy(), np.asarray(jXb))
    np.testing.assert_array_equal(tyb.numpy(), np.asarray(jyb))
