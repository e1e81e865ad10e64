"""The fused kernels' plain PyTorch versions (what a CPU tensor runs, and
what the card check holds the CUDA kernels against) against the reference
Pallas kernels in interpret mode, as ``tests/test_fused_erm.py`` runs them.

Tolerance rtol 1e-5, atol 1e-6: float32 on both sides, summed in another
order.  The CUDA kernels themselves run only on the card; ``chip_smoke.py``
holds them against these plain versions there."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import fused_erm as jfe
from repro_torch.core.erm import ERMProblem
from repro_torch.kernels import fused_erm as tfe

RTOL, ATOL = 1e-5, 1e-6
L, N, B = 103, 12, 10          # 103 % 10 != 0: the trailing block clamps
IDX = np.array([5, 99, 0, 102, 7, 7, 50, 31, 2, 88], np.int32)  # duplicates


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(1)
    X = rng.normal(size=(L, N)).astype(np.float32)
    y = np.where(rng.uniform(size=L) < 0.5, 1.0, -1.0).astype(np.float32)
    w = (rng.normal(size=N) * 0.3).astype(np.float32)
    return X, y, w


def _t(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.mark.parametrize("loss", tfe.LOSSES)
@pytest.mark.parametrize("start", [-5, 0, 30, L - B, L - B + 7])
def test_block_kernels_match_reference(data, loss, start):
    X, y, w = data
    ref_g = jfe.fused_grad_block(jnp.asarray(X), jnp.asarray(y),
                                 jnp.asarray(w), jnp.asarray(start),
                                 loss=loss, batch_size=B, interpret=True)
    ref_z = jfe.fused_margins_block(jnp.asarray(X), jnp.asarray(w),
                                    jnp.asarray(start), batch_size=B,
                                    interpret=True)
    tX, ty, tw = _t(X, y, w)
    for s in (start, torch.tensor(start, dtype=torch.int32)):
        _close(tfe._grad_block_plain(tX, ty, tw, s, B, loss), ref_g)
        _close(tfe.fused_grad_block(tX, ty, tw, s, loss=loss, batch_size=B),
               ref_g)
        _close(tfe._margins_block_plain(tX, tw, s, B), ref_z)
        _close(tfe.fused_margins_block(tX, tw, s, batch_size=B), ref_z)


@pytest.mark.parametrize("loss", tfe.LOSSES)
def test_rows_kernels_match_reference(data, loss):
    X, y, w = data
    ref_g = jfe.fused_grad_rows(jnp.asarray(X), jnp.asarray(y),
                                jnp.asarray(w), jnp.asarray(IDX), loss=loss,
                                interpret=True)
    ref_z = jfe.fused_margins_rows(jnp.asarray(X), jnp.asarray(w),
                                   jnp.asarray(IDX), interpret=True)
    tX, ty, tw, ti = _t(X, y, w, IDX)
    _close(tfe._grad_rows_plain(tX, ty, tw, ti, loss), ref_g)
    _close(tfe.fused_grad_rows(tX, ty, tw, ti, loss=loss), ref_g)
    _close(tfe._margins_rows_plain(tX, tw, ti), ref_z)
    _close(tfe.fused_margins_rows(tX, tw, ti), ref_z)


@pytest.mark.parametrize("loss", tfe.LOSSES)
@pytest.mark.parametrize("kw", [dict(start=L - B + 3), dict(idx=IDX)],
                         ids=["block", "rows"])
def test_batch_wrappers_match_reference(data, loss, kw):
    X, y, w = data
    jkw = {k: jnp.asarray(v) for k, v in kw.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in kw.items()}
    if "start" in kw:
        jkw["batch_size"] = tkw["batch_size"] = B
    from repro.core.erm import ERMProblem as JProblem
    jp, tp = JProblem(loss=loss, reg=1e-3), ERMProblem(loss=loss, reg=1e-3)
    jX, jy, jw = map(jnp.asarray, (X, y, w))
    tX, ty, tw = _t(X, y, w)
    _close(tfe.fused_batch_grad(tp, tX, ty, tw, **tkw),
           jfe.fused_batch_grad(jp, jX, jy, jw, interpret=True, **jkw))
    _close(tfe.fused_batch_objective(tp, tX, ty, tw, **tkw),
           jfe.fused_batch_objective(jp, jX, jy, jw, interpret=True, **jkw))
    np.testing.assert_array_equal(
        tfe.fused_batch_labels(ty, **tkw).numpy(),
        np.asarray(jfe.fused_batch_labels(jy, **jkw)))


def test_wrapper_argument_errors(data):
    X, y, w = data
    tX, ty, tw, ti = _t(X, y, w, IDX)
    p = ERMProblem()
    with pytest.raises(ValueError, match="exactly one"):
        tfe.fused_batch_grad_data(p, tX, ty, tw)
    with pytest.raises(ValueError, match="exactly one"):
        tfe.fused_batch_margins(tX, tw, start=0, idx=ti, batch_size=B)
    with pytest.raises(ValueError, match="batch_size"):
        tfe.fused_batch_margins(tX, tw, start=0)
    with pytest.raises(ValueError, match="> rows"):
        tfe.fused_margins_block(tX, tw, 0, batch_size=L + 1)
    with pytest.raises(TypeError, match="float32"):
        tfe.fused_grad_block(tX.double(), ty, tw, 0, loss="logistic",
                             batch_size=B)
    with pytest.raises(TypeError, match="int32"):
        tfe.fused_margins_rows(tX, tw, ti.long())
    with pytest.raises(ValueError, match="contiguous"):
        tfe.fused_margins_rows(tX.t().contiguous().t(), tw, ti)
    with pytest.raises(ValueError, match="features"):
        tfe.fused_margins_rows(tX, tw[:-1], ti)
    with pytest.raises(ValueError, match="rows"):
        tfe.fused_grad_rows(tX, ty[:-1], tw, ti, loss="logistic")
    with pytest.raises(ValueError, match="unknown loss"):
        tfe.fused_grad_rows(tX, ty, tw, ti, loss="hinge")
    with pytest.raises(TypeError, match="int32"):
        tfe.fused_grad_block(tX, ty, tw, torch.tensor(0), loss="logistic",
                             batch_size=B)


def test_cpu_tensors_run_the_plain_version_without_launching(data):
    X, y, w = data
    tX, ty, tw, ti = _t(X, y, w, IDX)
    before = dict(tfe.LAUNCHES)
    tfe.fused_grad_block(tX, ty, tw, 3, loss="square", batch_size=B)
    tfe.fused_grad_rows(tX, ty, tw, ti, loss="square")
    tfe.fused_margins_block(tX, tw, 3, batch_size=B)
    tfe.fused_margins_rows(tX, tw, ti)
    assert tfe.LAUNCHES == before
