"""The sparse kernels' plain PyTorch versions (what a CPU tensor runs, and
what the card check holds the CUDA kernels against) against the reference
Pallas kernels in interpret mode, as ``tests/test_sparse_erm.py`` runs them.

Tolerance rtol 1e-5, atol 1e-6: float32 on both sides, summed in another
order (the reference densifies each row by a one-hot contraction).  The
CUDA kernels themselves run only on the card; ``chip_smoke.py`` holds them
against these plain versions there."""
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.erm import ERMProblem as JProblem
from repro.data import sparse as jsp
from repro.kernels import sparse_erm as jse
from repro_torch.core import samplers as tsam
from repro_torch.core.erm import LOSSES, ERMProblem as TProblem
from repro_torch.data import sparse as tsp
from repro_torch.kernels import sparse_erm as tse

RTOL, ATOL = 1e-5, 1e-6
ROWS, FEATS, B = 57, 48, 10          # 57 % 10 != 0: clamped last block
DENSITY = 0.15
IDX = np.array([5, 51, 0, 56, 7, 7, 30, 21, 2, 44], np.int32)  # duplicates


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=RTOL,
                               atol=ATOL)


@pytest.fixture(scope="module")
def path(tmp_path_factory):
    p = tmp_path_factory.mktemp("csr") / "kern.csr"
    jsp.synth_sparse_classification(p, rows=ROWS, features=FEATS,
                                    density=DENSITY, seed=11)
    return p


@pytest.fixture(scope="module")
def devs(path):
    return (jse.csr_to_device(jsp.open_csr_corpus(path)),
            tse.csr_to_device(tsp.open_csr_corpus(path), device="cpu"))


@pytest.fixture(scope="module")
def w():
    return (np.random.default_rng(9).normal(size=FEATS) * 0.3).astype(
        np.float32)


def _block_pair(jd, td, w, start, loss, b=B):
    """(reference, port wrapper, port plain) for the block kernels."""
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    kw = dict(kmax=jd.kmax, nnz=jd.nnz, interpret=True)
    ref_g = jse.sparse_grad_block(jd.vals, jd.cols, jd.indptr, jd.y, jw,
                                  jnp.asarray(start), loss=loss,
                                  batch_size=b, **kw)
    ref_z = jse.sparse_margins_block(jd.vals, jd.cols, jd.indptr, jw,
                                     jnp.asarray(start), batch_size=b, **kw)
    a = (td.vals, td.cols, td.indptr)
    for s in (start, torch.tensor(start, dtype=torch.int32)):
        _close(tse.sparse_grad_block(*a, td.y, tw, s, loss=loss,
                                     batch_size=b), ref_g)
        _close(tse._grad_block_plain(*a, td.y, tw, s, b, loss), ref_g)
        _close(tse.sparse_margins_block(*a, tw, s, batch_size=b), ref_z)
        _close(tse._margins_block_plain(*a, tw, s, b), ref_z)


def _rows_pair(jd, td, w, idx, loss):
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    kw = dict(kmax=jd.kmax, nnz=jd.nnz, interpret=True)
    ref_g = jse.sparse_grad_rows(jd.vals, jd.cols, jd.indptr, jd.y, jw,
                                 jnp.asarray(idx), loss=loss, **kw)
    ref_z = jse.sparse_margins_rows(jd.vals, jd.cols, jd.indptr, jw,
                                    jnp.asarray(idx), **kw)
    a = (td.vals, td.cols, td.indptr)
    ti = torch.from_numpy(np.asarray(idx, np.int32))
    _close(tse.sparse_grad_rows(*a, td.y, tw, ti, loss=loss), ref_g)
    _close(tse._grad_rows_plain(*a, td.y, tw, ti, loss), ref_g)
    _close(tse.sparse_margins_rows(*a, tw, ti), ref_z)
    _close(tse._margins_rows_plain(*a, tw, ti), ref_z)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("start", [-5, 0, 20, ROWS - B, ROWS - B + 7])
def test_block_kernels_match_reference(devs, w, loss, start):
    _block_pair(*devs, w, start, loss)


@pytest.mark.parametrize("loss", LOSSES)
def test_rows_kernels_match_reference(devs, w, loss):
    """RS ids with duplicates, and the trailing RS batch of an epoch, which
    wraps around to the front of the corpus."""
    _rows_pair(*devs, w, IDX, loss)
    wrap = tsam.epoch_schedule("random", 0, 0, ROWS, B)[-1]
    _rows_pair(*devs, w, wrap, loss)


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("scheme", tsam.SCHEMES)
def test_every_batch_of_an_epoch_matches_reference(devs, w, loss, scheme):
    sched = tsam.epoch_schedule(scheme, 4, 1, ROWS, B)
    for j in range(sched.shape[0]):
        if sched.ndim == 1:
            _block_pair(*devs, w, int(sched[j]), loss)
        else:
            _rows_pair(*devs, w, sched[j], loss)


@pytest.fixture(scope="module")
def odd_corpus(tmp_path_factory):
    """n = 2,048 (above one reference feature tile): an empty row, a row of
    1,100 nonzeros (above 1,024) and short rows with distinct columns."""
    rng = np.random.default_rng(5)
    n = 2048
    rows = [np.zeros(0, np.int64),
            np.sort(rng.choice(n, 1100, replace=False))]
    rows += [np.sort(rng.choice(n, int(rng.integers(1, 30)), replace=False))
             for _ in range(10)]
    lens = [len(r) for r in rows]
    p = tmp_path_factory.mktemp("odd") / "odd.csr"
    jsp.write_csr_corpus(
        p, indptr=np.concatenate([[0], np.cumsum(lens)]),
        indices=np.concatenate(rows),
        values=rng.normal(size=sum(lens)) * 0.1,
        labels=np.where(rng.uniform(size=len(rows)) < 0.5, 1.0, -1.0),
        features=n)
    wo = (rng.normal(size=n) * 0.3).astype(np.float32)
    return (jse.csr_to_device(jsp.open_csr_corpus(p), batch_size=4),
            tse.csr_to_device(tsp.open_csr_corpus(p), batch_size=4,
                              device="cpu"), wo)


@pytest.mark.parametrize("loss", LOSSES)
def test_empty_long_and_wide_rows_match_reference(odd_corpus, loss):
    jd, td, wo = odd_corpus
    for start in (0, 1, 8):
        _block_pair(jd, td, wo, start, loss, b=4)
    _rows_pair(jd, td, wo, np.array([1, 0, 0, 11, 1], np.int32), loss)
    z = tse.sparse_margins_rows(td.vals, td.cols, td.indptr,
                                torch.from_numpy(wo),
                                torch.zeros(1, dtype=torch.int32))
    assert z.item() == 0.0                       # the empty row


def test_repeated_column_adds(tmp_path):
    """A column repeated within a row adds its values, in the reference's
    kernels and in the port's plain versions alike (``densify`` would keep
    only the last value)."""
    jsp.write_csr_corpus(
        tmp_path / "rep.csr", indptr=np.array([0, 4, 5]),
        indices=np.array([1, 3, 3, 3, 0]),
        values=np.array([0.5, 1.0, -2.0, 0.25, 1.5]),
        labels=np.array([1.0, -1.0]), features=6)
    jd = jse.csr_to_device(jsp.open_csr_corpus(tmp_path / "rep.csr"))
    td = tse.csr_to_device(tsp.open_csr_corpus(tmp_path / "rep.csr"),
                           device="cpu")
    wr = np.arange(6, dtype=np.float32) * 0.1
    for loss in LOSSES:
        _block_pair(jd, td, wr, 0, loss, b=2)
    z = tse.sparse_margins_rows(td.vals, td.cols, td.indptr,
                                torch.from_numpy(wr),
                                torch.zeros(1, dtype=torch.int32))
    np.testing.assert_allclose(z.numpy(), [0.5 * 0.1 - 0.75 * 0.3],
                               rtol=1e-6)


# ------------------------------------------------- staging and wrappers ----

@pytest.mark.parametrize("batch_size", [None, B])
def test_csr_to_device_layout_matches_reference(path, batch_size):
    jd = jse.csr_to_device(jsp.open_csr_corpus(path), batch_size=batch_size)
    td = tse.csr_to_device(tsp.open_csr_corpus(path), batch_size=batch_size,
                           device="cpu")
    for f, dt in (("vals", torch.float32), ("cols", torch.int32),
                  ("indptr", torch.int32), ("y", torch.float32)):
        got = getattr(td, f)
        assert got.dtype == dt
        np.testing.assert_array_equal(got.numpy(), np.asarray(getattr(jd, f)))
    assert (td.rows, td.features, td.kmax, td.nnz) == \
        (jd.rows, jd.features, jd.kmax, jd.nnz)
    assert not td.vals[td.nnz:].any() and not td.cols[td.nnz:].any()


def test_csr_to_device_refusals(tmp_path):
    huge = types.SimpleNamespace(indptr=np.array([0, 2 ** 31]), kmax=1)
    for mod, kw in ((jse, {}), (tse, dict(device="cpu"))):
        with pytest.raises(ValueError, match="too large"):
            mod.csr_to_device(huge, **kw)
    # the port's gradient kernels add a repeated column as a run of
    # neighbours, so a row out of column order is refused at staging
    tsp.write_csr_corpus(tmp_path / "u.csr", indptr=np.array([0, 2, 4]),
                         indices=np.array([0, 5, 3, 1]),
                         values=np.ones(4), labels=np.ones(2), features=6)
    with pytest.raises(ValueError, match="ascending"):
        tse.csr_to_device(tsp.open_csr_corpus(tmp_path / "u.csr"),
                          device="cpu")
    tsp.write_csr_corpus(tmp_path / "o.csr", indptr=np.array([0, 2]),
                         indices=np.array([0, 6]), values=np.ones(2),
                         labels=np.ones(1), features=6)
    with pytest.raises(ValueError, match="column ids"):
        tse.csr_to_device(tsp.open_csr_corpus(tmp_path / "o.csr"),
                          device="cpu")


def test_csr_to_device_defaults_to_the_card(path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tse.csr_to_device(tsp.open_csr_corpus(path))


@pytest.mark.parametrize("loss", LOSSES)
@pytest.mark.parametrize("kind", ["block", "rows"])
def test_batch_wrappers_match_reference(devs, w, loss, kind):
    jd, td = devs
    if kind == "block":
        jkw, tkw = (dict(start=jnp.asarray(ROWS - B + 3), batch_size=B),
                    dict(start=ROWS - B + 3, batch_size=B))
    else:
        jkw, tkw = dict(idx=jnp.asarray(IDX)), dict(idx=torch.from_numpy(IDX))
    jp, tp = JProblem(loss=loss, reg=1e-2), TProblem(loss=loss, reg=1e-2)
    jw, tw = jnp.asarray(w), torch.from_numpy(w)
    _close(tse.sparse_batch_grad_data(tp, td, tw, **tkw),
           jse.sparse_batch_grad_data(jp, jd, jw, interpret=True, **jkw))
    _close(tse.sparse_batch_grad(tp, td, tw, **tkw),
           jse.sparse_batch_grad(jp, jd, jw, interpret=True, **jkw))
    _close(tse.sparse_batch_margins(td, tw, **tkw),
           jse.sparse_batch_margins(jd, jw, interpret=True, **jkw))
    _close(tse.sparse_batch_objective(tp, td, tw, **tkw),
           jse.sparse_batch_objective(jp, jd, jw, interpret=True, **jkw))


BAD_KW = [dict(), dict(start=0, idx=IDX), dict(start=0)]


@pytest.mark.parametrize("bad", BAD_KW, ids=["neither", "both", "no-b"])
@pytest.mark.parametrize("fn", ["sparse_batch_grad_data",
                                "sparse_batch_margins"])
def test_wrappers_raise_the_reference_errors(devs, w, fn, bad):
    jd, td = devs
    jkw = {k: jnp.asarray(v) for k, v in bad.items()}
    tkw = {k: (torch.from_numpy(v) if isinstance(v, np.ndarray) else v)
           for k, v in bad.items()}
    jargs = (jd, jnp.asarray(w)) if fn == "sparse_batch_margins" else (
        JProblem(), jd, jnp.asarray(w))
    targs = (td, torch.from_numpy(w)) if fn == "sparse_batch_margins" else (
        TProblem(), td, torch.from_numpy(w))
    with pytest.raises(ValueError) as je:
        getattr(jse, fn)(*jargs, **jkw)
    with pytest.raises(ValueError) as te:
        getattr(tse, fn)(*targs, **tkw)
    assert str(te.value) == str(je.value)


def test_kernel_argument_errors(devs, w):
    _, td = devs
    a = (td.vals, td.cols, td.indptr)
    tw, ti = torch.from_numpy(w), torch.from_numpy(IDX)
    with pytest.raises(ValueError, match="> rows"):
        tse.sparse_margins_block(*a, tw, 0, batch_size=ROWS + 1)
    with pytest.raises(TypeError, match="int32"):
        tse.sparse_margins_rows(td.vals, td.cols.long(), td.indptr, tw, ti)
    with pytest.raises(TypeError, match="int32"):
        tse.sparse_margins_rows(*a, tw, ti.long())
    with pytest.raises(TypeError, match="float32"):
        tse.sparse_grad_rows(*a, td.y, tw.double(), ti, loss="logistic")
    with pytest.raises(ValueError, match="entries"):
        tse.sparse_grad_rows(*a, td.y[:-1], tw, ti, loss="logistic")
    with pytest.raises(ValueError, match="entries"):
        tse.sparse_margins_rows(td.vals, td.cols[:-1], td.indptr, tw, ti)
    with pytest.raises(ValueError, match="unknown loss"):
        tse.sparse_grad_block(*a, td.y, tw, 0, loss="hinge", batch_size=B)


def test_cpu_tensors_run_the_plain_version_without_launching(devs, w):
    _, td = devs
    a = (td.vals, td.cols, td.indptr)
    tw, ti = torch.from_numpy(w), torch.from_numpy(IDX)
    before = dict(tse.LAUNCHES)
    tse.sparse_grad_block(*a, td.y, tw, 3, loss="square", batch_size=B)
    tse.sparse_grad_rows(*a, td.y, tw, ti, loss="square")
    tse.sparse_margins_block(*a, tw, 3, batch_size=B)
    tse.sparse_margins_rows(*a, tw, ti)
    assert tse.LAUNCHES == before
