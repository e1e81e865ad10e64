"""The port's CSR data layer against ``repro.data.sparse``.

* Format: the corpus files both generators, both writers and both LIBSVM
  ingests produce are byte-identical, and each package opens the other's.
* Pipeline: ``SparsePipeline`` yields bit-identical padded-ELL batches and
  books bit-identical ``AccessStats`` bytes for RS/CS/SS, across the
  wrap-around batch and the epoch boundary, on resume, with prefetch off
  and on.
* Host helpers: ``csr_full_grad``, ``csr_objective``, ``csr_block_losses``
  and ``csr_lipschitz`` are float64 numpy in both packages and agree bit
  for bit.
* ELL methods: the port's ``ell_*`` against the reference's at rtol 1e-5 /
  atol 1e-6 (float32 gathers and scatters summed in another order), and
  the ELL gradient gives the same bits twice.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.erm import ERMProblem as JProblem
from repro.data import pipeline as jpipe
from repro.data import sparse as jsp
from repro_torch.core import samplers as tsam
from repro_torch.core.erm import LOSSES, ERMProblem as TProblem
from repro_torch.data import pipeline as tpipe
from repro_torch.data import sparse as tsp

ROWS, FEATS, B = 67, 40, 10          # 67 % 10 != 0: wrap-around exercised
DENSITY = 0.12
FILES = ("indptr.bin", "indices.bin", "values.bin", "labels.bin",
         "meta.json")


def _same_files(a, b):
    for name in FILES:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("csr") / "synth.csr"
    jsp.synth_sparse_classification(path, rows=ROWS, features=FEATS,
                                    density=DENSITY, seed=3)
    return path


# ------------------------------------------------------------ format ----

@pytest.mark.parametrize("rows,features,density,seed,chunk_rows", [
    (ROWS, FEATS, DENSITY, 3, None), (57, 48, 0.15, 11, None),
    (300, 2048, 0.01, 5, None), (40, 6, 1.0, 0, None),
    (101, 64, 0.2, 1, 7)])
def test_generators_write_identical_files(tmp_path, rows, features, density,
                                          seed, chunk_rows):
    kw = dict(rows=rows, features=features, density=density, seed=seed,
              chunk_rows=chunk_rows)
    jm = jsp.synth_sparse_classification(tmp_path / "j", **kw)
    tm = tsp.synth_sparse_classification(tmp_path / "t", **kw)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    _same_files(tmp_path / "j", tmp_path / "t")


LIBSVM = {
    "one-based": ("# comment line\n+1 1:0.5 4:-2.0 7:1.5\n-1 3:1.0\n"
                  "1 7:0.25 2:4.0\n-1\n", {}),
    "zero-based": ("1 0:2.0 2:3.0\n-1 1:1.0\n",
                   dict(features=10, zero_based=True)),
    "explicit features": ("1 1:1.0 3:2.0\n-1 2:0.5\n", dict(features=8)),
    "repeated column": ("1 3:1.0 1:2.0 3:2.5\n-1 2:1.0 2:1.0\n", {}),
    "small chunks": ("".join(f"{(-1) ** i} {i % 5 + 1}:{i}.5 9:1\n"
                             for i in range(11)), dict(chunk_rows=2)),
}


@pytest.mark.parametrize("case", list(LIBSVM))
def test_ingest_libsvm_writes_identical_files(tmp_path, case):
    text, kw = LIBSVM[case]
    src = tmp_path / "d.libsvm"
    src.write_text(text)
    jm = jsp.ingest_libsvm(src, tmp_path / "j", **kw)
    tm = tsp.ingest_libsvm(src, tmp_path / "t", **kw)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    _same_files(tmp_path / "j", tmp_path / "t")


def test_ingest_libsvm_refuses_index_beyond_features(tmp_path):
    src = tmp_path / "bad.libsvm"
    src.write_text("1 5:1.0\n")
    for mod, out in ((jsp, "j"), (tsp, "t")):
        with pytest.raises(ValueError, match="feature index"):
            mod.ingest_libsvm(src, tmp_path / out, features=3)


def test_write_csr_corpus_identical(tmp_path):
    arrays = dict(indptr=np.array([0, 2, 2, 5], np.int64),
                  indices=np.array([1, 4, 0, 0, 3], np.int32),
                  values=np.array([1.5, -2.0, 0.5, 1.0, 3.0], np.float32),
                  labels=np.array([1, -1, 1], np.float32), features=6)
    jm = jsp.write_csr_corpus(tmp_path / "j", **arrays)
    tm = tsp.write_csr_corpus(tmp_path / "t", **arrays)
    assert dataclasses.asdict(tm) == dataclasses.asdict(jm)
    _same_files(tmp_path / "j", tmp_path / "t")


def _open_equal(tc, jc):
    assert dataclasses.asdict(tc.meta) == dataclasses.asdict(jc.meta)
    for f in ("indptr", "indices", "values", "labels"):
        np.testing.assert_array_equal(np.asarray(getattr(tc, f)),
                                      np.asarray(getattr(jc, f)))
    assert (tc.rows, tc.features, tc.nnz, tc.kmax, tc.density) == \
        (jc.rows, jc.features, jc.nnz, jc.kmax, jc.density)
    for lo, hi in ((0, None), (5, 12)):
        for a, b in zip(tc.densify(lo, hi), jc.densify(lo, hi)):
            np.testing.assert_array_equal(a, b)


def test_each_package_opens_the_others_corpus(tmp_path):
    kw = dict(rows=ROWS, features=FEATS, density=DENSITY, seed=9)
    jsp.synth_sparse_classification(tmp_path / "by_ref", **kw)
    tsp.synth_sparse_classification(tmp_path / "by_port", **kw)
    for d in ("by_ref", "by_port"):
        _open_equal(tsp.open_csr_corpus(tmp_path / d),
                    jsp.open_csr_corpus(tmp_path / d))


def test_open_rejects_dense_meta(tmp_path):
    d = tmp_path / "fake.csr"
    d.mkdir()
    (d / "meta.json").write_text('{"kind": "rows", "rows": 1, "row_dim": 2, '
                                 '"dtype": "float32"}')
    with pytest.raises(ValueError, match="not a CSR corpus"):
        tsp.open_csr_corpus(d)


def test_densify_assigns_repeated_columns_as_the_reference(tmp_path):
    """``densify`` keeps a repeated column's LAST value in both packages,
    while the ELL batch (and the kernels) add the values."""
    arrays = dict(indptr=np.array([0, 3, 4], np.int64),
                  indices=np.array([2, 2, 5, 1], np.int32),
                  values=np.array([1.0, 4.0, 2.0, 3.0], np.float32),
                  labels=np.array([1, -1], np.float32), features=6)
    tsp.write_csr_corpus(tmp_path / "r", **arrays)
    tc, jc = tsp.open_csr_corpus(tmp_path / "r"), jsp.open_csr_corpus(
        tmp_path / "r")
    X, _ = tc.densify()
    np.testing.assert_array_equal(X, jc.densify()[0])
    assert X[0, 2] == 4.0
    pipe = tsp.SparsePipeline(tpipe.PipelineConfig(
        corpus=tmp_path / "r", batch_size=2, sampling="cyclic", prefetch=0))
    batch = pipe.read_batch()
    w = torch.arange(6, dtype=torch.float32)
    z = TProblem().ell_margins(w, torch.from_numpy(batch.cols),
                               torch.from_numpy(batch.vals))
    assert z.tolist() == [(1.0 + 4.0) * 2 + 2.0 * 5, 3.0 * 1]


# ---------------------------------------------------------- pipeline ----

def _cfgs(path, scheme, prefetch=0, **kw):
    return (jpipe.PipelineConfig(corpus=path, batch_size=B, sampling=scheme,
                                 seed=0, prefetch=prefetch, **kw),
            tpipe.PipelineConfig(corpus=path, batch_size=B, sampling=scheme,
                                 seed=0, prefetch=prefetch, **kw))


def _same_batch(tb, jb):
    for f in ("cols", "vals", "y"):
        np.testing.assert_array_equal(getattr(tb, f), getattr(jb, f))
        assert getattr(tb, f).dtype == getattr(jb, f).dtype
    assert tb.nnz == jb.nnz


@pytest.mark.parametrize("scheme", tsam.SCHEMES)
def test_pipeline_batches_and_bytes_identical(corpus, scheme):
    jc, tc = _cfgs(corpus, scheme)
    jp, tp = jsp.SparsePipeline(jc), tsp.SparsePipeline(tc)
    for _ in range(9):   # crosses the wrap-around batch and epoch boundary
        _same_batch(tp.read_batch(), jp.read_batch())
    assert (tp.stats.batches, tp.stats.bytes_read) == \
        (jp.stats.batches, jp.stats.bytes_read)
    assert tp.state_dict() == jp.state_dict()
    assert tp.sampler_meta() == jp.sampler_meta()
    assert tp.kmax == jp.kmax


@pytest.mark.parametrize("scheme", tsam.SCHEMES)
def test_pipeline_resume_identical(corpus, scheme):
    jc, tc = _cfgs(corpus, scheme)
    ref = jsp.SparsePipeline(jc)
    want = [ref.read_batch() for _ in range(9)]
    for start in (4, 7):
        jp = jsp.SparsePipeline(jc, start_step=start)
        tp = tsp.SparsePipeline(tc, start_step=start)
        for k in range(start, 9):
            tb = tp.read_batch()
            _same_batch(tb, jp.read_batch())
            _same_batch(tb, want[k])
        assert tp.stats.bytes_read == jp.stats.bytes_read
        assert tp.state_dict() == jp.state_dict()


@pytest.mark.parametrize("scheme", tsam.SCHEMES)
def test_pipeline_prefetch_matches_sync(corpus, scheme):
    """With read-ahead, the consumed batches are the synchronous ones, and
    the bytes booked are those of exactly the batches the producer read."""
    jc, tc = _cfgs(corpus, scheme, prefetch=2)
    pre = tsp.SparsePipeline(tc)
    it = iter(pre)
    got = [next(it) for _ in range(8)]
    pre.close()
    sync = jsp.SparsePipeline(_cfgs(corpus, scheme)[0])
    want = [sync.read_batch() for _ in range(pre.stats.batches)]
    for tb, jb in zip(got, want):
        _same_batch(tb, jb)
    assert pre.stats.bytes_read == sync.stats.bytes_read


# ---------------------------------------------------- host helpers ----

@pytest.mark.parametrize("chunk", [13, 8192])
@pytest.mark.parametrize("loss", LOSSES)
def test_host_helpers_bit_identical(corpus, loss, chunk):
    tc, jc = tsp.open_csr_corpus(corpus), jsp.open_csr_corpus(corpus)
    tp, jp = TProblem(loss=loss, reg=1e-3), JProblem(loss=loss, reg=1e-3)
    w = (np.random.default_rng(1).normal(size=FEATS) * 0.3).astype(np.float32)
    for dto in (False, True):
        np.testing.assert_array_equal(
            tsp.csr_full_grad(tp, tc, w, data_term_only=dto, chunk=chunk),
            jsp.csr_full_grad(jp, jc, w, data_term_only=dto, chunk=chunk))
    assert tsp.csr_objective(tp, tc, w, chunk=chunk) == \
        jsp.csr_objective(jp, jc, w, chunk=chunk)
    tm, to = tsp.csr_block_losses(tp, tc, w, B, chunk=chunk)
    jm, jo = jsp.csr_block_losses(jp, jc, w, B, chunk=chunk)
    np.testing.assert_array_equal(tm, jm)
    assert to == jo
    assert tsp.csr_lipschitz(tp, tc, chunk=chunk) == \
        jsp.csr_lipschitz(jp, jc, chunk=chunk)


# ----------------------------------------------------- ELL methods ----

@pytest.fixture(scope="module")
def ell_chunk(corpus):
    """Six ELL batches from the pipeline (padding included) and w."""
    p = tsp.SparsePipeline(_cfgs(corpus, "random")[1])
    batches = [p.read_batch() for _ in range(6)]
    w = (np.random.default_rng(0).normal(size=FEATS) * 0.4).astype(
        np.float32)
    return batches, w


@pytest.mark.parametrize("loss", LOSSES)
def test_ell_methods_match_reference(ell_chunk, loss):
    batches, w = ell_chunk
    tp, jp = TProblem(loss=loss, reg=1e-3), JProblem(loss=loss, reg=1e-3)
    tw, jw = torch.from_numpy(w), jnp.asarray(w)
    for sb in batches:
        targs = tuple(torch.from_numpy(a) for a in (sb.cols, sb.vals, sb.y))
        jargs = tuple(jnp.asarray(a) for a in (sb.cols, sb.vals, sb.y))
        for name in ("ell_data_objective", "ell_batch_objective",
                     "ell_batch_grad_data"):
            np.testing.assert_allclose(
                getattr(tp, name)(tw, *targs).numpy(),
                np.asarray(getattr(jp, name)(jw, *jargs)),
                rtol=1e-5, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(
            tp.ell_margins(tw, *targs[:2]).numpy(),
            np.asarray(jp.ell_margins(jw, *jargs[:2])), rtol=1e-5, atol=1e-6)


def test_ell_grad_is_deterministic_and_scoped(ell_chunk):
    batches, w = ell_chunk
    sb = batches[0]
    args = tuple(torch.from_numpy(a) for a in (sb.cols, sb.vals, sb.y))
    before = torch.are_deterministic_algorithms_enabled()
    g1 = TProblem().ell_batch_grad_data(torch.from_numpy(w), *args)
    g2 = TProblem().ell_batch_grad_data(torch.from_numpy(w), *args)
    assert torch.equal(g1, g2)
    assert torch.are_deterministic_algorithms_enabled() == before
