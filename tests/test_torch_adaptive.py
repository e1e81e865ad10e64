"""Adaptive schemes end to end in the port against the reference.

* ``chunk_importance`` and ``stochastic_batch`` through ``plan()`` /
  ``execute()`` on a streamed dense corpus, every solver, and on a CSR
  corpus: the same batches are drawn (the Scheme stream is the reference's,
  bit for bit), so the trajectories agree at rtol 1e-4 on ``w`` and 1e-5 on
  the objective trace — float32 sums in another order over 3 epochs.  The
  sampler state's integers are equal; chunk importance's learned scores
  (float64 EMAs of block losses at slightly different ``w``) agree at
  rtol 1e-4.
* The weighted engine's step against the reference's ``batch_step(...,
  weight=)`` (rtol 1e-6, one float32 step).
* The planner's rejections and decisions (``tests/test_schemes.py``
  355-395), and the crash-resume contract: 2 epochs + checkpoint +
  ``resume_from`` + 2 epochs == 4 uninterrupted epochs, bitwise.
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import erm as jerm
from repro.core import experiment as jx
from repro.core import schemes as jsch
from repro.core import solvers as jsol
from repro.data import dataset as jds
from repro.data import sparse as jsp
from repro_torch.api import (CheckpointPolicy, DataSource, ExperimentSpec,
                             PlanError, execute, plan, resume_from)
from repro_torch.core import erm as term
from repro_torch.core import schemes
from repro_torch.core import solvers as tsol

ROWS, FEATS, B = 600, 12, 100
SCHEMES = {"chunk_importance": (jsch.ChunkImportance, schemes.ChunkImportance),
           "stochastic_batch": (jsch.StochasticBatch, schemes.StochasticBatch)}


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("adaptive") / "dense.bin"
    jds.synth_erm_corpus(path, rows=ROWS, features=FEATS, seed=3)
    return path


@pytest.fixture(scope="module")
def csr_corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("adaptive") / "c.csr"
    jsp.synth_sparse_classification(path, rows=ROWS, features=80,
                                    density=0.1, seed=4)
    return path


def _both(path, scheme, **kw):
    kw.setdefault("batch_size", B)
    kw.setdefault("seed", 11)
    kw.setdefault("step_size", 0.05)
    kw.setdefault("epochs", 3)
    js, ts = SCHEMES[scheme]
    jr = jx.execute(jx.plan(jx.ExperimentSpec(jx.DataSource.corpus(path),
                                              scheme=js(), **kw)))
    tp = plan(ExperimentSpec(DataSource.corpus(path), scheme=ts(), **kw),
              device="cpu")
    return jr, tp, execute(tp)


def _same_sampler_state(t, j):
    assert set(t) == set(j)
    for k, v in j.items():
        if isinstance(v, list) and v and isinstance(v[0], float):
            np.testing.assert_allclose(t[k], v, rtol=1e-4)
        else:
            assert t[k] == v, k


@pytest.mark.parametrize("solver", ["mbsgd", "sag", "saga", "svrg", "saag2"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_streamed_run_matches_reference(corpus, scheme, solver):
    jr, tp, tr = _both(corpus, scheme, solver=solver, placement="streamed")
    assert tp.backend == "streamed-eager"
    np.testing.assert_allclose(tr.w, jr.w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tr.history, jr.history, rtol=1e-5)
    _same_sampler_state(tr.sampler_state, jr.sampler_state)
    assert tr.stats.bytes_read == jr.stats.bytes_read
    assert tr.stats.batches == jr.stats.batches == 3 * tp.num_batches


@pytest.mark.parametrize("solver", ["saga", "svrg"])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_csr_run_matches_reference(csr_corpus, scheme, solver):
    jr, tp, tr = _both(csr_corpus, scheme, solver=solver, step_size=0.5)
    assert tp.backend == "sparse-csr"
    np.testing.assert_allclose(tr.w, jr.w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tr.history, jr.history, rtol=1e-5)
    _same_sampler_state(tr.sampler_state, jr.sampler_state)
    assert tr.stats.bytes_read == jr.stats.bytes_read


@pytest.mark.parametrize("solver", ["mbsgd", "saga", "svrg", "saag2"])
@pytest.mark.parametrize("weight", [0.5, 1.0, 3.25])
def test_weighted_step_matches_reference(solver, weight):
    rng = np.random.default_rng(5)
    X = rng.normal(size=(8, 6)).astype(np.float32)
    y = np.where(rng.uniform(size=8) < 0.5, 1.0, -1.0).astype(np.float32)
    st = {k: rng.normal(size=s).astype(np.float32) for k, s in
          (("w", 6), ("table", (3, 6)), ("table_mean", 6), ("snapshot", 6),
           ("snapshot_grad", 6))}
    jcfg = jsol.SolverConfig(solver=solver, step_size=0.1)
    tcfg = tsol.SolverConfig(solver=solver, step_size=0.1)
    jp, tp = jerm.ERMProblem(reg=1e-3), term.ERMProblem(reg=1e-3)
    jn = jsol.batch_step(jp, jcfg, jsol.SolverState(
        **{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(X),
        jnp.asarray(y), 1, weight=jnp.float32(weight))
    tn = tsol.batch_step(tp, tcfg, tsol.state_from_numpy(st, "cpu"),
                         torch.from_numpy(X), torch.from_numpy(y), 1,
                         weight=torch.tensor(weight))
    np.testing.assert_allclose(tn.w.numpy(), np.asarray(jn.w), rtol=1e-6,
                               atol=1e-7)
    if weight == 1.0:       # weight 1 is the uniform step
        un = tsol.batch_step(tp, tcfg, tsol.state_from_numpy(st, "cpu"),
                             torch.from_numpy(X), torch.from_numpy(y), 1)
        assert torch.equal(un.w, tn.w)


@pytest.mark.parametrize("scheme", [schemes.ChunkImportance(),
                                    schemes.StochasticBatch(),
                                    schemes.ChunkImportance(ema=0.7,
                                                            floor=0.2)])
def test_adaptive_checkpoint_resume_is_bit_identical(corpus, tmp_path,
                                                     scheme):
    """2 epochs + checkpoint + resume_from (the no-spec crash path, scheme
    params rebuilt from the fingerprint) + 2 epochs == 4 uninterrupted
    epochs, learning state (scores / cursor) included."""
    kw = dict(solver="saga", scheme=scheme, batch_size=B, seed=11,
              step_size=0.05, placement="streamed", epochs=4)
    full = execute(plan(ExperimentSpec(DataSource.corpus(corpus), **kw),
                        device="cpu"))
    ck = tmp_path / "ck"
    execute(plan(ExperimentSpec(DataSource.corpus(corpus),
                                checkpoint=CheckpointPolicy(ck, every=1),
                                **kw), device="cpu"), epochs=2)
    restored = resume_from(ck, device="cpu")
    assert restored.plan.scheme_obj == scheme   # params survived the crash
    r = execute(restored.plan, resume=restored, epochs=2)
    np.testing.assert_array_equal(full.w, r.w)
    np.testing.assert_array_equal(full.history, r.history)
    assert r.sampler_state == full.sampler_state


def test_adaptive_plans_streamed_with_read_ahead_off(corpus):
    p = plan(ExperimentSpec(DataSource.corpus(corpus),
                            scheme=schemes.ChunkImportance(), batch_size=B,
                            step_size=0.05), device="cpu")
    assert p.backend == "streamed-eager" and p.placement == "streamed"
    assert any("read-ahead is disabled" in w for w in p.why)
    jp = jx.plan(jx.ExperimentSpec(jx.DataSource.corpus(corpus),
                                   scheme=jsch.ChunkImportance(),
                                   batch_size=B, step_size=0.05))
    assert (p.backend, p.placement, p.kernel, p.chunk) == \
        (jp.backend, jp.placement, jp.kernel, jp.chunk)


def test_plan_rejects_adaptive_line_search_and_resident(corpus):
    src = DataSource.corpus(corpus)

    def plan_(**kw):
        return plan(ExperimentSpec(data=src, batch_size=100, **kw),
                    device="cpu")
    with pytest.raises(PlanError, match="importance-weighted"):
        plan_(scheme=schemes.ChunkImportance(), step_mode="line_search")
    with pytest.raises(PlanError, match="resident"):
        plan_(scheme=schemes.StochasticBatch(), placement="resident",
              step_size=0.05)
    with pytest.raises(PlanError, match="streamed engine"):
        plan_(scheme=schemes.StochasticBatch(), kernel="fused",
              step_size=0.05)
    with pytest.raises(PlanError):
        plan_(scheme="sorted", step_size=0.05)
    with pytest.raises(PlanError, match="ema"):
        plan_(scheme=schemes.ChunkImportance(ema=2.0), step_size=0.05)
    rng = np.random.default_rng(0)
    X = rng.normal(size=(200, 4)).astype(np.float32)
    with pytest.raises(PlanError, match="streamed corpus"):
        plan(ExperimentSpec(DataSource.arrays(X, np.ones(200, np.float32)),
                            scheme=schemes.ChunkImportance(), batch_size=50,
                            step_size=0.05), device="cpu")


@pytest.mark.parametrize("over", [
    dict(step_mode="line_search"), dict(placement="resident"),
    dict(kernel="fused", placement="resident")])
@pytest.mark.parametrize("scheme", sorted(SCHEMES))
def test_same_adaptive_rejections_as_reference(corpus, scheme, over):
    js, ts = SCHEMES[scheme]
    with pytest.raises(jx.PlanError):
        jx.plan(jx.ExperimentSpec(jx.DataSource.corpus(corpus), scheme=js(),
                                  batch_size=B, **over))
    with pytest.raises(PlanError):
        plan(ExperimentSpec(DataSource.corpus(corpus), scheme=ts(),
                            batch_size=B, **over), device="cpu")


def test_plan_serialization_carries_scheme_params(corpus):
    r = execute(plan(ExperimentSpec(DataSource.corpus(corpus),
                                    scheme=schemes.ChunkImportance(ema=0.7),
                                    batch_size=B, seed=11, step_size=0.05,
                                    epochs=1), device="cpu"))
    d = json.loads(json.dumps(r.to_json()))
    assert d["plan"]["scheme"] == "chunk_importance"
    assert d["plan"]["scheme_params"]["ema"] == 0.7
    assert "chunk_importance" in r.plan.describe()
    assert "'ema': 0.7" in r.plan.describe()
