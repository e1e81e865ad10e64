"""The ``sparse-csr`` backend of the port against the reference's.

* ``plan()`` on a CSR corpus makes the reference's decisions — backend,
  placement, kernel, chunk K from kmax, the step size 1/L from
  ``csr_lipschitz`` (rtol 1e-6; it is float64 on both sides), the solver
  config field by field — and raises PlanError where the reference does.
* The ELL solver step and the sparse chunked engine against the
  reference's from the same mid-run state, rtol 1e-5 / atol 1e-6: one step
  of float32 arithmetic in another summation order.
* ``execute`` trajectories: both read the same ELL batches (the pipelines
  draw the same Scheme stream) and refresh SVRG/SAAG-II snapshots with the
  same float64 host pass, so final w agrees at rtol 1e-4 / atol 1e-6 and
  the history at rtol 1e-4 — float32 rounding compounds over the epochs —
  with identical access accounting.
* ``resume=`` is bitwise within the port.
"""
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import experiment as jx
from repro.core import solvers as jsol
from repro.core.erm import ERMProblem as JProblem
from repro.data import sparse as jsp
from repro.obs import TracePolicy as JTracePolicy
from repro_torch.core import experiment as tx
from repro_torch.core import solvers as tsol
from repro_torch.core.erm import ERMProblem as TProblem
from repro_torch.data import pipeline as tpipe
from repro_torch.data import sparse as tsp
from repro_torch.obs import TracePolicy

ROWS, FEATS, B = 57, 48, 10          # 57 % 10 != 0: the trailing batch wraps
DENSITY = 0.15
CSR_WHY = "CSR corpus → streamed sparse engine"


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("csrexp") / "c.csr"
    jsp.synth_sparse_classification(path, rows=ROWS, features=FEATS,
                                    density=DENSITY, seed=11)
    return path


def _specs(path, traced=False, **kw):
    kw.setdefault("batch_size", B)
    jkw = dict(kw, trace=JTracePolicy()) if traced else kw
    tkw = dict(kw, trace=TracePolicy()) if traced else kw
    return (jx.ExperimentSpec(jx.DataSource.corpus(path), **jkw),
            tx.ExperimentSpec(tx.DataSource.corpus(path), **tkw))


# ------------------------------------------------------------- planner ----

GRID = list(itertools.product(
    ("mbsgd", "saga", "svrg"), ("random", "systematic"),
    ("constant", "line_search"),
    (dict(), dict(placement="streamed"), dict(kernel="eager"),
     dict(chunk=4), dict(resident_budget=10), dict(loss="square"))))


@pytest.mark.parametrize("solver,scheme,step_mode,over", GRID)
def test_plan_decisions_match_reference(corpus, solver, scheme, step_mode,
                                        over):
    js, ts = _specs(corpus, solver=solver, scheme=scheme,
                    step_mode=step_mode, **over)
    jp, tp = jx.plan(js), tx.plan(ts, device="cpu")
    for f in ("backend", "placement", "kernel", "chunk", "num_batches",
              "rows", "features", "corpus_bytes", "fmt", "kmax", "nnz"):
        assert getattr(tp, f) == getattr(jp, f), f
    assert tp.backend == tx.SPARSE_CSR and tp.cfg.sparse
    jcfg = jp.cfg._replace(step_size=0)._asdict()
    assert tp.cfg._replace(step_size=0)._asdict() == jcfg
    np.testing.assert_allclose(tp.cfg.step_size, jp.cfg.step_size,
                               rtol=1e-6)
    assert tp.why[0] == "device cpu" and CSR_WHY in tp.why
    assert CSR_WHY in jp.why and len(tp.why) == len(jp.why) + 1
    assert f"nnz={tp.nnz}, kmax={tp.kmax}" in tp.describe()


BAD = [dict(kernel="fused"), dict(kernel="fused", placement="resident"),
       dict(placement="resident"), dict(batch_size=ROWS + 1),
       dict(loss="hinge"), dict(step_mode="line_search", ls_shrink=1.0)]


@pytest.mark.parametrize("bad", BAD, ids=[str(b) for b in BAD])
def test_same_plan_errors(corpus, bad):
    js, ts = _specs(corpus, **bad)
    with pytest.raises(jx.PlanError) as je:
        jx.plan(js)
    with pytest.raises(tx.PlanError) as te:
        tx.plan(ts, device="cpu")
    if "kernel" in bad or "placement" in bad:
        assert str(te.value) == str(je.value)


@pytest.mark.parametrize("over,match", [
    (dict(mesh=object()), "item 12"),
    (dict(checkpoint=object()), "CheckpointPolicy")])
def test_not_ported_options_are_refused_for_csr(corpus, over, match):
    _, ts = _specs(corpus, **over)
    with pytest.raises(tx.PlanError, match=match):
        tx.plan(ts, device="cpu")


def test_plan_defaults_to_the_card(corpus, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, ts = _specs(corpus)
    with pytest.raises(tx.PlanError, match='device="cpu"'):
        tx.plan(ts)


# ------------------------------------------------ step and chunk engine ----

RULES = {"constant": dict(step_mode="constant", step_size=0.05),
         "ls-seq": dict(step_mode="line_search", ls_mode="sequential"),
         "ls-vec": dict(step_mode="line_search", ls_mode="vectorized")}


def _mid_run_state(solver, m):
    rng = np.random.default_rng(11)
    st = {"w": rng.normal(size=FEATS) * 0.3, "table": np.zeros((0, 0)),
          "table_mean": np.zeros(0), "snapshot": np.zeros(0),
          "snapshot_grad": np.zeros(0)}
    if solver in ("sag", "saga"):
        st["table"] = rng.normal(size=(m, FEATS)) * 0.1
        st["table_mean"] = st["table"].mean(0)
    if solver in ("svrg", "saag2"):
        st["snapshot"] = st["w"] + rng.normal(size=FEATS) * 0.05
        st["snapshot_grad"] = rng.normal(size=FEATS) * 0.1
    return {k: v.astype(np.float32) for k, v in st.items()}


@pytest.fixture(scope="module")
def ell_chunk(corpus):
    p = tsp.SparsePipeline(tpipe.PipelineConfig(
        corpus=corpus, batch_size=B, sampling="random", prefetch=0))
    batches = [p.read_batch() for _ in range(5)]
    return tuple(np.stack([getattr(sb, f) for sb in batches])
                 for f in ("cols", "vals", "y"))


@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("solver", tsol.SOLVERS)
def test_sparse_engine_matches_reference(ell_chunk, solver, rule):
    """``make_epoch_fn`` with ``cfg.sparse`` over 5 staged ELL batches (so
    ``sparse_batch_step`` five times) from a mid-run state."""
    m = 6
    jp, tp = JProblem(reg=1e-3), TProblem(reg=1e-3)
    kw = dict(solver=solver, sparse=True, **RULES[rule])
    jcfg, tcfg = jsol.SolverConfig(**kw), tsol.SolverConfig(**kw)
    st = _mid_run_state(solver, m)
    js = np.array([0, 1, 5, 1, 3], np.int32)
    jst = jsol.make_epoch_fn(jp, jcfg)(
        jsol.SolverState(**{k: jnp.asarray(v) for k, v in st.items()}),
        *(jnp.asarray(a) for a in ell_chunk), jnp.asarray(js))
    tst = tsol.make_epoch_fn(tp, tcfg)(
        tsol.state_from_numpy(st, "cpu"),
        *(torch.from_numpy(a) for a in ell_chunk), torch.from_numpy(js))
    got = tsol.state_to_numpy(tst)
    for k in tsol.SolverState._fields:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                   rtol=1e-5, atol=1e-6, err_msg=k)


def test_resident_epoch_rejects_sparse():
    with pytest.raises(ValueError, match="make_epoch_fn"):
        tsol.resident_epoch(TProblem(), tsol.SolverConfig(sparse=True),
                            tsol.init_state("mbsgd", torch.zeros(3), 2),
                            torch.zeros((4, 3)), torch.zeros(4),
                            torch.zeros(2, dtype=torch.int32), 2)


# ---------------------------------------------------------- trajectories ----

CELLS = ([(s, sch, "constant", "auto") for s in tsol.SOLVERS
          for sch in ("random", "cyclic", "systematic")]
         + [(s, "systematic", "line_search", mode) for s in tsol.SOLVERS
            for mode in ("vectorized", "sequential")])


@pytest.mark.parametrize("solver,scheme,step_mode,ls_mode", CELLS)
def test_trajectory_matches_reference(corpus, solver, scheme, step_mode,
                                      ls_mode):
    js, ts = _specs(corpus, solver=solver, scheme=scheme,
                    step_mode=step_mode, ls_mode=ls_mode, epochs=2, chunk=4,
                    prefetch=0)
    jr = jx.execute(jx.plan(js))
    tr = tx.execute(tx.plan(ts, device="cpu"))
    np.testing.assert_allclose(tr.w, np.asarray(jr.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tr.history, jr.history, rtol=1e-4)
    for f in ("batches", "bytes_read", "staged", "bytes_staged"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    assert tr.sampler_state == jr.sampler_state
    assert (tr.epochs_run, tr.epochs_done) == (jr.epochs_run, jr.epochs_done)


@pytest.mark.parametrize("solver,scheme,step_mode", [
    ("saga", "random", "constant"), ("svrg", "systematic", "line_search"),
    ("saag2", "cyclic", "constant")])
def test_resume_is_bitwise(corpus, solver, scheme, step_mode):
    _, ts = _specs(corpus, solver=solver, scheme=scheme, step_mode=step_mode,
                   epochs=3)
    p = tx.plan(ts, device="cpu")
    full = tx.execute(p)
    first = tx.execute(p, epochs=1)
    rest = tx.execute(p, resume=first, epochs=2)
    np.testing.assert_array_equal(rest.w, full.w)
    np.testing.assert_array_equal(rest.history, full.history)
    assert rest.epochs_done == 3 and rest.sampler_state == full.sampler_state
    again = tx.execute(p)
    np.testing.assert_array_equal(again.w, full.w)


def _keys(d):
    return {k: (_keys(v) if isinstance(v, dict) and k != "metrics"
                and k != "sampler_state" else None) for k, v in d.items()}


def test_json_keys_and_timeline(corpus):
    js, ts = _specs(corpus, solver="saga", epochs=2, step_mode="line_search",
                    traced=True)
    jr = jx.execute(jx.plan(js))
    tr = tx.execute(tx.plan(ts, device="cpu"))
    assert _keys(tr.to_json()) == _keys(jr.to_json())
    assert tr.to_json()["plan"]["format"] == "csr"
    assert set(tr.breakdown()) == set(jr.breakdown())
    assert all(r["ok"] for r in tr.verify_timeline().values())
