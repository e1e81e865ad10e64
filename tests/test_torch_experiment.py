"""Port planner and executor against the reference ``repro.core.experiment``.

* ``plan()`` makes the reference's decisions on a grid of specs (step size
  at rtol 1e-6: the 1/L sample statistic is a float32 reduction) and
  raises PlanError on the same single-host specs.
* Streamed runs read the same batches as the reference (both draw from the
  Scheme stream), so their trajectories agree at rtol 1e-4 — float32
  rounding compounds over the epochs.  Resident CS is deterministic and
  agrees too.  Resident RS/SS do not: the port draws those schedules from
  the Scheme stream, the reference from ``jax.random``.
* AccessStats counts, ``resume=`` (bitwise within the port), ``to_json``
  keys and ``verify_timeline``.
"""
import itertools

import numpy as np
import pytest
import torch

from repro.core import experiment as jx
from repro.data import dataset as jds
from repro.obs import TracePolicy as JTracePolicy
from repro_torch.core import experiment as tx
from repro_torch.obs import TracePolicy

ROWS, FEATS, B = 530, 7, 50        # 530 % 50 != 0: the trailing batch wraps


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("exp") / "dense.bin"
    jds.synth_erm_corpus(path, rows=ROWS, features=FEATS, seed=3)
    return path


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(ROWS, FEATS)).astype(np.float32)
    y = np.where(rng.uniform(size=ROWS) < 0.5, 1.0, -1.0).astype(np.float32)
    return X, y


def _specs(path, X, y, traced=False, **kw):
    """The same spec for both packages (each with its own DataSource and,
    when ``traced``, its own TracePolicy)."""
    kw.setdefault("batch_size", B)
    jkw = dict(kw, trace=JTracePolicy()) if traced else kw
    tkw = dict(kw, trace=TracePolicy()) if traced else kw
    if path is not None:
        return (jx.ExperimentSpec(jx.DataSource.corpus(path), **jkw),
                tx.ExperimentSpec(tx.DataSource.corpus(path), **tkw))
    return (jx.ExperimentSpec(jx.DataSource.arrays(X, y), **jkw),
            tx.ExperimentSpec(tx.DataSource.arrays(X, y), **tkw))


GRID = list(itertools.product(
    ("corpus", "arrays"), ("mbsgd", "saga", "svrg"),
    ("random", "systematic"), ("constant", "line_search"),
    (dict(), dict(placement="streamed"), dict(placement="resident"),
     dict(kernel="eager"), dict(kernel="fused", placement="resident"),
     dict(resident_budget=1000), dict(chunk=3, placement="streamed"))))


@pytest.mark.parametrize("src,solver,scheme,step_mode,over", GRID)
def test_plan_decisions_match_reference(corpus, arrays, src, solver, scheme,
                                        step_mode, over):
    X, y = arrays
    js, ts = _specs(corpus if src == "corpus" else None, X, y, solver=solver,
                    scheme=scheme, step_mode=step_mode, **over)
    try:
        jp = jx.plan(js)
    except jx.PlanError:
        with pytest.raises(tx.PlanError):
            tx.plan(ts, device="cpu")
        return
    tp = tx.plan(ts, device="cpu")
    for f in ("backend", "placement", "kernel", "chunk", "num_batches",
              "rows", "features", "corpus_bytes", "fmt"):
        assert getattr(tp, f) == getattr(jp, f), f
    # every config field as the reference sets it (``sparse`` is off on a
    # dense corpus)
    jcfg = jp.cfg._replace(step_size=0)._asdict()
    assert tp.cfg._replace(step_size=0)._asdict() == jcfg
    assert not tp.cfg.sparse
    np.testing.assert_allclose(tp.cfg.step_size, jp.cfg.step_size,
                               rtol=1e-6)
    assert tp.device == "cpu"


BAD = [dict(solver="adam"), dict(scheme="bogus"), dict(step_mode="wolfe"),
       dict(ls_mode="fast"), dict(step_size=0.0),
       dict(step_mode="line_search", ls_shrink=1.0),
       dict(step_mode="line_search", ls_c=0.0),
       dict(step_mode="line_search", ls_max_iter=0), dict(loss="hinge"),
       dict(placement="disk"), dict(kernel="triton"),
       dict(reduction="psum"), dict(reduction="gather"),
       dict(batch_size=0), dict(epochs=0), dict(batch_size=ROWS + 1),
       dict(kernel="fused", placement="streamed")]


@pytest.mark.parametrize("bad", BAD, ids=[str(b) for b in BAD])
@pytest.mark.parametrize("src", ["corpus", "arrays"])
def test_same_plan_errors(corpus, arrays, src, bad):
    X, y = arrays
    js, ts = _specs(corpus if src == "corpus" else None, X, y, **bad)
    with pytest.raises(jx.PlanError):
        jx.plan(js)
    with pytest.raises(tx.PlanError):
        tx.plan(ts, device="cpu")


def test_arrays_cannot_stream(arrays):
    X, y = arrays
    _, ts = _specs(None, X, y, placement="streamed")
    with pytest.raises(tx.PlanError, match="no corpus to stream"):
        tx.plan(ts, device="cpu")


@pytest.mark.parametrize("over,match", [
    (dict(mesh=object()), "item 12"),
    (dict(checkpoint=object()), "CheckpointPolicy")])
def test_not_ported_options_are_refused(corpus, arrays, over, match):
    X, y = arrays
    _, ts = _specs(corpus, X, y, **over)
    with pytest.raises(tx.PlanError, match=match):
        tx.plan(ts, device="cpu")
    with pytest.raises(tx.PlanError, match="item 13"):
        tx.plan(_specs(None, X, y)[1], device="cpu", audit=True)


CELLS = [("saga", "systematic", "constant"), ("svrg", "random", "line_search"),
         ("mbsgd", "cyclic", "constant"), ("saag2", "systematic", "constant"),
         ("sag", "random", "constant")]


@pytest.mark.parametrize("solver,scheme,step_mode", CELLS)
def test_streamed_trajectory_matches_reference(corpus, solver, scheme,
                                               step_mode):
    js, ts = _specs(corpus, None, None, solver=solver, scheme=scheme,
                    step_mode=step_mode, placement="streamed", epochs=2,
                    chunk=4, prefetch=0)
    jr = jx.execute(jx.plan(js))
    tr = tx.execute(tx.plan(ts, device="cpu"))
    np.testing.assert_allclose(tr.w, np.asarray(jr.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tr.history, jr.history, rtol=1e-4)
    # access accounting: identical batches and bytes, read and staged
    for f in ("batches", "bytes_read", "staged", "bytes_staged"):
        assert getattr(tr.stats, f) == getattr(jr.stats, f), f
    assert tr.sampler_state == jr.sampler_state


@pytest.mark.parametrize("kernel", ["eager", "fused"])
@pytest.mark.parametrize("solver", ["saga", "svrg", "saag2"])
def test_resident_cyclic_matches_reference(corpus, solver, kernel):
    js, ts = _specs(corpus, None, None, solver=solver, scheme="cyclic",
                    placement="resident", kernel=kernel, epochs=2)
    jr = jx.execute(jx.plan(js))
    tr = tx.execute(tx.plan(ts, device="cpu"))
    np.testing.assert_allclose(tr.w, np.asarray(jr.w), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(tr.history, jr.history, rtol=1e-4)
    assert (tr.stats.batches, tr.stats.bytes_read) == \
        (jr.stats.batches, jr.stats.bytes_read)
    # the port also stages each epoch's schedule through the H2D lane
    m = tr.plan.num_batches
    assert tr.stats.staged == jr.stats.staged + 2
    assert tr.stats.bytes_staged == jr.stats.bytes_staged + 2 * m * 4


def test_saga_constant_step_history_matches_reference(tmp_path):
    """SAGA at the default constant step 1/L is not a descent method from
    epoch to epoch: on a SUSY-shaped corpus (18 features) the reference's
    per-epoch objective rises once it has neared the optimum, and the
    port's resident-fused run — the backend ``chip_smoke.py`` drives —
    traces the same curve, rise included.  (Resident SS in the port and
    streamed SS in the reference read the same batches.)"""
    path = tmp_path / "susy_shaped.bin"
    jds.synth_erm_corpus(path, rows=200_000, features=18, seed=0)
    kw = dict(solver="saga", scheme="systematic", step_mode="constant",
              batch_size=500, epochs=4)
    jr = jx.execute(jx.plan(jx.ExperimentSpec(
        jx.DataSource.corpus(path), placement="streamed", **kw)))
    tp = tx.plan(tx.ExperimentSpec(tx.DataSource.corpus(path),
                                   placement="resident", kernel="fused", **kw),
                 device="cpu")
    assert tp.backend == tx.RESIDENT_FUSED
    tr = tx.execute(tp)
    np.testing.assert_allclose(tr.history, jr.history, rtol=1e-5)
    assert np.all(jr.history < np.log(2.0))        # below f(0) throughout
    assert np.any(np.diff(jr.history) > 0)         # ...but not monotone
    assert np.array_equal(np.diff(tr.history) > 0, np.diff(jr.history) > 0)


@pytest.mark.parametrize("placement,solver,scheme,step_mode", [
    ("resident", "saga", "systematic", "constant"),
    ("resident", "svrg", "random", "line_search"),
    ("streamed", "saga", "random", "constant"),
    ("streamed", "saag2", "systematic", "line_search")])
def test_resume_is_bitwise(corpus, placement, solver, scheme, step_mode):
    _, ts = _specs(corpus, None, None, solver=solver, scheme=scheme,
                   step_mode=step_mode, placement=placement, epochs=3)
    p = tx.plan(ts, device="cpu")
    full = tx.execute(p)
    first = tx.execute(p, epochs=1)
    w_first = first.solver_state.w.clone()
    rest = tx.execute(p, resume=first, epochs=2)
    np.testing.assert_array_equal(rest.w, full.w)
    np.testing.assert_array_equal(rest.history, full.history)
    assert rest.epochs_done == 3 and rest.sampler_state == full.sampler_state
    assert torch.equal(first.solver_state.w, w_first)   # resume copied it
    other = tx.plan(tx.ExperimentSpec(ts.data, solver="mbsgd",
                                      batch_size=B), device="cpu")
    with pytest.raises(ValueError, match="different plan"):
        tx.execute(other, resume=first)


def _keys(d):
    return {k: (_keys(v) if isinstance(v, dict) and k != "metrics"
                and k != "sampler_state" else None) for k, v in d.items()}


@pytest.mark.parametrize("placement", ["resident", "streamed"])
def test_json_keys_and_timeline(corpus, tmp_path, placement):
    js, ts = _specs(corpus, None, None, solver="saga", placement=placement,
                    epochs=2, step_mode="line_search", traced=True)
    jr = jx.execute(jx.plan(js))
    tr = tx.execute(tx.plan(ts, device="cpu"))
    assert _keys(tr.to_json()) == _keys(jr.to_json())
    assert set(tr.breakdown()) == set(jr.breakdown())
    report = tr.verify_timeline()
    assert all(r["ok"] for r in report.values())
    assert tr.timeline.metrics["counters"]["ls.invocations"] == \
        2 * tr.plan.num_batches
    saved = tr.save_json(tmp_path / "r.json")
    assert saved.read_text().startswith("{")
    tr.save_trace(tmp_path / "t.json")
    assert tx.RunResult.from_json(str(saved), tr.plan).to_json() == \
        tr.to_json()
