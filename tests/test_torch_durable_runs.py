"""Durable runs in the port: checkpointed ``execute()``, ``resume_from``,
``RunResult`` JSON — the counterparts of the single-host tests of
``tests/test_durable_runs.py``, on the CPU.

The contract: a run that dies is continued from its newest COMPLETE
snapshot and reproduces the uninterrupted run BIT FOR BIT within the port
(weights, objective trace, sampler state), on every backend.  Against the
reference, the checkpointed-and-resumed port run agrees with the
reference's uninterrupted run at rtol 1e-4 (float32 sums in another order,
compounded over the epochs).  The sharded and elastic tests wait for
multi-GPU (ROADMAP queue 1, item 12).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import experiment as jx
from repro.data import dataset as jds
from repro_torch.api import (CheckpointPolicy, DataSource, ExperimentSpec,
                             PlanError, RESIDENT, RunResult, STREAMED,
                             execute, plan, resume_from)
from repro_torch.checkpoint import Checkpointer
from repro_torch.core import experiment as tx
from repro_torch.core import schemes
from repro_torch.data import sparse

ROWS, FEATS, B = 600, 12, 100


@pytest.fixture(scope="module")
def dense_corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("durable") / "dense.bin"
    jds.synth_erm_corpus(path, rows=ROWS, features=FEATS, seed=3)
    return path


@pytest.fixture(scope="module")
def csr_corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("durable") / "c.csr"
    sparse.synth_sparse_classification(path, rows=ROWS, features=64,
                                       density=0.1, seed=2)
    return path


@pytest.fixture(scope="module")
def arrays():
    rng = np.random.default_rng(0)
    X = rng.normal(size=(ROWS, FEATS)).astype(np.float32)
    y = np.where(rng.uniform(size=ROWS) < 0.5, 1.0, -1.0).astype(np.float32)
    return X, y


def _spec(data, **kw):
    kw.setdefault("step_size", 0.05)
    kw.setdefault("batch_size", B)
    kw.setdefault("epochs", 4)
    return ExperimentSpec(data=data, **kw)


def _plan(spec):
    return plan(spec, device="cpu")


# ------------------------------------------------------ policy validation ----

def test_policy_validated_at_plan_time(dense_corpus, tmp_path):
    data = DataSource.corpus(dense_corpus)
    with pytest.raises(PlanError, match="every"):
        _plan(_spec(data, checkpoint=CheckpointPolicy(tmp_path, every=0)))
    with pytest.raises(PlanError, match="keep"):
        _plan(_spec(data, checkpoint=CheckpointPolicy(tmp_path, keep=0)))
    with pytest.raises(PlanError, match="CheckpointPolicy"):
        _plan(_spec(data, checkpoint=str(tmp_path)))
    p = _plan(_spec(data, checkpoint=CheckpointPolicy(tmp_path)))
    assert any("durable" in w for w in p.why)
    assert "durable run" in p.describe()


def test_policy_str_and_path_directories_compare_equal(tmp_path):
    assert (CheckpointPolicy(str(tmp_path / "ck"))
            == CheckpointPolicy(tmp_path / "ck"))


# ---------------------------------------------------- checkpointed execute ----

CASES = [("streamed-eager", "mbsgd", "systematic"),
         ("streamed-eager", "saga", "systematic"),
         ("streamed-eager", "svrg", "random"),
         ("resident-eager", "svrg", "systematic"),
         ("resident-eager", "saga", "random"),
         ("resident-fused", "sag", "cyclic"),
         ("sparse-csr", "saga", "systematic"),
         ("sparse-csr", "saag2", "random")]


def _case_spec(backend, solver, scheme, dense, csr, **kw):
    if backend == "sparse-csr":
        return _spec(DataSource.corpus(csr), solver=solver, scheme=scheme,
                     step_size=0.5, **kw)
    over = {"streamed-eager": dict(placement=STREAMED),
            "resident-eager": dict(placement=RESIDENT, kernel="eager"),
            "resident-fused": dict(placement=RESIDENT, kernel="fused")}
    return _spec(DataSource.corpus(dense), solver=solver, scheme=scheme,
                 **over[backend], **kw)


@pytest.mark.parametrize("backend,solver,scheme", CASES,
                         ids=["-".join(c) for c in CASES])
def test_restore_mid_run_reproduces_uninterrupted(dense_corpus, csr_corpus,
                                                  tmp_path, backend, solver,
                                                  scheme):
    """Restore at epoch 2 of 4 ("the crash") + 2 more epochs == the
    uninterrupted run, bitwise, with one cumulative history."""
    ckdir = tmp_path / "ck"
    p = _plan(_case_spec(backend, solver, scheme, dense_corpus, csr_corpus,
                         checkpoint=CheckpointPolicy(ckdir, every=1)))
    assert p.backend == backend
    full = execute(p)
    res = resume_from(ckdir, p, step=2)
    assert res.epochs_done == 2 and res.epochs_run == 0
    assert len(res.history) == 2
    np.testing.assert_array_equal(res.history, full.history[:2])
    r2 = execute(p, resume=res, epochs=2)
    np.testing.assert_array_equal(full.w, r2.w)
    np.testing.assert_array_equal(full.history, r2.history)
    assert full.sampler_state == r2.sampler_state


@pytest.mark.parametrize("placement,solver", [(STREAMED, "saga"),
                                              (RESIDENT, "svrg")])
def test_resumed_run_agrees_with_the_reference(dense_corpus, tmp_path,
                                               placement, solver):
    """The slice end to end: a port run killed (here: stopped) at epoch 2
    and resumed from disk lands on the reference's uninterrupted trajectory
    at rtol 1e-4 (CS: both packages read the same batches, resident or
    streamed)."""
    kw = dict(solver=solver, scheme="cyclic", placement=placement,
              step_size=0.05, batch_size=B, epochs=4)
    jr = jx.execute(jx.plan(jx.ExperimentSpec(
        jx.DataSource.corpus(dense_corpus), **kw)))
    ckdir = tmp_path / "ck"
    execute(_plan(ExperimentSpec(DataSource.corpus(dense_corpus),
                                 checkpoint=CheckpointPolicy(ckdir), **kw)),
            epochs=2)
    res = resume_from(ckdir, device="cpu")
    r = execute(res.plan, resume=res, epochs=2)
    np.testing.assert_allclose(r.w, jr.w, rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(r.history, jr.history, rtol=1e-5)
    assert r.sampler_state == jr.sampler_state


def test_resume_from_rebuilds_plan_from_fingerprint(dense_corpus, tmp_path):
    """The no-spec restart: resume_from(dir) alone rebuilds a runnable plan
    for corpus-backed runs, on the device asked for."""
    ckdir = tmp_path / "ck"
    p = _plan(_spec(DataSource.corpus(dense_corpus), solver="saga",
                    placement=STREAMED, chunk=2,
                    checkpoint=CheckpointPolicy(ckdir, every=1, keep=2)))
    full = execute(p)
    res = resume_from(ckdir, device="cpu")
    assert res.plan.backend == p.backend and res.plan.device == "cpu"
    assert res.plan.chunk == 2 and res.plan.cfg == p.cfg
    assert res.plan.spec.checkpoint == p.spec.checkpoint
    assert res.epochs_done == 4
    np.testing.assert_array_equal(res.w, full.w)
    np.testing.assert_array_equal(res.history, full.history)
    r = execute(res.plan, resume=res, epochs=1)
    assert r.epochs_done == 5 and len(r.history) == 5


def test_resume_from_defaults_to_the_card(dense_corpus, tmp_path,
                                          monkeypatch):
    ckdir = tmp_path / "ck"
    execute(_plan(_spec(DataSource.corpus(dense_corpus), epochs=1,
                        checkpoint=CheckpointPolicy(ckdir))))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(PlanError, match='device="cpu"'):
        resume_from(ckdir)


def test_resume_from_arrays_source_requires_plan(arrays, tmp_path):
    X, y = arrays
    ckdir = tmp_path / "ck"
    p = _plan(_spec(DataSource.arrays(X, y), epochs=2,
                    checkpoint=CheckpointPolicy(ckdir)))
    full = execute(p)
    with pytest.raises(ValueError, match="pass the plan"):
        resume_from(ckdir, device="cpu")
    res = resume_from(ckdir, p)
    np.testing.assert_array_equal(res.w, full.w)


STRICT = [dict(seed=7), dict(solver="sag"), dict(batch_size=50),
          dict(loss="square"), dict(reg=1e-3), dict(step_size=0.01),
          dict(scheme="cyclic"), dict(record_objective=False),
          dict(placement=RESIDENT)]


@pytest.mark.parametrize("over", STRICT, ids=[next(iter(o)) for o in STRICT])
def test_resume_from_rejects_mismatched_plan_by_field(dense_corpus, tmp_path,
                                                      over):
    ckdir = tmp_path / "ck"
    data = DataSource.corpus(dense_corpus)
    p = _plan(_spec(data, epochs=1, placement=STREAMED,
                    checkpoint=CheckpointPolicy(ckdir)))
    execute(p)
    kw = dict(epochs=1, placement=STREAMED, checkpoint=CheckpointPolicy(ckdir))
    kw.update(over)
    p_other = _plan(_spec(data, **kw))
    with pytest.raises(ValueError, match=next(iter(over))):
        resume_from(ckdir, p_other)
    # the elastic fields may change: chunking and the epoch budget
    same = _plan(_spec(data, epochs=9, placement=STREAMED, chunk=1,
                       checkpoint=CheckpointPolicy(ckdir)))
    assert resume_from(ckdir, same).epochs_done == 1


def test_device_is_a_strict_fingerprint_field(dense_corpus):
    """A checkpoint written on one device does not restore onto a plan on
    another: the CPU and the card sum in different orders."""
    p = _plan(_spec(DataSource.corpus(dense_corpus), epochs=1,
                    placement=STREAMED))
    saved = dict(tx._plan_fingerprint(p), device="cuda")
    assert "device" in tx._FP_STRICT and "device" not in tx._FP_ELASTIC
    with pytest.raises(ValueError, match="device"):
        tx._validate_fingerprint(saved, p)
    tx._validate_fingerprint(tx._plan_fingerprint(p), p)
    other = dataclasses.replace(p, device="cuda")
    with pytest.raises(ValueError, match="plan.device"):
        execute(p, resume=dataclasses.replace(
            execute(p), plan=other))


def test_fingerprint_keys_are_the_references_plus_device(dense_corpus):
    kw = dict(solver="saga", batch_size=B, epochs=2, step_size=0.05,
              placement=STREAMED)
    jp = jx.plan(jx.ExperimentSpec(jx.DataSource.corpus(dense_corpus), **kw))
    tp = _plan(ExperimentSpec(DataSource.corpus(dense_corpus), **kw))
    jf, tf = jx._plan_fingerprint(jp), tx._plan_fingerprint(tp)
    assert set(tf) == set(jf) | {"device"}
    assert {k: tf[k] for k in jf} == jf
    assert set(tx._FP_STRICT) == set(jx._FP_STRICT) | {"device"}
    assert tx._FP_ELASTIC == jx._FP_ELASTIC


def test_missing_directory_fails_without_creating_it(tmp_path):
    missing = tmp_path / "nope"
    with pytest.raises(FileNotFoundError):
        resume_from(missing, device="cpu")
    assert not missing.exists()


@pytest.mark.parametrize("placement", [STREAMED, RESIDENT])
def test_every_n_cadence_always_includes_final_epoch(dense_corpus, tmp_path,
                                                     placement):
    ckdir = tmp_path / "ck"
    p = _plan(_spec(DataSource.corpus(dense_corpus), epochs=3,
                    placement=placement,
                    checkpoint=CheckpointPolicy(ckdir, every=2, keep=5)))
    execute(p)
    # epoch 2 divides `every`; epoch 3 is the final epoch of the call
    assert Checkpointer(ckdir).all_steps() == [2, 3]


def test_checkpoint_meta_sampler_state_replays_schedule(dense_corpus,
                                                        tmp_path):
    """The two-integer sampler state in a snapshot's meta reconstructs the
    exact batch stream the continued run will consume."""
    ckdir = tmp_path / "ck"
    p = _plan(_spec(DataSource.corpus(dense_corpus), epochs=2,
                    placement=STREAMED, scheme="systematic",
                    checkpoint=CheckpointPolicy(ckdir, every=1)))
    execute(p)
    _, meta = Checkpointer(ckdir).read_meta(1)
    s = schemes.restore_state(meta["sampler_state"], ROWS, B)
    assert s.step == p.num_batches        # exactly one epoch consumed
    scheme = schemes.Systematic()
    want = scheme.bind(ROWS, B, p.spec.seed)
    for _ in range(p.num_batches):
        _, want = scheme.next_batch(want)
    a, _ = scheme.next_batch(want)
    b, _ = scheme.next_batch(s)
    assert a.start == b.start


def test_resident_sampler_state_is_the_epoch_count(dense_corpus, tmp_path):
    """A resident run's schedule is a function of (seed, epoch): its
    sampler state holds the epoch count and no key."""
    ckdir = tmp_path / "ck"
    execute(_plan(_spec(DataSource.corpus(dense_corpus), epochs=2,
                        placement=RESIDENT,
                        checkpoint=CheckpointPolicy(ckdir))))
    _, meta = Checkpointer(ckdir).read_meta()
    assert meta["sampler_state"] == {"scheme": "systematic", "seed": 0,
                                     "epochs": 2}
    assert meta["schema"] == 1 and meta["epochs_done"] == 2


def test_failed_async_write_surfaces_at_finish(dense_corpus, tmp_path,
                                               monkeypatch):
    from repro_torch.checkpoint import checkpointer as ckmod

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(ckmod.np, "save", boom)
    p = _plan(_spec(DataSource.corpus(dense_corpus), epochs=1,
                    checkpoint=CheckpointPolicy(tmp_path / "ck")))
    with pytest.raises(OSError, match="disk full"):
        execute(p)


# ------------------------------------------------- JSON summary round trip ----

@pytest.mark.parametrize("placement", [STREAMED, RESIDENT])
def test_runresult_json_roundtrip_and_resume_pointer(dense_corpus, tmp_path,
                                                     placement):
    p = _plan(_spec(DataSource.corpus(dense_corpus), epochs=2,
                    placement=placement))
    r = execute(p)
    path = r.save_json(tmp_path / "res.json")
    rj = RunResult.from_json(path, p)
    assert rj.to_json() == r.to_json()          # bit-identical surface
    assert rj.solver_state is None
    with pytest.raises(ValueError, match="resume_from"):
        execute(p, resume=rj)


def test_from_json_rejects_foreign_plan_by_field(dense_corpus):
    data = DataSource.corpus(dense_corpus)
    r = execute(_plan(_spec(data, epochs=1, placement=STREAMED)))
    p_other = _plan(_spec(data, epochs=1, solver="saga", placement=STREAMED))
    with pytest.raises(ValueError, match="solver"):
        RunResult.from_json(r.to_json(), p_other)
