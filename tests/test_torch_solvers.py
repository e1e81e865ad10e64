"""Port solvers against the reference ``repro.core.solvers``.

* One ``batch_step`` / ``fused_batch_step`` per solver x step rule from the
  same mid-run state (non-zero SAG/SAGA table, SVRG/SAAG-II snapshot),
  rtol 1e-5: one step of float32 arithmetic in another summation order.
* Two resident epochs with the reference's own schedule injected (its
  ``epoch_indices`` / ``batch_slice_starts`` under the same keys) against
  ``_run_one_epoch``, rtol 1e-4 / atol 1e-6 on ``w``: the rounding
  differences of every step compound over 2 * m steps.
* The chunked engine against ``make_epoch_fn`` and the numpy state
  round trip.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import samplers as jsam
from repro.core import solvers as jsol
from repro.core.erm import ERMProblem as JProblem
from repro_torch.core import solvers as tsol
from repro_torch.core.erm import ERMProblem as TProblem

L, N, B = 230, 9, 20               # 230 % 20 != 0: the trailing batch wraps
M = -(-L // B)
REG = 1e-3
RULES = {"constant": dict(step_mode="constant"),
         "ls-seq": dict(step_mode="line_search", ls_mode="sequential"),
         "ls-vec": dict(step_mode="line_search", ls_mode="vectorized")}


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(7)
    X = rng.normal(size=(L, N)).astype(np.float32)
    w_true = rng.normal(size=N) / 3.0
    p = 1.0 / (1.0 + np.exp(-2.0 * (X @ w_true)))
    y = np.where(rng.uniform(size=L) < p, 1.0, -1.0).astype(np.float32)
    step = float(1.0 / (0.25 * np.max(np.sum(X * X, 1)) + REG))
    return X, y, step


def _mid_run_state(solver):
    """A state as a run leaves it mid-epoch: random w, a non-zero table
    with its mean, a snapshot and its gradient."""
    rng = np.random.default_rng(11)
    st = {"w": rng.normal(size=N) * 0.3,
          "table": np.zeros((0, 0)), "table_mean": np.zeros(0),
          "snapshot": np.zeros(0), "snapshot_grad": np.zeros(0)}
    if solver in ("sag", "saga"):
        st["table"] = rng.normal(size=(M, N)) * 0.1
        st["table_mean"] = st["table"].mean(0)
    if solver in ("svrg", "saag2"):
        st["snapshot"] = st["w"] + rng.normal(size=N) * 0.05
        st["snapshot_grad"] = rng.normal(size=N) * 0.1
    return {k: v.astype(np.float32) for k, v in st.items()}


def _jstate(d):
    return jsol.SolverState(**{k: jnp.asarray(v) for k, v in d.items()})


def _cfgs(solver, rule, step, fused=False):
    kw = dict(solver=solver, step_size=step if rule == "constant" else 1.0,
              **RULES[rule])
    return (jsol.SolverConfig(use_fused=fused, **kw),
            tsol.SolverConfig(use_fused=fused, **kw))


def _close_state(tst, jst, rtol, atol):
    got = tsol.state_to_numpy(tst)
    for k in tsol.SolverState._fields:
        np.testing.assert_allclose(got[k], np.asarray(getattr(jst, k)),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("kind", ["eager", "fused-block", "fused-rows"])
@pytest.mark.parametrize("rule", list(RULES))
@pytest.mark.parametrize("solver", tsol.SOLVERS)
def test_one_step_matches_reference(data, solver, rule, kind):
    X, y, step = data
    jp, tp = JProblem(reg=REG), TProblem(reg=REG)
    jcfg, tcfg = _cfgs(solver, rule, step, fused=kind != "eager")
    st = _mid_run_state(solver)
    j = 4
    idx = np.array([3, 229, 17, 17, 0, 100, 57, 58, 59, 201, 5, 5, 5, 60,
                    61, 62, 63, 64, 65, 66], np.int32)
    if kind == "eager":
        Xb, yb = X[idx], y[idx]
        jst = jsol.batch_step(jp, jcfg, _jstate(st), jnp.asarray(Xb),
                              jnp.asarray(yb), jnp.asarray(j))
        tst = tsol.batch_step(tp, tcfg, tsol.state_from_numpy(st, "cpu"),
                              torch.from_numpy(Xb), torch.from_numpy(yb), j)
    else:
        jkw = (dict(start=jnp.asarray(L - B + 4), batch_size=B)
               if kind == "fused-block" else dict(idx=jnp.asarray(idx)))
        tkw = (dict(start=L - B + 4, batch_size=B)
               if kind == "fused-block" else dict(idx=torch.from_numpy(idx)))
        jst = jsol.fused_batch_step(jp, jcfg, _jstate(st), jnp.asarray(X),
                                    jnp.asarray(y), jnp.asarray(j), **jkw)
        tst = tsol.fused_batch_step(tp, tcfg,
                                    tsol.state_from_numpy(st, "cpu"),
                                    torch.from_numpy(X), torch.from_numpy(y),
                                    j, **tkw)
    _close_state(tst, jst, rtol=1e-5, atol=1e-6)


RESIDENT_CELLS = ([(s, sch, "constant") for s in tsol.SOLVERS
                   for sch in ("random", "cyclic", "systematic")]
                  + [("svrg", "random", "ls-vec"),
                     ("saga", "systematic", "ls-vec")])


@pytest.mark.parametrize("solver,scheme,rule", RESIDENT_CELLS)
def test_resident_epoch_with_reference_schedule(data, solver, scheme, rule):
    X, y, step = data
    jp, tp = JProblem(reg=REG), TProblem(reg=REG)
    jcfg, tcfg = _cfgs(solver, rule, step)
    jst = jsol.init_state(solver, jnp.zeros(N, jnp.float32), M)
    tX, ty = torch.from_numpy(X), torch.from_numpy(y)
    tstates = {f: tsol.init_state(solver, torch.zeros(N), M)
               for f in (False, True)}
    key = jax.random.PRNGKey(3)
    for _ in range(2):
        key, sub = jax.random.split(key)
        jst = jsol._run_one_epoch(jp, jcfg, scheme, B, jst, jnp.asarray(X),
                                  jnp.asarray(y), sub)
        if scheme == "random":
            sched = jsam.epoch_indices(scheme, sub, L, B)
        else:
            sched = jsam.batch_slice_starts(scheme, sub, L, B)
        sched = torch.from_numpy(np.array(sched, np.int32))
        for fused, st in tstates.items():
            tstates[fused] = tsol.resident_epoch(
                tp, tcfg._replace(use_fused=fused), st, tX, ty, sched, B)
    for st in tstates.values():
        np.testing.assert_allclose(st.w.numpy(), np.asarray(jst.w),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("solver", tsol.SOLVERS)
def test_chunked_engine_matches_reference(data, solver):
    X, y, step = data
    jp, tp = JProblem(reg=REG), TProblem(reg=REG)
    jcfg, tcfg = _cfgs(solver, "ls-vec", step)
    st = _mid_run_state(solver)
    K = 5
    Xc = X[:K * B].reshape(K, B, N)
    yc = y[:K * B].reshape(K, B)
    js = np.array([0, 1, 2, M - 1, 1], np.int32)
    jst = jsol.make_epoch_fn(jp, jcfg)(_jstate(st), jnp.asarray(Xc),
                                       jnp.asarray(yc), jnp.asarray(js))
    tst = tsol.make_epoch_fn(tp, tcfg)(tsol.state_from_numpy(st, "cpu"),
                                       torch.from_numpy(Xc),
                                       torch.from_numpy(yc),
                                       torch.from_numpy(js))
    _close_state(tst, jst, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("solver", tsol.SOLVERS)
def test_state_numpy_round_trip(solver):
    st = _mid_run_state(solver)
    jst = _jstate(st)
    tst = tsol.state_from_numpy(
        jax.tree_util.tree_map(np.asarray, jst), "cpu")
    assert all(t.dtype == torch.float32 for t in tst)
    back = tsol.state_to_numpy(tst)
    for k, v in st.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].shape == np.asarray(getattr(jst, k)).shape
    # the host copies are independent of the state's tensors
    back["w"][0] += 1.0
    assert tst.w[0].item() == st["w"][0]


def test_snapshot_is_a_copy_and_fused_engine_rejected():
    tp = TProblem(reg=REG)
    cfg = tsol.SolverConfig(solver="svrg")
    st = tsol.init_state("svrg", torch.ones(N), M)
    st = tsol.epoch_begin(tp, cfg, st, lambda w: w * 2)
    assert st.snapshot.data_ptr() != st.w.data_ptr()
    with pytest.raises(ValueError, match="nothing left to fuse"):
        tsol.make_epoch_fn(tp, cfg._replace(use_fused=True))
