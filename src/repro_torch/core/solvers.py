"""The paper's five stochastic solvers, each usable with RS/CS/SS sampling
and with constant step size or backtracking line search (paper §4.1).

The port of ``repro.core.solvers``:

* **MBSGD**   w <- w - (a/|B|) sum_{i in B} grad f_i(w)
* **SAG**     table of per-batch gradients; w <- w - a * mean(table)
* **SAGA**    w <- w - a (g_B - table_B + mean(table))
* **SVRG**    epoch snapshot wt, mu = full grad(wt);
              w <- w - a (g_B(w) - g_B(wt) + mu)
* **SAAG-II** like SVRG but the snapshot is the previous epoch's LAST
              iterate and the l2 regularizer is applied exactly

Two epoch engines, both Python loops over batches (PyTorch runs eagerly;
the reference's ``lax.scan`` has no counterpart the port needs):

* :func:`resident_epoch` — the whole corpus resident on the device and the
  epoch's schedule passed in (block starts for CS/SS, row ids for RS; see
  :func:`repro_torch.core.samplers.epoch_schedule`).  With
  ``cfg.use_fused`` every gradient and line-search margin comes from the
  fused CUDA kernels (:mod:`repro_torch.kernels.fused_erm`).
* :func:`make_epoch_fn` — the chunked engine: K staged batches per call,
  dense rows or (``cfg.sparse``) padded-ELL CSR batches; ``weighted=True``
  adds the adaptive schemes' per-batch weights.

State is updated in place where the reference donates it: a SAG/SAGA step
writes its gradient into row ``j`` of the ``(m, n)`` table instead of
copying the table, so a caller that wants to keep a state must clone it
(:func:`clone_state`).  ``w`` and ``table_mean`` are new tensors each step.
"""
from __future__ import annotations

from typing import Callable, Dict, Mapping, NamedTuple, Optional, Tuple, Union

import numpy as np
import torch

from . import step_rules
from .erm import ERMProblem, block_rows, gather_batch
from .step_rules import CONSTANT, LINE_SEARCH, SEQUENTIAL, VECTORIZED  # noqa: F401 — re-exported vocabulary

MBSGD, SAG, SAGA, SVRG, SAAG2 = "mbsgd", "sag", "saga", "svrg", "saag2"
SOLVERS = (MBSGD, SAG, SAGA, SVRG, SAAG2)

Index = Union[int, torch.Tensor]


class SolverConfig(NamedTuple):
    solver: str = MBSGD
    step_mode: str = CONSTANT
    step_size: float = 0.1        # constant step, or initial step for LS
    ls_shrink: float = 0.5        # backtracking factor rho
    ls_c: float = 1e-4            # Armijo constant
    ls_max_iter: int = 25
    use_fused: bool = False       # fused gather+grad CUDA kernels
    sparse: bool = False          # CSR corpus: padded-ELL batches, no densify
    ls_mode: str = VECTORIZED     # trial-ladder sweep | "sequential" ref


class SolverState(NamedTuple):
    """Uniform state; unused slots are zero-size tensors."""
    w: torch.Tensor
    table: torch.Tensor          # (m, n) per-batch gradient memory (SAG/SAGA)
    table_mean: torch.Tensor     # (n,) running mean of table        (SAG/SAGA)
    snapshot: torch.Tensor       # (n,) epoch snapshot w~            (SVRG/SAAG2)
    snapshot_grad: torch.Tensor  # (n,) full gradient at snapshot    (SVRG/SAAG2)


def _needs_table(solver: str) -> bool:
    return solver in (SAG, SAGA)


def _needs_snapshot(solver: str) -> bool:
    return solver in (SVRG, SAAG2)


def init_state(solver: str, w0: torch.Tensor, num_batches: int) -> SolverState:
    n, dt, dev = w0.shape[0], w0.dtype, w0.device
    table = torch.zeros((num_batches, n) if _needs_table(solver) else (0, 0),
                        dtype=dt, device=dev)
    tmean = torch.zeros((n,) if _needs_table(solver) else (0,), dtype=dt,
                        device=dev)
    snap = torch.zeros((n,) if _needs_snapshot(solver) else (0,), dtype=dt,
                       device=dev)
    sgrad = torch.zeros((n,) if _needs_snapshot(solver) else (0,), dtype=dt,
                        device=dev)
    return SolverState(w0, table, tmean, snap, sgrad)


def clone_state(state: SolverState) -> SolverState:
    return SolverState(*(t.clone() for t in state))


def state_from_numpy(arrays: Union[Mapping, NamedTuple],
                     device) -> SolverState:
    """A :class:`SolverState` from numpy arrays — a mapping or any object
    with the five fields (a reference ``SolverState`` converted with
    ``np.asarray`` included) — as float32 tensors on ``device``."""
    get = (arrays.__getitem__ if isinstance(arrays, Mapping)
           else lambda k: getattr(arrays, k))
    return SolverState(*(torch.as_tensor(
        np.array(get(k), dtype=np.float32), device=device)
        for k in SolverState._fields))


def state_to_numpy(state: SolverState) -> Dict[str, np.ndarray]:
    """The five state fields as float32 numpy arrays (host copies)."""
    return {k: getattr(state, k).detach().cpu().numpy().copy()
            for k in SolverState._fields}


# ---------------------------------------------------------------------------
# one mini-batch update (shared by both engines)
# ---------------------------------------------------------------------------

def _row(table: torch.Tensor, j: Index) -> torch.Tensor:
    if isinstance(j, torch.Tensor):      # device index: no host read-back
        return table.index_select(0, j.reshape(1).long()).reshape(-1)
    return table[j]


def _set_row(table: torch.Tensor, j: Index, g: torch.Tensor) -> None:
    if isinstance(j, torch.Tensor):
        table.index_copy_(0, j.reshape(1).long(), g.reshape(1, -1))
    else:
        table[j].copy_(g)


def _solver_direction(problem: ERMProblem, cfg: SolverConfig,
                      state: SolverState, j: Index, gd: torch.Tensor,
                      gd_snap: Optional[torch.Tensor],
                      ) -> Tuple[torch.Tensor, torch.Tensor, SolverState]:
    """(v, g, new_state) from precomputed DATA-term gradients ``gd`` at
    ``state.w`` and ``gd_snap`` at ``state.snapshot`` (snapshot solvers)."""
    w = state.w
    g = gd + problem.reg * w
    solver = cfg.solver

    if solver == MBSGD:
        v, new_state = g, state
    elif solver in (SAG, SAGA):
        m = state.table.shape[0]
        old = _row(state.table, j)
        mean_new = state.table_mean + (g - old) / m
        v = mean_new if solver == SAG else g - old + state.table_mean
        _set_row(state.table, j, g)       # in place, after `old` is used
        new_state = state._replace(table_mean=mean_new)
    elif solver == SVRG:
        g_snap = gd_snap + problem.reg * state.snapshot
        v, new_state = g - g_snap + state.snapshot_grad, state
    elif solver == SAAG2:
        # data-term variance reduction + EXACT regularizer gradient
        v = gd - gd_snap + state.snapshot_grad + problem.reg * w
        new_state = state
    else:
        raise ValueError(f"unknown solver {solver!r}")
    return v, g, new_state


def _weigh(gd: torch.Tensor, gd_snap: Optional[torch.Tensor],
           weight: Optional[torch.Tensor]):
    """The adaptive schemes' unbiasedness correction on the batch-mean data
    gradients (``1/(m p_j)`` for importance sampling, ``b / b_t`` for a
    zero-padded stochastic batch); ``None`` leaves them untouched."""
    if weight is None:
        return gd, gd_snap
    return gd * weight, None if gd_snap is None else gd_snap * weight


def batch_step(problem: ERMProblem, cfg: SolverConfig, state: SolverState,
               Xb: torch.Tensor, yb: torch.Tensor, j: Index,
               weight: Optional[torch.Tensor] = None) -> SolverState:
    """One solver update using batch ``j`` with materialized data (Xb, yb).
    ``weight`` (a scalar tensor) rescales the batch-mean data gradient, as
    the weighted schemes' ``BatchIndices.weight`` asks; ``None`` keeps the
    uniform update."""
    w = state.w
    gd = problem.batch_grad_data(w, Xb, yb)
    gd_snap = (problem.batch_grad_data(state.snapshot, Xb, yb)
               if _needs_snapshot(cfg.solver) else None)
    gd, gd_snap = _weigh(gd, gd_snap, weight)
    v, g, new_state = _solver_direction(problem, cfg, state, j, gd, gd_snap)
    alpha = step_rules.from_config(cfg).pick(
        step_rules.dense_probe(problem, Xb, yb), w, v, g)
    return new_state._replace(w=w - alpha * v)


def sparse_batch_step(problem: ERMProblem, cfg: SolverConfig,
                      state: SolverState, cols: torch.Tensor,
                      vals: torch.Tensor, yb: torch.Tensor,
                      j: Index,
                      weight: Optional[torch.Tensor] = None) -> SolverState:
    """One solver update from a padded-ELL CSR batch — the corpus is never
    densified.  ``(cols, vals)``: (b, kmax) as in
    :class:`repro_torch.data.sparse.SparseBatch`; line search backtracks on
    the sparse batch objective.  ``weight`` as in :func:`batch_step`."""
    w = state.w
    gd = problem.ell_batch_grad_data(w, cols, vals, yb)
    gd_snap = (problem.ell_batch_grad_data(state.snapshot, cols, vals, yb)
               if _needs_snapshot(cfg.solver) else None)
    gd, gd_snap = _weigh(gd, gd_snap, weight)
    v, g, new_state = _solver_direction(problem, cfg, state, j, gd, gd_snap)
    alpha = step_rules.from_config(cfg).pick(
        step_rules.ell_probe(problem, cols, vals, yb), w, v, g)
    return new_state._replace(w=w - alpha * v)


def fused_batch_step(problem: ERMProblem, cfg: SolverConfig,
                     state: SolverState, X: torch.Tensor, y: torch.Tensor,
                     j: Index, *, start=None, idx=None,
                     batch_size: Optional[int] = None) -> SolverState:
    """One solver update whose gradients and line-search margins come from
    the fused kernels; the batch is ``start`` (CS/SS block) or ``idx`` (RS
    rows) of the resident corpus and never materializes."""
    from ..kernels import fused_erm

    kw = (dict(start=start, batch_size=batch_size) if start is not None
          else dict(idx=idx))
    gd = fused_erm.fused_batch_grad_data(problem, X, y, state.w, **kw)
    gd_snap = (fused_erm.fused_batch_grad_data(problem, X, y, state.snapshot,
                                               **kw)
               if _needs_snapshot(cfg.solver) else None)
    v, g, new_state = _solver_direction(problem, cfg, state, j, gd, gd_snap)
    rule = step_rules.from_config(cfg)
    probe = (step_rules.fused_probe(problem, X, y, **kw)
             if rule.needs_probe else None)
    alpha = rule.pick(probe, state.w, v, g)
    return new_state._replace(w=state.w - alpha * v)


def epoch_begin(problem: ERMProblem, cfg: SolverConfig, state: SolverState,
                full_grad_at: Callable[[torch.Tensor], torch.Tensor]
                ) -> SolverState:
    """Refresh epoch-level memory.  ``full_grad_at`` computes the full (or,
    for SAAG-II, data-term) gradient.  The snapshot is a CLONE of ``w``:
    aliasing it would let an in-place update of ``w`` corrupt SVRG/SAAG-II."""
    if not _needs_snapshot(cfg.solver):
        return state
    return state._replace(snapshot=state.w.clone(),
                          snapshot_grad=full_grad_at(state.w))


# ---------------------------------------------------------------------------
# the resident epoch engine
# ---------------------------------------------------------------------------

def resident_epoch_begin(problem: ERMProblem, cfg: SolverConfig,
                         state: SolverState, X: torch.Tensor,
                         y: torch.Tensor) -> SolverState:
    """:func:`epoch_begin` over a resident corpus: the snapshot gradient is
    over ALL of X, a plain matrix product (data term only for SAAG-II)."""
    if cfg.solver == SAAG2:
        return epoch_begin(problem, cfg, state,
                           lambda w: problem.batch_grad_data(w, X, y))
    return epoch_begin(problem, cfg, state,
                       lambda w: problem.full_grad(w, X, y))


def resident_epoch(problem: ERMProblem, cfg: SolverConfig, state: SolverState,
                   X: torch.Tensor, y: torch.Tensor, schedule: torch.Tensor,
                   batch_size: int) -> SolverState:
    """One epoch over a resident corpus, driven by ``schedule``: ``(m,)``
    int32 block starts (CS/SS) or ``(m, b)`` int32 row ids (RS), on X's
    device.  Batch ``j`` of the schedule updates table slot ``j``.

    The reference (``_run_one_epoch``) draws the schedule in-graph; here it
    is an argument, and a schedule entry is handed to the kernels as a
    device pointer — never read back to the host.
    """
    if cfg.sparse:
        raise ValueError(
            "resident_epoch is the dense device-resident loop; CSR corpora "
            "go through make_epoch_fn (padded-ELL chunks) or the "
            "repro_torch.kernels.sparse_erm kernels")
    state = resident_epoch_begin(problem, cfg, state, X, y)
    contiguous = schedule.dim() == 1
    l = X.shape[0]
    for j in range(schedule.shape[0]):
        if contiguous:
            if cfg.use_fused:
                state = fused_batch_step(problem, cfg, state, X, y, j,
                                         start=schedule[j],
                                         batch_size=batch_size)
                continue
            rows = block_rows(schedule[j], l, batch_size)
        else:
            if cfg.use_fused:
                state = fused_batch_step(problem, cfg, state, X, y, j,
                                         idx=schedule[j])
                continue
            rows = schedule[j]
        Xb, yb = gather_batch(X, y, rows)
        state = batch_step(problem, cfg, state, Xb, yb, j)
    return state


# ---------------------------------------------------------------------------
# the chunked engine (streamed batches)
# ---------------------------------------------------------------------------

def make_epoch_fn(problem: ERMProblem, cfg: SolverConfig,
                  weighted: bool = False):
    """Chunked epoch engine: ``(state, Xc, yc, js) -> state`` over K staged
    mini-batches (``Xc: (K, b, n)``, ``yc: (K, b)``, ``js: (K,)`` table
    slots), one :func:`batch_step` per batch.

    With ``cfg.sparse`` the chunk is padded-ELL CSR and the signature is
    ``(state, colsc, valsc, yc, js)`` with ``colsc: (K, b, kmax)`` int32 and
    ``valsc: (K, b, kmax)`` float32, one :func:`sparse_batch_step` per
    batch.

    With ``weighted=True`` (the adaptive schemes) either signature gains a
    trailing ``ws: (K,)`` float32 vector, each batch's unbiasedness weight;
    the unweighted engines are unchanged."""
    if cfg.use_fused:
        raise ValueError(
            "use_fused applies to the device-resident epoch: the chunked "
            "engine consumes staged batches, which are materialized by "
            "construction — there is nothing left to fuse")

    if cfg.sparse:
        if weighted:
            def sparse_epoch_chunk_w(state: SolverState, colsc: torch.Tensor,
                                     valsc: torch.Tensor, yc: torch.Tensor,
                                     js: torch.Tensor,
                                     ws: torch.Tensor) -> SolverState:
                js = js.long()
                for i in range(colsc.shape[0]):
                    state = sparse_batch_step(problem, cfg, state, colsc[i],
                                              valsc[i], yc[i], js[i],
                                              weight=ws[i])
                return state
            return sparse_epoch_chunk_w

        def sparse_epoch_chunk(state: SolverState, colsc: torch.Tensor,
                               valsc: torch.Tensor, yc: torch.Tensor,
                               js: torch.Tensor) -> SolverState:
            js = js.long()
            for i in range(colsc.shape[0]):
                state = sparse_batch_step(problem, cfg, state, colsc[i],
                                          valsc[i], yc[i], js[i])
            return state
        return sparse_epoch_chunk

    if weighted:
        def epoch_chunk_w(state: SolverState, Xc: torch.Tensor,
                          yc: torch.Tensor, js: torch.Tensor,
                          ws: torch.Tensor) -> SolverState:
            js = js.long()
            for i in range(Xc.shape[0]):
                state = batch_step(problem, cfg, state, Xc[i], yc[i], js[i],
                                   weight=ws[i])
            return state
        return epoch_chunk_w

    def epoch_chunk(state: SolverState, Xc: torch.Tensor, yc: torch.Tensor,
                    js: torch.Tensor) -> SolverState:
        js = js.long()
        for i in range(Xc.shape[0]):
            state = batch_step(problem, cfg, state, Xc[i], yc[i], js[i])
        return state
    return epoch_chunk


def streaming_full_grad(problem: ERMProblem, w: torch.Tensor, batch_iter, *,
                        data_term_only: bool = False) -> torch.Tensor:
    """Full gradient accumulated over streamed host (Xb, yb) chunks."""
    gfun = problem.batch_grad_data if data_term_only else problem.batch_grad
    acc = torch.zeros_like(w)
    total = 0
    for Xb, yb in batch_iter:
        Xt = torch.as_tensor(Xb, device=w.device)
        yt = torch.as_tensor(yb, device=w.device)
        acc = acc + gfun(w, Xt, yt) * Xb.shape[0]
        total += Xb.shape[0]
    return acc / total
