"""First-class step-determination rules (paper §4.1).

The port of ``repro.core.step_rules``:

* :class:`ConstantStep` — ``cfg.step_size``, verbatim.
* :class:`BacktrackingLS` — sequential Armijo backtracking, one trial
  objective per shrink.  The reference runs it as a ``lax.while_loop``; here
  it is a Python loop that reads each Armijo test back to the host.  It is
  the parity reference, not a fast path.
* :class:`VectorizedLS` — the geometric trial ladder evaluated in batched
  sweeps from two margin evaluations (``z(w - a v) = z(w) - a z(v)``).  The
  reference skips the tail sweep with one ``lax.cond`` when rung 0 passes;
  the port always evaluates it and chooses with ``torch.where``, so the rule
  never synchronises with the host.

Both line searches build the ladder by repeated multiplication and use the
``alpha0 * shrink ** max_iter`` safeguard as the reference writes them, so
the sequential and vectorized rules return the same rung bit for bit
(away from an exact Armijo tie, where the decomposed trial objective may
round the other way).

Every backend presents its batch through a :class:`BatchProbe`: dense eager
batches (:func:`dense_probe`), padded-ELL CSR batches (:func:`ell_probe`)
and the fused CUDA margin kernels (:func:`fused_probe`).
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Union

import torch

from .erm import ERMProblem

CONSTANT, LINE_SEARCH = "constant", "line_search"
STEP_MODES = (CONSTANT, LINE_SEARCH)

SEQUENTIAL, VECTORIZED = "sequential", "vectorized"
LS_MODES = (SEQUENTIAL, VECTORIZED)


class BatchProbe(NamedTuple):
    """The two things a step rule may ask of the current mini-batch."""
    objective: Callable[[torch.Tensor], torch.Tensor]   # u -> batch objective
    margins: Callable[[torch.Tensor], torch.Tensor]     # u -> (b,) Xb @ u
    labels: torch.Tensor                                # yb (b,)
    mean_loss: Callable[[torch.Tensor, torch.Tensor], torch.Tensor]
    reg: float


def dense_probe(problem: ERMProblem, Xb: torch.Tensor,
                yb: torch.Tensor) -> BatchProbe:
    """Probe over a materialized dense batch (the eager engines)."""
    return BatchProbe(
        objective=lambda u: problem.batch_objective(u, Xb, yb),
        margins=lambda u: Xb @ u,
        labels=yb, mean_loss=problem.mean_margin_loss, reg=problem.reg)


def ell_probe(problem: ERMProblem, cols: torch.Tensor, vals: torch.Tensor,
              yb: torch.Tensor) -> BatchProbe:
    """Probe over a padded-ELL CSR batch (the ``sparse-csr`` engine) —
    margins cost O(b * kmax), the corpus is never densified."""
    return BatchProbe(
        objective=lambda u: problem.ell_batch_objective(u, cols, vals, yb),
        margins=lambda u: problem.ell_margins(u, cols, vals),
        labels=yb, mean_loss=problem.mean_margin_loss, reg=problem.reg)


def fused_probe(problem: ERMProblem, X: torch.Tensor, y: torch.Tensor, *,
                start=None, idx=None,
                batch_size: Optional[int] = None) -> BatchProbe:
    """Probe whose margins come from the fused margin kernels — the batch
    never materializes.  Pass exactly one of ``start`` (CS/SS block; needs
    ``batch_size``) or ``idx`` (RS rows)."""
    from ..kernels import fused_erm

    yb = fused_erm.fused_batch_labels(y, start=start, idx=idx,
                                      batch_size=batch_size)
    margins = lambda u: fused_erm.fused_batch_margins(
        X, u, start=start, idx=idx, batch_size=batch_size)

    def objective(u):
        return (problem.mean_margin_loss(margins(u), yb)
                + 0.5 * problem.reg * torch.dot(u, u))

    return BatchProbe(objective=objective, margins=margins, labels=yb,
                      mean_loss=problem.mean_margin_loss, reg=problem.reg)


def _ray_objectives(probe: BatchProbe, zw, zv, ww, wv, vv, alphas):
    """Batch objective at every point ``w - alphas[k] * v`` of the search
    ray, from its cached margin/norm decomposition."""
    zs = zw[None, :] - alphas[:, None] * zv[None, :]
    data = probe.mean_loss(zs, probe.labels[None, :])
    reg = 0.5 * probe.reg * (ww - 2.0 * alphas * wv + alphas * alphas * vv)
    return data + reg


def trial_objectives(probe: BatchProbe, w: torch.Tensor, v: torch.Tensor,
                     alphas: torch.Tensor) -> torch.Tensor:
    """Batch objective at every trial point ``w - alphas[k] * v`` from TWO
    margin evaluations."""
    return _ray_objectives(probe, probe.margins(w), probe.margins(v),
                           torch.dot(w, w), torch.dot(w, v), torch.dot(v, v),
                           alphas)


def validate_ls(step_size: float, shrink: float, c: float, max_iter: int):
    """Reject line-search hyperparameters that cannot terminate or cannot
    decrease (ValueError; ``plan`` re-raises as PlanError)."""
    if not step_size > 0:
        raise ValueError(
            f"line search needs a positive initial step, got {step_size!r}")
    if not 0.0 < shrink < 1.0:
        raise ValueError(
            f"ls_shrink must lie in (0, 1) — a backtracking factor of "
            f"{shrink!r} would never shrink the step")
    if not 0.0 < c < 1.0:
        raise ValueError(f"ls_c (Armijo constant) must lie in (0, 1), "
                         f"got {c!r}")
    if max_iter < 1:
        raise ValueError(f"ls_max_iter must be >= 1, got {max_iter!r}")


def _alpha0(rule, w: torch.Tensor) -> torch.Tensor:
    """The rule's initial step as a 0-dim tensor of ``w``'s type (a fill on
    the device: ``torch.tensor`` from a host value would sync the stream)."""
    return torch.full((), rule.step_size, dtype=w.dtype, device=w.device)


class ConstantStep(NamedTuple):
    """Fixed step size (paper default: 1/L)."""
    step_size: float
    needs_probe: bool = False

    def pick(self, probe: Optional[BatchProbe], w: torch.Tensor,
             v: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
        return _alpha0(self, w)


class BacktrackingLS(NamedTuple):
    """Sequential Armijo backtracking on the mini-batch objective: one trial
    objective per shrink, each test read back to the host.  The parity
    reference for :class:`VectorizedLS`."""
    step_size: float
    shrink: float = 0.5
    c: float = 1e-4
    max_iter: int = 25
    needs_probe: bool = True

    def pick(self, probe: BatchProbe, w: torch.Tensor, v: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
        obj = probe.objective
        f0 = obj(w)
        gv = torch.dot(g, v)
        alpha0 = _alpha0(self, w)
        alpha = alpha0
        for _ in range(self.max_iter):
            if not bool(obj(w - alpha * v) > f0 - self.c * alpha * gv):
                break
            alpha = alpha * self.shrink
        # not a descent direction on this batch (<g, v> <= 0): the Armijo
        # test is vacuous, so take the smallest step the search can produce
        alpha_safe = alpha0 * self.shrink ** self.max_iter
        return torch.where(gv > 0, alpha, alpha_safe)


class VectorizedLS(NamedTuple):
    """Armijo backtracking with the trial ladder evaluated in batched sweeps
    instead of one objective call per shrink.

    Rung 0 is the sequential search's first trial verbatim (the direct
    objective at ``w - alpha0 v``).  The remaining rungs are swept in
    geometrically growing blocks (2, 4, 8, ...) from the margin
    decomposition, and the FIRST accepted rung wins.  The reference skips
    the sweep when rung 0 passes; here it is always computed and discarded
    by ``torch.where``, which keeps the rule free of host syncs.
    """
    step_size: float
    shrink: float = 0.5
    c: float = 1e-4
    max_iter: int = 25
    needs_probe: bool = True

    def pick(self, probe: BatchProbe, w: torch.Tensor, v: torch.Tensor,
             g: torch.Tensor) -> torch.Tensor:
        alpha0 = _alpha0(self, w)
        # repeated multiplication — NOT cumprod or shrink**k — so every rung
        # is bit-identical to the value the sequential loop produces
        rungs = [alpha0]
        for _ in range(self.max_iter):
            rungs.append(rungs[-1] * self.shrink)
        ladder = torch.stack(rungs)
        gv = torch.dot(g, v)

        zw = probe.margins(w)
        ww = torch.dot(w, w)
        f0 = probe.mean_loss(zw, probe.labels) + 0.5 * probe.reg * ww

        # rung 0: the sequential search's first trial — same ops, same rounding
        acc0 = probe.objective(w - ladder[0] * v) \
            <= f0 - self.c * ladder[0] * gv

        if self.max_iter == 1:
            alpha = torch.where(acc0, ladder[0], ladder[-1])
        else:
            zv = probe.margins(v)
            wv, vv = torch.dot(w, v), torch.dot(v, v)
            alpha_t = ladder[-1]                     # exhaustion rung
            found = torch.zeros((), dtype=torch.bool, device=w.device)
            start, j = 1, 1
            while start < self.max_iter:
                size = min(2 ** j, self.max_iter - start)
                blk = ladder[start:start + size]
                f = _ray_objectives(probe, zw, zv, ww, wv, vv, blk)
                acc = f <= f0 - self.c * blk * gv
                first = torch.argmax(acc.to(torch.int32))   # first accepted
                blk_alpha = blk.gather(0, first.reshape(1)).reshape(())
                hit = torch.any(acc)
                alpha_t = torch.where(~found & hit, blk_alpha, alpha_t)
                found = found | hit
                start += size
                j += 1
            # non-descent batches (gv <= 0) keep rung 0 here; the safeguard
            # below overrides them anyway
            alpha = torch.where(acc0 | (gv <= 0), ladder[0], alpha_t)
        # same non-descent safeguard, same arithmetic (one Python pow) as
        # the sequential reference
        alpha_safe = alpha0 * self.shrink ** self.max_iter
        return torch.where(gv > 0, alpha, alpha_safe)


StepRule = Union[ConstantStep, BacktrackingLS, VectorizedLS]


def from_config(cfg) -> StepRule:
    """Resolve a :class:`~repro_torch.core.solvers.SolverConfig` to its rule."""
    if cfg.step_mode == CONSTANT:
        return ConstantStep(cfg.step_size)
    if cfg.step_mode == LINE_SEARCH:
        validate_ls(cfg.step_size, cfg.ls_shrink, cfg.ls_c, cfg.ls_max_iter)
        if cfg.ls_mode == SEQUENTIAL:
            cls = BacktrackingLS
        elif cfg.ls_mode == VECTORIZED:
            cls = VectorizedLS
        else:
            raise ValueError(f"unknown ls_mode {cfg.ls_mode!r}; "
                             f"want one of {LS_MODES}")
        return cls(cfg.step_size, cfg.ls_shrink, cfg.ls_c, cfg.ls_max_iter)
    raise ValueError(f"unknown step mode {cfg.step_mode!r}; "
                     f"want one of {STEP_MODES}")
