"""l2-regularized empirical risk minimization (paper §1.1, eq. (2)).

    min_w f(w) = (1/l) sum_i f_i(w) + (C/2) ||w||^2

The port of ``repro.core.erm``.  Losses: logistic, square, smoothed hinge.
Where the reference takes gradients by autodiff, the port writes them out:
every gradient here is ``(1/b) Xb^T dloss(Xb w, yb)`` (+ ``reg * w``), with
the same :func:`dloss` the fused kernels compute, so the eager and fused
paths share one loss derivative.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Tuple, Union

import torch

LOGISTIC = "logistic"
SQUARE = "square"
SMOOTH_HINGE = "smooth_hinge"
LOSSES = (LOGISTIC, SQUARE, SMOOTH_HINGE)

Start = Union[int, torch.Tensor]


def _margin_losses(loss: str) -> Callable[[torch.Tensor, torch.Tensor],
                                          torch.Tensor]:
    """Per-example loss as a function of (z = w.x, y)."""
    if loss == LOGISTIC:
        # log(1 + exp(-y z)) computed stably
        return lambda z, y: torch.logaddexp(torch.zeros_like(z), -y * z)
    if loss == SQUARE:
        return lambda z, y: 0.5 * (z - y) ** 2
    if loss == SMOOTH_HINGE:
        # quadratically smoothed hinge (keeps Assumption 1 satisfiable)
        def sh(z, y):
            t = y * z
            return torch.where(t >= 1.0, 0.0,
                               torch.where(t <= 0.0, 0.5 - t,
                                           0.5 * (1.0 - t) ** 2))
        return sh
    raise ValueError(f"unknown loss {loss!r}")


def dloss(loss: str, z: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """d/dz of the per-example margin loss (``repro.kernels.fused_erm._dloss``;
    the CUDA kernels in ``kernels/csrc/fused_erm.cu`` compute the same)."""
    if loss == LOGISTIC:
        # d/dz log(1+exp(-yz)) = -y * sigmoid(-yz)
        return -y * torch.sigmoid(-y * z)
    if loss == SQUARE:
        return z - y
    if loss == SMOOTH_HINGE:
        t = y * z
        return -y * torch.where(t >= 1.0, 0.0,
                                torch.where(t <= 0.0, 1.0, 1.0 - t))
    raise ValueError(f"unknown loss {loss!r}")


@contextlib.contextmanager
def _deterministic():
    """Deterministic algorithms on for the enclosed ops, then the caller's
    setting back."""
    prev = torch.are_deterministic_algorithms_enabled()
    warn = torch.is_deterministic_algorithms_warn_only_enabled()
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        torch.use_deterministic_algorithms(prev, warn_only=warn)


@dataclasses.dataclass(frozen=True)
class ERMProblem:
    """Static description of an ERM instance. X: (l, n) float, y: (l,) float."""
    loss: str = LOGISTIC
    reg: float = 1e-4          # C in eq. (2)

    # ---- full objective -------------------------------------------------
    def objective(self, w: torch.Tensor, X: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
        per = _margin_losses(self.loss)(X @ w, y)
        return torch.mean(per) + 0.5 * self.reg * torch.dot(w, w)

    def full_grad(self, w: torch.Tensor, X: torch.Tensor,
                  y: torch.Tensor) -> torch.Tensor:
        return self.batch_grad_data(w, X, y) + self.reg * w

    # ---- mini-batch subproblem (eq. (3)) --------------------------------
    def mean_margin_loss(self, z: torch.Tensor,
                         yb: torch.Tensor) -> torch.Tensor:
        """Mean per-example loss from precomputed margins ``z = Xb @ w`` —
        the loss surface the vectorized line search and the fused margin
        kernels share."""
        return torch.mean(_margin_losses(self.loss)(z, yb), dim=-1)

    def data_objective(self, w: torch.Tensor, Xb: torch.Tensor,
                       yb: torch.Tensor) -> torch.Tensor:
        """Loss term only (no regularizer) — SAAG-II treats the reg exactly."""
        return self.mean_margin_loss(Xb @ w, yb)

    def batch_objective(self, w: torch.Tensor, Xb: torch.Tensor,
                        yb: torch.Tensor) -> torch.Tensor:
        return self.data_objective(w, Xb, yb) + 0.5 * self.reg * torch.dot(w, w)

    def batch_grad(self, w: torch.Tensor, Xb: torch.Tensor,
                   yb: torch.Tensor) -> torch.Tensor:
        return self.batch_grad_data(w, Xb, yb) + self.reg * w

    def batch_grad_data(self, w: torch.Tensor, Xb: torch.Tensor,
                        yb: torch.Tensor) -> torch.Tensor:
        """``(1/b) Xb^T dloss(Xb w, yb)`` — the data-term gradient the
        reference takes by autodiff of :meth:`data_objective`."""
        s = dloss(self.loss, Xb @ w, yb) / Xb.shape[0]
        return s @ Xb

    # ---- sparse (padded-ELL) mini-batch, same subproblem ----------------
    # A CSR mini-batch arrives as (cols, vals): (b, kmax) int32/float32 with
    # zero-valued padding (repro_torch.data.sparse.SparseBatch).  The margin
    # is a gather, the gradient the matching scatter-add, written out.

    def ell_margins(self, w: torch.Tensor, cols: torch.Tensor,
                    vals: torch.Tensor) -> torch.Tensor:
        """z_i = x_i . w for padded-ELL rows (padding vals are 0)."""
        wc = w.index_select(0, cols.reshape(-1)).reshape(cols.shape)
        return torch.sum(vals * wc, dim=-1)

    def ell_data_objective(self, w: torch.Tensor, cols: torch.Tensor,
                           vals: torch.Tensor,
                           yb: torch.Tensor) -> torch.Tensor:
        return self.mean_margin_loss(self.ell_margins(w, cols, vals), yb)

    def ell_batch_objective(self, w: torch.Tensor, cols: torch.Tensor,
                            vals: torch.Tensor,
                            yb: torch.Tensor) -> torch.Tensor:
        return (self.ell_data_objective(w, cols, vals, yb)
                + 0.5 * self.reg * torch.dot(w, w))

    def ell_batch_grad_data(self, w: torch.Tensor, cols: torch.Tensor,
                            vals: torch.Tensor,
                            yb: torch.Tensor) -> torch.Tensor:
        """``(1/b) scatter(cols, s_i * vals)``, ``s = dloss(z, yb)`` — the
        gradient the reference takes by autodiff of the gather.

        The scatter is ``index_put_(accumulate=True)`` with deterministic
        algorithms switched on for this call only: that is the sort-based
        kernel, which adds each column's contributions in their order in
        ``cols``, so the same batch gives the same bits on every run (float
        atomics, as in ``index_add_`` on CUDA, add in whatever order the
        hardware picks).  The switch is scoped so the rest of the process
        keeps its own setting."""
        s = dloss(self.loss, self.ell_margins(w, cols, vals), yb) / yb.shape[0]
        contrib = (s[:, None] * vals).reshape(-1)
        g = torch.zeros_like(w)
        with _deterministic():
            g.index_put_((cols.reshape(-1),), contrib, accumulate=True)
        return g

    # ---- theory constants (Assumptions 1 & 2) ---------------------------
    def lipschitz(self, X: torch.Tensor) -> torch.Tensor:
        """Upper bound on L for the chosen loss: c * max_i ||x_i||^2 + C.

        logistic: c = 1/4, square/smooth_hinge: c = 1.
        """
        c = 0.25 if self.loss == LOGISTIC else 1.0
        row_sq = torch.sum(X * X, dim=1)
        return c * torch.max(row_sq) + self.reg


# ---------------------------------------------------------------------------
# The two access patterns the paper compares, as data-selection primitives.
# ---------------------------------------------------------------------------

def block_rows(start: Start, l: int, batch_size: int,
               device=None) -> torch.Tensor:
    """Row ids ``[clip(start, 0, l-b), +b)`` of a contiguous batch — the
    clamp of ``lax.dynamic_slice`` at both ends.  ``start`` may be an int or
    a device tensor; a tensor is never read back to the host."""
    if isinstance(start, torch.Tensor):
        s = torch.clamp(start.reshape(()).to(torch.int64), 0, l - batch_size)
        return s + torch.arange(batch_size, device=start.device)
    s = min(max(int(start), 0), l - batch_size)
    return torch.arange(s, s + batch_size, device=device)


def gather_batch(X: torch.Tensor, y: torch.Tensor,
                 idx: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Scattered selection (RS): one gathered row per index."""
    return X.index_select(0, idx), y.index_select(0, idx)


def slice_batch(X: torch.Tensor, y: torch.Tensor, start: Start,
                batch_size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Contiguous selection (CS/SS) with the ``dynamic_slice`` clamp."""
    return gather_batch(X, y, block_rows(start, X.shape[0], batch_size,
                                         X.device))
