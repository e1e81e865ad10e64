"""Fused sampled-gather + ERM gradient kernels — the resident epoch's hot path.

The port of ``repro.kernels.fused_erm``.  The data-term gradient

    g_data = (1/b) * Xb^T s,   s_i = dloss/dz(z_i, y_i),   z = Xb w

and the margins ``z`` come straight from the resident corpus: the sampled
batch never exists as an array in device memory.  Four CUDA kernels
(``csrc/fused_erm.cu``) replace the four Pallas TPU kernels:

==========================  ==========================================
wrapper                     replaces (``src/repro/kernels/fused_erm.py``)
==========================  ==========================================
:func:`fused_grad_block`    ``fused_grad_block`` (line 140), CS/SS
:func:`fused_grad_rows`     ``fused_grad_rows`` (line 197), RS
:func:`fused_margins_block` ``fused_margins_block`` (line 254), CS/SS
:func:`fused_margins_rows`  ``fused_margins_rows`` (line 290), RS
==========================  ==========================================

Each has a plain PyTorch version beside it (``_grad_block_plain`` …) with
the same semantics: block rows ``[clip(start, 0, l-b), +b)`` — the clamp of
``lax.dynamic_slice`` at both ends — or exactly the rows of ``idx``
(duplicates and wrap-around included).  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises — there
is no fallback.  Each kernel launch adds one to its count in
:data:`LAUNCHES`, so a run can show that it went through the kernels.

At the main-path shape (b = 500, n = 18) every kernel is bound by launch
latency, not by the 36 KB of X it reads; at n = 4096 it is bound by the
b*n*4 bytes it reads (see the note in the CUDA source).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from ..core.erm import (LOGISTIC, LOSSES, SMOOTH_HINGE, SQUARE, ERMProblem,
                        Start, block_rows, dloss)

__all__ = ["LOSSES", "LAUNCHES", "reset_launches", "fused_grad_block",
           "fused_grad_rows", "fused_margins_block", "fused_margins_rows",
           "fused_batch_margins", "fused_batch_labels", "fused_batch_objective",
           "fused_batch_grad_data", "fused_batch_grad"]

_LOSS_CODE = {LOGISTIC: 0, SQUARE: 1, SMOOTH_HINGE: 2}

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"fused_grad_block": 0, "fused_grad_rows": 0,
            "fused_margins_block": 0, "fused_margins_rows": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, the tests' and the card check's oracle)
# ---------------------------------------------------------------------------

def _margins_block_plain(X, w, start: Start, b: int):
    return X.index_select(0, block_rows(start, X.shape[0], b, X.device)) @ w


def _margins_rows_plain(X, w, idx):
    return X.index_select(0, idx) @ w


def _grad_block_plain(X, y, w, start: Start, b: int, loss: str):
    rows = block_rows(start, X.shape[0], b, X.device)
    Xb, yb = X.index_select(0, rows), y.index_select(0, rows)
    return (dloss(loss, Xb @ w, yb) / b) @ Xb


def _grad_rows_plain(X, y, w, idx, loss: str):
    Xb, yb = X.index_select(0, idx), y.index_select(0, idx)
    return (dloss(loss, Xb @ w, yb) / idx.shape[0]) @ Xb


# ---------------------------------------------------------------------------
# argument checks and the ctypes launch
# ---------------------------------------------------------------------------

def _check_tensor(name: str, t, dtype, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, X on {device}")


def _check(X, w, y=None, idx=None) -> Tuple[int, int]:
    if not isinstance(X, torch.Tensor):
        raise TypeError(f"X must be a torch.Tensor, got {type(X).__name__}")
    _check_tensor("X", X, torch.float32, 2, X.device)
    l, n = X.shape
    _check_tensor("w", w, torch.float32, 1, X.device)
    if w.shape[0] != n:
        raise ValueError(f"w has {w.shape[0]} entries, X has {n} features")
    if y is not None:
        _check_tensor("y", y, torch.float32, 1, X.device)
        if y.shape[0] != l:
            raise ValueError(f"y has {y.shape[0]} entries, X has {l} rows")
    if idx is not None:
        _check_tensor("idx", idx, torch.int32, 1, X.device)
        if idx.shape[0] < 1:
            raise ValueError("idx must hold at least one row")
    if X.device.type not in ("cpu", "cuda"):
        raise ValueError(f"fused kernels run on cuda (or the plain version "
                         f"on cpu), got {X.device}")
    return l, n


def _check_block(l: int, b: Optional[int]) -> int:
    if b is None or int(b) < 1:
        raise ValueError(f"batch_size must be a positive int, got {b!r}")
    if b > l:
        raise ValueError(f"batch_size {b} > rows {l}")
    return int(b)


def _start_arg(start: Start, device) -> Tuple[Optional[int], int]:
    """(device pointer, value) for the kernel's block start: a tensor start
    is read by the kernel from device memory, an int is passed by value."""
    if isinstance(start, torch.Tensor):
        if start.numel() != 1 or start.dtype != torch.int32:
            raise TypeError(f"start tensor must hold one int32, got "
                            f"{start.dtype} of shape {tuple(start.shape)}")
        if start.device != device:
            raise ValueError(f"start lies on {start.device}, X on {device}")
        return start.data_ptr(), 0
    return None, int(start)


def _lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("fused_erm")
    if not getattr(lib, "_repro_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.repro_margins_block.argtypes = [P, P, P, I, I, I, I, P, P]
        lib.repro_margins_rows.argtypes = [P, P, P, I, I, I, P, P]
        lib.repro_grad_block.argtypes = [P, P, P, P, I, I, I, I, I, P, P, P]
        lib.repro_grad_rows.argtypes = [P, P, P, P, I, I, I, I, P, P, P]
        for fn in (lib.repro_margins_block, lib.repro_margins_rows,
                   lib.repro_grad_block, lib.repro_grad_rows):
            fn.restype = I
        lib._repro_typed = True
    return lib


def _launch(name: str, fn: str, *args) -> None:
    """Call the C entry point on the current stream; raise on a nonzero
    ``cudaError_t``; count the launch."""
    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(_lib(), fn)(*args, stream)
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t "
                           f"{rc}")
    LAUNCHES[name] += 1


def _p(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


# ---------------------------------------------------------------------------
# the four kernel wrappers
# ---------------------------------------------------------------------------

def fused_grad_block(X, y, w, start: Start, *, loss: str,
                     batch_size: int) -> torch.Tensor:
    """Data-term gradient ``(1/b) Xb^T dloss(Xb w, yb)`` of the contiguous
    batch at row ``start`` (clamped to ``[0, l-b]``).  Returns (n,) f32."""
    l, n = _check(X, w, y=y)
    b = _check_block(l, batch_size)
    if loss not in _LOSS_CODE:
        raise ValueError(f"unknown loss {loss!r}")
    sp, sv = _start_arg(start, X.device)
    if X.device.type == "cpu":
        return _grad_block_plain(X, y, w, start, b, loss)
    s = torch.empty(b, dtype=torch.float32, device=X.device)
    g = torch.empty(n, dtype=torch.float32, device=X.device)
    _launch("fused_grad_block", "repro_grad_block", _p(X), _p(y), _p(w), sp,
            sv, l, n, b, _LOSS_CODE[loss], _p(s), _p(g))
    return g


def fused_grad_rows(X, y, w, idx, *, loss: str) -> torch.Tensor:
    """Data-term gradient of the scattered batch ``X[idx]`` (RS).
    ``idx``: (b,) int32.  Returns (n,) f32."""
    l, n = _check(X, w, y=y, idx=idx)
    if loss not in _LOSS_CODE:
        raise ValueError(f"unknown loss {loss!r}")
    if X.device.type == "cpu":
        return _grad_rows_plain(X, y, w, idx, loss)
    b = idx.shape[0]
    s = torch.empty(b, dtype=torch.float32, device=X.device)
    g = torch.empty(n, dtype=torch.float32, device=X.device)
    _launch("fused_grad_rows", "repro_grad_rows", _p(X), _p(y), _p(w),
            _p(idx), l, n, b, _LOSS_CODE[loss], _p(s), _p(g))
    return g


def fused_margins_block(X, w, start: Start, *,
                        batch_size: int) -> torch.Tensor:
    """Margins ``z = Xb @ w`` of the contiguous batch at row ``start``, with
    the same clamp as :func:`fused_grad_block`.  Returns (b,) f32."""
    l, n = _check(X, w)
    b = _check_block(l, batch_size)
    sp, sv = _start_arg(start, X.device)
    if X.device.type == "cpu":
        return _margins_block_plain(X, w, start, b)
    z = torch.empty(b, dtype=torch.float32, device=X.device)
    _launch("fused_margins_block", "repro_margins_block", _p(X), _p(w), sp,
            sv, l, n, b, _p(z))
    return z


def fused_margins_rows(X, w, idx) -> torch.Tensor:
    """Margins ``z_i = X[idx[i]] . w`` of a scattered batch (RS).
    Returns (b,) f32."""
    l, n = _check(X, w, idx=idx)
    if X.device.type == "cpu":
        return _margins_rows_plain(X, w, idx)
    b = idx.shape[0]
    z = torch.empty(b, dtype=torch.float32, device=X.device)
    _launch("fused_margins_rows", "repro_margins_rows", _p(X), _p(w),
            _p(idx), l, n, b, _p(z))
    return z


# ---------------------------------------------------------------------------
# batch-level wrappers (the solver- and step-rule-facing surface)
# ---------------------------------------------------------------------------

def _one_of(start, idx, batch_size) -> None:
    if (start is None) == (idx is None):
        raise ValueError("pass exactly one of start= (CS/SS) or idx= (RS)")
    if start is not None and batch_size is None:
        raise ValueError("start= (CS/SS block) also requires batch_size=")


def fused_batch_margins(X, w, *, start=None, idx=None, batch_size=None):
    """Margins of the sampled batch: ``start`` (contiguous CS/SS block; needs
    ``batch_size``) or ``idx`` (scattered RS rows)."""
    _one_of(start, idx, batch_size)
    if start is not None:
        return fused_margins_block(X, w, start, batch_size=batch_size)
    return fused_margins_rows(X, w, idx)


def fused_batch_labels(y, *, start=None, idx=None, batch_size=None):
    """Labels of the sampled batch, with the SAME clamp / wrap-around
    semantics as the kernels — the one place that logic lives for labels."""
    _one_of(start, idx, batch_size)
    if start is not None:
        return y.index_select(0, block_rows(start, y.shape[0], batch_size,
                                            y.device))
    return y.index_select(0, idx)


def fused_batch_objective(problem: ERMProblem, X, y, w, *, start=None,
                          idx=None, batch_size=None):
    """``problem.batch_objective`` of the sampled batch from the margins
    kernel, labels by an O(b) selection."""
    z = fused_batch_margins(X, w, start=start, idx=idx, batch_size=batch_size)
    yb = fused_batch_labels(y, start=start, idx=idx, batch_size=batch_size)
    return problem.mean_margin_loss(z, yb) + 0.5 * problem.reg * torch.dot(w, w)


def fused_batch_grad_data(problem: ERMProblem, X, y, w, *, start=None,
                          idx=None, batch_size=None):
    """``problem.batch_grad_data`` of the sampled batch, from the kernels."""
    _one_of(start, idx, batch_size)
    if start is not None:
        return fused_grad_block(X, y, w, start, loss=problem.loss,
                                batch_size=batch_size)
    return fused_grad_rows(X, y, w, idx, loss=problem.loss)


def fused_batch_grad(problem: ERMProblem, X, y, w, **kw):
    """``problem.batch_grad`` from the kernels (adds the l2 term)."""
    return fused_batch_grad_data(problem, X, y, w, **kw) + problem.reg * w
