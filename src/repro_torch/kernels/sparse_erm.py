"""CSR mini-batch margin and gradient kernels.

The port of ``repro.kernels.sparse_erm``.  The data-term gradient

    g_data = (1/b) * Xb^T s,   s_i = dloss/dz(z_i, y_i),   z_i = x_i . w

and the margins ``z`` come straight from CSR storage resident on the device
(flat ``vals``/``cols`` plus an int32 ``indptr``, staged once by
:func:`csr_to_device`): the batch is never densified.  Four CUDA kernels
(``csrc/sparse_erm.cu``) replace the four Pallas TPU kernels:

===========================  ===========================================
wrapper                      replaces (``src/repro/kernels/sparse_erm.py``)
===========================  ===========================================
:func:`sparse_grad_rows`     ``sparse_grad_rows`` (line 180), RS
:func:`sparse_grad_block`    ``sparse_grad_block`` (line 260), CS/SS
:func:`sparse_margins_rows`  ``sparse_margins_rows`` (line 339), RS
:func:`sparse_margins_block` ``sparse_margins_block`` (line 405), CS/SS
===========================  ===========================================

As in the reference, no backend of the planner runs them: the
``sparse-csr`` backend steps on padded-ELL batches.  They are reached
through :func:`csr_to_device` and the ``sparse_batch_*`` wrappers.

Each has a plain PyTorch version beside it (``_grad_rows_plain`` …): element
ids from ``repeat_interleave`` over the row lengths, then ``index_add_``.
Batch semantics as in ``fused_erm``: block rows ``[clip(start, 0, l-b),
+b)`` or exactly the rows of ``idx`` (duplicates and wrap-around included);
an empty row has z = 0; a column repeated within a row adds its values.
A wrapper given CPU tensors runs the plain version; given CUDA tensors it
launches the kernel or raises — there is no fallback.  Each kernel launch
adds one to its count in :data:`LAUNCHES`.

The gradient kernels add in a fixed order (no float atomics), so the same
inputs give the same bits on every call; the plain versions' ``index_add_``
does not promise that on CUDA and serves as an oracle only.
"""
from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.erm import ERMProblem, Start, block_rows, dloss
from .fused_erm import (_LOSS_CODE, _check_block, _check_tensor, _one_of, _p,
                        _start_arg, fused_batch_labels)

__all__ = ["LAUNCHES", "reset_launches", "CSRDevice", "csr_to_device",
           "sparse_grad_rows", "sparse_grad_block", "sparse_margins_rows",
           "sparse_margins_block", "sparse_batch_grad_data",
           "sparse_batch_grad", "sparse_batch_margins",
           "sparse_batch_objective"]

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"sparse_grad_rows": 0, "sparse_grad_block": 0,
            "sparse_margins_rows": 0, "sparse_margins_block": 0}

#: row groups of the gradient scatter (each owns an n-wide partial)
GROUPS = 32


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def _round_up(x: int, mult: int) -> int:
    return -(-x // mult) * mult


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, the tests' and the card check's oracle)
# ---------------------------------------------------------------------------

def _segments(indptr, rows):
    """(element ids, batch-row ids) of every stored nonzero of ``rows``."""
    starts = indptr.index_select(0, rows).long()
    lens = indptr.index_select(0, rows + 1).long() - starts
    rowid = torch.repeat_interleave(
        torch.arange(rows.shape[0], device=rows.device), lens)
    offs = torch.cumsum(lens, 0) - lens
    elem = (torch.repeat_interleave(starts - offs, lens)
            + torch.arange(rowid.shape[0], device=rows.device))
    return elem, rowid


def _margins_rows_plain(vals, cols, indptr, w, rows):
    elem, rowid = _segments(indptr, rows)
    prod = vals.index_select(0, elem) * w.index_select(
        0, cols.index_select(0, elem))
    return torch.zeros(rows.shape[0], dtype=w.dtype,
                       device=w.device).index_add_(0, rowid, prod)


def _grad_rows_plain(vals, cols, indptr, y, w, rows, loss: str):
    b = rows.shape[0]
    elem, rowid = _segments(indptr, rows)
    v = vals.index_select(0, elem)
    c = cols.index_select(0, elem)
    z = torch.zeros(b, dtype=w.dtype, device=w.device).index_add_(
        0, rowid, v * w.index_select(0, c))
    s = dloss(loss, z, y.index_select(0, rows)) / b
    return torch.zeros_like(w).index_add_(0, c, v * s.index_select(0, rowid))


def _margins_block_plain(vals, cols, indptr, w, start: Start, b: int):
    rows = block_rows(start, indptr.shape[0] - 1, b, w.device)
    return _margins_rows_plain(vals, cols, indptr, w, rows)


def _grad_block_plain(vals, cols, indptr, y, w, start: Start, b: int,
                      loss: str):
    rows = block_rows(start, indptr.shape[0] - 1, b, w.device)
    return _grad_rows_plain(vals, cols, indptr, y, w, rows, loss)


# ---------------------------------------------------------------------------
# argument checks and the ctypes launch
# ---------------------------------------------------------------------------

def _check(vals, cols, indptr, w, y=None, idx=None):
    """(l, n) after checking the CSR arrays, ``w`` and the optional ``y``
    and ``idx`` — types, shapes, contiguity, one device."""
    if not isinstance(vals, torch.Tensor):
        raise TypeError(f"vals must be a torch.Tensor, got "
                        f"{type(vals).__name__}")
    dev = vals.device
    if dev.type not in ("cpu", "cuda"):
        raise ValueError(f"sparse kernels run on cuda (or the plain version "
                         f"on cpu), got {dev}")
    _check_tensor("vals", vals, torch.float32, 1, dev)
    _check_tensor("cols", cols, torch.int32, 1, dev)
    if cols.shape != vals.shape:
        raise ValueError(f"cols has {cols.shape[0]} entries, vals "
                         f"{vals.shape[0]}")
    _check_tensor("indptr", indptr, torch.int32, 1, dev)
    if indptr.shape[0] < 2:
        raise ValueError("indptr must hold at least one row (l+1 >= 2)")
    l = indptr.shape[0] - 1
    _check_tensor("w", w, torch.float32, 1, dev)
    if y is not None:
        _check_tensor("y", y, torch.float32, 1, dev)
        if y.shape[0] != l:
            raise ValueError(f"y has {y.shape[0]} entries, indptr {l} rows")
    if idx is not None:
        _check_tensor("idx", idx, torch.int32, 1, dev)
        if idx.shape[0] < 1:
            raise ValueError("idx must hold at least one row")
    return l, w.shape[0]


def _lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("sparse_erm")
    if not getattr(lib, "_repro_typed", False):
        P, I = ctypes.c_void_p, ctypes.c_int
        lib.repro_csr_margins_block.argtypes = [P, P, P, P, P, I, I, I, P, P]
        lib.repro_csr_margins_rows.argtypes = [P, P, P, P, P, I, I, P, P]
        lib.repro_csr_grad_block.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                             I, P, P, P, P]
        lib.repro_csr_grad_rows.argtypes = [P, P, P, P, P, P, I, I, I, I, I,
                                            P, P, P, P]
        for fn in (lib.repro_csr_margins_block, lib.repro_csr_margins_rows,
                   lib.repro_csr_grad_block, lib.repro_csr_grad_rows):
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


def _grad_scratch(b: int, n: int, device):
    """(s, partials, g, groups) for a gradient launch."""
    groups = min(GROUPS, b)
    return (torch.empty(b, dtype=torch.float32, device=device),
            torch.empty((groups, n), dtype=torch.float32, device=device),
            torch.empty(n, dtype=torch.float32, device=device), groups)


# ---------------------------------------------------------------------------
# the four kernel wrappers
# ---------------------------------------------------------------------------

def sparse_grad_rows(vals, cols, indptr, y, w, idx, *,
                     loss: str) -> torch.Tensor:
    """Data-term gradient ``(1/b) Xb^T dloss(Xb w, yb)`` of the scattered
    CSR batch ``rows[idx]`` (RS).  ``idx``: (b,) int32.  Returns (n,) f32."""
    l, n = _check(vals, cols, indptr, w, y=y, idx=idx)
    if loss not in _LOSS_CODE:
        raise ValueError(f"unknown loss {loss!r}")
    if vals.device.type == "cpu":
        return _grad_rows_plain(vals, cols, indptr, y, w, idx, loss)
    b = idx.shape[0]
    s, part, g, groups = _grad_scratch(b, n, vals.device)
    _launch("sparse_grad_rows", "repro_csr_grad_rows", _p(vals), _p(cols),
            _p(indptr), _p(y), _p(w), _p(idx), l, n, b, _LOSS_CODE[loss],
            groups, _p(s), _p(part), _p(g))
    return g


def sparse_grad_block(vals, cols, indptr, y, w, start: Start, *, loss: str,
                      batch_size: int) -> torch.Tensor:
    """Data-term gradient of the contiguous CSR batch at row ``start``
    (CS/SS), clamped to ``[0, l-b]`` like ``fused_grad_block``.  Returns
    (n,) f32."""
    l, n = _check(vals, cols, indptr, w, y=y)
    b = _check_block(l, batch_size)
    if loss not in _LOSS_CODE:
        raise ValueError(f"unknown loss {loss!r}")
    sp, sv = _start_arg(start, vals.device)
    if vals.device.type == "cpu":
        return _grad_block_plain(vals, cols, indptr, y, w, start, b, loss)
    s, part, g, groups = _grad_scratch(b, n, vals.device)
    _launch("sparse_grad_block", "repro_csr_grad_block", _p(vals), _p(cols),
            _p(indptr), _p(y), _p(w), sp, sv, l, n, b, _LOSS_CODE[loss],
            groups, _p(s), _p(part), _p(g))
    return g


def sparse_margins_rows(vals, cols, indptr, w, idx) -> torch.Tensor:
    """Margins ``z_i = rows[idx[i]] . w`` of a scattered CSR batch (RS).
    Returns (b,) f32."""
    l, _ = _check(vals, cols, indptr, w, idx=idx)
    if vals.device.type == "cpu":
        return _margins_rows_plain(vals, cols, indptr, w, idx)
    b = idx.shape[0]
    z = torch.empty(b, dtype=torch.float32, device=vals.device)
    _launch("sparse_margins_rows", "repro_csr_margins_rows", _p(vals),
            _p(cols), _p(indptr), _p(w), _p(idx), l, b, _p(z))
    return z


def sparse_margins_block(vals, cols, indptr, w, start: Start, *,
                         batch_size: int) -> torch.Tensor:
    """Margins of the contiguous CSR batch at row ``start`` (CS/SS), with the
    same clamp as :func:`sparse_grad_block`.  Returns (b,) f32."""
    l, _ = _check(vals, cols, indptr, w)
    b = _check_block(l, batch_size)
    sp, sv = _start_arg(start, vals.device)
    if vals.device.type == "cpu":
        return _margins_block_plain(vals, cols, indptr, w, start, b)
    z = torch.empty(b, dtype=torch.float32, device=vals.device)
    _launch("sparse_margins_block", "repro_csr_margins_block", _p(vals),
            _p(cols), _p(indptr), _p(w), sp, sv, l, b, _p(z))
    return z


# ---------------------------------------------------------------------------
# device staging + batch-level wrappers (parity contract with fused_erm)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CSRDevice:
    """Device-resident CSR corpus: the kernels' input layout.

    ``vals``/``cols`` carry the reference's zero tail padding past ``nnz``
    (the TPU kernels' DMA windows needed it; the CUDA kernels read only
    ``[indptr[r], indptr[r+1])``).  ``indptr`` is int32 (nnz < 2^31 checked
    at staging)."""
    vals: torch.Tensor     # (nnz + pad,) float32
    cols: torch.Tensor     # (nnz + pad,) int32
    indptr: torch.Tensor   # (rows+1,) int32
    y: torch.Tensor        # (rows,) float32
    rows: int
    features: int
    kmax: int
    nnz: int


def csr_to_device(corpus, *, batch_size: Optional[int] = None,
                  device="cuda") -> CSRDevice:
    """Stage a ``repro_torch.data.sparse.CSRCorpus`` (duck-typed) on
    ``device`` — the card unless the caller asks for the CPU.

    The tail padding is the reference's: ``round_up(b * kmax + K, 128)``
    zeros with ``K = round_up(kmax, 128)`` and ``b = batch_size or 1``.
    Raises ``ValueError`` for ``nnz >= 2**31``, a column outside
    ``[0, features)``, or a row whose columns are not in ascending order
    (the gradient kernels add a repeated column as a run of neighbours)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "csr_to_device stages on the card by default, and this host has "
            "no CUDA device; pass device=\"cpu\" for the plain versions")
    nnz = int(np.asarray(corpus.indptr[-1]))
    if nnz >= 2 ** 31:
        raise ValueError("CSR corpus too large for int32 element offsets")
    kmax = max(1, int(corpus.kmax))
    K = _round_up(kmax, 128)
    pad = _round_up((batch_size or 1) * kmax + K, 128)
    indptr = np.asarray(corpus.indptr)
    cols = np.asarray(corpus.indices[:nnz])
    if nnz and (cols.min() < 0 or cols.max() >= corpus.features):
        raise ValueError(f"CSR column ids must lie in [0, "
                         f"{corpus.features}), got [{cols.min()}, "
                         f"{cols.max()}]")
    falls = np.flatnonzero(np.diff(cols) < 0) + 1     # element k < k-1
    if np.any(np.isin(falls, indptr, invert=True)):
        raise ValueError("each CSR row must list its columns in ascending "
                         "order (as ingest_libsvm and the generators write "
                         "them)")

    def flat(mm, dt):
        a = np.zeros(nnz + pad, dt)
        a[:nnz] = np.asarray(mm[:nnz])
        return torch.from_numpy(a).to(dev)

    return CSRDevice(
        vals=flat(corpus.values, np.float32),
        cols=flat(corpus.indices, np.int32),
        indptr=torch.from_numpy(indptr.astype(np.int32)).to(dev),
        y=torch.from_numpy(np.array(corpus.labels, np.float32)).to(dev),
        rows=int(corpus.rows), features=int(corpus.features),
        kmax=kmax, nnz=nnz)


def sparse_batch_grad_data(problem: ERMProblem, dev: CSRDevice, w, *,
                           start=None, idx=None, batch_size=None):
    """``problem.batch_grad_data`` of the sampled CSR batch, from the
    kernels.  Pass exactly one of ``start`` (contiguous CS/SS block; needs
    ``batch_size``) or ``idx`` (scattered RS rows)."""
    _one_of(start, idx, batch_size)
    if start is not None:
        return sparse_grad_block(dev.vals, dev.cols, dev.indptr, dev.y, w,
                                 start, loss=problem.loss,
                                 batch_size=batch_size)
    return sparse_grad_rows(dev.vals, dev.cols, dev.indptr, dev.y, w, idx,
                            loss=problem.loss)


def sparse_batch_grad(problem: ERMProblem, dev: CSRDevice, w, **kw):
    """``problem.batch_grad`` from the kernels (adds the l2 term)."""
    return sparse_batch_grad_data(problem, dev, w, **kw) + problem.reg * w


def sparse_batch_margins(dev: CSRDevice, w, *, start=None, idx=None,
                         batch_size=None):
    """Margins of the sampled CSR batch — the CSR counterpart of
    ``fused_erm.fused_batch_margins``.  Pass exactly one of ``start``
    (CS/SS; needs ``batch_size``) or ``idx`` (RS)."""
    _one_of(start, idx, batch_size)
    if start is not None:
        return sparse_margins_block(dev.vals, dev.cols, dev.indptr, w, start,
                                    batch_size=batch_size)
    return sparse_margins_rows(dev.vals, dev.cols, dev.indptr, w, idx)


def sparse_batch_objective(problem: ERMProblem, dev: CSRDevice, w, *,
                           start=None, idx=None, batch_size=None):
    """``problem.batch_objective`` of the sampled CSR batch — margins from
    the kernel, labels by an O(b) selection."""
    z = sparse_batch_margins(dev, w, start=start, idx=idx,
                             batch_size=batch_size)
    yb = fused_batch_labels(dev.y, start=start, idx=idx,
                            batch_size=batch_size)
    return problem.mean_margin_loss(z, yb) + 0.5 * problem.reg * torch.dot(w, w)
