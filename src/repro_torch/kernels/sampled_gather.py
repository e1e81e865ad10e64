"""Mini-batch assembly kernels — the paper's access patterns at the
device-memory tier.

The port of ``repro.kernels.sampled_gather``.  Two CUDA kernels
(``csrc/sampled_gather.cu``) replace the two Pallas TPU kernels:

======================  ================================================
wrapper                 replaces (``src/repro/kernels/sampled_gather.py``)
======================  ================================================
:func:`block_gather`    ``block_gather`` (line 34), CS/SS
:func:`random_gather`   ``random_gather`` (line 58), RS
======================  ================================================

* :func:`block_gather` copies the contiguous rows
  ``[clip(block_idx*b, 0, l-b), +b)`` — the clamp of ``lax.dynamic_slice``
  (``repro.kernels.ref.block_gather``) — as one region, with the widest
  loads its alignment allows over one grid of CTAs.  ``block_idx`` is an
  int32 scalar tensor that the kernel reads from device memory; it is never
  read back to the host.
* :func:`random_gather` copies ``data[idx]``, one warp per row.  Duplicate
  ids are allowed.  An id outside ``[0, l)`` is clamped to the nearest row:
  a negative id reads row 0, an id of ``l`` or more reads row ``l - 1``, so
  the kernel never reads outside ``data``.  (The reference's TPU DMA is
  undefined there; its interpret mode reads row ``l - 1`` for ids of ``l``
  or more and counts negative ids from the end.)

Both take float32, bfloat16 or int32 data — the dtypes the reference's
tests sweep — and, being copies, equal their plain versions bit for bit.
Beside each kernel is its plain PyTorch version (``index_select`` on the
block's rows or on the clamped ids).  A wrapper given CPU tensors runs the
plain version; given CUDA tensors it launches the kernel or raises — there
is no fallback.  Each launch adds one to its count in :data:`LAUNCHES`.
"""
from __future__ import annotations

import ctypes
from typing import Union

import torch

from ..core.erm import block_rows

__all__ = ["DTYPES", "LAUNCHES", "reset_launches", "block_gather",
           "random_gather"]

#: element types the kernels take (one copy kernel over the row's bytes)
DTYPES = (torch.float32, torch.bfloat16, torch.int32)

#: kernel launches per wrapper, counted where the kernel is launched
LAUNCHES = {"block_gather": 0, "random_gather": 0}


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain PyTorch versions (the CPU path, the tests' and the card check's oracle)
# ---------------------------------------------------------------------------

def _block_gather_plain(data: torch.Tensor, block_idx: torch.Tensor,
                        b: int) -> torch.Tensor:
    start = block_idx.reshape(()).to(torch.int64) * b
    return data.index_select(0, block_rows(start, data.shape[0], b))


def _random_gather_plain(data: torch.Tensor,
                         idx: torch.Tensor) -> torch.Tensor:
    return data.index_select(0, idx.clamp(0, data.shape[0] - 1))


# ---------------------------------------------------------------------------
# argument checks and the ctypes launch
# ---------------------------------------------------------------------------

def _check_data(data) -> None:
    if not isinstance(data, torch.Tensor):
        raise TypeError(f"data must be a torch.Tensor, got "
                        f"{type(data).__name__}")
    if data.dtype not in DTYPES:
        raise TypeError(f"data must be one of {DTYPES}, got {data.dtype}")
    if data.dim() != 2:
        raise ValueError(f"data must be (l, n), got shape "
                         f"{tuple(data.shape)}")
    if data.shape[0] < 1:
        raise ValueError("data must hold at least one row")
    if not data.is_contiguous():
        raise ValueError("data must be contiguous")
    if data.device.type not in ("cpu", "cuda"):
        raise ValueError(f"the gather kernels run on cuda (or the plain "
                         f"version on cpu), got {data.device}")


def _check_index(name: str, t, ndim: int, device) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got "
                        f"{type(t).__name__}")
    if t.dtype != torch.int32:
        raise TypeError(f"{name} must be torch.int32, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got shape "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.device != device:
        raise ValueError(f"{name} lies on {t.device}, data on {device}")


def _lib() -> ctypes.CDLL:
    from . import _build
    lib = _build.load("sampled_gather")
    if not getattr(lib, "_repro_typed", False):
        P, I, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.repro_block_gather.argtypes = [P, P, I, L, I, P, P]
        lib.repro_random_gather.argtypes = [P, P, I, L, I, P, P]
        lib.repro_block_gather.restype = I
        lib.repro_random_gather.restype = I
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


# ---------------------------------------------------------------------------
# the two kernel wrappers
# ---------------------------------------------------------------------------

def block_gather(data: torch.Tensor, block_idx: Union[int, torch.Tensor], *,
                 batch_size: int) -> torch.Tensor:
    """Rows ``[clip(block_idx*b, 0, l-b), +b)`` of ``data`` (l, n) as a new
    (b, n) tensor: one contiguous copy (CS/SS).  ``block_idx`` is the
    mini-batch number, an int32 scalar tensor on ``data``'s device (an int
    is put there first)."""
    _check_data(data)
    l, n = data.shape
    b = int(batch_size)
    if not 1 <= b <= l:
        raise ValueError(f"batch_size must be in [1, {l}], got {batch_size!r}")
    if not isinstance(block_idx, torch.Tensor):
        block_idx = torch.tensor(int(block_idx), dtype=torch.int32,
                                 device=data.device)
    if block_idx.numel() != 1:
        raise ValueError(f"block_idx must hold one int32, got shape "
                         f"{tuple(block_idx.shape)}")
    _check_index("block_idx", block_idx, block_idx.dim(), data.device)
    if data.device.type == "cpu":
        return _block_gather_plain(data, block_idx, b)
    out = torch.empty((b, n), dtype=data.dtype, device=data.device)
    _launch("block_gather", "repro_block_gather", data.data_ptr(),
            block_idx.data_ptr(), l, n * data.element_size(), b,
            out.data_ptr())
    return out


def random_gather(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``data[idx]`` as a new (b, n) tensor, one row per id (RS); ``idx`` is
    (b,) int32 on ``data``'s device, duplicates allowed, ids outside
    ``[0, l)`` clamped to the nearest row."""
    _check_data(data)
    _check_index("idx", idx, 1, data.device)
    l, n = data.shape
    b = idx.shape[0]
    if b < 1:
        raise ValueError("idx must hold at least one row id")
    if data.device.type == "cpu":
        return _random_gather_plain(data, idx)
    out = torch.empty((b, n), dtype=data.dtype, device=data.device)
    _launch("random_gather", "repro_random_gather", data.data_ptr(),
            idx.data_ptr(), l, n * data.element_size(), b, out.data_ptr())
    return out
