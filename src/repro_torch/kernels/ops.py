"""Public entry points of the port's stand-alone kernels — the gather half
of ``repro.kernels.ops``.

:func:`block_gather` and :func:`random_gather` are the paper's two access
patterns at the device-memory tier (contiguous CS/SS block against scattered
RS rows); :mod:`repro_torch.kernels.sampled_gather` holds their CUDA
kernels and plain versions.  On CUDA tensors they launch the kernels, on CPU
tensors they run the plain versions: there is no interpret mode to choose,
as the reference's ``ops`` chooses one off the TPU.

The reference's three LM wrappers (``flash_attention``, ``ssd``, ``rglru``)
are not here: their kernels come with the LM zoo (ROADMAP queue 1, item 14).
"""
from __future__ import annotations

from . import sampled_gather as _sg

__all__ = ["block_gather", "random_gather"]


def block_gather(data, block_idx, *, batch_size: int):
    """Contiguous mini-batch fetch (CS/SS access pattern): one block copy."""
    return _sg.block_gather(data, block_idx, batch_size=batch_size)


def random_gather(data, idx):
    """Scattered mini-batch fetch (RS access pattern): one copy per row."""
    return _sg.random_gather(data, idx)
