"""Mini-batch sampling schemes from the paper (§2) as epoch schedules.

The reference draws its device-resident schedules in-graph with
``jax.random`` (``repro.core.samplers.epoch_indices`` /
``batch_slice_starts``), whose threefry bits torch cannot reproduce.  The
port draws every schedule on the host from the :class:`~.schemes.Scheme`
stream instead: :func:`epoch_schedule` stacks one epoch of that stream, and
the resident engine takes the result as an argument.  So in the port a
resident RS/SS epoch reads exactly the batches a streamed one does (and not
the reference's resident batches); CS is deterministic and agrees with the
reference everywhere.
"""
from __future__ import annotations

import numpy as np

from . import schemes
from .schemes import num_batches  # noqa: F401  (historical home)

RANDOM = "random"
CYCLIC = "cyclic"
SYSTEMATIC = "systematic"
SCHEMES = (RANDOM, CYCLIC, SYSTEMATIC)


def epoch_schedule(scheme: schemes.SchemeLike, seed: int, epoch: int,
                   l: int, batch_size: int) -> np.ndarray:
    """One epoch of the scheme's batch stream at ``(seed, epoch)``, stacked.

    Returns the block starts ``(m,)`` int32 for a contiguous scheme (CS/SS)
    or the row ids ``(m, b)`` int32 for RS — element ``j`` is exactly what
    ``next_batch`` emits at global step ``epoch * m + j`` (wrap-around
    padding of the trailing RS batch included).
    """
    scheme = schemes.resolve(scheme)
    if scheme.adaptive:
        raise ValueError(f"scheme {scheme.name!r} picks batches from run "
                         f"feedback; it has no precomputed epoch schedule")
    m = num_batches(l, batch_size)
    state = scheme.bind(l, batch_size, seed, step=epoch * m)
    first, state = scheme.next_batch(state)
    if first.start is not None:
        out = np.empty(m, np.int32)
        out[0] = first.start
        for j in range(1, m):
            bi, state = scheme.next_batch(state)
            out[j] = bi.start
        return out
    out = np.empty((m, batch_size), np.int32)
    out[0] = first.idx
    for j in range(1, m):
        bi, state = scheme.next_batch(state)
        out[j] = bi.idx
    return out
