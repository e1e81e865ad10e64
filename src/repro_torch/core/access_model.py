"""Data-access-time cost model (paper §1, eq. (1)) generalised across tiers.

The port of ``repro.core.access_model``.  The paper decomposes
``training_time = access_time + processing_time`` and ``access_time = seek +
rotational latency + transfer``.  On electronic tiers (RAM, SSD, device
memory) seek and latency collapse into a fixed per-descriptor issue cost,
but the block-wise transfer mechanics are the same: a contiguous mini-batch
costs ~1 descriptor, a scattered one ~b.  This module predicts access time
per scheme per tier; ``chip_smoke.py`` phase 2d measures it on the card.

The ``hdd``, ``ssd`` and ``ram`` tiers are the reference's, constant for
constant.  The ``hbm_dma`` tier is the H100's own, measured by
``chip_smoke.py`` phase 2d with the port's gather kernels
(:mod:`repro_torch.kernels.sampled_gather`) on an NVIDIA H100 80GB HBM3,
power limit 700.00 W:

* ``bandwidth``: the bytes of one full-size contiguous batch (500 rows of
  4,096 float32, 8,192,000 bytes) over ``block_gather``'s device time;
* ``latency_s``: the per-descriptor cost, ``(t_rs - t_ss) / (b - 1)`` from
  ``random_gather`` (b row copies) against ``block_gather`` (one block) at
  equal bytes (b = 1,000 rows of 100 float32);
* ``block_bytes``: the card's 32-byte memory sector.

The tier leaves out what dominates a batch on the card at these sizes: the
~6 us a kernel launch costs whatever it copies (see ``PERF.md``).
"""
from __future__ import annotations

import dataclasses
import math

from . import samplers


@dataclasses.dataclass(frozen=True)
class Tier:
    """A storage tier. Times in seconds, bandwidth in bytes/s, block in bytes."""
    name: str
    seek_s: float          # head movement (0 for electronic tiers)
    latency_s: float       # rotational / per-request issue latency
    bandwidth: float       # sustained transfer bandwidth
    block_bytes: int       # minimum transfer granule


# HDD/SSD/RAM follow the paper's narrative (the reference's constants);
# HBM_DMA is the H100's device memory as the gather kernels see it (above).
HDD = Tier("hdd", seek_s=9e-3, latency_s=4.2e-3, bandwidth=160e6, block_bytes=4096)
SSD = Tier("ssd", seek_s=0.0, latency_s=60e-6, bandwidth=2.5e9, block_bytes=4096)
RAM = Tier("ram", seek_s=0.0, latency_s=1e-7, bandwidth=25e9, block_bytes=64)
HBM_DMA = Tier("hbm_dma", seek_s=0.0, latency_s=3.363363336663586e-10,
               bandwidth=8.366013024637439e11, block_bytes=32)
TIERS = {t.name: t for t in (HDD, SSD, RAM, HBM_DMA)}


def batch_access_time(tier: Tier, scheme: str, batch_size: int,
                      row_bytes: int) -> float:
    """Predicted seconds to access ONE mini-batch of `batch_size` rows.

    Contiguous schemes (CS/SS) issue one descriptor covering the whole block;
    RS issues one per row (each row may straddle block granules).
    """
    total_bytes = batch_size * row_bytes
    if scheme in (samplers.CYCLIC, samplers.SYSTEMATIC):
        n_desc = 1
        blocks = math.ceil(total_bytes / tier.block_bytes)
    elif scheme == samplers.RANDOM:
        n_desc = batch_size
        blocks = batch_size * math.ceil(row_bytes / tier.block_bytes)
    else:
        raise ValueError(f"unknown scheme {scheme!r}")
    issue = n_desc * (tier.seek_s + tier.latency_s)
    transfer = blocks * tier.block_bytes / tier.bandwidth
    return issue + transfer


def epoch_access_time(tier: Tier, scheme: str, l: int, batch_size: int,
                      row_bytes: int) -> float:
    m = samplers.num_batches(l, batch_size)
    return m * batch_access_time(tier, scheme, batch_size, row_bytes)


def predicted_speedup(tier: Tier, l: int, batch_size: int, row_bytes: int,
                      processing_s_per_epoch: float = 0.0) -> float:
    """Predicted epoch-time speedup of SS over RS (paper reports up to 6x)."""
    rs = epoch_access_time(tier, samplers.RANDOM, l, batch_size, row_bytes)
    ss = epoch_access_time(tier, samplers.SYSTEMATIC, l, batch_size, row_bytes)
    return (rs + processing_s_per_epoch) / (ss + processing_s_per_epoch)
