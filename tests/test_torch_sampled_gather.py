"""The port's gather kernels and access model against the reference.

* ``block_gather`` / ``random_gather`` (their plain versions, which a CPU
  tensor takes) against ``repro.kernels.sampled_gather`` in interpret mode,
  over the reference test's shape and dtype sweep: equal BITS (a copy has
  no rounding; bfloat16 is compared as raw 16-bit words).
* Clamped block starts against ``repro.kernels.ref.block_gather`` (the
  ``lax.dynamic_slice`` clamp); the interpret-mode kernel reads padding
  there, so it is no oracle for them.
* ``repro_torch.kernels.ops`` on the CPU against ``repro.kernels.ops``.
* ``access_model``: the ``hdd`` / ``ssd`` / ``ram`` tiers give the
  reference's floats exactly, and the reference's formulas applied to the
  port's own ``hbm_dma`` constants give the port's.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import access_model as jam
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.kernels import sampled_gather as jsg
from repro_torch.core import access_model as tam
from repro_torch.kernels import ops as tops
from repro_torch.kernels import sampled_gather as tsg

DTYPES = {"float32": (jnp.float32, torch.float32),
          "bfloat16": (jnp.bfloat16, torch.bfloat16),
          "int32": (jnp.int32, torch.int32)}


def _pair(base: np.ndarray, dtype: str):
    """The same values for both packages: ``base`` (float32 or int) cast
    to ``dtype`` by each framework (round to nearest even for bfloat16)."""
    jd, td = DTYPES[dtype]
    return jnp.asarray(base).astype(jd), torch.from_numpy(base).to(td)


def _bits(a) -> np.ndarray:
    """Raw words of a jax or torch array, for an exact comparison."""
    if isinstance(a, torch.Tensor):
        a = a.view(torch.int16) if a.dtype == torch.bfloat16 else a
        return a.numpy().view(np.uint16 if a.dtype == torch.int16
                              else np.uint32)
    a = np.asarray(a)
    return a.view(np.uint16 if a.dtype.itemsize == 2 else np.uint32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("l,n,b", [(64, 128, 8), (256, 256, 32), (40, 512, 8)])
def test_block_gather_matches_reference_bitwise(l, n, b, dtype):
    jd, td = _pair(np.arange(l * n).reshape(l, n), dtype)
    for blk in range(l // b):
        want = jsg.block_gather(jd, jnp.asarray(blk, jnp.int32),
                                batch_size=b, interpret=True)
        got = tsg.block_gather(td, torch.tensor(blk, dtype=torch.int32),
                               batch_size=b)
        assert got.dtype == td.dtype and tuple(got.shape) == (b, n)
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=blk)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("l,n,b", [(64, 128, 8), (512, 256, 16)])
def test_random_gather_matches_reference_bitwise(l, n, b, dtype):
    rng = np.random.default_rng(l + n)
    jd, td = _pair(rng.normal(size=(l, n)).astype(np.float32), dtype)
    idx = rng.integers(0, l, size=b).astype(np.int32)
    idx[1], idx[2] = idx[0], l - 1                  # duplicates, the end
    want = jsg.random_gather(jd, jnp.asarray(idx), interpret=True)
    got = tsg.random_gather(td, torch.from_numpy(idx))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("l,b,blk", [(44, 8, 5), (44, 8, 6), (40, 8, 9),
                                     (7, 7, 3)])
def test_block_gather_clamps_like_dynamic_slice(l, b, blk, dtype):
    """A block past the end reads the last b rows, as
    ``lax.dynamic_slice`` (``ref.block_gather``) clamps its start."""
    jd, td = _pair(np.arange(l * 5).reshape(l, 5), dtype)
    want = jref.block_gather(jd, blk, b)
    got = tsg.block_gather(td, torch.tensor(blk, dtype=torch.int32),
                           batch_size=b)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(got), _bits(td[l - b:]))


def test_out_of_range_ids_and_negative_blocks_clamp():
    """The port's rule where the reference's TPU DMA is undefined: ids
    below 0 read row 0, ids of l or more read row l - 1; a negative block
    starts at row 0."""
    X = torch.arange(30, dtype=torch.float32).reshape(10, 3)
    out = tsg.random_gather(X, torch.tensor([-4, -1, 0, 9, 10, 99],
                                            dtype=torch.int32))
    assert torch.equal(out, X[[0, 0, 0, 9, 9, 9]])
    # ids of l or more: the reference's interpret mode reads row l - 1 too
    jout = jsg.random_gather(jnp.asarray(X.numpy()),
                             jnp.asarray([9, 10, 99], jnp.int32),
                             interpret=True)
    np.testing.assert_array_equal(out[3:].numpy(), np.asarray(jout))
    blk = tsg.block_gather(X, torch.tensor(-2, dtype=torch.int32),
                           batch_size=4)
    assert torch.equal(blk, X[:4])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
def test_ops_on_cpu_match_reference_ops(dtype):
    rng = np.random.default_rng(3)
    l, n, b = 96, 33, 12
    jd, td = _pair((rng.normal(size=(l, n)) * 50).astype(np.float32)
                   if dtype != "int32" else rng.integers(-9, 9, (l, n)),
                   dtype)
    for blk in (0, 3, 7):
        np.testing.assert_array_equal(
            _bits(tops.block_gather(td, torch.tensor(blk, dtype=torch.int32),
                                    batch_size=b)),
            _bits(jops.block_gather(jd, jnp.asarray(blk, jnp.int32),
                                    batch_size=b)))
    if dtype != "int32":          # the reference sweeps RS over floats only
        idx = rng.integers(0, l, size=b).astype(np.int32)
        np.testing.assert_array_equal(
            _bits(tops.random_gather(td, torch.from_numpy(idx))),
            _bits(jops.random_gather(jd, jnp.asarray(idx))))


def test_cpu_runs_the_plain_versions_and_counts_no_launch():
    tsg.reset_launches()
    X = torch.randn(20, 4)
    tops.block_gather(X, 1, batch_size=5)          # an int block index too
    tops.random_gather(X, torch.tensor([3, 3, 1], dtype=torch.int32))
    assert tsg.LAUNCHES == {"block_gather": 0, "random_gather": 0}


@pytest.mark.parametrize("call,exc", [
    (lambda X: tsg.block_gather(X.double(), 0, batch_size=2), TypeError),
    (lambda X: tsg.block_gather(X, 0, batch_size=11), ValueError),
    (lambda X: tsg.block_gather(X, 0, batch_size=0), ValueError),
    (lambda X: tsg.block_gather(X.t(), 0, batch_size=2), ValueError),
    (lambda X: tsg.block_gather(X[0], 0, batch_size=2), ValueError),
    (lambda X: tsg.block_gather(X, torch.tensor(0), batch_size=2), TypeError),
    (lambda X: tsg.random_gather(X, torch.tensor([1, 2])), TypeError),
    (lambda X: tsg.random_gather(X, torch.zeros(0, dtype=torch.int32)),
     ValueError),
    (lambda X: tsg.random_gather(X, torch.zeros((2, 2), dtype=torch.int32)),
     ValueError)])
def test_wrappers_refuse_what_the_kernels_do_not_take(call, exc):
    with pytest.raises(exc):
        call(torch.zeros(10, 10))


# ---------------------------------------------------------------------------
# the access model
# ---------------------------------------------------------------------------

SIZES = [(1000, 500, 72), (200_000, 1000, 400), (5_000_000, 500, 76),
         (20_000, 500, 16_384), (33, 7, 3)]


@pytest.mark.parametrize("tier", ["hdd", "ssd", "ram"])
def test_paper_tiers_equal_the_reference(tier):
    t, j = tam.TIERS[tier], jam.TIERS[tier]
    assert dataclasses.asdict(t) == dataclasses.asdict(j)
    for l, b, row in SIZES:
        for scheme in ("random", "cyclic", "systematic"):
            assert (tam.batch_access_time(t, scheme, b, row)
                    == jam.batch_access_time(j, scheme, b, row))
            assert (tam.epoch_access_time(t, scheme, l, b, row)
                    == jam.epoch_access_time(j, scheme, l, b, row))
        for proc in (0.0, 0.5):
            assert (tam.predicted_speedup(t, l, b, row, proc)
                    == jam.predicted_speedup(j, l, b, row, proc))


def test_card_tier_follows_the_reference_formulas():
    """The port's ``hbm_dma`` holds the card's own constants (not the
    reference's TPU ones); the reference's arithmetic on them gives the
    port's results exactly."""
    t = tam.HBM_DMA
    assert set(tam.TIERS) == set(jam.TIERS)
    assert t.name == "hbm_dma"
    assert dataclasses.astuple(t) != dataclasses.astuple(jam.HBM_DMA)
    j = jam.Tier(**dataclasses.asdict(t))
    for l, b, row in SIZES:
        for scheme in ("random", "cyclic", "systematic"):
            assert (tam.batch_access_time(t, scheme, b, row)
                    == jam.batch_access_time(j, scheme, b, row))
        assert (tam.predicted_speedup(t, l, b, row)
                == jam.predicted_speedup(j, l, b, row))


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown scheme"):
        tam.batch_access_time(tam.RAM, "sorted", 10, 8)
