"""The port's Checkpointer against the reference's
(``repro.checkpoint.checkpointer``): the counterparts of
``tests/test_checkpoint.py`` (roundtrip, atomicity, keep-k, async,
half-deleted-step fallback, meta-only reads — not the mesh resharding,
which waits for multi-GPU), plus the layout on disk held against the
reference's: a directory either package writes, the other restores, and one
checkpointed streamed-eager run leaves the same files, manifest index and
meta keys in both (arrays bit for bit where the arithmetic is integer).
"""
import json

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint.checkpointer import Checkpointer as JCheckpointer
from repro.core import experiment as jx
from repro.data import dataset as jds
from repro_torch.checkpoint import (Checkpointer, CheckpointPolicy,
                                    atomic_write_text)
from repro_torch.core import experiment as tx
from repro_torch.core import schemes


def tree():
    return {"params": {"w": torch.arange(12.0).reshape(3, 4),
                       "b": torch.ones(4)},
            "opt": (torch.zeros(()), [torch.full((2,), 7.0)])}


def _leaves(t):
    return [t["params"]["w"], t["params"]["b"], t["opt"][0], t["opt"][1][0]]


def _restore(ck, t, **kw):
    return ck.restore(t, device="cpu", **kw)


def test_roundtrip(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    t = tree()
    ck.save(10, t, {"step": 10, "note": "x"})
    restored, meta = _restore(ck, t)
    assert meta["step"] == 10
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert torch.equal(a, b) and a.dtype == b.dtype


def test_latest_pointer_and_keep_k(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=False)
    t = tree()
    for s in (1, 2, 3, 4):
        ck.save(s, t, {"step": s})
    assert ck.latest_step() == 4
    assert ck.all_steps() == [3, 4]


def test_async_save_overlaps_and_is_visible(tmp_path):
    ck = Checkpointer(tmp_path, async_save=True)
    ck.save(5, tree(), {"step": 5})
    ck.wait()
    assert ck.latest_step() == 5


def test_snapshot_is_a_copy_taken_at_save(tmp_path):
    """The engines update the SAG/SAGA table in place: a save must snapshot
    the values at the call, not a view the next epoch overwrites."""
    ck = Checkpointer(tmp_path, async_save=True)
    t = tree()
    ck.save(1, t, {})
    t["params"]["w"].add_(100.0)          # the "next epoch", in place
    ck.wait()
    restored, _ = _restore(ck, tree())
    assert torch.equal(restored["params"]["w"],
                       torch.arange(12.0).reshape(3, 4))


def test_crash_mid_save_leaves_no_corrupt_latest(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    t = tree()
    ck.save(1, t, {"step": 1})
    broken = tmp_path / ".tmp_step_0000000002_999"
    broken.mkdir()
    (broken / "garbage.npy").write_bytes(b"not-an-npy")
    assert ck.latest_step() == 1
    _, meta = _restore(ck, t)
    assert meta["step"] == 1


def test_keep_k_gc_under_concurrent_async_saves(tmp_path):
    ck = Checkpointer(tmp_path, keep=2, async_save=True)
    t = tree()
    for s in range(1, 8):
        ck.save(s, t, {"step": s})
    ck.wait()
    assert ck.all_steps() == [6, 7]
    assert all(ck._is_complete(s) for s in (6, 7))
    assert ck.latest_step() == 7
    _, meta = _restore(ck, t)
    assert meta["step"] == 7


def test_latest_pointing_at_half_deleted_step_falls_back(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    t = tree()
    for s in (1, 2, 3):
        ck.save(s, t, {"step": s})
    assert (tmp_path / "LATEST").read_text().strip() == "step_0000000003"
    sorted((tmp_path / "step_0000000003").glob("*.npy"))[0].unlink()
    assert ck.latest_step() == 2
    restored, meta = _restore(ck, t)
    assert meta["step"] == 2
    for a, b in zip(_leaves(t), _leaves(restored)):
        assert torch.equal(a, b)
    with pytest.raises(FileNotFoundError):
        _restore(ck, t, step=3)


def test_read_meta_is_array_free_and_fails_loudly_when_empty(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    with pytest.raises(FileNotFoundError):
        ck.read_meta()
    ck.save(4, tree(), {"step": 4, "note": "probe"})
    step, meta = ck.read_meta()
    assert step == 4 and meta["note"] == "probe"


def test_atomic_write_text_replaces_and_leaves_no_tmp(tmp_path):
    path = tmp_path / "state.json"
    atomic_write_text(path, '{"v": 1}')
    atomic_write_text(path, '{"v": 2}')
    assert json.loads(path.read_text()) == {"v": 2}
    assert list(tmp_path.glob(".tmp_*")) == []


def test_sampler_state_in_meta_roundtrip(tmp_path):
    scheme = schemes.Systematic()
    s = scheme.bind(100, 10, 11)
    for _ in range(3):
        _, s = scheme.next_batch(s)
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(3, tree(), {"step": 3, "sampler": scheme.state_meta(s)})
    _, meta = _restore(ck, tree())
    s2 = scheme.restore(meta["sampler"], 100, 10)
    a, _ = scheme.next_batch(s)
    b, _ = scheme.next_batch(s2)
    assert a.start == b.start and np.array_equal(a.idx, b.idx)


def test_elastic_restore_waits_for_multi_gpu(tmp_path):
    ck = Checkpointer(tmp_path, async_save=False)
    ck.save(1, tree(), {})
    with pytest.raises(NotImplementedError, match="item 12"):
        ck.restore(tree(), shardings=object())


@pytest.mark.parametrize("every,keep,msg", [(0, 3, "every"),
                                            (1, 0, "keep")])
def test_policy_validate(tmp_path, every, keep, msg):
    with pytest.raises(ValueError, match=msg):
        CheckpointPolicy(tmp_path, every=every, keep=keep).validate()
    assert CheckpointPolicy(str(tmp_path)) == CheckpointPolicy(tmp_path)


# ---------------------------------------------------------------------------
# the layout on disk, both ways
# ---------------------------------------------------------------------------

def _same_values(rng):
    w = rng.normal(size=(3, 4)).astype(np.float32)
    b = rng.normal(size=4).astype(np.float32)
    return w, b


def test_port_restores_a_reference_checkpoint(tmp_path):
    w, b = _same_values(np.random.default_rng(0))
    jtree = {"params": {"w": jnp.asarray(w), "b": jnp.asarray(b)},
             "opt": (jnp.zeros(()), [jnp.full((2,), 7.0)])}
    JCheckpointer(tmp_path, async_save=False).save(
        7, jtree, {"step": 7, "sampler_state": {"seed": 1, "step": 9}})
    restored, meta = _restore(Checkpointer(tmp_path), tree())
    assert meta == {"step": 7, "sampler_state": {"seed": 1, "step": 9}}
    np.testing.assert_array_equal(restored["params"]["w"].numpy(), w)
    np.testing.assert_array_equal(restored["params"]["b"].numpy(), b)
    assert restored["opt"][0].shape == () and restored["opt"][0].item() == 0
    assert torch.equal(restored["opt"][1][0], torch.full((2,), 7.0))


def test_reference_restores_a_port_checkpoint(tmp_path):
    w, b = _same_values(np.random.default_rng(1))
    t = {"params": {"w": torch.from_numpy(w), "b": torch.from_numpy(b)},
         "opt": (torch.zeros(()), [torch.full((2,), 7.0)])}
    Checkpointer(tmp_path, async_save=False).save(2, t, {"note": "port"})
    jt = {"params": {"w": jnp.zeros((3, 4)), "b": jnp.zeros(4)},
          "opt": (jnp.zeros(()), [jnp.zeros(2)])}
    restored, meta = JCheckpointer(tmp_path).restore(jt)
    assert meta == {"note": "port"}
    np.testing.assert_array_equal(np.asarray(restored["params"]["w"]), w)
    np.testing.assert_array_equal(np.asarray(restored["opt"][1][0]),
                                  np.full(2, 7.0, np.float32))


ROWS, FEATS, B = 530, 7, 50


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    path = tmp_path_factory.mktemp("ckpt") / "dense.bin"
    jds.synth_erm_corpus(path, rows=ROWS, features=FEATS, seed=3)
    return path


@pytest.mark.parametrize("solver", ["saga", "svrg"])
def test_streamed_run_leaves_the_reference_layout(corpus, tmp_path, solver):
    """One checkpointed streamed-eager spec run by both packages (prefetch
    0, so the access counts are exact at each checkpoint): the same file
    names, the same manifest index (keys, shapes, dtypes), the same meta
    keys; ``sampler_state``, ``epochs_done`` and the stats' byte and batch
    counts equal; the plan fingerprint the reference's keys plus
    ``device``; the weights within rtol 1e-4 (float32 sums in another
    order over 2 epochs)."""
    kw = dict(solver=solver, scheme="systematic", batch_size=B, epochs=2,
              step_size=0.05, placement="streamed", prefetch=0, seed=4)
    jd, td = tmp_path / "ref", tmp_path / "port"
    jx.execute(jx.plan(jx.ExperimentSpec(
        jx.DataSource.corpus(corpus),
        checkpoint=jx.CheckpointPolicy(jd, every=1), **kw)))
    tx.execute(tx.plan(tx.ExperimentSpec(
        tx.DataSource.corpus(corpus),
        checkpoint=CheckpointPolicy(td, every=1), **kw), device="cpu"))
    names = lambda d: sorted(p.relative_to(d).as_posix()
                             for p in d.rglob("*"))
    assert names(td) == names(jd)
    assert (td / "LATEST").read_text() == (jd / "LATEST").read_text()
    for step in ("step_0000000001", "step_0000000002"):
        jm = json.loads((jd / step / "manifest.json").read_text())
        tm = json.loads((td / step / "manifest.json").read_text())
        assert tm["step"] == jm["step"]
        assert tm["index"] == jm["index"]
        assert set(tm["meta"]) == set(jm["meta"])
        assert tm["meta"]["sampler_state"] == jm["meta"]["sampler_state"]
        assert tm["meta"]["epochs_done"] == jm["meta"]["epochs_done"]
        assert tm["meta"]["schema"] == jm["meta"]["schema"] == 1
        assert tm["meta"]["policy"] == jm["meta"]["policy"]
        assert set(tm["meta"]["stats"]) == set(jm["meta"]["stats"])
        for k in ("batches", "bytes_read", "staged", "bytes_staged",
                  "shards"):
            assert tm["meta"]["stats"][k] == jm["meta"]["stats"][k], k
        assert set(tm["meta"]["plan"]) == set(jm["meta"]["plan"]) | {"device"}
        assert tm["meta"]["plan"]["device"] == "cpu"
        for k, v in jm["meta"]["plan"].items():
            assert tm["meta"]["plan"][k] == v, k
        for entry in jm["index"].values():
            np.testing.assert_allclose(np.load(td / step / entry["file"]),
                                       np.load(jd / step / entry["file"]),
                                       rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(tm["meta"]["history"],
                                   jm["meta"]["history"], rtol=1e-5)
