"""Host-side integer work must match the reference bit for bit: the Scheme
index streams at arbitrary steps, the port's stacked epoch schedules, the
corpus files, and the data pipeline's batches and access counts."""
import numpy as np
import pytest

from repro.core import schemes as jsch
from repro.data import dataset as jds
from repro.data import pipeline as jpipe
from repro_torch.core import samplers as tsam
from repro_torch.core import schemes as tsch
from repro_torch.data import dataset as tds
from repro_torch.data import pipeline as tpipe

L, B = 1037, 50            # 1037 % 50 != 0: the trailing batch wraps

SCHEMES = [("random", {}), ("random", {"with_replacement": True}),
           ("cyclic", {}), ("systematic", {}),
           ("chunk_importance", {}), ("stochastic_batch", {})]


def _pair(name, params):
    return jsch.REGISTRY[name](**params), tsch.REGISTRY[name](**params)


def _same(a, b):
    np.testing.assert_array_equal(a.idx, b.idx)
    assert a.idx.dtype == b.idx.dtype
    assert (a.start, a.j, a.weight) == (b.start, b.j, b.weight)


@pytest.mark.parametrize("name,params", SCHEMES,
                         ids=[f"{n}{'-wr' if p else ''}" for n, p in SCHEMES])
@pytest.mark.parametrize("seed,step", [(0, 0), (7, 19), (3, 20 * 21 + 5)])
def test_streams_equal_reference_at_any_step(name, params, seed, step):
    js, ts = _pair(name, params)
    jst, tst = js.bind(L, B, seed, step=step), ts.bind(L, B, seed, step=step)
    for _ in range(25):             # crosses an epoch boundary (m = 21)
        jb, jst = js.next_batch(jst)
        tb, tst = ts.next_batch(tst)
        _same(jb, tb)
    assert js.state_meta(jst) == ts.state_meta(tst)
    meta = ts.state_meta(tst)
    jr, tr = js.restore(meta, L, B), ts.restore(meta, L, B)
    _same(js.next_batch(jr)[0], ts.next_batch(tr)[0])


@pytest.mark.parametrize("name", ["random", "cyclic", "systematic"])
@pytest.mark.parametrize("seed,epoch", [(0, 0), (5, 3)])
def test_epoch_schedule_stacks_the_reference_stream(name, seed, epoch):
    js = jsch.resolve(name)
    m = tsam.num_batches(L, B)
    st = js.bind(L, B, seed, step=epoch * m)
    rows = []
    for _ in range(m):
        bi, st = js.next_batch(st)
        rows.append(bi.idx if bi.start is None else bi.start)
    want = np.asarray(rows, np.int32)
    got = tsam.epoch_schedule(name, seed, epoch, L, B)
    assert got.dtype == np.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)


def test_epoch_schedule_refuses_adaptive_schemes():
    with pytest.raises(ValueError, match="feedback"):
        tsam.epoch_schedule(tsch.ChunkImportance(), 0, 0, L, B)


def test_corpus_files_are_byte_identical(tmp_path):
    jp, tp = tmp_path / "j.bin", tmp_path / "t.bin"
    jm = jds.synth_erm_corpus(jp, rows=L, features=9, seed=4)
    tm = tds.synth_erm_corpus(tp, rows=L, features=9, seed=4)
    assert jm.to_json() == tm.to_json()
    assert jp.read_bytes() == tp.read_bytes()
    assert (jp.with_suffix(".bin.meta.json").read_text()
            == tp.with_suffix(".bin.meta.json").read_text())
    (ja, jmeta), (ta, tmeta) = jds.open_corpus(tp), tds.open_corpus(jp)
    assert jmeta.to_json() == tmeta.to_json()
    np.testing.assert_array_equal(np.asarray(ja), np.asarray(ta))


@pytest.mark.parametrize("name", ["random", "cyclic", "systematic"])
def test_pipeline_reads_the_same_batches_and_bytes(tmp_path, name):
    path = tmp_path / "c.bin"
    tds.synth_erm_corpus(path, rows=L, features=6, seed=2)
    kw = dict(corpus=path, batch_size=B, sampling=name, seed=3, prefetch=0)
    jp = jpipe.DataPipeline(jpipe.PipelineConfig(**kw), start_step=17)
    tp = tpipe.DataPipeline(tpipe.PipelineConfig(**kw), start_step=17)
    for _ in range(30):
        np.testing.assert_array_equal(jp.read_batch(), tp.read_batch())
    assert (jp.stats.batches, jp.stats.bytes_read) == \
        (tp.stats.batches, tp.stats.bytes_read)
    assert jp.sampler_meta() == tp.sampler_meta()
    res = dict(kw, resident=True)
    ja = jpipe.DataPipeline(jpipe.PipelineConfig(**res)).read_all()
    ta = tpipe.DataPipeline(tpipe.PipelineConfig(**res)).read_all()
    np.testing.assert_array_equal(ja, ta)


def test_device_stager_mesh_is_not_ported():
    with pytest.raises(NotImplementedError, match="item 12"):
        tpipe.DeviceStager(iter(()), mesh=object())
