"""Sharded host data pipeline with the paper's sampling schemes first-class.

The port of ``repro.data.pipeline`` (numpy only; torch enters through the
``put`` a caller injects into :class:`DeviceStager`).  The mesh-aware
staging of the reference is not ported yet (ROADMAP queue 1, item 12).

Every host reads mini-batch rows from its contiguous corpus shard according
to a sampling scheme:

  systematic (default)  one contiguous block per batch, random block order
  cyclic                one contiguous block per batch, sequential order
  random                scattered rows (the paper's baseline)

The sampler state is two integers (seed, step) — checkpointed with the model
so restarts replay the exact batch sequence, and a replacement host can
reconstruct its position without coordination (straggler/elastic story).

A background prefetch thread overlaps disk access with the train step; the
measured access time per batch is recorded so the paper's access-time claims
are observable in production telemetry, not just microbenchmarks.

:class:`DeviceStager` adds the second overlap tier: while the device computes
on batch k, a staging thread converts and copies batch k+1 host->device
(double buffering), and the H2D time lands in :class:`AccessStats` next to
the disk-access time so the full access/H2D/compute breakdown is observable.
"""
from __future__ import annotations

import dataclasses
import queue
import threading
from pathlib import Path
from typing import Dict, Iterator, Optional, Union

import numpy as np

from ..core import samplers, schemes
from ..obs import ACCESS, H2D, NULL_TRACER
from .dataset import host_shard, open_corpus


@dataclasses.dataclass
class PipelineConfig:
    corpus: Path
    batch_size: int                  # rows per host batch (upper bound for
    # variable-size schemes; staged buffers keep this static shape)
    sampling: Union[str, schemes.Scheme] = samplers.SYSTEMATIC
    seed: int = 0
    host: int = 0
    num_hosts: int = 1
    prefetch: int = 2
    drop_remainder: bool = True
    resident: bool = False           # stage the whole shard on device ONCE
    # (fused host mode: the epoch runner slices batches in-graph from the
    # resident copy and skips per-chunk H2D entirely; consumed by the
    # benchmark/train drivers via read_all(), not by the batch iterator)


@dataclasses.dataclass
class AccessStats:
    """Access/H2D accounting.  ``bytes_read`` counts bytes ACTUALLY touched
    by each read — the dense slice/gather size, or for CSR pipelines the
    nnz-proportional indices+values+indptr+label bytes — never an assumed
    ``b * row_dim`` footprint, so MB/s columns are comparable across dense
    and sparse runs."""
    batches: int = 0
    access_s: float = 0.0
    bytes_read: int = 0
    staged: int = 0          # batches copied host->device
    h2d_s: float = 0.0       # time spent in host->device staging
    bytes_staged: int = 0
    h2d_saved_s: float = 0.0  # staging time AVOIDED by resident mode
    shards: int = 1          # devices each staged chunk is split across
    gather_s: float = 0.0    # device-to-device replication time (subset of
    # h2d_s: the sharded 'gather' staging mode reshards chunks to replicated
    # inside the staging thread; h2d_s - gather_s is the host-link time)

    def record(self, dt: float, nbytes: int):
        self.batches += 1
        self.access_s += dt
        self.bytes_read += nbytes

    def record_h2d(self, dt: float, nbytes: int):
        self.staged += 1
        self.h2d_s += dt
        self.bytes_staged += nbytes

    def record_h2d_saved(self, dt: float):
        """Resident mode: credit the per-epoch restaging cost that the
        one-time device copy made unnecessary."""
        self.h2d_saved_s += dt

    def record_gather(self, dt: float):
        """Sharded staging: time spent resharding staged chunks to
        replicated (device-to-device, not the host link)."""
        self.gather_s += dt

    @property
    def s_per_batch(self) -> float:
        return self.access_s / max(self.batches, 1)

    @property
    def h2d_s_per_batch(self) -> float:
        return self.h2d_s / max(self.staged, 1)

    @property
    def read_mb(self) -> float:
        return self.bytes_read / 1e6

    @property
    def read_mb_per_s(self) -> float:
        return self.bytes_read / 1e6 / max(self.access_s, 1e-12)

    @property
    def h2d_bytes_per_device(self) -> int:
        """Host->device bytes each device received: staged chunks are split
        ``shards`` ways on the batch axis, so the per-device link traffic is
        the sharded fraction of the total."""
        return self.bytes_staged // max(self.shards, 1)


class PrefetchPipeline:
    """Prefetch machinery shared by the dense and CSR pipelines.

    Subclasses own the sampler and implement :meth:`_read_batch`; this base
    provides the guarded synchronous read, the background producer thread,
    and teardown.  The single-producer invariant lives here once: a second
    reader racing the producer on sampler state would silently corrupt the
    deterministic schedule.
    """

    def __init__(self, prefetch: int):
        self._prefetch = prefetch
        self._q: Optional[queue.Queue] = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def _read_batch(self):
        raise NotImplementedError

    # ---- state (for checkpointing) ------------------------------------
    def state_dict(self) -> Dict:
        return {"sampling": self.scheme.name, "seed": self.cfg.seed,
                "step": self.sampler.step, "host": self.cfg.host,
                "num_hosts": self.cfg.num_hosts,
                "batch_size": self.cfg.batch_size}

    def sampler_meta(self) -> Dict:
        """The scheme's own checkpoint dict (``Scheme.state_meta``) — what
        the executors persist as ``sampler_state``.  For the uniform schemes
        this is the historical two-integer ``{"scheme", "seed", "step"}``
        layout; adaptive schemes append their params + learning state."""
        return self.scheme.state_meta(self.sampler)

    def observe(self, batch_stats: Dict) -> None:
        """Feed run statistics back into the sampling state (adaptive
        schemes' ``Scheme.observe``).  Guarded like :meth:`read_batch`: the
        producer thread owns the sampler while it is alive, so observing
        mid-stream would race the deterministic schedule."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "prefetch producer is active; observe() would race on "
                "sampler state — drain the epoch (or use prefetch=0) first")
        self.sampler = self.scheme.observe(self.sampler, batch_stats)

    # ---- synchronous read ----------------------------------------------
    def _check_not_resident(self):
        # resident mode and batch streaming are mutually exclusive: the
        # flag promises "staged once, sliced in-graph", so silently
        # streaming batches anyway would misreport what ran
        if getattr(getattr(self, "cfg", None), "resident", False):
            raise RuntimeError(
                "resident pipeline: stage the shard once via read_all(); "
                "batch iteration is disabled")

    def read_batch(self):
        """Public synchronous read.

        Refuses to run while the prefetch producer thread owns the sampler:
        a concurrent ``_read_batch`` would race on ``self.sampler`` and
        silently skew the schedule.  Consume via ``iter(self)`` instead, or
        build the pipeline with ``prefetch=0``.
        """
        self._check_not_resident()
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "prefetch producer is active; reading synchronously would "
                "race on sampler state — iterate the pipeline or use "
                "prefetch=0")
        return self._read_batch()

    # ---- prefetching iterator -------------------------------------------
    def _producer(self):
        while not self._stop.is_set():
            batch = self._read_batch()
            while not self._stop.is_set():
                try:
                    self._q.put(batch, timeout=0.1)
                    break
                except queue.Full:
                    continue

    def __iter__(self) -> Iterator:
        self._check_not_resident()
        if self._prefetch <= 0:
            while True:
                yield self._read_batch()
        if self._thread is not None and self._thread.is_alive():
            # same invariant read_batch() guards: two producers would race
            # on sampler state and corrupt the deterministic schedule
            raise RuntimeError(
                "prefetch producer already running; close() this pipeline "
                "before iterating it again")
        self._q = queue.Queue(maxsize=self._prefetch)
        self._stop.clear()
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        try:
            while True:
                yield self._q.get()
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


class DataPipeline(PrefetchPipeline):
    """Iterator over host-local mini-batches of corpus rows."""

    def __init__(self, cfg: PipelineConfig, start_step: int = 0,
                 tracer=NULL_TRACER, sampler_meta: Optional[Dict] = None):
        super().__init__(cfg.prefetch)
        self.cfg = cfg
        self.tracer = tracer
        self.mm, self.meta = open_corpus(cfg.corpus)
        lo, hi = host_shard(self.meta.rows, cfg.host, cfg.num_hosts)
        self.lo, self.hi = lo, hi
        self.scheme = schemes.resolve(cfg.sampling)
        # sampler_meta (a Scheme.state_meta dict) wins when given — exact
        # adaptive-state resume; otherwise the historical (seed+host, step)
        # construction, bit-identical for the uniform schemes
        meta = sampler_meta if sampler_meta is not None else {
            "scheme": self.scheme.name, "seed": cfg.seed + cfg.host,
            "step": start_step}
        self.sampler = self.scheme.restore(meta, hi - lo, cfg.batch_size)
        self.stats = AccessStats()

    def _read_batch(self):
        # timespan, not a raw perf_counter pair: the span's duration IS the
        # number booked into AccessStats, so trace and stats cannot drift
        with self.tracer.timespan("read", ACCESS,
                                  scheme=self.scheme.name) as sp:
            bi, self.sampler = self.scheme.next_batch(self.sampler)
            b = bi.idx.shape[0]          # == batch_size except for
            # variable-size schemes, where it is this step's draw
            if bi.start is not None:     # contiguous block (CS/SS-profile)
                start = bi.start
                if start + b <= self.hi - self.lo:
                    # np.array, not asarray: a memmap slice is a lazy VIEW,
                    # and the timed region must actually fault the pages in
                    # or the recorded access time is just pointer arithmetic
                    # (the RS branch's fancy indexing always copies — same
                    # basis)
                    rows = np.array(
                        self.mm[self.lo + start:self.lo + start + b])
                else:  # wrap-around at shard end: two contiguous reads
                    first = self.hi - self.lo - start
                    rows = np.concatenate([
                        np.asarray(self.mm[self.lo + start:self.hi]),
                        np.asarray(self.mm[self.lo:self.lo + b - first])])
            else:
                rows = np.asarray(self.mm[self.lo + bi.idx])  # scattered gather
            sp.set(bytes=rows.nbytes)
        self.stats.record(sp.dur, rows.nbytes)
        if self.scheme.adaptive:
            bmax = self.cfg.batch_size
            if b < bmax:
                # variable-size scheme: pad the row count back to the static
                # staged shape OUTSIDE the timed span — zero rows (features
                # AND label) contribute exactly zero to the data gradient,
                # and the scheme's weight re-normalizes the batch mean
                rows = np.concatenate(
                    [rows, np.zeros((bmax - b,) + rows.shape[1:],
                                    rows.dtype)])
            # adaptive consumers need the scheme's chosen table slot and
            # unbiasedness weight alongside the payload
            return rows, bi.j, bi.weight
        return rows

    # ---- resident (fused host) mode -------------------------------------
    def read_all(self) -> np.ndarray:
        """ONE contiguous read of the whole host shard.

        Resident mode (``PipelineConfig.resident``): the caller stages this
        on device once and drives the epoch from ``batch_slice_starts`` /
        ``epoch_indices`` in-graph, skipping per-chunk H2D; per-epoch
        staging time avoided is credited via
        :meth:`AccessStats.record_h2d_saved`.
        """
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError(
                "prefetch producer is active; resident staging and batch "
                "streaming are mutually exclusive on one pipeline")
        with self.tracer.timespan("read_all", ACCESS,
                                  scheme=self.scheme.name) as sp:
            # forced copy: a memmap view would defer the actual read to the
            # device_put that follows, silently booking disk time as H2D
            rows = np.array(self.mm[self.lo:self.hi])
            sp.set(bytes=rows.nbytes)
        self.stats.record(sp.dur, rows.nbytes)
        return rows


class DeviceStager:
    """Double-buffered host->device staging over any host batch iterator.

    While the consumer computes on batch k, a staging thread pulls batch
    k+1 from ``source``, applies ``convert`` (e.g. rows -> (X, y)), and
    runs ``put`` (e.g. a pinned-buffer copy to the card that it waits for)
    so the H2D copy overlaps compute.  ``depth`` bounds the number of staged
    batches in flight (2 = classic double buffering).  The pipeline layer
    stays numpy-only: torch enters through the injected ``put`` callable.

    H2D time/bytes are recorded into ``stats`` (an :class:`AccessStats`)
    alongside the disk-access numbers, giving the benchmark its
    access/H2D/compute breakdown.  ``mesh=`` (the reference's sharded
    staging) is not in the port yet (ROADMAP queue 1, item 12).
    """

    def __init__(self, source: Iterator, put=None, convert=None,
                 depth: int = 2, stats: Optional[AccessStats] = None,
                 mesh=None, batch_axes=None, gather: bool = False,
                 tracer=NULL_TRACER):
        if mesh is not None:
            raise NotImplementedError(
                "mesh-aware staging is not in the port yet (ROADMAP queue 1, "
                "item 12: multi-GPU)")
        if put is None:
            raise ValueError("DeviceStager needs put=")
        self.source = source
        self.tracer = tracer
        self.put = put
        self.convert = convert or (lambda x: x)
        self.depth = max(1, depth)
        self.stats = stats if stats is not None else AccessStats()
        self._q: queue.Queue = queue.Queue(maxsize=self.depth)
        self._stop = threading.Event()
        self._err: Optional[BaseException] = None
        self._thread: Optional[threading.Thread] = None
        self._consumed = False

    @staticmethod
    def _nbytes(tree) -> int:
        if isinstance(tree, (tuple, list)):
            return sum(DeviceStager._nbytes(t) for t in tree)
        return getattr(tree, "nbytes", 0)

    def _producer(self):
        try:
            for batch in self.source:
                if self._stop.is_set():
                    return
                host = self.convert(batch)
                nbytes = self._nbytes(host)
                with self.tracer.timespan("stage", H2D, bytes=nbytes) as sp:
                    dev = self.put(host)
                self.stats.record_h2d(sp.dur, nbytes)
                while not self._stop.is_set():
                    try:
                        self._q.put(dev, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except BaseException as e:  # surfaced to the consumer
            self._err = e
        finally:
            while True:
                try:
                    self._q.put(_STAGER_DONE, timeout=0.1)
                    return
                except queue.Full:
                    if self._stop.is_set():
                        return

    def __iter__(self):
        # single-use: a second producer over the same source would
        # interleave batches nondeterministically, and resuming after
        # close() would silently drop staged batches
        if self._consumed:
            raise RuntimeError(
                "DeviceStager is single-use and already iterated; create a "
                "new stager over a fresh source")
        self._consumed = True
        self._thread = threading.Thread(target=self._producer, daemon=True)
        self._thread.start()
        try:
            while True:
                try:
                    item = self._q.get(timeout=0.1)
                except queue.Empty:
                    # close() may have drained the DONE sentinel out from
                    # under a live consumer; don't block on a dead producer
                    if self._stop.is_set():
                        return
                    continue
                if item is _STAGER_DONE:
                    if self._err is not None:
                        raise self._err
                    return
                yield item
        finally:
            self.close()

    def close(self):
        self._stop.set()
        if self._q is not None:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None


_STAGER_DONE = object()
