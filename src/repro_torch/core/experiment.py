"""Unified ExperimentSpec → plan → execute API (the port of
``repro.core.experiment``, single host).

    spec = ExperimentSpec(data=DataSource.corpus("corpus.bin"),
                          solver="saga", scheme="systematic", epochs=5)
    result = execute(plan(spec))          # on the card
    result = execute(plan(spec, device="cpu"))

* :func:`plan` lowers a spec into an :class:`ExecutionPlan` for one of four
  backends — ``streamed-eager`` (the host pipeline stages chunks of batches
  to the device), ``sparse-csr`` (the same for a CSR corpus, as padded-ELL
  batches), ``resident-eager`` and ``resident-fused`` (the whole dense
  corpus on the device; fused runs the CUDA kernels) — and rejects what
  cannot run with a :class:`PlanError`.  The plan records its device; the
  default is the card, and a host without CUDA is refused rather than
  silently run on the CPU.
* :func:`execute` runs a plan and returns a :class:`RunResult` with the
  same surface as the reference's: objective trace, ``AccessStats``,
  wall-clock breakdown, span timeline, and resumable state
  (``execute(plan, resume=prev)``).
* Durable runs: a :class:`~repro_torch.checkpoint.CheckpointPolicy` in
  ``ExperimentSpec.checkpoint`` makes every backend snapshot the run at
  epoch boundaries (solver state, sampler state, objective trace,
  ``AccessStats`` and the plan fingerprint) in the reference's layout on
  disk, and :func:`resume_from` rebuilds a resumable result — with no plan
  given, the plan too — after a crash.  A resumed run gives bitwise the
  ``w`` and history of an uninterrupted one on the same device.  The
  fingerprint holds the reference's fields plus ``device``, which is
  strict: the CPU and the card sum in different orders, so a run resumed
  across them would not continue the same trajectory.
* Adaptive schemes (``chunk_importance``, ``stochastic_batch``) run on the
  streamed backends: the weighted engines, read-ahead off, and the
  per-epoch ``observe`` feedback applied before each checkpoint, so a
  resume carries the learned sampler state.

The resident epoch's schedule is drawn on the host from the Scheme stream
(:func:`repro_torch.core.samplers.epoch_schedule`), outside the compute
span, and staged to the device through the H2D lane; the reference draws
it in-graph with ``jax.random``.  Device work inside a timed span ends in
``torch.cuda.synchronize``.

A CSR corpus runs on ``sparse-csr`` only, as in the reference: its
snapshot gradients and per-epoch objectives are the reference's float64
host passes (``repro_torch.data.sparse``), and ``kernel='fused'`` or
``placement='resident'`` raise the reference's PlanErrors.

Not in the port yet, each refused by :func:`plan` with a PlanError: device
meshes (``mesh=``) and the plan audit.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Callable, Dict, List, Optional, Tuple, Union

import numpy as np
import torch

from ..checkpoint.checkpointer import (Checkpointer, CheckpointPolicy,
                                       atomic_write_text)
from ..obs import (ACCESS, COMPUTE, EPOCH, GATHER as GATHER_LANE, H2D,
                   NULL_TRACER, Timeline, TracePolicy, Tracer)
from . import samplers, schemes
from .erm import ERMProblem, LOGISTIC, LOSSES
from .solvers import (CONSTANT, LINE_SEARCH, SOLVERS, SolverConfig,
                      SolverState, clone_state, epoch_begin, init_state,
                      make_epoch_fn, resident_epoch, streaming_full_grad)
from .step_rules import LS_MODES, VECTORIZED, validate_ls

# ---- spec-level knobs ------------------------------------------------------
AUTO = "auto"
STREAMED, RESIDENT = "streamed", "resident"     # placement
FUSED, EAGER = "fused", "eager"                 # kernel
GATHER, PSUM = "gather", "psum"                 # sharded reduction mode

# ---- data source kinds -----------------------------------------------------
ARRAYS, DENSE, CSR = "arrays", "dense", "csr"

# ---- backends the planner can select ---------------------------------------
STREAMED_EAGER = "streamed-eager"    # DataPipeline + chunked epoch engine
SPARSE_CSR = "sparse-csr"            # SparsePipeline + sparse chunked engine
RESIDENT_EAGER = "resident-eager"    # resident corpus, gathered batches
RESIDENT_FUSED = "resident-fused"    # resident corpus, fused CUDA kernels
BACKENDS = (STREAMED_EAGER, SPARSE_CSR, RESIDENT_EAGER, RESIDENT_FUSED)

# resident-placement budget when the device reports no memory size (the
# CPU): stage corpora up to this size, stream anything larger
DEFAULT_RESIDENT_BUDGET = 1 << 30
_CHUNK_BYTE_BUDGET = 64 << 20  # per staged chunk when spec.chunk is unset
_STEP_SAMPLE_ROWS = 4096       # rows sampled for the auto 1/L step size
_EVAL_CHUNK = 8192             # rows per streamed objective/gradient chunk

_NOT_PORTED = "not yet in the PyTorch port (ROADMAP queue 1, item {})"


class PlanError(ValueError):
    """A spec combination that cannot execute — raised by :func:`plan` with
    the reason, instead of a silent fallback at run time."""


# ---------------------------------------------------------------------------
# data sources and the spec
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DataSource:
    """Where the training data lives: :meth:`arrays` for in-memory
    ``(X, y)`` (numpy or torch), :meth:`corpus` for an on-disk corpus (a
    dense memmap from ``dataset.write_corpus``/``synth_erm_corpus`` or a
    CSR directory from ``sparse.write_csr_corpus``/``ingest_libsvm``/
    ``synth_sparse_classification``)."""
    kind: str                                   # ARRAYS | DENSE | CSR
    path: Optional[Path] = None
    X: Optional[object] = dataclasses.field(default=None, compare=False,
                                            repr=False)
    y: Optional[object] = dataclasses.field(default=None, compare=False,
                                            repr=False)

    @staticmethod
    def arrays(X, y) -> "DataSource":
        if getattr(X, "ndim", None) != 2 or X.shape[0] != len(y):
            raise PlanError("DataSource.arrays wants X: (l, n) with y: (l,)")
        return DataSource(ARRAYS, X=X, y=y)

    @staticmethod
    def corpus(path) -> "DataSource":
        path = Path(path)
        if (path / "meta.json").exists():           # CSR corpus directory
            return DataSource(CSR, path=path)
        return DataSource(DENSE, path=path)


@dataclasses.dataclass(frozen=True)
class ExperimentSpec:
    """Frozen description of one experiment: problem + data + scheme +
    solver + step rule + budget, with the reference's fields.  The last
    block overrides planner decisions; ``mesh`` and ``reduction`` are
    accepted and refused by :func:`plan` until the port has them.
    ``checkpoint`` (a :class:`CheckpointPolicy`) makes the run durable;
    ``trace`` is excluded from the plan fingerprint, so a checkpointed run
    may resume with tracing toggled either way."""
    data: DataSource
    # problem
    loss: str = LOGISTIC
    reg: float = 1e-4
    # method
    solver: str = "mbsgd"
    scheme: Union[str, schemes.Scheme] = samplers.SYSTEMATIC
    step_mode: str = CONSTANT
    step_size: Optional[float] = None   # None → 1/L (constant) or 1.0 (LS)
    ls_mode: str = AUTO                 # AUTO | SEQUENTIAL | VECTORIZED
    ls_shrink: float = 0.5
    ls_c: float = 1e-4
    ls_max_iter: int = 25
    # budget
    batch_size: int = 500
    epochs: int = 3
    seed: int = 0
    record_objective: bool = True
    # execution overrides (AUTO lets the planner decide)
    placement: str = AUTO               # AUTO | STREAMED | RESIDENT
    kernel: str = AUTO                  # AUTO | FUSED | EAGER
    chunk: Optional[int] = None         # batches per device call (streamed)
    prefetch: int = 2                   # pipeline read-ahead (streamed)
    resident_budget: Optional[int] = None   # bytes; None → device memory
    mesh: Optional[object] = None
    reduction: str = AUTO
    checkpoint: Optional[CheckpointPolicy] = None
    trace: Optional[TracePolicy] = None

    @property
    def problem(self) -> ERMProblem:
        return ERMProblem(loss=self.loss, reg=self.reg)


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Explicit lowering of a spec: which backend runs, on which device,
    with what shapes.  ``why`` records each planner decision."""
    spec: ExperimentSpec
    backend: str          # one of BACKENDS
    placement: str        # STREAMED | RESIDENT
    kernel: str           # EAGER | FUSED
    fmt: str              # DENSE | CSR (ARRAYS lowers to DENSE)
    cfg: SolverConfig     # resolved solver config (step size, flags)
    rows: int
    features: int
    num_batches: int      # m, batches per epoch
    chunk: int            # K, batches per device call (m when resident)
    corpus_bytes: int
    kmax: int = 0         # densest CSR row (sparse only)
    nnz: int = 0          # stored nonzeros (sparse only)
    device: str = "cuda"
    why: Tuple[str, ...] = ()

    @property
    def scheme_obj(self) -> schemes.Scheme:
        return schemes.resolve(self.spec.scheme)

    @property
    def scheme_name(self) -> str:
        return self.scheme_obj.name

    @property
    def step_rule(self) -> str:
        if self.cfg.step_mode == LINE_SEARCH:
            return f"{LINE_SEARCH}[{self.cfg.ls_mode}]"
        return self.cfg.step_mode

    def describe(self) -> str:
        lines = [
            f"backend   : {self.backend} on {self.device}",
            f"data      : {self.fmt} {self.rows}x{self.features} "
            f"({self.corpus_bytes / 1e6:.1f} MB"
            + (f", nnz={self.nnz}, kmax={self.kmax}" if self.fmt == CSR
               else "") + ")",
            f"method    : {self.cfg.solver}/{self.step_rule} under "
            f"{self.scheme_name}"
            + (f"{self.scheme_obj.params()}" if self.scheme_obj.params()
               else "")
            + f" sampling, step={self.cfg.step_size:.3g}",
            f"epoch     : m={self.num_batches} batches of "
            f"{self.spec.batch_size}, {self.chunk} per device call, "
            f"{self.spec.epochs} epochs",
        ]
        return "\n".join(lines + [f"  - {w}" for w in self.why])


@dataclasses.dataclass
class _Probe:
    fmt: str
    rows: int
    features: int
    nbytes: int
    kmax: int = 0
    nnz: int = 0


def _probe(data: DataSource) -> _Probe:
    if data.kind == ARRAYS:
        X, y = data.X, data.y
        return _Probe(DENSE, X.shape[0], X.shape[1],
                      int(X.nbytes + np.asarray(y).nbytes))
    if data.path is None:
        raise PlanError("corpus DataSource has no path")
    if data.kind == CSR:
        from ..data import sparse
        csr = sparse.open_csr_corpus(data.path)
        return _Probe(CSR, csr.rows, csr.features, csr.meta.nbytes,
                      kmax=csr.kmax, nnz=csr.nnz)
    from ..data import dataset
    _, meta = dataset.open_corpus(data.path)
    return _Probe(DENSE, meta.rows, meta.row_dim - 1, meta.nbytes)


def _resolve_device(device) -> torch.device:
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise PlanError(
            "plan() runs on the card by default, and this host has no CUDA "
            "device; pass device=\"cpu\" to run the port on the CPU (the "
            "kernels' plain PyTorch versions)")
    if dev.type not in ("cuda", "cpu"):
        raise PlanError(f"device must be cuda or cpu, got {dev}")
    return dev


def _resident_budget(spec: ExperimentSpec, device: torch.device) -> int:
    if spec.resident_budget is not None:
        return spec.resident_budget
    if device.type == "cuda":
        # leave headroom for solver state, staging and scratch
        _, total = torch.cuda.mem_get_info(device)
        return int(total * 0.6)
    return DEFAULT_RESIDENT_BUDGET


def plan(spec: ExperimentSpec, *, device=None,
         audit: bool = False) -> ExecutionPlan:
    """Lower a spec to an :class:`ExecutionPlan` on ``device`` (default the
    card, ``"cuda"``), rejecting combinations that cannot run with a
    :class:`PlanError` that names the conflict."""
    dev = _resolve_device(device)
    if audit:
        raise PlanError("the plan audit (audit=True) is "
                        + _NOT_PORTED.format(13))
    if spec.solver not in SOLVERS:
        raise PlanError(f"unknown solver {spec.solver!r}; want one of {SOLVERS}")
    try:
        scheme_obj = schemes.resolve(spec.scheme)
        scheme_obj.validate(batch_size=spec.batch_size)
    except ValueError as e:
        raise PlanError(str(e)) from e
    if spec.step_mode not in (CONSTANT, LINE_SEARCH):
        raise PlanError(f"unknown step_mode {spec.step_mode!r}; want "
                        f"{(CONSTANT, LINE_SEARCH)}")
    if spec.ls_mode not in (AUTO,) + LS_MODES:
        raise PlanError(f"ls_mode must be auto/sequential/vectorized, got "
                        f"{spec.ls_mode!r}")
    if spec.step_size is not None and not spec.step_size > 0:
        raise PlanError(f"step_size must be positive (got "
                        f"{spec.step_size!r}) — it is the constant step or "
                        f"the line search's initial trial")
    try:
        validate_ls(1.0 if spec.step_size is None else spec.step_size,
                    spec.ls_shrink, spec.ls_c, spec.ls_max_iter)
    except ValueError as e:
        raise PlanError(str(e)) from e
    if spec.loss not in LOSSES:
        raise PlanError(f"unknown loss {spec.loss!r}; want one of {LOSSES}")
    if spec.placement not in (AUTO, STREAMED, RESIDENT):
        raise PlanError(f"placement must be auto/streamed/resident, got "
                        f"{spec.placement!r}")
    if spec.kernel not in (AUTO, FUSED, EAGER):
        raise PlanError(f"kernel must be auto/fused/eager, got {spec.kernel!r}")
    if spec.reduction not in (AUTO, GATHER, PSUM):
        raise PlanError(f"reduction must be auto/gather/psum, got "
                        f"{spec.reduction!r}")
    if spec.mesh is None and spec.reduction != AUTO:
        raise PlanError(
            "reduction= picks how a device mesh combines per-device work; "
            "it needs mesh= (leave it 'auto' for single-host runs)")
    if spec.batch_size <= 0 or spec.epochs <= 0:
        raise PlanError("batch_size and epochs must be positive")
    if spec.mesh is not None:
        raise PlanError("device meshes (mesh=) are " + _NOT_PORTED.format(12))
    if spec.checkpoint is not None:
        if not isinstance(spec.checkpoint, CheckpointPolicy):
            raise PlanError(
                f"checkpoint= wants a repro_torch.checkpoint.CheckpointPolicy,"
                f" got {type(spec.checkpoint).__name__}")
        try:
            spec.checkpoint.validate()
        except ValueError as e:
            raise PlanError(str(e)) from e
    if spec.trace is not None:
        if not isinstance(spec.trace, TracePolicy):
            raise PlanError(
                f"trace= wants a repro_torch.obs.TracePolicy, "
                f"got {type(spec.trace).__name__}")
        try:
            spec.trace.validate()
        except ValueError as e:
            raise PlanError(str(e)) from e

    # ---- adaptive schemes: host-feedback sampling constrains the lowering
    # (a device mesh is refused above for every scheme)
    if scheme_obj.adaptive:
        if spec.step_mode == LINE_SEARCH:
            raise PlanError(
                f"scheme {scheme_obj.name!r} emits importance-weighted "
                "gradients, but line search probes the UNWEIGHTED (and, for "
                "stochastic batch size, zero-padded) batch objective — the "
                "VectorizedLS trial ladder's Armijo comparison would mix "
                "the two normalizations; use step_mode='constant'")
        if spec.placement == RESIDENT or spec.data.kind == ARRAYS:
            raise PlanError(
                f"scheme {scheme_obj.name!r} picks each batch on the host "
                "(per-step draws + feedback), which a resident epoch over a "
                "precomputed schedule cannot replay; it needs a streamed "
                "corpus (placement='streamed' over DataSource.corpus)")
        if spec.kernel == FUSED:
            raise PlanError(
                f"scheme {scheme_obj.name!r} needs the streamed engine; "
                "fused kernels sample from a device-resident corpus")

    probe = _probe(spec.data)
    if spec.batch_size > probe.rows:
        raise PlanError(
            f"batch_size {spec.batch_size} exceeds the corpus "
            f"({probe.rows} rows) — the samplers pad the TRAILING batch by "
            f"wrap-around, they don't oversample the whole corpus")
    why: List[str] = [f"device {dev}"]

    # ---- placement: streamed vs resident --------------------------------
    if spec.data.kind == ARRAYS:
        if spec.placement == STREAMED:
            raise PlanError("in-memory arrays have no corpus to stream; use "
                            "a DataSource.corpus(...) for streamed placement")
        placement = RESIDENT
        why.append("arrays are device-resident by construction")
    elif probe.fmt == CSR:
        if spec.placement == RESIDENT:
            raise PlanError(
                "resident placement stages a dense (l, n) corpus; CSR "
                "corpora run the streamed sparse engine (sparse resident "
                "mode is a ROADMAP follow-on)")
        placement = STREAMED
        why.append("CSR corpus → streamed sparse engine")
    elif scheme_obj.adaptive:
        placement = STREAMED
        why.append(f"{scheme_obj.name} sampling picks batches on the host "
                   "(per-step draws + feedback) → streamed placement; "
                   "pipeline read-ahead is disabled so the scheme state is "
                   "exact at every epoch boundary")
    elif spec.placement != AUTO:
        placement = spec.placement
        why.append(f"placement {placement!r} forced by spec")
    else:
        budget = _resident_budget(spec, dev)
        if probe.nbytes <= budget:
            placement = RESIDENT
            why.append(f"corpus {probe.nbytes / 1e6:.1f} MB fits the "
                       f"{budget / 1e6:.0f} MB device budget → resident")
        else:
            placement = STREAMED
            why.append(f"corpus {probe.nbytes / 1e6:.1f} MB exceeds the "
                       f"{budget / 1e6:.0f} MB device budget → streamed")

    # ---- kernel: fused vs eager ------------------------------------------
    from ..kernels import fused_erm
    if probe.fmt == CSR:
        ok, reason = False, ("fused kernels are dense-only; CSR corpora keep "
                             "the sparse chunked engine")
    else:
        ok = spec.loss in fused_erm.LOSSES
        reason = f"loss {spec.loss!r} has no fused kernel"
    if spec.kernel == FUSED:
        if not ok:
            raise PlanError(f"kernel='fused' rejected: {reason}")
        if placement != RESIDENT:
            raise PlanError(
                "kernel='fused' rejected: the fused gather+grad kernels "
                "sample from a device-resident corpus; the streamed engine "
                "consumes staged batches, which are materialized by "
                "construction (force placement='resident' or drop the "
                "kernel override)")
        kernel = FUSED
        why.append("fused kernels forced by spec"
                   + ("" if dev.type == "cuda" else
                      " (on the CPU they run their plain PyTorch versions)"))
    elif spec.kernel == EAGER or placement != RESIDENT:
        kernel = EAGER
    elif not ok:
        kernel = EAGER
        why.append(f"fused kernels skipped: {reason}")
    elif dev.type != "cuda":
        kernel = EAGER
        why.append("fused kernels are CUDA kernels; on the CPU they would "
                   "run their plain versions — pass kernel='fused' to force")
    else:
        kernel = FUSED
        why.append("resident + supported loss on the card → fused CUDA "
                   "kernels (line search runs on the fused margin kernels)")

    # ---- chunk shape (streamed) and solver config ------------------------
    m = samplers.num_batches(probe.rows, spec.batch_size)
    if placement == RESIDENT:
        chunk = m
        if spec.chunk is not None:
            why.append(f"spec.chunk={spec.chunk} ignored: resident runs the "
                       "whole epoch per schedule, there is no staged chunking")
    elif spec.chunk is not None:
        chunk = max(1, min(spec.chunk, m))
        why.append(f"chunk K={chunk} forced by spec")
    else:
        if probe.fmt == CSR:
            per_batch = spec.batch_size * (probe.kmax * 8 + 4)
        else:
            per_batch = spec.batch_size * (probe.features + 1) * 4
        chunk = max(1, min(_CHUNK_BYTE_BUDGET // max(per_batch, 1), m))

    step_size = (spec.step_size if spec.step_size is not None
                 else _auto_step_size(spec, probe))
    ls_mode = VECTORIZED if spec.ls_mode == AUTO else spec.ls_mode
    if spec.step_mode == LINE_SEARCH:
        why.append("line search lowers to the vectorized trial-ladder sweep "
                   "(ls_mode='sequential' keeps the backtracking reference)"
                   if spec.ls_mode == AUTO else
                   f"ls_mode {ls_mode!r} forced by spec")
    if spec.checkpoint is not None:
        pol = spec.checkpoint
        why.append(f"durable run: checkpoint every {pol.every} epoch(s) to "
                   f"{pol.directory} (keep {pol.keep}, "
                   f"{'async' if pol.async_save else 'blocking'} saves)")
    if spec.trace is not None:
        tp = spec.trace
        why.append(
            (f"traced run: span timeline over a {tp.buffer}-event ring "
             "buffer" + (f", Chrome trace to {tp.path}" if tp.path else ""))
            if tp.enabled else
            "trace policy present but disabled → near-zero-cost no-op spans")
    cfg = SolverConfig(solver=spec.solver, step_mode=spec.step_mode,
                       step_size=step_size, ls_shrink=spec.ls_shrink,
                       ls_c=spec.ls_c, ls_max_iter=spec.ls_max_iter,
                       ls_mode=ls_mode, use_fused=(kernel == FUSED),
                       sparse=(probe.fmt == CSR))
    if probe.fmt == CSR:
        backend = SPARSE_CSR
    elif placement == RESIDENT:
        backend = RESIDENT_FUSED if kernel == FUSED else RESIDENT_EAGER
    else:
        backend = STREAMED_EAGER
    return ExecutionPlan(spec=spec, backend=backend, placement=placement,
                         kernel=kernel, fmt=probe.fmt, cfg=cfg,
                         rows=probe.rows, features=probe.features,
                         num_batches=m, chunk=chunk,
                         corpus_bytes=probe.nbytes, kmax=probe.kmax,
                         nnz=probe.nnz, device=str(dev),
                         why=tuple(why))


def _auto_step_size(spec: ExperimentSpec, probe: _Probe) -> float:
    """Paper §4.1 defaults: constant step = 1/L, line search starts at 1."""
    if spec.step_mode == LINE_SEARCH:
        return 1.0
    if probe.fmt == CSR:
        from ..data import sparse
        return 1.0 / sparse.csr_lipschitz(spec.problem, sparse.open_csr_corpus(
            spec.data.path))
    if spec.data.kind == ARRAYS:
        sample = np.asarray(spec.data.X[:_STEP_SAMPLE_ROWS], np.float32)
    else:
        from ..data import dataset
        mm, meta = dataset.open_corpus(spec.data.path)
        sample = np.asarray(mm[:_STEP_SAMPLE_ROWS, :meta.row_dim - 1])
    return 1.0 / float(spec.problem.lipschitz(torch.from_numpy(
        np.ascontiguousarray(sample))))


# ---------------------------------------------------------------------------
# the result
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class RunResult:
    """Uniform outcome of :func:`execute` (see the reference's docstring):
    ``history`` is the cumulative per-epoch objective trace, ``objective``
    the final full-corpus value, ``solver_state``/``sampler_state`` resume
    the run exactly via ``execute(plan, resume=result)``.  (``solver_state``
    is ``None`` on results rebuilt by :meth:`from_json`: JSON carries the
    summary; on-disk checkpoints carry resumable state.)"""
    plan: ExecutionPlan
    objective: float
    history: np.ndarray
    w: np.ndarray
    solver_state: SolverState
    sampler_state: Dict
    epochs_run: int
    epochs_done: int
    stats: "AccessStats"       # noqa: F821 — repro_torch.data.pipeline
    train_s: float
    compute_s: float
    timeline: Optional[Timeline] = None

    def breakdown(self) -> Dict[str, float]:
        """Per-epoch wall-clock decomposition in the BENCH_erm schema."""
        st, e = self.stats, max(self.epochs_run, 1)
        m, K = self.plan.num_batches, self.plan.chunk
        out = {"epoch_s": self.train_s / e,
               "compute_s_per_epoch": self.compute_s / e,
               "access_mb_per_s": st.read_mb_per_s,
               "objective": self.objective}
        if self.plan.placement == RESIDENT:
            out.update(
                access_s_per_epoch=st.access_s / e,      # one-time, amortized
                h2d_s_per_epoch=st.h2d_s / e,
                h2d_saved_s_per_epoch=st.h2d_saved_s / e,
                access_mb_per_epoch=st.read_mb / e)
        else:
            out.update(
                access_s_per_epoch=st.s_per_batch * m,   # producer thread
                h2d_s_per_epoch=st.h2d_s / max(st.staged, 1) * (-(-m // K)),
                access_mb_per_epoch=st.read_mb / max(st.batches, 1) * m)
        return out

    def save_trace(self, path) -> Path:
        """Write the span timeline as Chrome/Perfetto trace-event JSON."""
        if self.timeline is None or not self.timeline.events:
            raise ValueError(
                "this result carries no span timeline — run with "
                "ExperimentSpec.trace=TracePolicy()")
        return self.timeline.save(path)

    def verify_timeline(self, tol: float = 0.05) -> Dict[str, Dict]:
        """Assert the span timeline reconciles with the stats accounting:
        each accounting lane's toplevel span sum IS what ``stats`` booked
        (exact basis), and the :meth:`breakdown` estimates times
        ``epochs_run`` match the lane sums within ``tol`` (see the
        reference for the streamed access overrun rule)."""
        if self.timeline is None or not self.timeline.events:
            raise ValueError(
                "no span timeline to verify — run with "
                "ExperimentSpec.trace=TracePolicy()")
        if self.timeline.dropped:
            raise ValueError(
                f"{self.timeline.dropped} spans were evicted from the ring "
                f"buffer; lane sums would undercount — raise "
                f"TracePolicy.buffer")
        lanes = self.timeline.lane_totals()
        st, e = self.stats, max(self.epochs_run, 1)
        bd = self.breakdown()
        report: Dict[str, Dict] = {}
        bad: List[str] = []

        def check(name: str, span_s: float, ref_s: float, rel: float):
            slack = max(rel * max(abs(ref_s), abs(span_s)), 1e-4)
            ok = abs(span_s - ref_s) <= slack
            report[name] = {"span_s": span_s, "ref_s": ref_s, "ok": ok}
            if not ok:
                bad.append(f"{name}: span sum {span_s:.6f}s vs reference "
                           f"{ref_s:.6f}s (tolerance {slack:.6f}s)")

        check("access_vs_stats", lanes.get(ACCESS, 0.0), st.access_s, 1e-6)
        check("h2d_vs_stats", lanes.get(H2D, 0.0), st.h2d_s, 1e-6)
        check("gather_vs_stats", lanes.get(GATHER_LANE, 0.0), st.gather_s,
              1e-6)
        check("compute_vs_stats", lanes.get(COMPUTE, 0.0), self.compute_s,
              1e-6)
        access_span = lanes.get(ACCESS, 0.0)
        if self.plan.placement != RESIDENT and st.batches > 0:
            # per-batch units: the remainder is prefetch-producer overrun
            consumed = self.plan.num_batches * e
            access_span *= min(1.0, consumed / st.batches)
        check("access_vs_breakdown", access_span,
              bd["access_s_per_epoch"] * e, tol)
        check("h2d_vs_breakdown", lanes.get(H2D, 0.0),
              bd["h2d_s_per_epoch"] * e, tol)
        check("compute_vs_breakdown", lanes.get(COMPUTE, 0.0),
              bd["compute_s_per_epoch"] * e, tol)
        if bad:
            raise ValueError(
                "span timeline does not reconcile with the access/compute "
                "accounting:\n  " + "\n  ".join(bad))
        return report

    def to_json(self) -> Dict:
        """JSON-safe summary with the reference's schema-3 keys, ``w``,
        ``train_s`` and ``compute_s`` included so :meth:`from_json` rebuilds
        the whole summary (the device is recorded in ``plan.why``)."""
        p = self.plan
        return {
            "schema": 3,
            "backend": p.backend,
            "plan": {"placement": p.placement, "kernel": p.kernel,
                     "format": p.fmt, "solver": p.cfg.solver,
                     "step_mode": p.cfg.step_mode,
                     "ls_mode": (p.cfg.ls_mode
                                 if p.cfg.step_mode == LINE_SEARCH else None),
                     "step_size": p.cfg.step_size, "scheme": p.scheme_name,
                     "scheme_params": p.scheme_obj.params(),
                     "batch_size": p.spec.batch_size, "rows": p.rows,
                     "features": p.features, "num_batches": p.num_batches,
                     "chunk": p.chunk, "corpus_bytes": p.corpus_bytes,
                     "devices": 1, "reduction": None,   # single host
                     "why": list(p.why)},
            "epochs_run": self.epochs_run,
            "epochs_done": self.epochs_done,
            "objective": self.objective,
            "history": [float(h) for h in self.history],
            "w": [float(v) for v in self.w],
            "w_norm": float(np.linalg.norm(self.w)),
            "sampler_state": self.sampler_state,
            "train_s": self.train_s,
            "compute_s": self.compute_s,
            "breakdown": self.breakdown(),
            "stats": {**dataclasses.asdict(self.stats),
                      "h2d_bytes_per_device":
                          self.stats.h2d_bytes_per_device},
            "metrics": (self.timeline.metrics
                        if self.timeline is not None else {}),
        }

    def save_json(self, path) -> Path:
        """Write :meth:`to_json` atomically (tmp + ``os.replace``)."""
        return atomic_write_text(path,
                                 json.dumps(self.to_json(), indent=2) + "\n")

    @staticmethod
    def from_json(source, plan_: ExecutionPlan) -> "RunResult":
        """Rebuild the JSON surface of a saved result (a dict or a path)
        against ``plan_``: :meth:`to_json` of the result equals the saved
        one, but ``solver_state`` is ``None`` — resumable state comes from a
        checkpoint through :func:`resume_from`."""
        d = source
        if not isinstance(d, dict):
            d = json.loads(Path(source).read_text())
        want = {"backend": plan_.backend, "solver": plan_.cfg.solver,
                "scheme": plan_.scheme_name, "rows": plan_.rows,
                "devices": 1}
        got = {"backend": d["backend"], "solver": d["plan"]["solver"],
               "scheme": d["plan"]["scheme"], "rows": d["plan"]["rows"],
               "devices": d["plan"]["devices"]}
        if want != got:
            bad = [f"{k}: json {got[k]!r} != plan {want[k]!r}"
                   for k in want if got[k] != want[k]]
            raise ValueError("saved RunResult JSON does not describe this "
                             "plan; differing fields:\n  " + "\n  ".join(bad))
        from ..data import pipeline as pipemod
        fields = {f.name for f in dataclasses.fields(pipemod.AccessStats)}
        stats = pipemod.AccessStats(**{k: v for k, v in d["stats"].items()
                                       if k in fields})
        metrics = d.get("metrics") or {}
        timeline = Timeline(events=[], metrics=metrics) if metrics else None
        return RunResult(
            plan=plan_, objective=d["objective"],
            history=np.asarray(d["history"]),
            w=np.asarray(d["w"], np.float32), solver_state=None,
            sampler_state=d["sampler_state"], epochs_run=d["epochs_run"],
            epochs_done=d["epochs_done"], stats=stats,
            train_s=d["train_s"], compute_s=d["compute_s"],
            timeline=timeline)


# ---------------------------------------------------------------------------
# plan identity: what a resume / restore must match
# ---------------------------------------------------------------------------

# STRICT fields pin the trajectory arithmetic and the batch schedule — a
# checkpoint restored under a different value of any of these would not
# continue the same run.  ``device`` is the port's one field beyond the
# reference's: the CPU and the card sum in different orders.  ELASTIC fields
# may change across a restart: the chunk shape and the epoch budget reshape
# HOW the same trajectory executes, not WHAT it computes (``shards`` and
# ``reduction`` are fixed at 1 and None until the port has device meshes).
_FP_STRICT = ("solver", "scheme", "scheme_params", "loss", "reg", "seed",
              "batch_size",
              "step_mode", "step_size", "ls_mode", "ls_shrink", "ls_c",
              "ls_max_iter", "record_objective", "data", "fmt", "rows",
              "features", "num_batches", "placement", "kernel", "device")
_FP_ELASTIC = ("backend", "chunk", "shards", "reduction", "epochs")


def _plan_fingerprint(p: ExecutionPlan) -> Dict:
    """JSON-safe identity of a plan, stored in every checkpoint's meta and
    validated by :func:`resume_from` before any array is loaded: the
    reference's keys plus ``device``."""
    s = p.spec
    return {
        "solver": p.cfg.solver, "scheme": p.scheme_name,
        "scheme_params": p.scheme_obj.params(), "loss": s.loss,
        "reg": s.reg, "seed": s.seed, "batch_size": s.batch_size,
        "step_mode": p.cfg.step_mode, "step_size": p.cfg.step_size,
        "ls_mode": p.cfg.ls_mode, "ls_shrink": p.cfg.ls_shrink,
        "ls_c": p.cfg.ls_c, "ls_max_iter": p.cfg.ls_max_iter,
        "record_objective": s.record_objective,
        "data": str(s.data.path) if s.data.path is not None else None,
        "fmt": p.fmt, "rows": p.rows, "features": p.features,
        "num_batches": p.num_batches, "placement": p.placement,
        "kernel": p.kernel,
        "backend": p.backend, "chunk": p.chunk, "shards": 1,
        "reduction": None, "epochs": s.epochs,
        "device": p.device,
    }


def _validate_fingerprint(saved: Dict, plan_: ExecutionPlan) -> None:
    """Field-by-field check that a checkpoint belongs to ``plan_``: every
    strict field must match exactly.  (The reference's extra rule, that a
    'psum' checkpoint pins its mesh, waits for device meshes.)"""
    cur = _plan_fingerprint(plan_)
    bad = [f"{k}: checkpoint {saved.get(k)!r} != plan {cur[k]!r}"
           for k in _FP_STRICT if saved.get(k) != cur[k]
           # checkpoints written before the Scheme protocol carry no
           # scheme_params block; the scheme NAME still pins the schedule
           and not (k == "scheme_params" and k not in saved)]
    if bad:
        raise ValueError(
            "checkpoint does not belong to this plan — a restored run must "
            "continue the SAME plan (chunking and epoch budget may change; "
            "everything else, the device included, pins the trajectory); "
            "differing fields:\n  " + "\n  ".join(bad))


def _plan_diff(a: ExecutionPlan, b: ExecutionPlan) -> List[str]:
    """Human-readable field-by-field differences between two plans, for the
    ``execute(resume=)`` rejection message."""
    diffs = []
    for f in dataclasses.fields(ExperimentSpec):
        va, vb = getattr(a.spec, f.name), getattr(b.spec, f.name)
        if f.name == "scheme":
            # a legacy string and the Scheme object it resolves to are the
            # same scheme — compare canonically
            va, vb = schemes.resolve(va), schemes.resolve(vb)
        if va != vb:
            diffs.append(f"spec.{f.name}: resume {va!r} != plan {vb!r}")
    for name in ("backend", "placement", "kernel", "fmt", "rows",
                 "features", "num_batches", "chunk", "device"):
        va, vb = getattr(a, name), getattr(b, name)
        if va != vb:
            diffs.append(f"plan.{name}: resume {va!r} != plan {vb!r}")
    for name in SolverConfig._fields:
        va, vb = getattr(a.cfg, name), getattr(b.cfg, name)
        if va != vb:
            diffs.append(f"cfg.{name}: resume {va!r} != plan {vb!r}")
    return diffs


class _RunCheckpointer:
    """Bridges an epoch loop to the :class:`Checkpointer`.

    Owns the cadence (every ``policy.every`` CUMULATIVE epochs, plus always
    the final epoch of the call, so a completed segment is resumable
    regardless of alignment) and packages the resumable surface into each
    snapshot's meta: sampler state, cumulative objective trace,
    :class:`AccessStats` and the plan fingerprint.  The solver state is the
    array payload.  ``after_epoch`` runs OUTSIDE the timers: the host
    snapshot is synchronous (the next epoch updates the state in place), the
    disk write overlaps the next epoch when the policy is async.
    """

    def __init__(self, plan_: ExecutionPlan, done0: int, epochs: int,
                 tracer=NULL_TRACER):
        self.pol = plan_.spec.checkpoint
        self.ck = (Checkpointer(self.pol.directory, keep=self.pol.keep,
                                async_save=self.pol.async_save,
                                tracer=tracer)
                   if self.pol is not None else None)
        self.plan = plan_
        self.done0 = done0
        self.epochs = epochs

    def after_epoch(self, e: int, state: SolverState, sampler_state: Dict,
                    history: List[float], stats) -> None:
        if self.ck is None:
            return
        done = self.done0 + e + 1
        if done % self.pol.every and e + 1 < self.epochs:
            return
        meta = {
            "schema": 1,
            "epochs_done": done,
            "sampler_state": sampler_state,
            "history": [float(h) for h in history],
            "objective": float(history[-1]) if history else None,
            "plan": _plan_fingerprint(self.plan),
            "policy": {"every": self.pol.every, "keep": self.pol.keep,
                       "async_save": self.pol.async_save},
            "stats": dataclasses.asdict(stats),
        }
        self.ck.save(done, state, meta)

    def finish(self) -> None:
        # a failed async write surfaces HERE — the run must not report
        # durable state it failed to persist
        if self.ck is not None:
            self.ck.wait()


# ---------------------------------------------------------------------------
# execution
# ---------------------------------------------------------------------------

def _sync(device: torch.device) -> None:
    """Wait for the device: the end of every timed span of device work."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(plan_: ExecutionPlan, *, resume: Optional[RunResult] = None,
            epochs: Optional[int] = None) -> RunResult:
    """Run a plan for ``epochs`` epochs (default: the spec's budget).

    ``resume`` continues from a previous result OF THE SAME PLAN: the solver
    state is copied (the stored result stays usable) and the schedule
    resumes where an uninterrupted run would be."""
    epochs = plan_.spec.epochs if epochs is None else epochs
    if resume is not None:
        if resume.solver_state is None:
            raise ValueError(
                "resume result carries no solver state (RunResult.from_json "
                "rebuilds the summary surface only) — reconstruct resumable "
                "state from an on-disk checkpoint via "
                "repro_torch.api.resume_from(directory)")
        prev, cur = resume.plan.spec.data, plan_.spec.data
        # DataSource equality excludes array payloads, so in-memory sources
        # additionally require the SAME arrays
        same_arrays = (prev.kind != ARRAYS
                       or (prev.X is cur.X and prev.y is cur.y))
        # identity is the RESOLVED trajectory (the fingerprint), not raw
        # spec equality: a plan rebuilt from a checkpoint forces fields the
        # original spec left 'auto', and the chunking and epoch budget may
        # change across a restart
        try:
            _validate_fingerprint(_plan_fingerprint(resume.plan), plan_)
            same_run = True
        except ValueError:
            same_run = False
        if not same_run or not same_arrays:
            diffs = _plan_diff(resume.plan, plan_)
            if not same_arrays:
                diffs.append("spec.data: in-memory sources must be the "
                             "same arrays (X/y object identity)")
            raise ValueError(
                "resume result came from a different plan than the one "
                "being executed — a resumed run must continue the SAME "
                "plan (and, for in-memory sources, the same arrays) or the "
                "batch schedule silently diverges from an uninterrupted "
                "run; differing fields:\n  "
                + "\n  ".join(diffs
                              or ["(plans compare unequal with no "
                                  "field-level difference)"]))
    pol = plan_.spec.trace
    tracer = pol.make_tracer() if pol is not None else NULL_TRACER
    if plan_.placement == RESIDENT:
        result = _execute_resident(plan_, resume, epochs, tracer)
    else:
        result = _execute_streamed(plan_, resume, epochs, tracer)
    if tracer.enabled:
        result.timeline = tracer.timeline()
        if pol.path is not None:
            result.timeline.save(pol.path)
    return result


def run_experiment(spec: ExperimentSpec, *, device=None) -> RunResult:
    """``execute(plan(spec, device=device))`` — the one-call path."""
    return execute(plan(spec, device=device))


def _resume_state(plan_: ExecutionPlan, resume: Optional[RunResult],
                  device: torch.device) -> Tuple[SolverState, int]:
    """(initial solver state, epochs already done).  A resumed state is
    CLONED: the engines update the SAG/SAGA table in place."""
    if resume is None:
        w0 = torch.zeros(plan_.features, dtype=torch.float32, device=device)
        return init_state(plan_.cfg.solver, w0, plan_.num_batches), 0
    return clone_state(resume.solver_state), resume.epochs_done


# ---- resident backends -----------------------------------------------------

def _execute_resident(plan_: ExecutionPlan, resume: Optional[RunResult],
                      epochs: int, tracer: Tracer = NULL_TRACER) -> RunResult:
    from ..data import pipeline as pipemod

    spec, cfg = plan_.spec, plan_.cfg
    problem = spec.problem
    device = torch.device(plan_.device)
    stats = pipemod.AccessStats()
    h2d_dt = 0.0

    if spec.data.kind == ARRAYS:
        X = torch.as_tensor(spec.data.X, dtype=torch.float32, device=device)
        y = torch.as_tensor(spec.data.y, dtype=torch.float32, device=device)
    else:
        pipe = pipemod.DataPipeline(pipemod.PipelineConfig(
            corpus=spec.data.path, batch_size=spec.batch_size,
            sampling=spec.scheme, seed=spec.seed, prefetch=0, resident=True),
            tracer=tracer)
        stats = pipe.stats
        rows = pipe.read_all()
        n = plan_.features
        # contiguity copies BEFORE the timer: the H2D number is the copy
        Xh = torch.from_numpy(np.ascontiguousarray(rows[:, :n]))
        yh = torch.from_numpy(np.ascontiguousarray(rows[:, n]))
        nbytes = Xh.nbytes + yh.nbytes
        with tracer.timespan("stage_resident", H2D, bytes=nbytes) as sp:
            X, y = Xh.to(device), yh.to(device)
            _sync(device)
        h2d_dt = sp.dur
        stats.record_h2d(h2d_dt, nbytes)

    l, b = plan_.rows, spec.batch_size
    scheme = plan_.scheme_obj
    objective = lambda w: float(problem.objective(w, X, y))
    state, done0 = _resume_state(plan_, resume, device)

    if resume is None:
        # first use builds the kernels and warms the device: one batch of a
        # throwaway state, untimed
        dummy = init_state(cfg.solver, torch.zeros_like(state.w),
                           plan_.num_batches)
        warm = torch.from_numpy(samplers.epoch_schedule(scheme, spec.seed, 0,
                                                        l, b)[:1])
        resident_epoch(problem, cfg, dummy, X, y, warm.to(device), b)
        objective(state.w)
        _sync(device)

    prefix = [] if resume is None else [float(h) for h in resume.history]
    history: List[float] = []
    compute_s = 0.0
    train_s = 0.0
    rck = _RunCheckpointer(plan_, done0, epochs, tracer)
    try:
        for e in range(epochs):
            with tracer.span("epoch", EPOCH, epoch=done0 + e):
                # the epoch's schedule: drawn on the host from the Scheme
                # stream (outside the compute span), staged through the H2D
                # lane
                sched_h = torch.from_numpy(samplers.epoch_schedule(
                    scheme, spec.seed, done0 + e, l, b))
                with tracer.timespan("stage_schedule", H2D,
                                     bytes=sched_h.nbytes) as sp:
                    sched = sched_h.to(device)
                    _sync(device)
                stats.record_h2d(sp.dur, sched_h.nbytes)
                with tracer.timespan("resident_epoch", COMPUTE,
                                     epoch=done0 + e,
                                     step_rule=plan_.step_rule) as sc:
                    state = resident_epoch(problem, cfg, state, X, y, sched,
                                           b)
                    _sync(device)
            compute_s += sc.dur
            train_s += sc.dur
            if cfg.step_mode == LINE_SEARCH:
                tracer.metrics.counter("ls.invocations").inc(
                    plan_.num_batches)
            if spec.data.kind != ARRAYS and e > 0:
                # every epoch after the first of THIS call would have
                # restaged the corpus
                stats.record_h2d_saved(h2d_dt)
            if spec.record_objective:
                history.append(objective(state.w))     # outside the timers
            # the schedule is a function of (seed, epoch): the sampler state
            # is the epoch count, and a resume needs no key
            rck.after_epoch(e, state,
                            {"scheme": plan_.scheme_name, "seed": spec.seed,
                             "epochs": done0 + e + 1},
                            prefix + history, stats)
    finally:
        rck.finish()

    final = history[-1] if history else objective(state.w)
    return RunResult(
        plan=plan_, objective=final, history=np.asarray(prefix + history),
        w=state.w.detach().cpu().numpy().copy(), solver_state=state,
        sampler_state={"scheme": plan_.scheme_name, "seed": spec.seed,
                       "epochs": done0 + epochs},
        epochs_run=epochs, epochs_done=done0 + epochs, stats=stats,
        train_s=train_s, compute_s=compute_s)


# ---- streamed backend ------------------------------------------------------

def _make_put(device: torch.device) -> Callable:
    """The :class:`DeviceStager` put: non-blocking copies of the pinned host
    buffers on a side stream, waited for inside the stager's H2D span (so
    the span measures the copy and nothing the compute stream queued)."""
    if device.type != "cuda":
        return lambda host: host
    consumer = torch.cuda.current_stream(device)
    side = torch.cuda.Stream(device)

    def put(host):
        with torch.cuda.stream(side):
            dev = tuple(t.to(device, non_blocking=True) for t in host)
        side.synchronize()
        for t in dev:
            t.record_stream(consumer)   # freed only after the consumer's use
        return dev
    return put


def _execute_streamed(plan_: ExecutionPlan, resume: Optional[RunResult],
                      epochs: int, tracer: Tracer = NULL_TRACER) -> RunResult:
    """The ``streamed-eager`` and ``sparse-csr`` backends: one chunked loop
    (:func:`_drive_chunked`) over a dense row stream or a CSR stream of
    padded-ELL batches; adaptive schemes take the weighted engines and
    :func:`_drive_chunked_adaptive`."""
    from ..data import pipeline as pipemod

    spec, cfg = plan_.spec, plan_.cfg
    problem = spec.problem
    device = torch.device(plan_.device)
    pin = device.type == "cuda"
    m, K, n = plan_.num_batches, plan_.chunk, plan_.features
    b = spec.batch_size
    state, done0 = _resume_state(plan_, resume, device)
    start_step = done0 * m
    scheme_obj = plan_.scheme_obj
    adaptive = scheme_obj.adaptive
    epoch_fn = make_epoch_fn(problem, cfg, weighted=adaptive)

    # adaptive schemes: read-ahead is off (prefetch=0) so the sampler state
    # is exact at every epoch boundary, and a resumed run restores the
    # scheme's learning state (scores / cursor) from the checkpoint's own
    # meta instead of the (seed, step) arithmetic of the uniform schemes
    smeta = (resume.sampler_state if adaptive and resume is not None
             else None)
    pcfg = pipemod.PipelineConfig(corpus=spec.data.path, batch_size=b,
                                  sampling=spec.scheme, seed=spec.seed,
                                  prefetch=0 if adaptive else spec.prefetch)
    if plan_.fmt == CSR:
        from ..data import sparse
        csr = sparse.open_csr_corpus(spec.data.path)
        kmax = plan_.kmax
        pipe = sparse.SparsePipeline(pcfg, start_step=start_step,
                                     tracer=tracer, sampler_meta=smeta)
        # (cols, vals, y) of k ELL batches, in pinned host buffers
        shapes = (((b, kmax), torch.int32), ((b, kmax), torch.float32),
                  ((b,), torch.float32))

        def fill(bufs, i, sb):
            for buf, part in zip(bufs, (sb.cols, sb.vals, sb.y)):
                buf[i].numpy()[:] = part

        def full_grad_at(w, data_term_only=False):
            # the reference's float64 host pass, so the snapshot keeps its bits
            return torch.from_numpy(sparse.csr_full_grad(
                problem, csr, w.cpu().numpy(),
                data_term_only=data_term_only)).to(device)

        def eval_obj(w):
            return sparse.csr_objective(problem, csr, w.cpu().numpy())

        def block_losses(w):
            means, _ = sparse.csr_block_losses(problem, csr, w.cpu().numpy(),
                                               b)
            return {"block_losses": means}
    else:
        from ..data import dataset
        mm, _ = dataset.open_corpus(spec.data.path)
        pipe = pipemod.DataPipeline(pcfg, start_step=start_step,
                                    tracer=tracer, sampler_meta=smeta)
        shapes = (((b, n), torch.float32), ((b,), torch.float32))

        def fill(bufs, i, rows):
            bufs[0][i].numpy()[:] = rows[:, :n]
            bufs[1][i].numpy()[:] = rows[:, n]

        def row_chunks():
            for lo in range(0, plan_.rows, _EVAL_CHUNK):
                rows = np.array(mm[lo:lo + _EVAL_CHUNK])   # writable copy
                yield rows[:, :n], rows[:, n]

        def full_grad_at(w, data_term_only=False):
            return streaming_full_grad(problem, w, row_chunks(),
                                       data_term_only=data_term_only)

        def eval_obj(w):
            total = 0.0
            for Xc, yc in row_chunks():
                total += float(problem.data_objective(
                    w, torch.as_tensor(Xc, device=device),
                    torch.as_tensor(yc, device=device))) * Xc.shape[0]
            return (total / plan_.rows
                    + 0.5 * problem.reg * float(torch.dot(w, w)))

        def block_losses(w):
            # per-BLOCK mean loss (blocks = the b-row batch slots the
            # contiguous schemes index) in one streamed numpy pass, rows
            # binned by global offset, as the reference does
            from ..data.sparse import _loss_np
            wh = w.detach().cpu().numpy()
            sums = np.zeros(m, np.float64)
            cnt = np.zeros(m, np.int64)
            lo = 0
            for Xc, yc in row_chunks():
                per = _loss_np(problem.loss, Xc @ wh, yc)
                blk = (lo + np.arange(Xc.shape[0])) // b
                np.add.at(sums, blk, per)
                np.add.at(cnt, blk, 1)
                lo += Xc.shape[0]
            return {"block_losses": sums / np.maximum(cnt, 1)}

    def alloc(k):
        # pinned host buffers: the stager's copy to the card is asynchronous
        return tuple(torch.empty((k,) + shape, dtype=dt, pin_memory=pin)
                     for shape, dt in shapes)

    # warm the device (first kernels, allocator) outside the timed region;
    # the weighted (adaptive) engines take a trailing (k,) weight vector
    dummy = init_state(cfg.solver, torch.zeros(n, device=device), m)
    epoch_fn(dummy, *(torch.zeros((1,) + shape, dtype=dt, device=device)
                      for shape, dt in shapes),
             torch.zeros(1, dtype=torch.int32, device=device),
             *((torch.ones(1, device=device),) if adaptive else ()))
    _sync(device)

    snapshot_begin = None
    if cfg.solver in ("svrg", "saag2"):
        data_only = cfg.solver == "saag2"

        def snapshot_begin(st):
            return epoch_begin(problem, cfg, st,
                               lambda w: full_grad_at(
                                   w, data_term_only=data_only))

    prefix = [] if resume is None else [float(h) for h in resume.history]
    rck = _RunCheckpointer(plan_, done0, epochs, tracer)

    def on_epoch(e, st, hist):
        if adaptive:
            # the adaptive chunk loop drains exactly m draws per epoch and
            # applies observe() BEFORE this hook, so the scheme's own meta
            # (scores / cursor included) is exact here
            smeta_e = pipe.sampler_meta()
        else:
            # the count of CONSUMED batches — the prefetch producer may have
            # advanced the live sampler a few steps further
            smeta_e = {"scheme": plan_.scheme_name, "seed": spec.seed,
                       "step": start_step + m * (e + 1)}
        rck.after_epoch(e, st, smeta_e, prefix + hist, pipe.stats)

    try:
        state, history, compute_s, train_s = _drive_chunked(
            pipe, epoch_fn, state, m=m, K=K, epochs=epochs,
            start_step=start_step, alloc=alloc, fill=fill,
            snapshot_begin=snapshot_begin,
            eval_fn=eval_obj if spec.record_objective else None,
            put=_make_put(device), device=device, on_epoch=on_epoch,
            tracer=tracer, epoch0=done0, step_rule=plan_.step_rule,
            adaptive=adaptive,
            feedback=(block_losses if adaptive and scheme_obj.wants_feedback
                      else None))
        if cfg.step_mode == LINE_SEARCH:
            tracer.metrics.counter("ls.invocations").inc(m * epochs)
    finally:
        rck.finish()

    final = history[-1] if history else eval_obj(state.w)
    return RunResult(
        plan=plan_, objective=final, history=np.asarray(prefix + history),
        w=state.w.detach().cpu().numpy().copy(), solver_state=state,
        sampler_state=(pipe.sampler_meta() if adaptive else
                       {"scheme": plan_.scheme_name, "seed": spec.seed,
                        "step": start_step + m * epochs}),
        epochs_run=epochs, epochs_done=done0 + epochs, stats=pipe.stats,
        train_s=train_s, compute_s=compute_s)


def _drive_chunked(pipe, epoch_fn, state, *, m: int, K: int, epochs: int,
                   start_step: int, alloc: Callable, fill: Callable,
                   snapshot_begin: Optional[Callable],
                   eval_fn: Optional[Callable], put: Callable,
                   device: torch.device,
                   on_epoch: Optional[Callable] = None,
                   tracer: Tracer = NULL_TRACER, epoch0: int = 0,
                   step_rule: Optional[str] = None, adaptive: bool = False,
                   feedback: Optional[Callable] = None,
                   ) -> Tuple[SolverState, List[float], float, float]:
    """The streaming engine: group the pipeline's batch stream into <=K-batch
    chunks (never crossing an epoch boundary — snapshot solvers refresh
    between epochs), double-buffer them host->device (DeviceStager), and run
    each chunk in one engine call.  ``eval_fn(w)`` (the per-epoch objective)
    and ``on_epoch(e, state, history)`` (the checkpoint hook) run at every
    epoch boundary, outside the timers.  With ``adaptive=True`` the pipeline
    yields ``(payload, j, weight)`` triples and the loop switches to
    :func:`_drive_chunked_adaptive`.  Returns (state, history, compute_s,
    train_s)."""
    from ..data import pipeline as pipemod

    if adaptive:
        return _drive_chunked_adaptive(
            pipe, epoch_fn, state, m=m, K=K, epochs=epochs, alloc=alloc,
            fill=fill, snapshot_begin=snapshot_begin, eval_fn=eval_fn,
            feedback=feedback, put=put, device=device, on_epoch=on_epoch,
            tracer=tracer, epoch0=epoch0, step_rule=step_rule)

    def host_chunks():
        it = iter(pipe)
        step, total = start_step, start_step + m * epochs
        while step < total:
            j0 = step % m
            k = min(K, m - j0)
            bufs = alloc(k)
            for i in range(k):
                fill(bufs, i, next(it))
            yield bufs + (j0,)
            step += k

    def convert(arg):
        *bufs, j0 = arg
        js = (np.arange(j0, j0 + bufs[0].shape[0]) % m).astype(np.int32)
        return tuple(bufs) + (torch.from_numpy(js),)

    stager = pipemod.DeviceStager(host_chunks(), put=put, convert=convert,
                                  depth=2, stats=pipe.stats, tracer=tracer)
    chunks_iter = iter(stager)
    history: List[float] = []
    compute_s = 0.0
    train_s = 0.0
    try:
        for e in range(epochs):
            with tracer.timespan("train_epoch", EPOCH,
                                 epoch=epoch0 + e) as se:
                if snapshot_begin is not None:
                    state = snapshot_begin(state)
                done = 0
                while done < m:
                    args = next(chunks_iter)
                    with tracer.timespan("chunk", COMPUTE,
                                         epoch=epoch0 + e, first_batch=done,
                                         step_rule=step_rule) as sc:
                        state = epoch_fn(state, *args)
                        _sync(device)
                        sc.set(batches=int(args[0].shape[0]))
                    compute_s += sc.dur
                    done += args[0].shape[0]
            train_s += se.dur
            if eval_fn is not None:
                history.append(float(eval_fn(state.w)))   # untimed
            if on_epoch is not None:
                on_epoch(e, state, history)               # untimed
    finally:
        stager.close()
        pipe.close()
    return state, history, compute_s, train_s


def _drive_chunked_adaptive(pipe, epoch_fn, state, *, m: int, K: int,
                            epochs: int, alloc: Callable, fill: Callable,
                            snapshot_begin: Optional[Callable],
                            eval_fn: Optional[Callable],
                            feedback: Optional[Callable], put: Callable,
                            device: torch.device,
                            on_epoch: Optional[Callable] = None,
                            tracer: Tracer = NULL_TRACER, epoch0: int = 0,
                            step_rule: Optional[str] = None,
                            ) -> Tuple[SolverState, List[float], float, float]:
    """The adaptive-scheme variant of :func:`_drive_chunked`, serving one
    invariant — the scheme state is EXACT at every epoch boundary:

    * the pipeline yields ``(payload, j, weight)`` triples: the scheme picks
      the table slot ``j`` (not ``step % m``) and the unbiasedness
      ``weight`` the weighted engine takes as a trailing ``(k,)`` vector;
    * the :class:`DeviceStager` is scoped to ONE epoch, so after its chunks
      drain the (prefetch=0) pipeline has consumed exactly ``m`` draws;
    * ``feedback(w)`` lands through ``pipe.observe`` BEFORE ``on_epoch``,
      so the checkpoint carries the post-observe learning state and a
      resume replays the next epoch bit for bit.
    """
    from ..data import pipeline as pipemod

    def epoch_chunks():
        it = iter(pipe)
        done = 0
        while done < m:
            k = min(K, m - done)
            bufs = alloc(k)
            js = torch.empty(k, dtype=torch.int32)
            ws = torch.empty(k, dtype=torch.float32)
            for i in range(k):
                payload, j, w = next(it)
                fill(bufs, i, payload)
                js[i] = int(j)
                ws[i] = float(w)
            yield bufs + (js, ws)
            done += k

    history: List[float] = []
    compute_s = 0.0
    train_s = 0.0
    try:
        for e in range(epochs):
            stager = pipemod.DeviceStager(epoch_chunks(), put=put, depth=2,
                                          stats=pipe.stats, tracer=tracer)
            with tracer.timespan("train_epoch", EPOCH,
                                 epoch=epoch0 + e) as se:
                if snapshot_begin is not None:
                    state = snapshot_begin(state)
                done = 0
                for args in stager:
                    with tracer.timespan("chunk", COMPUTE,
                                         epoch=epoch0 + e, first_batch=done,
                                         step_rule=step_rule) as sc:
                        state = epoch_fn(state, *args)
                        _sync(device)
                        sc.set(batches=int(args[0].shape[0]))
                    compute_s += sc.dur
                    done += args[0].shape[0]
            stager.close()   # producer joined: the sampler is quiescent
            train_s += se.dur
            if eval_fn is not None:
                history.append(float(eval_fn(state.w)))   # untimed
            if feedback is not None:
                pipe.observe(feedback(state.w))           # untimed
            if on_epoch is not None:
                on_epoch(e, state, history)               # untimed
    finally:
        pipe.close()
    return state, history, compute_s, train_s


# ---------------------------------------------------------------------------
# durable-run restore
# ---------------------------------------------------------------------------

def _plan_from_fingerprint(saved: Dict, directory: Path, meta: Dict,
                           device=None) -> ExecutionPlan:
    """Rebuild a runnable plan from a checkpoint's own fingerprint — the
    ``resume_from(dir)`` path after a crash took the process (and its spec)
    with it.  Every planner choice the fingerprint resolved (placement,
    kernel, step size, ls mode, chunk) is FORCED so the rebuilt plan cannot
    re-plan differently."""
    if saved.get("data") is None:
        raise ValueError(
            "checkpoint was taken from an in-memory arrays source, which "
            "has no path to reopen — pass the plan explicitly: "
            "resume_from(directory, plan(spec))")
    pol = meta.get("policy", {})
    spec = ExperimentSpec(
        data=DataSource.corpus(saved["data"]),
        loss=saved["loss"], reg=saved["reg"],
        solver=saved["solver"],
        # rebuild the Scheme OBJECT: a bare name would drop the adaptive
        # schemes' parameters (ema/floor/min_frac)
        scheme=schemes.from_meta({"scheme": saved["scheme"],
                                  "params": saved.get("scheme_params")}),
        step_mode=saved["step_mode"], step_size=saved["step_size"],
        ls_mode=saved["ls_mode"], ls_shrink=saved["ls_shrink"],
        ls_c=saved["ls_c"], ls_max_iter=saved["ls_max_iter"],
        batch_size=saved["batch_size"], epochs=saved["epochs"],
        seed=saved["seed"], record_objective=saved["record_objective"],
        placement=saved["placement"], kernel=saved["kernel"],
        chunk=saved["chunk"],
        checkpoint=CheckpointPolicy(directory, **pol))
    return plan(spec, device=device)


def resume_from(directory, plan_: Optional[ExecutionPlan] = None, *,
                step: Optional[int] = None, device=None) -> RunResult:
    """Reconstruct a resumable :class:`RunResult` from an on-disk checkpoint
    directory — the crash-recovery entry point.

    With ``plan_=None`` the plan is rebuilt from the checkpoint's
    fingerprint (corpus-backed runs) on ``device`` — the card unless
    ``device="cpu"`` — and is ``result.plan``.  An explicit ``plan_`` is
    validated against the checkpoint field by field.  ``step`` picks a
    snapshot (default: the newest COMPLETE one).  A checkpoint restores only
    onto a plan on the device that wrote it.  Pass the result straight back:
    ``execute(result.plan, resume=result)``.
    """
    directory = Path(directory)
    if not directory.exists():
        # Checkpointer() would mkdir it: a typo'd path must fail loudly
        raise FileNotFoundError(f"no checkpoint directory at {directory}")
    ck = Checkpointer(directory)
    step_, meta = ck.read_meta(step)
    saved = meta["plan"]
    if plan_ is None:
        plan_ = _plan_from_fingerprint(saved, directory, meta, device=device)
    _validate_fingerprint(saved, plan_)
    dev = torch.device(plan_.device)
    # a fresh init state has the saved tree's exact structure
    template = init_state(plan_.cfg.solver,
                          torch.zeros(plan_.features, device=dev),
                          plan_.num_batches)
    state, meta = ck.restore(template, step=step_, device=dev)

    from ..data import pipeline as pipemod
    fields = {f.name for f in dataclasses.fields(pipemod.AccessStats)}
    stats = pipemod.AccessStats(**{k: v for k, v in meta["stats"].items()
                                   if k in fields})
    history = [float(h) for h in meta["history"]]
    objective = (float(meta["objective"])
                 if meta.get("objective") is not None else float("nan"))
    return RunResult(
        plan=plan_, objective=objective, history=np.asarray(history),
        w=state.w.detach().cpu().numpy().copy(), solver_state=state,
        sampler_state=meta["sampler_state"],
        epochs_run=0, epochs_done=meta["epochs_done"], stats=stats,
        train_s=0.0, compute_s=0.0)
