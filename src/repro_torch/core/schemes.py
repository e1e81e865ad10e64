"""First-class sampling schemes: the ``Scheme`` protocol.

A verbatim copy of ``repro.core.schemes`` (pure numpy): the port draws the
same index streams bit for bit, and importing the reference module would
pull in JAX through ``repro/core/__init__.py``.

The paper's RS/CS/SS axis (§2) is one point in a larger design space: any
rule that picks *which rows to read next* trades access locality against
statistical progress per epoch.  This module makes that rule a first-class,
frozen, serializable object so the rest of the framework — ``ExperimentSpec``,
``plan()``, both executors, the checkpointer, ``supercell_key`` — consumes a
protocol instead of a hard-coded string triple.

A :class:`Scheme` is **parameters only** (a frozen dataclass, hashable, safe
inside ``ExperimentSpec``).  All mutable progress lives in a
:class:`SchemeState` produced by :meth:`Scheme.bind`; stepping is pure
(``next_batch(state) -> (BatchIndices, state)``) and every state is exactly
reconstructable from the small JSON dict :meth:`Scheme.state_meta` emits —
the property the fault-tolerance layer relies on.

Protocol surface::

    scheme.validate(batch_size=...)        # ValueError on bad params
    scheme.bind(l, batch_size, seed)       # -> SchemeState (step 0)
    scheme.next_batch(state)               # -> (BatchIndices, SchemeState)
    scheme.max_batch_size(batch_size)      # static upper bound on rows/batch
    scheme.observe(state, batch_stats)     # feedback hook (adaptive schemes)
    scheme.state_meta(state)               # -> JSON-safe checkpoint dict
    scheme.restore(meta, l, batch_size)    # -> SchemeState (exact resume)
    scheme.params()                        # -> JSON-safe constructor params

plus module-level :func:`resolve` (legacy string or Scheme instance → the
canonical object) and :func:`restore_state` (the single restore-from-meta
entry point the checkpointer uses).

Five schemes ship on the protocol:

* :class:`Random` / :class:`Cyclic` / :class:`Systematic` — the paper's
  RS/CS/SS, **bit-identical** to the pre-protocol ``samplers`` module
  (including the memoized epoch-permutation path, whose per-scheme special
  cases used to live in ``samplers.next_indices`` and now live behind
  ``next_batch``).
* :class:`ChunkImportance` — chunk-level importance sampling in the style of
  Active Sampler (arXiv 1512.03880): per-block loss statistics bias *which
  contiguous block* is staged next.  Rows inside a block stay sequential, so
  the access profile (and ``AccessStats`` accounting) keeps the CS/SS
  contiguous fast path while convergence accelerates on heterogeneous data.
  Gradients are importance-weighted (``BatchIndices.weight``) so the
  estimator stays unbiased.
* :class:`StochasticBatch` — per-step batch size drawn from a validated
  distribution (Liu & Hsieh, arXiv 1808.02169) over a contiguous cursor.
  ``batch_size`` becomes an upper *bound*: staged buffers keep the static
  ``(b, n)`` shape (zero-padded rows contribute exactly zero to the data
  gradient) and ``weight = b / b_t`` re-normalizes the batch mean.
"""
from __future__ import annotations

import dataclasses
from typing import ClassVar, Dict, NamedTuple, Optional, Tuple, Union

import numpy as np

__all__ = [
    "BatchIndices", "Scheme", "SchemeState",
    "Random", "Cyclic", "Systematic", "ChunkImportance", "StochasticBatch",
    "REGISTRY", "resolve", "from_meta", "restore_state", "scheme_name",
    "num_batches",
]


def num_batches(l: int, batch_size: int) -> int:
    return -(-l // batch_size)


class BatchIndices(NamedTuple):
    """One batch's row selection, scheme-agnostic.

    ``idx`` is always materialized (``(b_t,)`` int64 rows, wrap-around
    padded); ``start`` is the contiguous block start when the scheme has
    block structure and ``None`` for scattered RS — consumers keep their
    single-slice fast path by testing ``start`` instead of scheme names.
    ``j`` is the gradient-table slot this batch updates (SAG/SAGA); for the
    uniform schemes it equals ``step % m`` and consumers may recompute it
    arithmetically, but adaptive schemes choose it, so drivers must take it
    from here.  ``weight`` rescales the batch-mean data gradient so biased
    selection (importance sampling) or short batches (stochastic batch
    size) keep the estimator unbiased; uniform schemes emit 1.0.
    """
    idx: np.ndarray
    start: Optional[int]
    j: int = 0
    weight: float = 1.0


@dataclasses.dataclass(frozen=True)
class SchemeState:
    """Bound sampling state: deterministic, trivially checkpointable.

    ``seed`` fixes the whole schedule; ``step`` is the global batch counter.
    ``aux`` is the scheme-specific extra state (importance scores, batch
    cursor) — a tuple of JSON-representable leaves so :meth:`Scheme.state_meta`
    can serialize it.  The uniform schemes carry ``aux=()`` and remain the
    two-integer state the fault-tolerance layer was built on.

    ``_memo`` caches the current epoch's O(l) shuffle so stepping is O(b)
    amortized per batch, not O(l).  It is pure derived data (a function of
    (seed, epoch) only), excluded from comparison, carried across
    ``dataclasses.replace`` steps by reference, and never serialized.
    """
    scheme: "Scheme"
    seed: int
    step: int
    l: int
    batch_size: int
    aux: tuple = ()
    _memo: dict = dataclasses.field(default_factory=dict, compare=False,
                                    repr=False)

    @property
    def m(self) -> int:
        return num_batches(self.l, self.batch_size)

    @property
    def epoch(self) -> int:
        return self.step // self.m

    @property
    def batch_in_epoch(self) -> int:
        return self.step % self.m


def _epoch_perm(state, size: int) -> np.ndarray:
    """This epoch's permutation of ``size`` (rows for RS, block starts for
    SS) over the ``SeedSequence([seed, epoch])`` stream — unchanged from the
    pre-memoization code, so checkpointed schedules replay identically.

    Memoized on the state: recomputing an O(l) shuffle for EVERY batch made
    "access time" in the benchmarks mostly sampler time (7x the actual
    scattered read at l=100k).  Only the current epoch's permutation is
    retained; read-only so every batch of the epoch can share it.  Works on
    any state exposing ``seed`` / ``epoch`` / ``_memo`` (both SchemeState
    and the legacy ``samplers.SamplerState`` shim).
    """
    key = (state.epoch, size)
    perm = state._memo.get(key)
    if perm is None:
        perm = np.random.default_rng(
            np.random.SeedSequence([state.seed, state.epoch])).permutation(size)
        perm.setflags(write=False)
        state._memo.clear()          # previous epoch is never needed again
        state._memo[key] = perm
    return perm


def _step_rng(seed: int, step: int) -> np.random.Generator:
    """Deterministic per-step stream — fresh generator keyed on (seed, step)
    so any host replays any step without history (same construction the
    pre-protocol RS-with-replacement path used)."""
    return np.random.default_rng(np.random.SeedSequence([seed, step]))


@dataclasses.dataclass(frozen=True)
class Scheme:
    """Base class: a frozen, hashable, serializable sampling scheme.

    Subclasses override :meth:`next_batch` (required) plus whichever of the
    class flags / hooks their behavior needs.  ``adaptive`` schemes require
    the streamed executor's host feedback loop (they cannot be baked into a
    jit-traced resident epoch); ``weighted`` schemes emit non-unit
    ``BatchIndices.weight`` and need the weighted epoch engine.
    """
    name: ClassVar[str] = ""
    adaptive: ClassVar[bool] = False
    weighted: ClassVar[bool] = False
    wants_feedback: ClassVar[bool] = False

    # -- parameters ---------------------------------------------------------
    def params(self) -> Dict[str, object]:
        """JSON-safe constructor params (field name -> value)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    def canonical(self) -> tuple:
        """Hashable identity: (name, sorted params).  Equal for a legacy
        string spec and the object it resolves to — the fingerprint /
        ``supercell_key`` currency."""
        return (self.name, tuple(sorted(self.params().items())))

    def validate(self, batch_size: Optional[int] = None) -> None:
        """Raise ``ValueError`` on bad parameters.  This is THE validator:
        ``plan()`` calls it and re-raises as ``PlanError``; direct users
        (``bind``, the pipelines) get the ``ValueError`` — one rule, error
        type chosen at the boundary."""

    def max_batch_size(self, batch_size: int) -> int:
        """Static upper bound on rows per batch — the staged-buffer shape.
        For fixed-size schemes this IS the batch size; schemes with a
        variable draw still bound it here so XLA shapes stay static."""
        return batch_size

    # -- state --------------------------------------------------------------
    def _init_aux(self, l: int, batch_size: int) -> tuple:
        return ()

    def bind(self, l: int, batch_size: int, seed: int,
             step: int = 0) -> SchemeState:
        """Bind the scheme to a corpus: validated, step-``step`` state."""
        if batch_size <= 0 or l <= 0:
            raise ValueError("l and batch_size must be positive")
        self.validate(batch_size=batch_size)
        return SchemeState(self, seed, step, l, batch_size,
                           self._init_aux(l, batch_size))

    def next_batch(self, state: SchemeState
                   ) -> Tuple[BatchIndices, SchemeState]:
        raise NotImplementedError

    def observe(self, state: SchemeState, batch_stats: Dict
                ) -> SchemeState:
        """Feedback hook: fold run statistics (e.g. per-block losses) into
        the sampling state.  Uniform schemes ignore it."""
        return state

    # -- checkpointing ------------------------------------------------------
    def state_meta(self, state: SchemeState) -> Dict:
        """JSON-safe dict from which :meth:`restore` rebuilds ``state``
        exactly.  The uniform schemes keep the historical two-integer
        ``{"scheme", "seed", "step"}`` layout byte-compatible with existing
        checkpoints; adaptive schemes append ``params`` + their aux."""
        return {"scheme": self.name, "seed": state.seed, "step": state.step}

    def _meta_step(self, meta: Dict, l: int, batch_size: int) -> int:
        # streamed checkpoints store the global batch counter ("step");
        # resident ones store whole epochs — the in-graph engine only stops
        # at epoch boundaries, so its step is epochs * m
        if "step" in meta:
            return int(meta["step"])
        return int(meta["epochs"]) * num_batches(l, batch_size)

    def restore(self, meta: Dict, l: int, batch_size: int) -> SchemeState:
        """THE restore entry point (collapses the historical
        ``samplers.restore`` / ``restore_from_meta`` pair): rebuild bound
        state from checkpoint metadata for exact resume."""
        return self.bind(l, batch_size, int(meta["seed"]),
                         step=self._meta_step(meta, l, batch_size))


# ---------------------------------------------------------------------------
# the paper's three schemes, reimplemented on the protocol
# (bit-identical index streams to the pre-protocol samplers module)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class Random(Scheme):
    """RS — scattered access; with or without replacement (§2.1)."""
    name: ClassVar[str] = "random"
    with_replacement: bool = False

    def state_meta(self, state):
        meta = super().state_meta(state)
        if self.with_replacement:
            # non-default draw mode must survive the meta round trip; the
            # default keeps the historical two-integer layout byte-for-byte
            meta["params"] = self.params()
        return meta

    def next_batch(self, state):
        j = state.batch_in_epoch
        b, l = state.batch_size, state.l
        if self.with_replacement:
            # fresh draw per batch, but deterministic in (seed, step)
            idx = _step_rng(state.seed, state.step).integers(0, l, size=b)
        else:
            perm = _epoch_perm(state, l)
            lo, hi = j * b, (j + 1) * b
            if hi <= l:
                idx = perm[lo:hi]
            else:  # wrap-around padding for the trailing batch
                idx = np.concatenate([perm[lo:], perm[: hi - l]])
        return (BatchIndices(idx.astype(np.int64), None, j),
                dataclasses.replace(state, step=state.step + 1))


@dataclasses.dataclass(frozen=True)
class Cyclic(Scheme):
    """CS — batch ``j`` is rows ``[j*b, (j+1)*b)``; fully contiguous (§2.2)."""
    name: ClassVar[str] = "cyclic"

    def next_batch(self, state):
        j, b, l = state.batch_in_epoch, state.batch_size, state.l
        start = j * b
        idx = np.arange(start, start + b, dtype=np.int64) % l
        return (BatchIndices(idx.astype(np.int64), start, j),
                dataclasses.replace(state, step=state.step + 1))


@dataclasses.dataclass(frozen=True)
class Systematic(Scheme):
    """SS — a per-epoch random permutation of the ``m`` block starts; each
    batch is a contiguous run ``[start, start+b)`` (§2.3)."""
    name: ClassVar[str] = "systematic"

    def next_batch(self, state):
        j, b, l = state.batch_in_epoch, state.batch_size, state.l
        start = int(_epoch_perm(state, state.m)[j]) * b
        idx = (start + np.arange(b, dtype=np.int64)) % l
        return (BatchIndices(idx.astype(np.int64), start, j),
                dataclasses.replace(state, step=state.step + 1))


# ---------------------------------------------------------------------------
# adaptive schemes
# ---------------------------------------------------------------------------

_SCORE_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class ChunkImportance(Scheme):
    """Chunk-level importance sampling (Active Sampler style).

    Maintains an EMA score per contiguous block (the per-block mean loss the
    executor feeds back through :meth:`observe` once per epoch) and draws
    the next block ``j`` with probability::

        p_j = floor/m + (1 - floor) * score_j / sum(score)

    ``floor`` mixes in the uniform distribution so every block keeps a
    nonzero visiting rate (bounded importance weights, no starvation).  The
    emitted batch is the *contiguous* block ``[j*b, (j+1)*b)`` — one seek,
    exactly the CS/SS access profile — and ``weight = 1/(m * p_j)`` keeps
    the batch-mean gradient unbiased.  Table slot ``j`` is the chosen block,
    so SAG/SAGA-style per-block tables stay aligned with the data.
    """
    name: ClassVar[str] = "chunk_importance"
    adaptive: ClassVar[bool] = True
    weighted: ClassVar[bool] = True
    wants_feedback: ClassVar[bool] = True
    ema: float = 0.3
    floor: float = 0.1

    def validate(self, batch_size=None):
        if not 0.0 < self.ema <= 1.0:
            raise ValueError(f"chunk_importance: ema must be in (0, 1] "
                             f"(got {self.ema})")
        if not 0.0 <= self.floor <= 1.0:
            raise ValueError(f"chunk_importance: floor must be in [0, 1] "
                             f"(got {self.floor})")

    def _init_aux(self, l, batch_size):
        scores = np.ones(num_batches(l, batch_size), dtype=np.float64)
        scores.setflags(write=False)
        return (scores,)

    def _probs(self, state) -> np.ndarray:
        s = state.aux[0]
        m = s.shape[0]
        p = self.floor / m + (1.0 - self.floor) * (s / s.sum())
        return p / p.sum()

    def next_batch(self, state):
        b, l, m = state.batch_size, state.l, state.m
        p = self._probs(state)
        j = int(_step_rng(state.seed, state.step).choice(m, p=p))
        start = j * b
        idx = (start + np.arange(b, dtype=np.int64)) % l
        weight = 1.0 / (m * float(p[j]))
        return (BatchIndices(idx, start, j, weight),
                dataclasses.replace(state, step=state.step + 1))

    def observe(self, state, batch_stats):
        losses = batch_stats.get("block_losses")
        if losses is None:
            return state
        losses = np.asarray(losses, dtype=np.float64)
        old = state.aux[0]
        if losses.shape != old.shape:
            raise ValueError(
                f"chunk_importance: block_losses shape {losses.shape} != "
                f"(m,) = {old.shape}")
        new = (1.0 - self.ema) * old + self.ema * np.maximum(losses,
                                                             _SCORE_EPS)
        new.setflags(write=False)
        return dataclasses.replace(state, aux=(new,))

    def state_meta(self, state):
        return {"scheme": self.name, "seed": state.seed, "step": state.step,
                "params": self.params(),
                "scores": [float(v) for v in state.aux[0]]}

    def restore(self, meta, l, batch_size):
        st = super().restore(meta, l, batch_size)
        if "scores" in meta:
            scores = np.asarray(meta["scores"], dtype=np.float64)
            if scores.shape != (st.m,):
                raise ValueError(
                    f"chunk_importance: checkpoint carries {scores.shape[0]} "
                    f"block scores but the corpus has m={st.m} blocks")
            scores.setflags(write=False)
            st = dataclasses.replace(st, aux=(scores,))
        return st


@dataclasses.dataclass(frozen=True)
class StochasticBatch(Scheme):
    """Per-step stochastic batch size over a contiguous cursor.

    Each step draws ``b_t`` from a validated distribution on
    ``[ceil(min_frac * b), b]`` (``b`` = ``ExperimentSpec.batch_size``, now
    an upper *bound*) and reads the ``b_t`` rows at the running cursor —
    contiguous, so the access profile stays sequential.  Consumers pad the
    staged buffer to the static ``(b, n)`` shape with zero rows (which
    contribute exactly zero to the data gradient ``X^T dloss``, dense or
    ELL) and ``weight = b / b_t`` re-normalizes the engine's mean-over-``b``
    to a mean over the ``b_t`` real rows.  The cursor rides ``aux`` and the
    checkpoint meta, so resume replays bit-identically.
    """
    name: ClassVar[str] = "stochastic_batch"
    adaptive: ClassVar[bool] = True
    weighted: ClassVar[bool] = True
    min_frac: float = 0.5
    dist: str = "uniform"

    def validate(self, batch_size=None):
        if self.dist != "uniform":
            raise ValueError(
                f"stochastic_batch: unknown dist {self.dist!r} "
                f"(supported: 'uniform')")
        if not 0.0 < self.min_frac <= 1.0:
            raise ValueError(f"stochastic_batch: min_frac must be in (0, 1] "
                             f"(got {self.min_frac})")
        if batch_size is not None and int(np.ceil(
                self.min_frac * batch_size)) < 1:
            raise ValueError("stochastic_batch: empty draw range")

    def _init_aux(self, l, batch_size):
        return (0,)   # cursor: next row to read

    def draw(self, seed: int, step: int, batch_size: int) -> int:
        lo = max(1, int(np.ceil(self.min_frac * batch_size)))
        return int(_step_rng(seed, step).integers(lo, batch_size + 1))

    def next_batch(self, state):
        b, l = state.batch_size, state.l
        b_t = self.draw(state.seed, state.step, b)
        pos = int(state.aux[0])
        idx = (pos + np.arange(b_t, dtype=np.int64)) % l
        bi = BatchIndices(idx, pos, state.batch_in_epoch, b / float(b_t))
        new = dataclasses.replace(state, step=state.step + 1,
                                  aux=((pos + b_t) % l,))
        return bi, new

    def state_meta(self, state):
        return {"scheme": self.name, "seed": state.seed, "step": state.step,
                "params": self.params(), "pos": int(state.aux[0])}

    def restore(self, meta, l, batch_size):
        st = super().restore(meta, l, batch_size)
        if "pos" in meta:
            return dataclasses.replace(st, aux=(int(meta["pos"]),))
        # legacy meta without the cursor: replay the draws (each is a pure
        # function of (seed, step), so this is exact, just O(step))
        pos = 0
        for s in range(st.step):
            pos = (pos + self.draw(st.seed, s, batch_size)) % l
        return dataclasses.replace(st, aux=(pos,))


# ---------------------------------------------------------------------------
# resolution / restore entry points
# ---------------------------------------------------------------------------

REGISTRY: Dict[str, type] = {
    Random.name: Random,
    Cyclic.name: Cyclic,
    Systematic.name: Systematic,
    ChunkImportance.name: ChunkImportance,
    StochasticBatch.name: StochasticBatch,
}

SchemeLike = Union[str, Scheme]


def resolve(scheme: SchemeLike, with_replacement: bool = False) -> Scheme:
    """Legacy string or Scheme instance → the canonical Scheme object.

    Unknown names raise ``ValueError`` (``plan()`` re-raises as
    ``PlanError`` at its boundary).  ``with_replacement`` only applies to
    the string ``"random"`` spelling, mirroring the old ``make_sampler``
    signature."""
    if isinstance(scheme, Scheme):
        return scheme
    if isinstance(scheme, str):
        cls = REGISTRY.get(scheme)
        if cls is None:
            raise ValueError(
                f"unknown sampling scheme {scheme!r}; want one of "
                f"{tuple(REGISTRY)} or a Scheme instance")
        if cls is Random:
            return Random(with_replacement=with_replacement)
        return cls()
    raise ValueError(
        f"scheme must be a string or a Scheme instance (got "
        f"{type(scheme).__name__})")


def scheme_name(scheme: SchemeLike) -> str:
    """Canonical name for a string-or-Scheme spec field."""
    return scheme.name if isinstance(scheme, Scheme) else str(scheme)


def from_meta(meta: Dict) -> Scheme:
    """Rebuild the Scheme object named by a checkpoint / fingerprint dict
    (``{"scheme": name, "params": {...}}``; params optional for the uniform
    schemes)."""
    name = meta["scheme"]
    cls = REGISTRY.get(name)
    if cls is None:
        raise ValueError(f"unknown sampling scheme {name!r} in metadata")
    return cls(**meta.get("params", {}) or {})


def restore_state(meta: Dict, l: int, batch_size: int) -> SchemeState:
    """The single restore-from-meta entry point: resolve the scheme from the
    metadata, then rebuild its bound state.  Replaces the historical
    ``samplers.restore`` / ``samplers.restore_from_meta`` pair."""
    return from_meta(meta).restore(meta, l, batch_size)
