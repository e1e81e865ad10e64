"""repro_torch.api — the import surface of the port.

Declare an :class:`ExperimentSpec`, lower it with :func:`plan` (on the card
by default, ``device="cpu"`` on request), run it with :func:`execute`:

    from repro_torch.api import DataSource, ExperimentSpec, execute, plan

    spec = ExperimentSpec(data=DataSource.corpus("corpus.bin"),
                          solver="saga", scheme="systematic", epochs=5)
    result = execute(plan(spec))
    print(result.objective, result.breakdown())

A durable run checkpoints at epoch boundaries and resumes after a crash:

    spec = ExperimentSpec(..., checkpoint=CheckpointPolicy("ckpt", every=1))
    execute(plan(spec))                   # killed part way
    res = resume_from("ckpt")             # plan rebuilt, on the card
    execute(res.plan, resume=res, epochs=spec.epochs - res.epochs_done)

Only what the port has is exported; see ``ROADMAP.md`` for the rest of the
reference's ``repro.api``.
"""
from .checkpoint import (  # noqa: F401
    Checkpointer, CheckpointPolicy, atomic_write_text)
from .core.experiment import (  # noqa: F401
    ARRAYS, AUTO, BACKENDS, CSR, DENSE, EAGER, FUSED, GATHER, PSUM, RESIDENT,
    RESIDENT_EAGER, RESIDENT_FUSED, SPARSE_CSR, STREAMED, STREAMED_EAGER,
    DataSource, ExecutionPlan, ExperimentSpec, PlanError, RunResult, execute,
    plan, resume_from, run_experiment)
from .core.erm import LOSSES  # noqa: F401
from .core.samplers import CYCLIC, RANDOM, SCHEMES, SYSTEMATIC  # noqa: F401
from .core.schemes import (  # noqa: F401
    ChunkImportance, Cyclic, Random, Scheme, StochasticBatch, Systematic)
from .core.solvers import CONSTANT, LINE_SEARCH, SOLVERS  # noqa: F401
from .core.step_rules import LS_MODES, SEQUENTIAL, VECTORIZED  # noqa: F401
from .data.sparse import (  # noqa: F401
    ingest_libsvm, open_csr_corpus, synth_sparse_classification,
    write_csr_corpus)
from .obs import Timeline, TracePolicy, Tracer  # noqa: F401

__all__ = [
    "ARRAYS", "AUTO", "BACKENDS", "CSR", "DENSE", "EAGER", "FUSED", "GATHER",
    "LOSSES", "PSUM", "RESIDENT", "RESIDENT_EAGER", "RESIDENT_FUSED",
    "SPARSE_CSR", "STREAMED", "STREAMED_EAGER",
    "CYCLIC", "RANDOM", "SCHEMES", "SYSTEMATIC",
    "ChunkImportance", "Cyclic", "Random", "Scheme", "StochasticBatch",
    "Systematic", "Checkpointer", "CheckpointPolicy", "atomic_write_text",
    "CONSTANT", "LINE_SEARCH", "SOLVERS",
    "LS_MODES", "SEQUENTIAL", "VECTORIZED",
    "DataSource", "ExecutionPlan", "ExperimentSpec", "PlanError",
    "RunResult", "Timeline", "TracePolicy", "Tracer",
    "execute", "plan", "resume_from", "run_experiment",
    "ingest_libsvm", "open_csr_corpus", "synth_sparse_classification",
    "write_csr_corpus",
]
