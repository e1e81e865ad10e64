"""repro_torch.api — the import surface of the port.

Declare an :class:`ExperimentSpec`, lower it with :func:`plan` (on the card
by default, ``device="cpu"`` on request), run it with :func:`execute`:

    from repro_torch.api import DataSource, ExperimentSpec, execute, plan

    spec = ExperimentSpec(data=DataSource.corpus("corpus.bin"),
                          solver="saga", scheme="systematic", epochs=5)
    result = execute(plan(spec))
    print(result.objective, result.breakdown())

Only what the port has is exported; see ``ROADMAP.md`` for the rest of the
reference's ``repro.api``.
"""
from .core.experiment import (  # noqa: F401
    ARRAYS, AUTO, BACKENDS, CSR, DENSE, EAGER, FUSED, GATHER, PSUM, RESIDENT,
    RESIDENT_EAGER, RESIDENT_FUSED, STREAMED, STREAMED_EAGER, DataSource,
    ExecutionPlan, ExperimentSpec, PlanError, RunResult, execute, plan,
    resume_from, run_experiment)
from .core.erm import LOSSES  # noqa: F401
from .core.samplers import CYCLIC, RANDOM, SCHEMES, SYSTEMATIC  # noqa: F401
from .core.schemes import Cyclic, Random, Scheme, Systematic  # noqa: F401
from .core.solvers import CONSTANT, LINE_SEARCH, SOLVERS  # noqa: F401
from .core.step_rules import LS_MODES, SEQUENTIAL, VECTORIZED  # noqa: F401
from .obs import Timeline, TracePolicy, Tracer  # noqa: F401

__all__ = [
    "ARRAYS", "AUTO", "BACKENDS", "CSR", "DENSE", "EAGER", "FUSED", "GATHER",
    "LOSSES", "PSUM", "RESIDENT", "RESIDENT_EAGER", "RESIDENT_FUSED",
    "STREAMED", "STREAMED_EAGER",
    "CYCLIC", "RANDOM", "SCHEMES", "SYSTEMATIC",
    "Cyclic", "Random", "Scheme", "Systematic",
    "CONSTANT", "LINE_SEARCH", "SOLVERS",
    "LS_MODES", "SEQUENTIAL", "VECTORIZED",
    "DataSource", "ExecutionPlan", "ExperimentSpec", "PlanError",
    "RunResult", "Timeline", "TracePolicy", "Tracer",
    "execute", "plan", "resume_from", "run_experiment",
]
