"""Core of the port: the ERM problem, the sampling schemes, the step rules,
the five solvers and the planner/executor (:mod:`repro_torch.core.experiment`,
re-exported as :mod:`repro_torch.api`)."""
