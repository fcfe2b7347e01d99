from .metrics import MetricsLogger, StepTimer  # noqa: F401
