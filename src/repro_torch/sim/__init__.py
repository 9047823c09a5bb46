"""The trace-driven simulator plane: the port's copy of ``repro/sim``."""
