"""Training: the step and the restart-safe loop (twin of ``repro.train``)."""
