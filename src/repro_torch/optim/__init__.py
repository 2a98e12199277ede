"""Optimizer and gradient utilities (counterpart of ``repro.optim``)."""
