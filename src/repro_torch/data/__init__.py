"""Training data (counterpart of ``repro.data``)."""
