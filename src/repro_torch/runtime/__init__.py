"""Step builders of the port (counterpart of ``repro.runtime``): the
serving steps. The training step belongs to a later slice."""
