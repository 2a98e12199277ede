"""Model stack of the port (counterpart of ``repro.models``): the dense
family's layers, the flash forward pass and the model builder."""
