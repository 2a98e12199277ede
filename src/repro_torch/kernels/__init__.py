"""Hand-written CUDA kernels of the port (``csrc/``), their build
(:mod:`.build`), wrappers (:mod:`.cpm`, :mod:`.attention`, :mod:`.ops`)
and plain PyTorch versions (:mod:`.ref`)."""
