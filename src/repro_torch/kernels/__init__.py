"""Hand-written CUDA kernels of the port (``csrc/``), their build
(:mod:`.build`), wrappers (:mod:`.cpm`, :mod:`.stage2`, :mod:`.attention`,
:mod:`.moe_dispatch`, :mod:`.selective_scan`, :mod:`.ops`) and plain
PyTorch versions (:mod:`.ref`)."""
