"""PyTorch / CUDA port of the ``repro`` scheduling engine.

Laid out like the JAX package (``core/``, ``kernels/``, ``online/``,
``obs/``) and held against it bit for bit. Entry points take
``device=None`` (the CUDA card); a CPU run must be asked for with
``device="cpu"``.
"""
