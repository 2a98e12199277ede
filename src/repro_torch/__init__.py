"""PyTorch / CUDA port of the ``repro`` package: the scheduling engine and
the serving path of the model stack.

Laid out like the JAX package (``core/``, ``kernels/``, ``online/``,
``obs/``, ``configs/``, ``models/``, ``runtime/``, ``launch/``) and held
against it: bit for bit for the scheduler, within the reference's own
tolerances for attention and the models. Entry points take
``device=None`` (the CUDA card); a CPU run must be asked for with
``device="cpu"``.
"""
