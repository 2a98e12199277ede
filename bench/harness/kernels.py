"""Device operations by kind, from their names in the profiler's trace:
the port's attention kernels, the library's matrix products, and the rest
(elementwise passes, reductions, casts, copies, sorts, scatters)."""

from __future__ import annotations

# The port's hand-written attention kernels (kernels/csrc/flash_attention.cu,
# flash_attention_bwd.cu): the name's start, and the kernel it is.
_ATTENTION = (("flash_fwd", "fwd"), ("flash_bwd_delta", "delta"),
              ("flash_bwd_dkdv", "dkdv"), ("flash_bwd_dq", "dq"))

# cuBLAS / cuBLASLt product kernels on Hopper and earlier parts.
_GEMM_MARKS = ("gemm", "nvjet", "gemv", "xmma", "cutlass", "cublas", "s16816", "wgmma")


def _bare(name: str) -> str:
    """The kernel's own name: return type, namespaces and template and
    call arguments dropped."""
    name = name.removeprefix("void ").replace("(anonymous namespace)::", "")
    return name.split("<", 1)[0].split("(", 1)[0].strip().rsplit("::", 1)[-1]


def attention_kind(name: str) -> str | None:
    """"fwd", "delta", "dkdv" or "dq" for a port attention kernel, else None."""
    bare = _bare(name)
    for prefix, kind in _ATTENTION:
        if bare.startswith(prefix):
            return kind
    return None


def kind(name: str) -> str:
    """"attention", "gemm" or "other"."""
    if attention_kind(name) is not None:
        return "attention"
    low = name.lower()
    if any(m in low for m in _GEMM_MARKS):
        return "gemm"
    return "other"
