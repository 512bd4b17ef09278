"""Backend selection: the one place that decides between the hand-written
SGM kernel and the XLA formulation.

SGM has two implementations with identical results: the ``lax.scan``
formulation (ops/aggregation.py — the semantic oracle, runs anywhere) and
the Hopper CUDA kernel (ops/sgm_cuda.cu, called through the XLA FFI; NVIDIA
GPUs of compute capability 9.x only).  ``"auto"`` takes the kernel on a
Hopper GPU and XLA elsewhere; on a Hopper GPU that cannot build the
kernel (no nvcc) it raises rather than swap in the far slower scans, and
an explicit ``"cuda"`` on a device that cannot run it raises — there is
no interpreted fallback.  ``"xla"`` is the way to ask for the scans.
"""

from __future__ import annotations

import jax

BACKENDS = ("auto", "cuda", "xla")


def kernel_supported(device=None) -> bool:
    """Whether ``device`` (default: JAX's first device) runs the kernel:
    an NVIDIA GPU of compute capability 9.x.  Raises on such a GPU when
    the kernel library is neither built nor buildable (JAX's pip wheels
    bring CUDA runtime libraries but no nvcc)."""
    device = jax.devices()[0] if device is None else device
    capability = str(getattr(device, "compute_capability", ""))
    if device.platform != "gpu" or capability.split(".")[0] != "9":
        return False
    from ..ops.sgm_cuda import buildable
    if not buildable():
        raise RuntimeError(
            "Hopper GPU found but no nvcc to build the SGM kernel (set "
            "CUDA_HOME); pass backend='xla' to run the XLA scans instead")
    return True


def resolve_backend(backend: str) -> str:
    """Resolve ``backend`` to ``"cuda"`` or ``"xla"``.

    ``"auto"`` is ``"cuda"`` on a Hopper GPU and ``"xla"`` elsewhere;
    ``"xla"`` always passes; ``"cuda"`` raises unless the default device
    runs the kernel; anything else raises, and so does a non-``"xla"``
    request on a Hopper GPU without nvcc (:func:`kernel_supported`).
    """
    if backend not in BACKENDS:
        raise ValueError(f"unknown backend {backend!r}; expected one of "
                         f"{BACKENDS}")
    if backend == "xla":
        return backend
    if backend == "auto":
        return "cuda" if kernel_supported() else "xla"
    if not kernel_supported():
        device = jax.devices()[0]
        raise RuntimeError(
            "backend='cuda' needs an NVIDIA GPU of compute capability 9.x "
            f"(Hopper) and nvcc; the default device is {device.platform} "
            f"{device.device_kind!r}")
    return backend


def sgm_scan_fn(backend: str):
    """The per-direction SGM sweep with the carry contract of
    ``ops.aggregation.sgm_scan_with_carry`` for a resolved backend."""
    if backend == "cuda":
        from ..ops.sgm_cuda import sgm_scan_with_carry
    else:
        from ..ops.aggregation import sgm_scan_with_carry
    return sgm_scan_with_carry


def semiglobal_fn(backend: str):
    """The 8-direction SGM aggregation for a resolved backend."""
    if backend == "cuda":
        from ..ops.sgm_cuda import semiglobal_aggregate_cuda
        return semiglobal_aggregate_cuda
    from ..ops.aggregation import semiglobal_aggregate
    return semiglobal_aggregate
