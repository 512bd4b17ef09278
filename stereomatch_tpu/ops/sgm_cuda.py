"""Hopper SGM kernel: build, registration and JAX-facing wrappers.

The kernel (``sgm_cuda.cu``, CUDA C++ for ``sm_90a``) runs one SGM path
direction per launch with one warp per path; see the source's header for
the design.  This module compiles it with ``nvcc`` into
``stereomatch_tpu/ops/_build/`` (git-ignored) on first use — or ahead of
time with ``python -m stereomatch_tpu.ops.sgm_cuda`` — registers it with
the XLA FFI and exposes:

* :func:`sgm_scan_with_carry` — the contract of
  ``ops/aggregation.py::sgm_scan_with_carry`` (scan-major input,
  ``carry_shift``, ``init_carry``, ``seed_first``), which the sharded exact
  and overlap paths call per tile;
* :func:`semiglobal_aggregate_cuda` — the 8-direction aggregation of
  ``ops/aggregation.py::semiglobal_aggregate``, accumulated in the same
  direction order so the two agree to the last ulp.

The kernel exists only for NVIDIA GPUs of compute capability 9.x; the
choice between it and the XLA scans is ``utils/backend.py``'s.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

_SRC = Path(__file__).with_name("sgm_cuda.cu")
BUILD_DIR = Path(__file__).resolve().parent / "_build"
_ARCH = "arch=compute_90a,code=sm_90a"
MAX_DISPARITY = 1024          # 32 lanes x 32 values per lane

# (transpose, flip_s, flip_n, carry_shift) of the eight traversals, in the
# accumulation order of ops/aggregation.py::semiglobal_aggregate:
# horizontal fwd/rev (scan along W), vertical fwd/rev, diagonal (1, 1)
# fwd/rev, diagonal (-1, 1) fwd/rev (reverse diagonals = 180-degree turn).
DIRECTIONS = (
    (True, False, False, 0), (True, True, False, 0),
    (False, False, False, 0), (False, True, False, 0),
    (False, False, False, 1), (False, True, True, 1),
    (False, False, False, -1), (False, True, True, -1),
)


def _find_nvcc():
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in ([Path(home) / "bin" / "nvcc"] if home else []) + [
            Path("/usr/local/cuda/bin/nvcc")]:
        if cand.exists():
            return str(cand)
    return shutil.which("nvcc")


def _nvcc() -> str:
    found = _find_nvcc()
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the Hopper SGM "
                           "kernel is compiled from ops/sgm_cuda.cu at "
                           "first use")
    return found


def buildable() -> bool:
    """Whether the library is built or can be (a CUDA toolkit is found)."""
    return library_path().exists() or _find_nvcc() is not None


def _compile_command(out: Path) -> list:
    return [_nvcc(), "-gencode", _ARCH, "-std=c++17", "-O3", "-shared",
            "-Xcompiler", "-fPIC", "-I", jax.ffi.include_dir(),
            "-o", str(out), str(_SRC)]


def library_path() -> Path:
    """Where the library for the current source and flags lives: the name
    carries a hash of both, so an edited source never loads a stale build."""
    key = hashlib.sha256(_SRC.read_bytes() + _ARCH.encode()
                         + jax.ffi.include_dir().encode()).hexdigest()[:16]
    return BUILD_DIR / f"libstm_sgm_{key}.so"


def build() -> Path:
    """Compile the kernel library if it is missing; return its path.

    Concurrent builders (test workers, a CLI beside a benchmark) serialise
    on a lock file and the finished library is renamed into place, so no
    process ever loads a partial file.
    """
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        partial = so.with_name(so.name + ".partial")
        proc = subprocess.run(_compile_command(partial), capture_output=True,
                              text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {_SRC.name}:\n"
                               f"{proc.stderr[-4000:]}")
        os.replace(partial, so)
    return so


@functools.cache
def _register() -> None:
    lib = ctypes.cdll.LoadLibrary(str(build()))
    for name, symbol in (("stm_sgm_sweep", lib.StmSgmSweep),
                         ("stm_sgm_sweep_acc", lib.StmSgmSweepAcc)):
        jax.ffi.register_ffi_target(name, jax.ffi.pycapsule(symbol),
                                    platform="CUDA")


def _result(shape, operands):
    """Result type of the FFI call.  Under shard_map the results vary over
    every mesh axis an operand varies over, which keeps shard_map's type
    check on for the kernel path."""
    vma = frozenset()
    for x in operands:
        vma |= getattr(jax.typeof(x), "vma", frozenset())
    if not vma:
        return jax.ShapeDtypeStruct(shape, jnp.float32)
    sharding = jax.sharding.NamedSharding(jax.sharding.get_abstract_mesh(),
                                          jax.sharding.PartitionSpec())
    return jax.ShapeDtypeStruct(shape, jnp.float32, sharding=sharding,
                                vma=vma)


def sweep(cost, image, *, penalty1, penalty2, carry_shift=0,
          transpose=False, flip_s=False, flip_n=False, acc=None,
          init_prev=None, init_int=None, seed_first=True):
    """One SGM traversal of ``cost`` [A, B, D] with guide ``image`` [A, B].

    The scan runs along axis 0 (or axis 1 with ``transpose``), backwards
    along the scan axis with ``flip_s`` and along the path axis with
    ``flip_n``.  Returns ``(out, final_prev)``: ``out`` [A, B, D] f32 holds
    this traversal's path costs, plus ``acc`` when given (``acc`` is
    updated in place); ``final_prev`` [N, D] is the carry after the last
    scan step.  ``init_prev`` [N, D] / ``init_int`` [N] continue paths
    from a preceding chunk when ``seed_first`` is false (a traced bool is
    accepted).
    """
    _register()
    if cost.dtype not in (jnp.float32, jnp.bfloat16):
        cost = cost.astype(jnp.float32)
    image = image.astype(jnp.float32)
    rows, cols, d = cost.shape[-3:]
    if d > MAX_DISPARITY:
        raise ValueError(f"the CUDA SGM kernel handles at most "
                         f"{MAX_DISPARITY} disparities; got {d}")
    n = rows if transpose else cols
    if init_prev is None:
        init_prev = jnp.full((n, d), jnp.inf, jnp.float32)
        init_int = jnp.zeros((n,), jnp.float32)
    init_prev = init_prev.astype(jnp.float32)
    init_int = init_int.astype(jnp.float32)
    seed = jnp.asarray(seed_first).astype(jnp.int32).reshape(1)
    args = [cost, image, init_prev, init_int, seed]
    if acc is not None:
        args.append(acc)
    results = (_result(cost.shape, args), _result((n, d), args))
    attrs = dict(transpose=np.int32(transpose), flip_s=np.int32(flip_s),
                 flip_n=np.int32(flip_n), shift=np.int32(carry_shift),
                 p1=np.float32(penalty1), p2=np.float32(penalty2))
    if acc is None:
        call = jax.ffi.ffi_call("stm_sgm_sweep", results,
                                vmap_method="expand_dims")
    else:
        call = jax.ffi.ffi_call("stm_sgm_sweep_acc", results,
                                vmap_method="expand_dims",
                                input_output_aliases={5: 0})
    out, final_prev = call(*args, **attrs)
    return out, final_prev


def sgm_scan_with_carry(cost_sv, image_sv, penalty1, penalty2, carry_shift,
                        init_carry=None, seed_first=True):
    """Kernel counterpart of ``ops.aggregation.sgm_scan_with_carry``: same
    arguments, same ``((final_prev, final_intensity), contributions)``."""
    init_prev, init_int = (None, None) if init_carry is None else init_carry
    out, final_prev = sweep(cost_sv, image_sv, penalty1=penalty1,
                            penalty2=penalty2, carry_shift=carry_shift,
                            init_prev=init_prev, init_int=init_int,
                            seed_first=seed_first)
    return (final_prev, image_sv[-1].astype(jnp.float32)), out


@functools.partial(jax.jit, static_argnames=("penalty1", "penalty2"))
def semiglobal_aggregate_cuda(cost_volume, left_image, *,
                              penalty1: float = 0.1,
                              penalty2: float = 0.2):
    """8-direction SGM of an [H, W, D] volume on the Hopper kernel.

    Same result as ``ops.aggregation.semiglobal_aggregate``: every
    traversal adds into one f32 accumulator in that function's order,
    then the sum is narrowed to the volume's dtype.
    """
    out = None
    for transpose, flip_s, flip_n, shift in DIRECTIONS:
        out, _ = sweep(cost_volume, left_image, penalty1=penalty1,
                       penalty2=penalty2, carry_shift=shift,
                       transpose=transpose, flip_s=flip_s, flip_n=flip_n,
                       acc=out)
    return out.astype(cost_volume.dtype)


if __name__ == "__main__":
    print(build())
