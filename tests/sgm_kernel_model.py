"""Numpy model of the Hopper SGM kernel (stereomatch_tpu/ops/sgm_cuda.cu).

A CUDA kernel has no interpret mode, so its algorithm is modelled here step
for step and checked on the CPU against the XLA formulation
(ops/aggregation.py): the same line enumeration (every path enters through
the first scan row or, for diagonals, through the side edge the carry
shift exposes), the same address mapping (scan along axis 0 or, with
``transpose``, axis 1; ``flip_s`` / ``flip_n`` reverse the scan and path
axes), the same per-step arithmetic in the same association, and
accumulation in ``sgm_cuda.DIRECTIONS`` order.  Lines are independent, so
the model walks all lines of one direction in lockstep.
"""

import numpy as np

from stereomatch_tpu.ops.sgm_cuda import DIRECTIONS


def line_starts(steps: int, paths: int, shift: int):
    """(t0, n0, length) of the kernel's lines over an [S, N] grid."""
    if shift == 0:
        return (np.zeros(paths, np.int64), np.arange(paths),
                np.full(paths, steps))
    i = np.arange(paths + steps - 1)
    t0 = np.where(i < paths, 0, i - paths + 1)
    n0 = np.where(i < paths, i, 0 if shift > 0 else paths - 1)
    room = paths - n0 if shift > 0 else n0 + 1
    return t0, n0, np.minimum(steps - t0, room)


def visit_counts(steps: int, paths: int, shift: int) -> np.ndarray:
    """How often the lines visit each (step, path) cell."""
    counts = np.zeros((steps, paths), np.int64)
    for t0, n0, length in zip(*line_starts(steps, paths, shift)):
        k = np.arange(length)
        np.add.at(counts, (t0 + k, n0 + shift * k), 1)
    return counts


def sweep(cost, image, penalty1, penalty2, *, transpose=False,
          flip_s=False, flip_n=False, shift=0, init_prev=None,
          init_int=None, seed_first=True):
    """One traversal; returns (contributions like ``cost``, final_prev)."""
    c = np.asarray(cost, np.float32)
    img = np.asarray(image, np.float32)
    if transpose:
        c, img = c.transpose(1, 0, 2), img.T
    steps, paths, d = c.shape
    t0, n0, length = line_starts(steps, paths, shift)
    n_lines = len(t0)
    p1, p2 = np.float32(penalty1), np.float32(penalty2)
    inf = np.float32(np.inf)

    prev = np.full((n_lines, d), inf, np.float32)
    prev_int = np.zeros(n_lines, np.float32)
    start = np.ones(n_lines, bool)
    if not seed_first:
        pn = n0 - shift
        ok = (t0 == 0) & (pn >= 0) & (pn < paths)
        prev[ok] = np.asarray(init_prev, np.float32)[pn[ok]]
        prev_int[ok] = np.asarray(init_int, np.float32)[pn[ok]]
        start[ok] = False

    out = np.zeros_like(c)
    for k in range(steps):
        act = k < length
        t = t0[act] + k
        n = n0[act] + shift * k
        ts = steps - 1 - t if flip_s else t
        ns = paths - 1 - n if flip_n else n
        cst, im = c[ts, ns], img[ts, ns]
        pv, pi = prev[act], prev_int[act]
        with np.errstate(divide="ignore", invalid="ignore"):
            m = pv.min(axis=1, keepdims=True)
            p2a = np.maximum(p1, p2 / np.abs(im - pi))[:, None]
            pnorm = pv - m
            edge = np.full((len(pv), 1), inf, np.float32)
            up = np.concatenate([edge, pnorm[:, :-1]], axis=1)
            down = np.concatenate([pnorm[:, 1:], edge], axis=1)
            band = np.minimum(np.minimum(pnorm, up + p1),
                              np.minimum(down + p1, p2a))
            new = np.where(start[act][:, None], cst, cst + band)
        out[ts, ns] = new
        prev[act] = new
        prev_int[act] = im
        start[act] = False

    final = np.full((paths, d), np.nan, np.float32)
    ends = t0 + length == steps
    final[(n0 + shift * (length - 1))[ends]] = prev[ends]
    if transpose:
        out = out.transpose(1, 0, 2)
    return out, final


def aggregate(cost, image, penalty1=0.1, penalty2=0.2):
    """The kernel's 8-direction aggregation (f32 accumulator, narrowed to
    the volume's dtype as ``semiglobal_aggregate_cuda`` does)."""
    acc = None
    for transpose, flip_s, flip_n, shift in DIRECTIONS:
        out, _ = sweep(cost, image, penalty1, penalty2, transpose=transpose,
                       flip_s=flip_s, flip_n=flip_n, shift=shift)
        acc = out if acc is None else acc + out
    return acc


def xla_sweep(cost, image, *, penalty1, penalty2, carry_shift=0,
              transpose=False, flip_s=False, flip_n=False, acc=None,
              init_prev=None, init_int=None, seed_first=True):
    """``ops.sgm_cuda.sweep``'s contract on the XLA scan, for running the
    kernel branches of the callers (sharded, tiled, streamed) on the CPU."""
    import jax
    import jax.numpy as jnp
    from jax import lax

    from stereomatch_tpu.ops.aggregation import sgm_scan_with_carry

    v = cost.astype(jnp.float32)
    im = image.astype(jnp.float32)
    if transpose:
        v, im = jnp.swapaxes(v, 0, 1), im.T
    if flip_s:
        v, im = v[::-1], im[::-1]
    if flip_n:
        v, im = v[:, ::-1], im[:, ::-1]
    if init_prev is None:
        init_prev = jnp.full(v.shape[1:], jnp.inf, jnp.float32)
        init_int = jnp.zeros(v.shape[1:2], jnp.float32)
    def varying(x):            # the scan carry must vary like the volume
        missing = tuple(set(getattr(jax.typeof(v), "vma", ()))
                        - set(getattr(jax.typeof(x), "vma", ())))
        return lax.pcast(x, missing, to="varying") if missing else x
    init_prev, init_int = varying(init_prev), varying(init_int)
    (final, _), out = sgm_scan_with_carry(
        v, im, penalty1, penalty2, carry_shift,
        init_carry=(init_prev, init_int), seed_first=seed_first)
    if flip_n:
        out = out[:, ::-1]
    if flip_s:
        out = out[::-1]
    if transpose:
        out = jnp.swapaxes(out, 0, 1)
    return (out if acc is None else acc + out), final


def xla_aggregate(cost_volume, left_image, *, penalty1=0.1, penalty2=0.2):
    """``semiglobal_aggregate_cuda`` over :func:`xla_sweep`."""
    out = None
    for transpose, flip_s, flip_n, shift in DIRECTIONS:
        out, _ = xla_sweep(cost_volume, left_image, penalty1=penalty1,
                           penalty2=penalty2, carry_shift=shift,
                           transpose=transpose, flip_s=flip_s,
                           flip_n=flip_n, acc=out)
    return out.astype(cost_volume.dtype)


def substitute_kernel(monkeypatch):
    """Route every ``backend="cuda"`` call through :func:`xla_sweep`."""
    from stereomatch_tpu.ops import sgm_cuda
    from stereomatch_tpu.utils import backend

    monkeypatch.setattr(backend, "kernel_supported",
                        lambda device=None: True)
    monkeypatch.setattr(sgm_cuda, "sweep", xla_sweep)
    monkeypatch.setattr(sgm_cuda, "semiglobal_aggregate_cuda", xla_aggregate)
