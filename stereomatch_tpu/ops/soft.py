"""Differentiable SGM surface: gradient-safe aggregation + soft-argmin.

Beyond the reference's capability surface — its README states "The
operations aren't differentiable" (/root/reference/README.md:25).  Under
JAX the scan-based SGM formulation *is* differentiable almost everywhere
(min/max carry subgradients), which turns the SGM penalties into tunable
parameters: see ``stereomatch_tpu.tune``.

Two details make the stock formulation (ops/aggregation.py) unsafe to
differentiate, both classic where/inf cotangent traps:

* Path starts seed via ``jnp.where(start, cost, sgm)`` with an all-+inf
  initial carry, so the discarded ``sgm`` branch is NaN (inf - inf in the
  normalization) — and ``0 * NaN = NaN`` poisons the backward pass.
  Here the carry seeds *uniform zero* instead: after normalization
  (prev - min) the band is ``min(0, up + P1, down + P1, P2_adj) = 0``
  (every candidate is >= 0), so the first step emits exactly ``cost`` —
  bit-identical to the reference's explicit re-seed
  (semiglobal.cpp:121-127) with no data-dependent select at all.
* The adaptive penalty ``P2_adj = P2 / |dI|`` divides by zero on flat
  image regions (intentional in the forward pass: +inf drops the term,
  matching the C++ float division, semiglobal.cpp:137-138).  Its VJP is
  ``cotangent / |dI|`` — ``0 * inf = NaN`` even though the +inf candidate
  is never selected.  Here the gradient magnitude is floored at a
  denormal-scale epsilon: ``P2 / max(|dI|, 1e-30)`` saturates around
  1e30, far above any selectable band candidate, so the forward result
  is unchanged while the backward pass stays finite.

``semiglobal_aggregate_diff`` is verified bit-identical to
``semiglobal_aggregate`` in tests/test_tune.py.
"""

from __future__ import annotations

import jax
import numpy as np

import jax.numpy as jnp
from jax import lax

# np.float32, not jnp.float32: keep module import free of device-array
# construction (tests/test_import_hygiene.py).
_GRAD_EPS = np.float32(1e-30)


def _diff_scan(cost_sv, image_sv, p1, p2, carry_shift):
    """One gradient-safe SGM sweep over scan-major [S, N, D] inputs."""
    n = cost_sv.shape[1]
    p1 = jnp.asarray(p1, jnp.float32)
    p2 = jnp.asarray(p2, jnp.float32)

    if carry_shift == 0:
        edge_start = jnp.zeros((n, 1), bool)
    elif carry_shift > 0:
        edge_start = (lax.broadcasted_iota(jnp.int32, (n, 1), 0) == 0)
    else:
        edge_start = (lax.broadcasted_iota(jnp.int32, (n, 1), 0) == n - 1)

    def shift_n(arr, fill):
        if carry_shift == 0:
            return arr
        shifted = jnp.roll(arr, carry_shift, axis=0)
        return jnp.where(edge_start if arr.ndim == 2 else edge_start[:, 0],
                         fill, shifted)

    def step(carry, inputs):
        prev, prev_int = carry            # [N, D], [N]
        cost, intensity = inputs

        # Zero fill at the diagonal edge column: a uniform row normalizes
        # to band = 0, i.e. the fresh-path re-seed, without a select.
        prev = shift_n(prev, jnp.float32(0))
        prev_int = shift_n(prev_int, jnp.float32(0))

        prev_min = jnp.min(prev, axis=-1, keepdims=True)            # [N, 1]
        grad = jnp.abs(intensity - prev_int)                         # [N]
        p2_adj = jnp.maximum(p1, p2 / jnp.maximum(grad, _GRAD_EPS))[:, None]

        # Identical association to sgm_scan_with_carry (normalized band).
        prevn = prev - prev_min
        inf = jnp.float32(jnp.inf)
        up = jnp.concatenate([jnp.full_like(prevn[:, :1], inf),
                              prevn[:, :-1]], axis=1)                # d-1
        down = jnp.concatenate([prevn[:, 1:],
                                jnp.full_like(prevn[:, :1], inf)], axis=1)

        band = jnp.minimum(jnp.minimum(prevn, up + p1),
                           jnp.minimum(down + p1, p2_adj))
        new_prev = cost + band
        return (new_prev, intensity), new_prev

    init = (jnp.zeros(cost_sv.shape[1:], jnp.float32),
            jnp.zeros((n,), jnp.float32))
    _, contributions = lax.scan(step, init, (cost_sv, image_sv))
    return contributions


def _sweep_h(cost, image, p1, p2, reverse):
    vol, img = jnp.swapaxes(cost, 0, 1), jnp.swapaxes(image, 0, 1)
    if reverse:
        vol, img = vol[::-1], img[::-1]
    out = _diff_scan(vol, img, p1, p2, 0)
    if reverse:
        out = out[::-1]
    return jnp.swapaxes(out, 0, 1)


def _sweep_v(cost, image, p1, p2, reverse):
    vol, img = (cost[::-1], image[::-1]) if reverse else (cost, image)
    out = _diff_scan(vol, img, p1, p2, 0)
    return out[::-1] if reverse else out


def _sweep_d(cost, image, p1, p2, down_right, reverse):
    vol, img = cost, image
    if reverse:
        vol, img = vol[::-1, ::-1], img[::-1, ::-1]
    out = _diff_scan(vol, img, p1, p2, 1 if down_right else -1)
    if reverse:
        out = out[::-1, ::-1]
    return out


@jax.jit
def semiglobal_aggregate_diff(cost_volume: jnp.ndarray,
                              left_image: jnp.ndarray,
                              penalty1, penalty2) -> jnp.ndarray:
    """8-path SGM aggregation, differentiable in (volume, penalties).

    Bit-identical to ``semiglobal_aggregate`` in the forward pass (the
    penalties here are *traced* rather than static, so one compilation
    serves every penalty value — e.g. each optimizer step while tuning).
    """
    cost = cost_volume.astype(jnp.float32)
    image = left_image.astype(jnp.float32)
    out = _sweep_h(cost, image, penalty1, penalty2, False)
    out += _sweep_h(cost, image, penalty1, penalty2, True)
    out += _sweep_v(cost, image, penalty1, penalty2, False)
    out += _sweep_v(cost, image, penalty1, penalty2, True)
    out += _sweep_d(cost, image, penalty1, penalty2, True, False)
    out += _sweep_d(cost, image, penalty1, penalty2, True, True)
    out += _sweep_d(cost, image, penalty1, penalty2, False, False)
    out += _sweep_d(cost, image, penalty1, penalty2, False, True)
    return out.astype(cost_volume.dtype)


@jax.jit
def soft_argmin(volume: jnp.ndarray, tau=1.0) -> jnp.ndarray:
    """Differentiable disparity: softmax(-volume/tau) expectation over D.

    The continuous relaxation of winner-takes-all (argmin).  +inf cells
    (d > column) receive exactly zero weight, so the invalid-disparity
    convention needs no special handling; as ``tau -> 0`` the expectation
    approaches the hard argmin wherever the minimum is unique.
    """
    tau = jnp.asarray(tau, jnp.float32)
    d = jnp.arange(volume.shape[-1], dtype=jnp.float32)
    w = jax.nn.softmax(-volume.astype(jnp.float32) / tau, axis=-1)
    return jnp.sum(w * d, axis=-1)
