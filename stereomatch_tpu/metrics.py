"""Disparity quality metrics.

Replacement for the reference's dependency on
``stereomideval.eval.Metric`` in its Flyte workflow
(workflows/evaluation/workflow.py:96-98): RMSE, average absolute error and
bad-pixel percentage, each masked to valid ground-truth pixels.
"""

from __future__ import annotations

import functools
from typing import Dict

import jax
import jax.numpy as jnp


def _valid_mask(gt_disparity: jnp.ndarray) -> jnp.ndarray:
    """Valid ground truth: finite and strictly positive (Middlebury PFMs use
    inf/0 for unknown pixels)."""
    gt = gt_disparity.astype(jnp.float32)
    return jnp.logical_and(jnp.isfinite(gt), gt > 0)


@jax.jit
def rmse(predicted: jnp.ndarray, gt_disparity: jnp.ndarray) -> jnp.ndarray:
    mask = _valid_mask(gt_disparity)
    diff = predicted.astype(jnp.float32) - gt_disparity.astype(jnp.float32)
    sq = jnp.where(mask, diff * diff, 0.0)
    return jnp.sqrt(jnp.sum(sq) / jnp.maximum(jnp.sum(mask), 1))


@jax.jit
def avg_abs_error(predicted: jnp.ndarray,
                  gt_disparity: jnp.ndarray) -> jnp.ndarray:
    mask = _valid_mask(gt_disparity)
    diff = jnp.abs(predicted.astype(jnp.float32)
                   - gt_disparity.astype(jnp.float32))
    return jnp.sum(jnp.where(mask, diff, 0.0)) / jnp.maximum(jnp.sum(mask), 1)


@functools.partial(jax.jit, static_argnames=("threshold",))
def bad_pixel_ratio(predicted: jnp.ndarray, gt_disparity: jnp.ndarray,
                    threshold: float = 2.0) -> jnp.ndarray:
    """Fraction of valid pixels whose |error| exceeds ``threshold`` (the
    Middlebury "bad2.0"-style metric)."""
    mask = _valid_mask(gt_disparity)
    diff = jnp.abs(predicted.astype(jnp.float32)
                   - gt_disparity.astype(jnp.float32))
    bad = jnp.logical_and(mask, diff > threshold)
    return jnp.sum(bad) / jnp.maximum(jnp.sum(mask), 1)


def evaluate(predicted, gt_disparity, threshold: float = 2.0) -> Dict[str, float]:
    """All metrics as Python floats (workflow.py:96-103 equivalent)."""
    return {
        "rmse": float(rmse(predicted, gt_disparity)),
        "avg_abs_error": float(avg_abs_error(predicted, gt_disparity)),
        "bad_pixel_ratio": float(bad_pixel_ratio(predicted, gt_disparity,
                                                 threshold=threshold)),
    }


def sparsification_curve(predicted, gt_disparity, confidence,
                         threshold: float = 2.0, steps: int = 20):
    """Bad-pixel ratio of the kept pixels as the least-confident fraction
    is removed (the standard stereo-confidence quality diagnostic).

    Host-side numpy (sorting-based, evaluation-time only).  Returns
    ``(fractions_removed, curve, oracle_curve)`` — ``curve[i]`` is the
    bad-pixel ratio after dropping ``fractions_removed[i]`` of the valid
    pixels in ascending-confidence order; ``oracle_curve`` drops them in
    descending-|error| order (the best any confidence could do).
    """
    import numpy as np

    pred = np.asarray(predicted, np.float32)
    gt = np.asarray(gt_disparity, np.float32)
    conf = np.asarray(confidence, np.float32)
    mask = np.isfinite(gt) & (gt > 0)
    err = np.abs(pred - gt)[mask]
    bad = (err > threshold).astype(np.float64)
    conf = conf[mask]
    n = bad.size
    if n == 0:
        flat = np.zeros(steps + 1)
        return np.linspace(0.0, 1.0, steps + 1), flat, flat

    # Most-confident-first prefix means the *suffix* is what gets removed.
    by_conf = np.cumsum(bad[np.argsort(-conf, kind="stable")])
    by_err = np.cumsum(bad[np.argsort(err, kind="stable")])
    fractions = np.linspace(0.0, 1.0, steps + 1)
    keep = np.maximum((n * (1.0 - fractions)).astype(np.int64), 1)
    curve = by_conf[keep - 1] / keep
    oracle = by_err[keep - 1] / keep
    return fractions, curve, oracle


def sparsification_ause(predicted, gt_disparity, confidence,
                        threshold: float = 2.0, steps: int = 20) -> float:
    """Area Under the Sparsification Error curve: mean gap between the
    confidence-ordered and oracle-ordered curves, in bad-pixel-ratio
    units.  0 = the confidence ranks pixels as well as knowing the true
    error; the gap to a *random* ranking is the overall bad-pixel ratio
    itself, so AUSE is read against that scale.
    """
    import numpy as np
    _, curve, oracle = sparsification_curve(predicted, gt_disparity,
                                            confidence, threshold=threshold,
                                            steps=steps)
    return float(np.mean(curve - oracle))


def metrics_markdown_table(rows) -> str:
    """Render per-config metric rows as a markdown table, like the
    reference's join_metrics task (workflow.py:108-121).

    Args:
        rows: iterable of dicts with keys name/rmse/avg_abs_error/
          bad_pixel_ratio and optionally ause (adds a column when any
          row carries it).
    """
    with_ause = any("ause" in row for row in rows)
    header = "| config | rmse | avg abs err | bad pixel % |"
    rule = "|---|---|---|---|"
    if with_ause:
        header += " AUSE |"
        rule += "---|"
    lines = [header, rule]
    for row in rows:
        line = (f"| {row['name']} | {row['rmse']:.4f} | "
                f"{row['avg_abs_error']:.4f} | "
                f"{row['bad_pixel_ratio'] * 100:.2f} |")
        if with_ause:
            line += (f" {row['ause']:.4f} |" if "ause" in row else " — |")
        lines.append(line)
    return "\n".join(lines)
