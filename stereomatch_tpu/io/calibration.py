"""Stereo rectification via homography pairs, on the device.

The reference's ``StereoRectifier`` (stereomatch/calibration.py:11-72) wraps
``cv2.warpPerspective``.  Here the perspective warp itself is a jitted JAX
gather (bilinear, zero padding outside — cv2's default border), so
rectification runs on-device as part of the frame pipeline instead of on the
host before upload.  State-dict pickling round-trips with the reference's
format (homography0/homography1 keys, calibration.py:23-37).
"""

from __future__ import annotations

import functools
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np


@functools.partial(jax.jit, static_argnames=("inverse",))
def warp_perspective(image: jnp.ndarray, homography: jnp.ndarray,
                     inverse: bool = False) -> jnp.ndarray:
    """Apply a 3x3 homography to [H, W] or [H, W, C] with bilinear sampling.

    Matches cv2.warpPerspective semantics: for each *destination* pixel p,
    sample the source at H^-1 @ p (cv2 inverts the matrix internally unless
    WARP_INVERSE_MAP is set — ``inverse=True`` here).
    """
    squeeze = image.ndim == 2
    if squeeze:
        image = image[:, :, None]
    height, width = image.shape[:2]

    hmat = jnp.asarray(homography, jnp.float32)
    if not inverse:
        hmat = jnp.linalg.inv(hmat)

    ys, xs = jnp.meshgrid(jnp.arange(height, dtype=jnp.float32),
                          jnp.arange(width, dtype=jnp.float32),
                          indexing="ij")
    ones = jnp.ones_like(xs)
    dst = jnp.stack([xs, ys, ones], axis=-1).reshape(-1, 3)       # [N, 3]
    # HIGHEST: a TF32 product (the H100's default for f32 matmuls) keeps
    # ~10 mantissa bits, ~1 px of error at 1e3-pixel coordinates.
    src = jnp.matmul(dst, hmat.T, precision=jax.lax.Precision.HIGHEST)
    sx = src[:, 0] / src[:, 2]
    sy = src[:, 1] / src[:, 2]

    img = image.astype(jnp.float32)

    x0 = jnp.floor(sx)
    y0 = jnp.floor(sy)
    wx = (sx - x0)[:, None]
    wy = (sy - y0)[:, None]

    def gather(ix, iy):
        inb = ((ix >= 0) & (ix <= width - 1) & (iy >= 0) & (iy <= height - 1))
        ixc = jnp.clip(ix, 0, width - 1).astype(jnp.int32)
        iyc = jnp.clip(iy, 0, height - 1).astype(jnp.int32)
        vals = img.reshape(height * width, -1)[iyc * width + ixc]
        return jnp.where(inb[:, None], vals, 0.0)  # zero border, as cv2

    v00 = gather(x0, y0)
    v01 = gather(x0 + 1, y0)
    v10 = gather(x0, y0 + 1)
    v11 = gather(x0 + 1, y0 + 1)
    out = ((v00 * (1 - wx) + v01 * wx) * (1 - wy)
           + (v10 * (1 - wx) + v11 * wx) * wy)
    out = out.reshape(height, width, -1)

    out = out.astype(image.dtype) if jnp.issubdtype(image.dtype, jnp.floating) \
        else jnp.round(out).astype(image.dtype)
    return out[:, :, 0] if squeeze else out


class StereoRectifier:
    """Homography-pair rectifier (reference: stereomatch/calibration.py:11-72).

    Attributes:
        homography0: 3x3 homography for the left camera.
        homography1: 3x3 homography for the right camera.
    """

    def __init__(self, homography0: np.ndarray, homography1: np.ndarray):
        self.homography0 = np.asarray(homography0, np.float32)
        self.homography1 = np.asarray(homography1, np.float32)

    @classmethod
    def from_state_dict(cls, state_dict) -> "StereoRectifier":
        return cls(state_dict["homography0"], state_dict["homography1"])

    def get_state_dict(self):
        return {"homography0": self.homography0,
                "homography1": self.homography1}

    def __call__(self, img0, img1) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Rectify a stereo pair."""
        return (warp_perspective(jnp.asarray(img0), self.homography0),
                warp_perspective(jnp.asarray(img1), self.homography1))

    def invert(self, rectified_img, stereo_view_idx: int) -> jnp.ndarray:
        """Undo the rectification for one view (0 = left, 1 = right)."""
        assert 0 <= stereo_view_idx <= 1
        hmat = (self.homography0, self.homography1)[stereo_view_idx]
        return warp_perspective(jnp.asarray(rectified_img), hmat, inverse=True)
