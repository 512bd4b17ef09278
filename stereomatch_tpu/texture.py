"""Image sampling layer — array stand-in for CUDA textures.

The reference wraps ``cudaArray`` + ``cudaTextureObject_t`` in a CUDATexture
class (src/cuda_texture.cpp:23-172, stereomatch/cuda_texture.py:11-40) to get
hardware-filtered, clamp-addressed image reads in kernels.  Here the same
*semantics* — clamp addressing, nearest or bilinear filtering, optional
normalized coordinates — are provided as a gather-based sampler over a
device-resident ``jax.Array``, so every backend XLA compiles for runs it.  Sampling at integer
pixel centres with nearest filtering returns the stored image exactly, which
is why the texture-backed SSD agrees bit-for-bit with the tensor path (the
property the reference asserts in tests/test_cost.py:41-57).

Contract parity with the reference:
  * 1/2/4-channel float32 or uint8 images (cuda_texture.cpp:37-63); a
    3-channel image raises, as the reference's channel check does
    (tests/test_texture.py:31-37).
  * ``use_normalized_coords`` requires power-of-two width and height
    (cuda_texture.cpp:30-35).
  * round-trip: ``from_array`` then ``to_array`` restores the input
    (cuda_texture.cpp:139-172, ``ToTensor``).

There is no ``release()``: JAX arrays are garbage-collected; a no-op method
is kept so reference code migrates without edits (cuda_texture.py:15-16).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from .utils.numeric import is_power_of_two

_ALLOWED_CHANNELS = (1, 2, 4)
_ALLOWED_DTYPES = ("float32", "uint8")


class FilterMode:
    NEAREST = "nearest"
    LINEAR = "linear"


@functools.partial(jax.jit, static_argnames=("filter_mode", "normalized"))
def _sample(image: jnp.ndarray, xs: jnp.ndarray, ys: jnp.ndarray,
            filter_mode: str = FilterMode.NEAREST,
            normalized: bool = False) -> jnp.ndarray:
    """Gather-based tex2D: clamp addressing over [H, W, C]."""
    height, width = image.shape[0], image.shape[1]
    xs = jnp.asarray(xs, jnp.float32)
    ys = jnp.asarray(ys, jnp.float32)
    if normalized:
        xs = xs * width
        ys = ys * height

    img = image.astype(jnp.float32)

    def gather(ix, iy):
        ix = jnp.clip(ix, 0, width - 1)
        iy = jnp.clip(iy, 0, height - 1)
        flat = img.reshape(height * width, -1)
        return jnp.take(flat, iy * width + ix, axis=0)

    if filter_mode == FilterMode.NEAREST:
        # CUDA point sampling truncates the continuous coordinate.
        out = gather(jnp.floor(xs).astype(jnp.int32),
                     jnp.floor(ys).astype(jnp.int32))
    else:
        # CUDA bilinear convention: texel centres at integer+0.5.
        fx = xs - 0.5
        fy = ys - 0.5
        x0 = jnp.floor(fx)
        y0 = jnp.floor(fy)
        wx = (fx - x0)[..., None]
        wy = (fy - y0)[..., None]
        x0i = x0.astype(jnp.int32)
        y0i = y0.astype(jnp.int32)
        v00 = gather(x0i, y0i)
        v01 = gather(x0i + 1, y0i)
        v10 = gather(x0i, y0i + 1)
        v11 = gather(x0i + 1, y0i + 1)
        top = v00 * (1 - wx) + v01 * wx
        bot = v10 * (1 - wx) + v11 * wx
        out = top * (1 - wy) + bot * wy
    return out


class TextureImage:
    """Clamp-addressed, filterable view over an image array.

    Drop-in analogue of ``stereomatch.cuda_texture.CUDATexture``
    (stereomatch/cuda_texture.py:11-40).
    """

    def __init__(self, data: jnp.ndarray, *, use_normalized_coords: bool = False,
                 filter_mode: str = FilterMode.NEAREST):
        if data.ndim == 2:
            data = data[:, :, None]
        if data.ndim != 3:
            raise RuntimeError(
                f"TextureImage expects [H, W] or [H, W, C], got {data.shape}")
        channels = data.shape[2]
        if channels not in _ALLOWED_CHANNELS:
            raise RuntimeError(
                f"TextureImage supports {_ALLOWED_CHANNELS} channels, got "
                f"{channels} (reference contract: cuda_texture.cpp:44-63)")
        if str(jnp.dtype(data.dtype)) not in _ALLOWED_DTYPES:
            raise RuntimeError(
                f"TextureImage supports float32/uint8, got {data.dtype}")
        if use_normalized_coords and not (
                is_power_of_two(data.shape[0]) and is_power_of_two(data.shape[1])):
            raise RuntimeError(
                "Normalized coordinates require power-of-two dimensions "
                "(reference contract: cuda_texture.cpp:30-35)")
        self._data = jnp.asarray(data)
        self.use_normalized_coords = use_normalized_coords
        self.filter_mode = filter_mode

    # -- reference-parity accessors ------------------------------------
    @property
    def width(self) -> int:
        return self._data.shape[1]

    @property
    def height(self) -> int:
        return self._data.shape[0]

    @property
    def channels(self) -> int:
        return self._data.shape[2]

    @classmethod
    def from_array(cls, array, normalized_coords: bool = False,
                   filter_mode: str = FilterMode.NEAREST) -> "TextureImage":
        """Analogue of CUDATexture.from_tensor (cuda_texture.py:18-33)."""
        return cls(jnp.asarray(array), use_normalized_coords=normalized_coords,
                   filter_mode=filter_mode)

    # Alias so reference call sites read unchanged.
    from_tensor = from_array

    def to_array(self) -> jnp.ndarray:
        """Read back the stored image ([H, W] if single-channel), like
        CUDATexture::ToTensor (cuda_texture.cpp:139-172)."""
        if self.channels == 1:
            return self._data[:, :, 0]
        return self._data

    def release(self) -> None:
        """No-op: JAX owns the buffer lifetime."""

    # -- sampling --------------------------------------------------------
    def sample(self, xs, ys) -> jnp.ndarray:
        """tex2D(texture, x, y) for arbitrary coordinate arrays."""
        out = _sample(self._data, xs, ys, filter_mode=self.filter_mode,
                      normalized=self.use_normalized_coords)
        if self.channels == 1:
            return out[..., 0]
        return out

    def sample_grid(self) -> jnp.ndarray:
        """Sample every integer pixel centre — identity under nearest
        filtering (the property the SSD texture path relies on).

        Nearest + unnormalized is exactly the stored image, so that case
        skips the gather (a CUDA texture would still route reads through
        the sampler; here the gather would cost real memory traffic for
        bit-identical output).
        """
        if (self.filter_mode == FilterMode.NEAREST
                and not self.use_normalized_coords):
            return self.to_array().astype(jnp.float32)
        ys, xs = jnp.meshgrid(jnp.arange(self.height, dtype=jnp.float32),
                              jnp.arange(self.width, dtype=jnp.float32),
                              indexing="ij")
        return self.sample(xs, ys)

    def __str__(self) -> str:
        return (f"TextureImage(width={self.width}, height={self.height}, "
                f"channels={self.channels}, "
                f"normalized={self.use_normalized_coords}, "
                f"filter={self.filter_mode})")

    __repr__ = __str__


# Reference-compatible alias: code written against the reference's
# `CUDATexture` name migrates by changing only the import.
CUDATexture = TextureImage
