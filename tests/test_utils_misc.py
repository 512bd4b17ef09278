"""Direct unit coverage for small shared contracts that the integration
tests only exercise indirectly."""

from pathlib import Path

import numpy as np
import pytest

import jax
import jax.numpy as jnp


def test_resolve_backend_contract():
    """auto -> the Hopper kernel ONLY where it can run (the CPU here);
    an explicit kernel request on the CPU raises instead of falling
    back; unknown names raise."""
    from stereomatch_tpu.utils.backend import resolve_backend
    assert resolve_backend("xla") == "xla"
    assert resolve_backend("auto") == "xla"          # CPU in CI
    with pytest.raises(RuntimeError, match="Hopper"):
        resolve_backend("cuda")
    with pytest.raises(ValueError, match="unknown backend"):
        resolve_backend("pallas")


def test_device_table_knows_the_h100():
    from stereomatch_tpu.utils.devices import device_spec
    spec = device_spec("NVIDIA H100 80GB HBM3")
    assert spec.hbm_bytes_per_s == 3.35e12
    assert spec.link_bytes_per_s == 450e9
    assert "data sheet" in spec.source


def test_device_table_unknown_kind_raises():
    from stereomatch_tpu.utils.devices import UnknownDeviceError, device_spec
    with pytest.raises(UnknownDeviceError, match="no published figures"):
        device_spec("cpu")
    with pytest.raises(UnknownDeviceError):
        device_spec()                                 # the CPU device here


def test_interconnect_model_rates():
    """The SGM mode model takes the device table's rates, or explicit
    ones (how CPU callers use it); a device without figures raises."""
    from stereomatch_tpu.parallel.ici_model import select_sgm_mode
    from stereomatch_tpu.utils.devices import UnknownDeviceError
    geo = dict(height=376, width=450, disp=128, tiles=4, batch=1)
    table = select_sgm_mode(device_kind="NVIDIA H100 80GB HBM3", **geo)
    explicit = select_sgm_mode(link_gbps=450.0, hbm_gbps=3350.0, **geo)
    assert table == explicit
    with pytest.raises(UnknownDeviceError):
        select_sgm_mode(**geo)


def test_compile_cache_honours_environment(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set, the directory is JAX's to read
    and none is set in code; unset, the checkout's .jax_cache/ is used."""
    from stereomatch_tpu.utils import compile_cache
    before = jax.config.jax_compilation_cache_dir
    min_time = jax.config.jax_persistent_cache_min_compile_time_secs
    try:
        monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere/cache")
        assert str(compile_cache.enable_compile_cache()) == "/elsewhere/cache"
        assert jax.config.jax_compilation_cache_dir == before
        monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR")
        path = compile_cache.enable_compile_cache()
        assert path == compile_cache.CHECKOUT_CACHE
        assert path.parent == Path(__file__).resolve().parent.parent
        assert jax.config.jax_compilation_cache_dir == str(path)
    finally:
        jax.config.update("jax_compilation_cache_dir", before)
        jax.config.update("jax_persistent_cache_min_compile_time_secs",
                          min_time)


def test_out_of_image_mask_ranks():
    """The shared halo-bounds helper: exact per-rank truth table for a
    4-shard axis with asymmetric (before=2, after=1) halos."""
    from jax import shard_map
    from jax.sharding import Mesh, PartitionSpec as P

    from stereomatch_tpu.parallel import halo

    n, local_len, before, after = 4, 3, 2, 1
    mesh = Mesh(np.asarray(jax.devices()[:n]), ("tile",))

    def body(x):
        del x
        return halo.out_of_image_mask("tile", n, local_len,
                                      before, after)[None]

    out = np.asarray(jax.jit(shard_map(
        body, mesh=mesh, in_specs=P("tile"), out_specs=P("tile")))(
            jnp.zeros((n,), jnp.float32)))
    # Rank 0: the 2 leading halo rows precede the image.
    np.testing.assert_array_equal(out[0], [1, 1, 0, 0, 0, 0])
    # Interior ranks: everything maps to real rows.
    np.testing.assert_array_equal(out[1], [0] * 6)
    np.testing.assert_array_equal(out[2], [0] * 6)
    # Last rank: the trailing halo row is past the image.
    np.testing.assert_array_equal(out[3], [0, 0, 0, 0, 0, 1])
    # Default after=before.
    def body2(x):
        del x
        return halo.out_of_image_mask("tile", n, local_len, 1)[None]
    out2 = np.asarray(jax.jit(shard_map(
        body2, mesh=mesh, in_specs=P("tile"), out_specs=P("tile")))(
            jnp.zeros((n,), jnp.float32)))
    np.testing.assert_array_equal(out2[0], [1, 0, 0, 0, 0])
    np.testing.assert_array_equal(out2[3], [0, 0, 0, 0, 1])
