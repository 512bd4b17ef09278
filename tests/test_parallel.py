"""Multi-chip sharding tests on the 8-device virtual CPU mesh.

The oracle pattern follows the reference's CPU<->GPU equivalence tests
(tests/test_semiglobalmatch.py:39-55 etc.): the single-chip jitted pipeline
is the trusted implementation, and the sharded program must match it —
bit-exactly for `exact` SGM hand-off, and for `overlap` mode whenever the
warm-up window covers every preceding tile (multi-hop halos pull from all
predecessors, so overlap >= (n_tiles-1)*Hl reconstructs the full scan
state; the deepest halo bottoms out in ppermute zero fill, the recurrence
identity).
"""

import numpy as np
import pytest

import jax

from stereomatch_tpu.aggregation import Semiglobal
from stereomatch_tpu.cost import SSD, Birchfield
from stereomatch_tpu.disparity_reduce import DynamicProgramming, WinnerTakesAll
from stereomatch_tpu.parallel import ShardedPipeline, make_mesh
from stereomatch_tpu.parallel.mesh import batch_tile_axes

from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair

D = STM_MAX_DISPARITY


@pytest.fixture(scope="module")
def pair():
    left, right, _ = synthetic_stereo_pair(32, 48, D, seed=3)
    return left, right


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) >= 8, "tests need the 8-device CPU mesh"
    return make_mesh(jax.devices()[:8], n_batch=2)


def _reference(left, right, aggregation, reducer):
    vol = SSD(D, kernel_size=3)(left, right)
    if aggregation:
        vol = Semiglobal()(vol, left)
    return np.asarray(reducer(vol))


def test_mesh_factorization():
    assert batch_tile_axes(1) == (1, 1)
    assert batch_tile_axes(8) == (2, 4)
    assert batch_tile_axes(8, n_batch=1) == (1, 8)
    with pytest.raises(ValueError):
        batch_tile_axes(8, n_batch=3)


@pytest.mark.parametrize("sgm_mode", ["exact", "overlap"])
def test_sharded_sgm_wta_matches_single_chip(pair, mesh, sgm_mode):
    left, right = pair
    ref = _reference(left, right, True, WinnerTakesAll())
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode=sgm_mode,
                           overlap=left.shape[0])
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    for b in range(2):
        np.testing.assert_array_equal(out[b], ref)


def test_exact_schedule_selection_and_parity(pair, mesh):
    """The interconnect model picks the exact hand-off schedule by
    (tiles, batch) — naive at small local batches (where an
    unconditional wavefront measured slower on the CPU mesh), the
    wavefront once the frame pipeline fills — and both schedules (and
    auto) produce identical disparities."""
    from stereomatch_tpu.parallel.ici_model import select_exact_schedule

    # Calibrated picks: B=1 degenerate -> naive; B=2/T=4 -> naive (the
    # measured r4 regression); B>=4 -> wavefront.
    assert select_exact_schedule(tiles=4, batch=1)[0] == "naive"
    assert select_exact_schedule(tiles=4, batch=2)[0] == "naive"
    assert select_exact_schedule(tiles=4, batch=4)[0] == "wavefront"
    assert select_exact_schedule(tiles=4, batch=8)[0] == "wavefront"

    left, right = pair
    ref = _reference(left, right, True, WinnerTakesAll())
    outs = {}
    for sched in ("wavefront", "naive", "auto"):
        pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                               reducer="wta", sgm_mode="exact",
                               sgm_schedule=sched, backend="xla")
        outs[sched] = np.asarray(pipe.estimate(np.stack([left] * 2),
                                               np.stack([right] * 2)))
        np.testing.assert_array_equal(outs[sched][0], ref)
    np.testing.assert_array_equal(outs["wavefront"], outs["naive"])
    np.testing.assert_array_equal(outs["auto"], outs["naive"])


def test_sharded_dp_matches_single_chip(pair, mesh):
    left, right = pair
    ref = _reference(left, right, True, DynamicProgramming())
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="dynamic_programming", sgm_mode="exact")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sharded_cost_only(pair, mesh):
    left, right = pair
    ref = _reference(left, right, False, WinnerTakesAll())
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation=None,
                           reducer="wta")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sharded_birchfield(pair, mesh):
    left, right = pair
    vol = Birchfield(D)(left, right)
    ref = np.asarray(WinnerTakesAll()(vol))
    pipe = ShardedPipeline(mesh, D, cost="birchfield", aggregation=None,
                           reducer="wta")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sharded_ssd_texture(pair, mesh):
    """Sharded 'ssd-texture' must bit-match the single-chip SSDTexture
    config (sampler identity + float32 SSD)."""
    from stereomatch_tpu.cost import SSDTexture
    from stereomatch_tpu.texture import TextureImage
    left, right = pair
    vol = SSDTexture(D, kernel_size=3)(TextureImage.from_array(left),
                                       TextureImage.from_array(right))
    ref = np.asarray(WinnerTakesAll()(vol))
    pipe = ShardedPipeline(mesh, D, cost="ssd-texture", kernel_size=3,
                           aggregation=None, reducer="wta")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_tiled2d_ssd_texture(pair):
    from stereomatch_tpu.cost import SSDTexture
    from stereomatch_tpu.texture import TextureImage
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSDTexture(D, kernel_size=3)(TextureImage.from_array(left),
                                       TextureImage.from_array(right))
    agg = Semiglobal(backend="xla")(vol, left)
    ref = np.asarray(WinnerTakesAll()(agg))
    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, cost="ssd-texture",
                               kernel_size=3, overlap=max(left.shape),
                               backend="xla")
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_disp_sharded_ssd_texture(pair):
    from stereomatch_tpu.cost import SSDTexture
    from stereomatch_tpu.texture import TextureImage
    from stereomatch_tpu.parallel import make_disp_mesh, make_disp_sharded_wta
    left, right = pair
    d_total = 32
    vol = SSDTexture(d_total, kernel_size=3)(TextureImage.from_array(left),
                                             TextureImage.from_array(right))
    ref = np.asarray(WinnerTakesAll()(vol))
    mesh = make_disp_mesh(n_disp=8)
    fn = make_disp_sharded_wta(mesh, max_disparity=d_total,
                               cost="ssd-texture", kernel_size=3)
    np.testing.assert_array_equal(np.asarray(fn(left, right)), ref)


def test_sharded_census(pair, mesh):
    """Sharded census cost must bit-match the single-chip Census config
    (ppermute zero halos == the census out-of-image convention)."""
    from stereomatch_tpu.cost import Census
    left, right = pair
    vol = Census(D)(left, right)
    ref = np.asarray(WinnerTakesAll()(vol))
    pipe = ShardedPipeline(mesh, D, cost="census", aggregation=None,
                           reducer="wta")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_overlap_mode_close_even_with_small_window(pair, mesh):
    """Warm-up shorter than the tile: not bit-exact, but disparity maps
    should disagree on only a small fraction of pixels (SGM forgets its
    carry geometrically)."""
    left, right = pair
    ref = _reference(left, right, True, WinnerTakesAll())
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="overlap", overlap=4)
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    assert np.mean(out[0] != ref) < 0.05


def test_overlap_mode_multi_hop_partial_window(pair, mesh):
    """Warm-up longer than one tile but short of full coverage: the 2-hop
    halo path must run and beat the 1-tile-window error."""
    left, right = pair
    ref = _reference(left, right, True, WinnerTakesAll())
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="overlap", overlap=12)
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    assert np.mean(out[0] != ref) < 0.03


def test_single_device_mesh(pair):
    left, right = pair
    ref = _reference(left, right, True, WinnerTakesAll())
    mesh1 = make_mesh(jax.devices()[:1])
    pipe = ShardedPipeline(mesh1, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="exact")
    out = np.asarray(pipe.estimate(left[None], right[None]))
    np.testing.assert_array_equal(out[0], ref)


@pytest.mark.parametrize("reducer", ["wta", "dynamic_programming"])
def test_cuda_branch_sharded(pair, mesh, reducer, monkeypatch):
    """The sharded pipeline's kernel branch (backend="cuda": the kernel's
    in-place horizontal sweeps and its carry contract per tile), run on
    the CPU through the kernel's sweep contract on the XLA scan: overlap
    spanning the tile height reproduces the single-chip result exactly."""
    from .sgm_kernel_model import substitute_kernel
    substitute_kernel(monkeypatch)
    left, right = pair
    red = (WinnerTakesAll() if reducer == "wta" else DynamicProgramming())
    ref = _reference(left, right, True, red)
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer=reducer, sgm_mode="overlap",
                           overlap=left.shape[0], backend="cuda")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


@pytest.mark.parametrize("schedule", ["wavefront", "naive"])
def test_cuda_branch_exact_handoff(pair, mesh, schedule, monkeypatch):
    """Exact carry hand-off on the kernel branch bit-matches the
    single-chip aggregation regardless of tiling and fill schedule."""
    from .sgm_kernel_model import substitute_kernel
    substitute_kernel(monkeypatch)
    left, right = pair
    ref = _reference(left, right, True, WinnerTakesAll())
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="exact",
                           sgm_schedule=schedule, backend="cuda")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_cuda_branch_small_overlap(pair, mesh, monkeypatch):
    from .sgm_kernel_model import substitute_kernel
    substitute_kernel(monkeypatch)
    left, right = pair
    ref = _reference(left, right, True, WinnerTakesAll())
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="overlap", overlap=4,
                           backend="cuda")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    assert np.mean(out[0] != ref) < 0.05


@pytest.mark.parametrize("cost", ["ssd", "birchfield", "census"])
def test_disparity_sharded_wta(pair, cost):
    """Disparity-block sharding: each chip owns D/8 hypotheses; the global
    argmin (lowest-d tie-break) must bit-match the single-chip reducer."""
    from stereomatch_tpu.ops.cost import (birchfield_cost_volume,
                                          census_hamming_cost_volume,
                                          ssd_cost_volume)
    from stereomatch_tpu.parallel import make_disp_mesh, make_disp_sharded_wta
    left, right = pair
    d_total = 32
    mesh = make_disp_mesh(n_disp=8)
    kwargs = {"kernel_size": 3} if cost == "ssd" else {}
    fn = make_disp_sharded_wta(mesh, max_disparity=d_total, cost=cost,
                               **kwargs)
    out = np.asarray(fn(left, right))
    if cost == "ssd":
        vol = ssd_cost_volume(left, right, max_disparity=d_total,
                              kernel_size=3)
    elif cost == "census":
        vol = census_hamming_cost_volume(left, right, max_disparity=d_total)
    else:
        vol = birchfield_cost_volume(left, right, max_disparity=d_total)
    ref = np.asarray(WinnerTakesAll()(vol))
    np.testing.assert_array_equal(out, ref)


def test_disparity_offset_blocks_concatenate():
    """Cost blocks at increasing offsets tile the full-D volume exactly."""
    from stereomatch_tpu.ops.cost import ssd_cost_volume
    rng = np.random.default_rng(0)
    left = rng.random((16, 40)).astype(np.float32)
    right = rng.random((16, 40)).astype(np.float32)
    full = np.asarray(ssd_cost_volume(left, right, max_disparity=16,
                                      kernel_size=3))
    blocks = [np.asarray(ssd_cost_volume(left, right, max_disparity=4,
                                         kernel_size=3,
                                         disparity_offset=o))
              for o in (0, 4, 8, 12)]
    np.testing.assert_array_equal(np.concatenate(blocks, axis=2), full)


@pytest.mark.parametrize("cost", ["ssd", "birchfield", "census"])
def test_tiled2d_exact_with_covering_overlap(pair, cost):
    """2-D (tile x tile_w) mesh with halos covering the whole tile must
    reproduce the single-chip SGM+WTA result exactly."""
    from stereomatch_tpu.cost import Birchfield, Census
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    cost_fn = {"ssd": SSD(D, kernel_size=3), "birchfield": Birchfield(D),
               "census": Census(D)}[cost]
    vol = cost_fn(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    ref = np.asarray(WinnerTakesAll()(agg))
    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    kwargs = {"kernel_size": 3} if cost == "ssd" else {}
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, cost=cost,
                               overlap=max(left.shape), backend="xla",
                               **kwargs)
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


@pytest.mark.parametrize("grid", [(2, 2, 2), (2, 1, 4)])
def test_tiled2d_dp_exact_handoff(pair, grid):
    """DP under 2-D tiling runs exactly (forward accumulator hand-off,
    rightmost-tile argmin, backward trace hand-off) — bit-matching the
    single-chip reducer regardless of the W split."""
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    ref = np.asarray(DynamicProgramming()(agg))
    nb, nt, nw = grid
    mesh2 = make_mesh_2d(n_batch=nb, n_tile=nt, n_tile_w=nw)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               reducer="dynamic_programming",
                               overlap=max(left.shape), backend="xla")
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_tiled2d_cuda_branch(pair, monkeypatch):
    """2-D tiling with the kernel branch of the aggregation (run on the
    CPU through the kernel's sweep contract on the XLA scan)."""
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    from .sgm_kernel_model import substitute_kernel
    substitute_kernel(monkeypatch)
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    ref = np.asarray(WinnerTakesAll()(agg))
    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               overlap=max(left.shape), backend="cuda")
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_tiled2d_small_overlap_close(pair):
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    ref = np.asarray(WinnerTakesAll()(agg))
    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               overlap=6, backend="xla")
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    assert np.mean(out[0] != ref) < 0.02


def test_divisibility_errors(pair, mesh):
    left, right = pair
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation=None,
                           reducer="wta")
    with pytest.raises(ValueError):
        pipe.estimate(np.stack([left] * 3), np.stack([right] * 3))
    with pytest.raises(ValueError):
        pipe.estimate(left[None, :30], right[None, :30])


def test_sharded_sad(pair, mesh):
    """Sharded SAD: identical halo pattern to SSD, L1 summand."""
    from stereomatch_tpu.cost import SAD
    left, right = pair
    vol = SAD(D, kernel_size=3)(left, right)
    ref = np.asarray(WinnerTakesAll()(vol))
    pipe = ShardedPipeline(mesh, D, cost="sad", kernel_size=3,
                           aggregation=None, reducer="wta")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sharded_ncc(pair, mesh):
    """Sharded ZNCC is BIT-EQUAL to the single-chip volume (round 5).

    The padded body now runs the single-chip prefix-plane formulation
    on the haloed tile with the global centering means threaded in, so
    the volumes — not just the
    WTA picks — must match exactly (the round-3/4 contract allowed
    ~1e-5 divergence between the two formulations)."""
    import functools

    import jax.numpy as jnp
    from jax import shard_map
    from jax.sharding import PartitionSpec as P

    from stereomatch_tpu.cost import NCC
    from stereomatch_tpu.parallel.mesh import BATCH_AXIS, TILE_AXIS
    from stereomatch_tpu.parallel.sharded import _local_zncc

    left, right = pair
    vol = np.asarray(NCC(D, kernel_size=3)(left, right))

    n_tiles = mesh.shape[TILE_AXIS]
    local = functools.partial(_local_zncc, max_disparity=D, kernel_size=3,
                              cost_dtype=jnp.float32, axis_name=TILE_AXIS,
                              n_tiles=n_tiles)
    spec = P(BATCH_AXIS, TILE_AXIS)
    fn = jax.jit(shard_map(local, mesh=mesh, in_specs=(spec, spec),
                           out_specs=P(BATCH_AXIS, TILE_AXIS, None, None)))
    got = np.asarray(fn(jnp.asarray(np.stack([left] * 2)),
                        jnp.asarray(np.stack([right] * 2))))
    np.testing.assert_array_equal(got[0], vol)
    np.testing.assert_array_equal(got[1], vol)

    # End-to-end through the pipeline: WTA parity is now exact too.
    ref = np.asarray(WinnerTakesAll()(jnp.asarray(vol)))
    pipe = ShardedPipeline(mesh, D, cost="ncc", kernel_size=3,
                           aggregation=None, reducer="wta")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(out[1], ref)


def test_tiled2d_ncc(pair):
    from stereomatch_tpu.cost import NCC
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = NCC(D, kernel_size=3)(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    ref = np.asarray(WinnerTakesAll()(agg))
    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, cost="ncc",
                               kernel_size=3, overlap=max(left.shape),
                               backend="xla")
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


@pytest.mark.parametrize("cost_name", ["sad", "ncc"])
def test_disp_sharded_sad_ncc(pair, cost_name):
    from stereomatch_tpu.cost import NCC, SAD
    from stereomatch_tpu.parallel import make_disp_mesh, make_disp_sharded_wta
    left, right = pair
    d_total = 32
    cls = {"sad": SAD, "ncc": NCC}[cost_name]
    vol = cls(d_total, kernel_size=3)(left, right)
    ref = np.asarray(WinnerTakesAll()(vol))
    mesh = make_disp_mesh(n_disp=8)
    fn = make_disp_sharded_wta(mesh, max_disparity=d_total, cost=cost_name,
                               kernel_size=3)
    np.testing.assert_array_equal(np.asarray(fn(left, right)), ref)


@pytest.mark.parametrize("kwargs", [
    dict(lr_check=True, median=True),
    dict(lr_check=True, lr_mode="volume"),
    dict(min_confidence=0.05),
])
def test_sharded_postprocessing_matches_single_chip(pair, mesh, kwargs):
    """Mesh post-processing (LR fill, median, confidence gate) bit-matches
    Pipeline.estimate_refined: every stage is row-local except the median's
    one-row halos (the volume-mode LR check is row-local outright)."""
    from stereomatch_tpu.pipeline import Pipeline
    left, right = pair
    single = Pipeline(SSD(D, kernel_size=3), WinnerTakesAll(), Semiglobal())
    ref = np.asarray(single.estimate_refined(
        left, right, subpixel=False,
        median=kwargs.get("median", False),
        lr_check=kwargs.get("lr_check", False),
        lr_mode=kwargs.get("lr_mode", "mirror"),
        min_confidence=kwargs.get("min_confidence")))
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="exact", backend="xla",
                           **kwargs)
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sharded_subpixel_close_to_single_chip(pair, mesh):
    """Sub-pixel output under the mesh: the parabolic vertex divides
    last-ulp differences in the aggregated volume (the sharded SGM sums
    the 8 directions in a different order), so assert a tight tolerance
    rather than equality."""
    from stereomatch_tpu.pipeline import Pipeline
    left, right = pair
    single = Pipeline(SSD(D, kernel_size=3), WinnerTakesAll(), Semiglobal())
    ref = np.asarray(single.estimate_refined(left, right, subpixel=True,
                                             median=True))
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="exact", backend="xla",
                           median=True, subpixel=True)
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    assert out.dtype == np.float32
    np.testing.assert_allclose(out[0], ref, atol=1e-4)


def test_sharded_speckle_matches_single_chip(pair, mesh):
    """Windowed-support speckle under row sharding (NaN ring-end halos =
    the single-chip out-of-image convention) bit-matches filter_speckles
    applied to the single-chip result."""
    from stereomatch_tpu.ops.refine import filter_speckles
    from stereomatch_tpu.pipeline import Pipeline
    left, right = pair
    single = Pipeline(SSD(D, kernel_size=3), WinnerTakesAll(), Semiglobal())
    ref = np.asarray(filter_speckles(
        np.asarray(single.estimate(left, right)).astype(np.float32),
        fill="background"))
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="exact", backend="xla",
                           speckle=True, speckle_fill="background")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_tiled2d_postprocessing_matches_single_chip(pair):
    """2-D tiled post-processing (median with 2-D edge halos, one-hot
    sub-pixel, confidence gate, NaN-halo speckle) vs the single-chip
    stages applied to the exact (covering-overlap) result."""
    from stereomatch_tpu.ops import refine
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    disp = WinnerTakesAll()(agg)
    disp_m = refine.median_filter_3x3(disp)
    idx = np.clip(np.round(np.asarray(disp_m)), 0, D - 1).astype(np.int32)
    ref = np.asarray(refine.subpixel_refine(agg, idx))
    ref = np.where(np.asarray(refine.speckle_mask(ref)), ref, 0.0)

    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               overlap=max(left.shape), backend="xla",
                               median=True, subpixel=True, speckle=True)
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    assert out.dtype == np.float32
    # The extended-tile recompute evaluates the same math at different
    # array shapes, so XLA may order reductions differently: the
    # parabola amplifies last-ulp volume differences (same tolerance
    # rationale as test_sharded_subpixel_close_to_single_chip).
    np.testing.assert_allclose(out[0], ref, atol=1e-4)


def test_tiled2d_confidence_gate_matches_single_chip(pair):
    from stereomatch_tpu.ops import refine
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    disp = np.asarray(WinnerTakesAll()(agg))
    conf = np.asarray(refine.confidence_pkrn(agg))
    ref = np.where(conf >= 0.05, disp, 0)

    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               overlap=max(left.shape), backend="xla",
                               min_confidence=0.05)
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


@pytest.mark.parametrize("n_batch,n_tile_w", [(2, 2), (1, 4)])
def test_tiled2d_lr_check_matches_single_chip(pair, n_batch, n_tile_w):
    """Volume-mode LR check under 2-D tiling is bit-exact vs the
    single-chip stages on an exactly-tiled volume (aggregation=None):
    the re-indexed right disparity pulls a (D-1)-wide volume halo
    (multi-hop: D-1=31 > W/n_tile_w), the consistency test a disparity
    halo, and the fill chains a last-valid carry across ranks."""
    from stereomatch_tpu.ops import refine
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    disp = WinnerTakesAll()(vol)
    disp_r = refine.right_disparity_from_volume(vol)
    mask = refine.left_right_consistency(disp, disp_r, 1, max_disparity=D)
    ref = np.asarray(refine.fill_inconsistent(disp, mask))

    mesh2 = make_mesh_2d(n_batch=n_batch, n_tile=2, n_tile_w=n_tile_w)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               aggregation=None, backend="xla",
                               lr_check=True)
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out[0], ref)
    np.testing.assert_array_equal(out[1], ref)


def test_tiled2d_lr_check_rejects_mirror(pair):
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    with pytest.raises(ValueError, match="volume"):
        make_tiled2d_estimate(mesh2, max_disparity=D, lr_check=True,
                              lr_mode="mirror")


def test_tiled2d_speckle_background_fill_matches_single_chip(pair):
    """Background speckle fill under 2-D tiling: the windowed-support mask
    takes 2-D NaN halos and the scanline fill reuses the LR check's
    cross-rank scan stitching — bit-exact vs filter_speckles."""
    from stereomatch_tpu.ops import refine
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    disp = WinnerTakesAll()(vol)
    ref = np.asarray(refine.filter_speckles(disp, fill="background"))

    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               aggregation=None, backend="xla",
                               speckle=True, speckle_fill="background")
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sharded_weighted_median_matches_single_chip(pair, mesh):
    """Row-sharded guide-weighted median: halo rows of bins + guide with
    +inf ring-end guide (zero affinity) — bit-exact vs the single-chip
    filter applied to the exact mesh disparity."""
    from stereomatch_tpu.ops import refine
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    agg = Semiglobal(backend="xla")(vol, left)
    disp = WinnerTakesAll()(agg)
    ref = np.asarray(refine.weighted_median_filter(
        disp, left, window=5, sigma=0.1, n_bins=D))

    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="exact", backend="xla",
                           weighted_median=True, wmf_sigma=0.1,
                           wmf_window=5)
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_tiled2d_weighted_median_matches_single_chip(pair):
    from stereomatch_tpu.ops import refine
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    disp = WinnerTakesAll()(vol)
    ref = np.asarray(refine.weighted_median_filter(
        disp, left, window=5, sigma=0.1, n_bins=D))

    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, kernel_size=3,
                               aggregation=None, backend="xla",
                               weighted_median=True, wmf_sigma=0.1,
                               wmf_window=5)
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sharded_fgs_matches_single_chip(pair, mesh):
    """Row-sharded fast global smoother: horizontal solves are row-local
    and the vertical Thomas sweeps chain (cp, dp)/first-row carries
    through the ranks.  The recurrences are the single-chip ones, but
    XLA fuses the elementwise system-building differently inside the
    shard_map program, so agreement is to float-associativity noise
    (tight atol), not bit-exact."""
    from stereomatch_tpu.ops import refine
    left, right = pair
    vol = SSD(D, kernel_size=3)(left, right)
    disp = WinnerTakesAll()(vol)
    disp_r = refine.right_disparity_from_volume(vol)
    mask = refine.left_right_consistency(disp, disp_r, 1, max_disparity=D)
    filled = refine.fill_inconsistent(disp, mask)
    ref = np.asarray(refine.fgs_smooth(
        np.asarray(filled, np.float32), left, lam=64.0, sigma_color=0.05,
        confidence=np.asarray(mask, np.float32)))

    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation=None,
                           reducer="wta", backend="xla",
                           lr_check=True, lr_mode="volume",
                           fgs_lambda=64.0, fgs_sigma=0.05)
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_allclose(out[0], ref, atol=2e-3)
    np.testing.assert_array_equal(out[0], out[1])


def test_sharded_census_multiword_window(pair, mesh):
    """census_window=7 (two int32 code words) under row sharding: the
    3-row halos feed the wider window; bit-exact vs single chip."""
    from stereomatch_tpu.cost import Census
    left, right = pair
    vol = Census(D, window_size=7)(left, right)
    ref = np.asarray(WinnerTakesAll()(vol))
    pipe = ShardedPipeline(mesh, D, cost="census", census_window=7,
                           aggregation=None, reducer="wta")
    out = np.asarray(pipe.estimate(np.stack([left] * 2),
                                   np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_tiled2d_census_multiword_window(pair):
    """census_window=7 under 2-D tiling (two code words, 3-row halos):
    bit-exact vs the single-chip Census volume."""
    from stereomatch_tpu.cost import Census
    from stereomatch_tpu.parallel import make_mesh_2d, make_tiled2d_estimate
    left, right = pair
    vol = Census(D, window_size=7)(left, right)
    ref = np.asarray(WinnerTakesAll()(vol))
    mesh2 = make_mesh_2d(n_batch=2, n_tile=2, n_tile_w=2)
    fn = make_tiled2d_estimate(mesh2, max_disparity=D, cost="census",
                               census_window=7, aggregation=None,
                               backend="xla")
    out = np.asarray(fn(np.stack([left] * 2), np.stack([right] * 2)))
    np.testing.assert_array_equal(out[0], ref)


def test_sgm_mode_auto_and_model_selection(pair, mesh):
    """sgm_mode='auto' resolves through the interconnect model: the model
    prefers bit-exact 'exact' within 5% efficiency, and the
    frame-pipelined hand-off makes batch size enter the prediction (more
    frames per chip amortize the serial chain).  Rates come from the
    device table — passed explicitly here (the H100's), and an error for
    a device with no published figures, such as this CPU mesh."""
    from stereomatch_tpu.parallel.ici_model import select_sgm_mode
    from stereomatch_tpu.utils.devices import UnknownDeviceError
    rates = dict(link_gbps=450.0, hbm_gbps=3350.0)
    mode_small, info_small = select_sgm_mode(height=64, width=96, disp=32,
                                             tiles=4, batch=1, **rates)
    mode_big, info_big = select_sgm_mode(height=4096, width=512, disp=64,
                                         tiles=4, batch=8, **rates)
    # Tall images with few tiles and deep batches favor exact (carry is
    # one [3, W, D] slab vs H/T rows of compute); tiny tiles favor
    # overlap.  The directions, not the absolute numbers, are the pin.
    assert mode_big == "exact", info_big
    assert (info_big["exact_efficiency"]
            >= info_small["exact_efficiency"])
    # Deeper batches never make exact look worse.
    _, info_b1 = select_sgm_mode(height=375, width=450, disp=128,
                                 tiles=8, batch=1, **rates)
    _, info_b8 = select_sgm_mode(height=375, width=450, disp=128,
                                 tiles=8, batch=8, **rates)
    assert (info_b8["exact_efficiency"]
            >= info_b1["exact_efficiency"])

    # The auto pipeline asks the mesh devices for their rates.
    left, right = pair
    pipe = ShardedPipeline(mesh, D, kernel_size=3, aggregation="sgm",
                           reducer="wta", sgm_mode="auto")
    with pytest.raises(UnknownDeviceError):
        pipe.estimate(np.stack([left] * 2), np.stack([right] * 2))
    out = np.asarray(ShardedPipeline(
        mesh, D, kernel_size=3, aggregation="sgm", reducer="wta",
        sgm_mode=mode_small).estimate(np.stack([left] * 2),
                                      np.stack([right] * 2)))
    assert out.shape == (2,) + left.shape
    with pytest.raises(ValueError, match="unknown sgm_mode"):
        ShardedPipeline(mesh, D, aggregation="sgm", sgm_mode="exactt")


def test_frame_pipelined_handoff_equals_naive(pair, mesh):
    """The (frame, tile) wavefront schedule is bit-equal to the naive
    all-frames-every-stage hand-off (same per-frame computation in the
    same order) — the A/B benchmark's correctness premise."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from stereomatch_tpu.parallel import sharded
    from stereomatch_tpu.parallel.mesh import BATCH_AXIS, TILE_AXIS
    try:
        from jax import shard_map
    except ImportError:
        from jax.experimental.shard_map import shard_map

    left, right = pair
    from stereomatch_tpu.cost import SSD
    vol = np.stack([np.asarray(SSD(D, kernel_size=3)(left, right))] * 4)
    img = np.stack([left] * 4)
    n_tiles = mesh.shape[TILE_AXIS]
    vs = NamedSharding(mesh, P(BATCH_AXIS, TILE_AXIS, None, None))
    ims = NamedSharding(mesh, P(BATCH_AXIS, TILE_AXIS, None))

    outs = {}
    for name in ("_handoff_sweep", "_handoff_sweep_naive"):
        sweep = getattr(sharded, name)

        def local(v, im, sweep=sweep):
            a = sweep(v, im, 0.1, 0.2, 0, axis_name=TILE_AXIS,
                      n_tiles=n_tiles, reverse=False)
            return a + sweep(v, im, 0.1, 0.2, 1, axis_name=TILE_AXIS,
                             n_tiles=n_tiles, reverse=True)

        fn = jax.jit(shard_map(
            local, mesh=mesh,
            in_specs=(P(BATCH_AXIS, TILE_AXIS, None, None),
                      P(BATCH_AXIS, TILE_AXIS, None)),
            out_specs=P(BATCH_AXIS, TILE_AXIS, None, None)))
        outs[name] = np.asarray(fn(jax.device_put(vol, vs),
                                   jax.device_put(img, ims)))
    np.testing.assert_array_equal(outs["_handoff_sweep"],
                                  outs["_handoff_sweep_naive"])
