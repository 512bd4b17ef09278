"""The Hopper SGM kernel's CPU-side contract (ops/sgm_cuda.py + .cu).

The kernel itself runs only on the card (tests/test_gpu_hardware.py
compares it with the XLA scans there).  Here, without a card:

* its algorithm — line enumeration, address mapping, per-step arithmetic,
  accumulation order — through the numpy model in
  tests/sgm_kernel_model.py, which must reproduce the XLA formulation bit
  for bit at the shapes the kernel is tested with;
* the wrapper: the program it lowers for CUDA (eight FFI sweeps in the
  oracle's accumulation order, bf16 streamed without widening, batching
  under vmap, shard_map typing), and its input checks;
* the choice of implementation (utils/backend.py): the kernel where it
  can run, XLA elsewhere, and an error — never an interpreter — for an
  explicit kernel request on a device without it.
"""

import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from stereomatch_tpu.aggregation import Semiglobal
from stereomatch_tpu.ops import sgm_cuda
from stereomatch_tpu.ops.aggregation import (semiglobal_aggregate,
                                             sgm_scan_with_carry)
from stereomatch_tpu.ops.cost import ssd_cost_volume
from stereomatch_tpu.ops.disparity import winner_takes_all
from stereomatch_tpu.utils import backend

from . import sgm_kernel_model as model
from .conftest import STM_MAX_DISPARITY, synthetic_stereo_pair

D = STM_MAX_DISPARITY


@pytest.fixture(scope="module")
def volumes():
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=5)
    vol = ssd_cost_volume(left, right, max_disparity=D, kernel_size=3)
    return np.asarray(vol), left


@pytest.fixture
def cuda_lowering(monkeypatch):
    """Lower for CUDA on this CPU host: the FFI targets need no library to
    be lowered, only to be compiled."""
    monkeypatch.setattr(sgm_cuda, "_register", lambda: None)
    monkeypatch.setattr(backend, "kernel_supported", lambda device=None:
                        True)

    def lower(fn, *args):
        return fn.trace(*args).lower(lowering_platforms=("cuda",)).as_text()
    return lower


def _sweeps(text):
    """(target, attrs) of each FFI sweep in a lowered module, in order."""
    out = []
    for m in re.finditer(r"custom_call @(stm_sgm_sweep\w*)\((.*?)\) "
                         r"\{.*?mhlo.backend_config = \{(.*?)\}", text):
        attrs = dict(re.findall(r"(\w+) = ([-\w.+]+)", m.group(3)))
        out.append((m.group(1), m.group(2), attrs))
    return out


# -- the algorithm, through the numpy model ----------------------------------

def test_kernel_model_matches_xla_values(volumes):
    vol, left = volumes
    np.testing.assert_array_equal(model.aggregate(vol, left),
                                  np.asarray(semiglobal_aggregate(vol, left)))


@pytest.mark.parametrize("seed", [5, 11, 23])
def test_kernel_model_matches_xla_disparities(seed):
    left, right, _ = synthetic_stereo_pair(24, 40, D, seed=seed)
    vol = np.asarray(ssd_cost_volume(left, right, max_disparity=D,
                                     kernel_size=3))
    ref = np.asarray(winner_takes_all(semiglobal_aggregate(vol, left)))
    out = np.asarray(winner_takes_all(model.aggregate(vol, left)))
    np.testing.assert_array_equal(out, ref)


def test_kernel_model_nondefault_penalties(volumes):
    vol, left = volumes
    ref = np.asarray(semiglobal_aggregate(vol, left, penalty1=0.3,
                                          penalty2=0.9))
    np.testing.assert_array_equal(model.aggregate(vol, left, 0.3, 0.9), ref)


@pytest.mark.parametrize("seed_first", [True, False])
@pytest.mark.parametrize("shift", [0, 1, -1])
def test_kernel_model_carry_contract(shift, seed_first):
    """The per-tile contract the sharded exact/overlap paths rely on:
    contributions and final carry equal sgm_scan_with_carry's."""
    rng = np.random.default_rng(7 + shift)
    vol = rng.random((13, 17, 8), np.float32)
    img = rng.random((13, 17), np.float32)
    init_prev = rng.random((17, 8), np.float32)
    init_int = rng.random(17).astype(np.float32)
    (fin, fin_int), contrib = sgm_scan_with_carry(
        jnp.asarray(vol), jnp.asarray(img), 0.1, 0.2, shift,
        init_carry=(init_prev, init_int), seed_first=seed_first)
    out, final = model.sweep(vol, img, 0.1, 0.2, shift=shift,
                             init_prev=init_prev, init_int=init_int,
                             seed_first=seed_first)
    np.testing.assert_array_equal(out, np.asarray(contrib))
    np.testing.assert_array_equal(final, np.asarray(fin))
    np.testing.assert_array_equal(img[-1], np.asarray(fin_int))


@pytest.mark.parametrize("shift", [0, 1, -1])
@pytest.mark.parametrize("grid", [(5, 7), (7, 5), (1, 4), (4, 1), (6, 6)])
def test_line_enumeration_visits_every_cell_once(grid, shift):
    """Each traversal's lines (N + S - 1 for diagonals, the reference's
    enumeration) cover every pixel exactly once."""
    steps, paths = grid
    counts = model.visit_counts(steps, paths, shift)
    np.testing.assert_array_equal(counts, np.ones_like(counts))


def test_kernel_model_distinct_value_tiebreak():
    """On a volume of distinct values the WTA picks are identical."""
    rng = np.random.default_rng(3)
    vol = rng.permutation(20 * 28 * 12).reshape(20, 28, 12).astype(
        np.float32) / 97.0
    img = rng.random((20, 28), np.float32)
    np.testing.assert_array_equal(
        np.asarray(winner_takes_all(model.aggregate(vol, img))),
        np.asarray(winner_takes_all(semiglobal_aggregate(vol, img))))


def test_kernel_model_bf16_narrowing(volumes):
    """bf16 volumes widen exactly, accumulate in f32, narrow once at the
    end — the XLA path's result."""
    vol, left = volumes
    vol16 = jnp.asarray(vol, jnp.bfloat16)
    ref = semiglobal_aggregate(vol16, left)
    out = model.aggregate(np.asarray(vol16, np.float32), left)
    assert ref.dtype == jnp.bfloat16
    np.testing.assert_array_equal(
        np.asarray(jnp.asarray(out).astype(jnp.bfloat16), np.float32),
        np.asarray(ref, np.float32))


# -- the wrapper, lowered for CUDA -------------------------------------------

def test_cuda_lowering_eight_sweeps_in_order(cuda_lowering):
    text = cuda_lowering(sgm_cuda.semiglobal_aggregate_cuda,
                         jnp.zeros((9, 12, 16)), jnp.zeros((9, 12)))
    sweeps = _sweeps(text)
    assert [s[0] for s in sweeps] == (["stm_sgm_sweep"]
                                      + ["stm_sgm_sweep_acc"] * 7)
    got = [(int(a["transpose"]), int(a["flip_s"]), int(a["flip_n"]),
            int(a["shift"])) for _, _, a in sweeps]
    assert got == [tuple(int(v) for v in d) for d in sgm_cuda.DIRECTIONS]
    assert text.count("output_operand_aliases") == 7   # in-place accumulator


def test_cuda_lowering_bf16_streams_without_widening(cuda_lowering):
    text = cuda_lowering(sgm_cuda.semiglobal_aggregate_cuda,
                         jnp.zeros((9, 12, 16), jnp.bfloat16),
                         jnp.zeros((9, 12)))
    for _, operands, _ in _sweeps(text):
        assert operands.startswith("%arg0")       # the bf16 input itself
    assert re.search(r"return .*: tensor<9x12x16xbf16>", text)


def test_cuda_lowering_casts_integer_volume(cuda_lowering):
    text = cuda_lowering(sgm_cuda.semiglobal_aggregate_cuda,
                         jnp.zeros((9, 12, 16), jnp.int32),
                         jnp.zeros((9, 12)))
    assert "stablehlo.convert" in text
    assert "(tensor<9x12x16xf32>, tensor<9x12xf32>" in text


def test_cuda_lowering_vmap_batches_one_call(cuda_lowering):
    fn = jax.jit(jax.vmap(sgm_cuda.semiglobal_aggregate_cuda))
    text = cuda_lowering(fn, jnp.zeros((3, 9, 12, 16)), jnp.zeros((3, 9, 12)))
    sweeps = _sweeps(text)
    assert len(sweeps) == 8
    assert "(tensor<3x9x12x16xf32>, tensor<3x9x12xf32>" in text


def test_cuda_rejects_too_many_disparities(cuda_lowering):
    with pytest.raises(ValueError, match="at most 1024"):
        cuda_lowering(sgm_cuda.semiglobal_aggregate_cuda,
                      jnp.zeros((4, 5, 1025)), jnp.zeros((4, 5)))


@pytest.mark.parametrize("mode", ["exact", "overlap"])
def test_sharded_cuda_lowering_keeps_type_check(cuda_lowering, mode):
    """The FFI results carry their operands' shard_map varying-axes type,
    so the sharded program lowers with shard_map's type check on."""
    from stereomatch_tpu.parallel import make_mesh, make_sharded_estimate
    mesh = make_mesh(jax.devices()[:4], n_batch=2, n_tile=2)
    fn = make_sharded_estimate(mesh, max_disparity=8, kernel_size=3,
                               sgm_mode=mode, overlap=4, backend="cuda")
    x = jax.ShapeDtypeStruct((2, 16, 20), jnp.float32)
    assert len(_sweeps(cuda_lowering(fn, x, x))) == 8


def test_library_named_by_source_and_target(tmp_path, monkeypatch):
    src = tmp_path / "sgm_cuda.cu"
    src.write_text("// a")
    monkeypatch.setattr(sgm_cuda, "_SRC", src)
    first = sgm_cuda.library_path()
    src.write_text("// b")
    assert sgm_cuda.library_path() != first
    assert first.parent == sgm_cuda.BUILD_DIR
    monkeypatch.setattr(sgm_cuda, "_nvcc", lambda: "nvcc")
    cmd = sgm_cuda._compile_command(first)
    assert "arch=compute_90a,code=sm_90a" in cmd
    assert jax.ffi.include_dir() in cmd


# -- the choice of implementation --------------------------------------------

def test_resolve_backend_auto_is_xla_without_hopper():
    assert not backend.kernel_supported()
    assert backend.resolve_backend("auto") == "xla"
    assert backend.resolve_backend("xla") == "xla"


def test_resolve_backend_auto_takes_kernel_on_hopper(monkeypatch):
    monkeypatch.setattr(backend, "kernel_supported", lambda device=None:
                        True)
    assert backend.resolve_backend("auto") == "cuda"
    assert (backend.semiglobal_fn("cuda")
            is sgm_cuda.semiglobal_aggregate_cuda)
    assert backend.sgm_scan_fn("cuda") is sgm_cuda.sgm_scan_with_carry


def test_explicit_cuda_raises_without_hopper(volumes):
    vol, left = volumes
    with pytest.raises(RuntimeError, match="compute capability 9"):
        Semiglobal(backend="cuda")(vol, left)


def test_unknown_backend_raises():
    for name in ("pallas", "gpu", ""):
        with pytest.raises(ValueError, match="unknown backend"):
            backend.resolve_backend(name)


def test_kernel_supported_needs_compute_capability_9(monkeypatch):
    """Hopper (9.x) with a buildable library runs the kernel; a Hopper
    without nvcc raises instead of falling back to the XLA scans."""
    class Dev:
        def __init__(self, platform, cc):
            self.platform, self.compute_capability = platform, cc
    monkeypatch.setattr(sgm_cuda, "buildable", lambda: True)
    assert backend.kernel_supported(Dev("gpu", "9.0"))
    assert not backend.kernel_supported(Dev("gpu", "8.0"))
    assert not backend.kernel_supported(Dev("cpu", ""))
    monkeypatch.setattr(sgm_cuda, "buildable", lambda: False)
    with pytest.raises(RuntimeError, match="nvcc"):
        backend.kernel_supported(Dev("gpu", "9.0"))
    assert not backend.kernel_supported(Dev("gpu", "8.0"))


@pytest.mark.parametrize("name", ["auto", "cuda"])
def test_hopper_without_nvcc_raises_unless_xla(monkeypatch, name):
    """On a Hopper GPU that cannot build the kernel, ``auto`` and
    ``cuda`` raise; only an explicit ``xla`` runs the scans."""
    class Hopper:
        platform, compute_capability, device_kind = "gpu", "9.0", "H100"
    monkeypatch.setattr(backend.jax, "devices", lambda *a: [Hopper()])
    monkeypatch.setattr(sgm_cuda, "buildable", lambda: False)
    with pytest.raises(RuntimeError, match="backend='xla'"):
        backend.resolve_backend(name)
    assert backend.resolve_backend("xla") == "xla"
