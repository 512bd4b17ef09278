// SGM path sweeps for NVIDIA Hopper (sm_90a), called from JAX through the
// XLA FFI (route: CUDA C++ compiled with nvcc; ops/sgm_cuda.py builds,
// registers and calls it).
//
// One sweep = one path direction of ops/aggregation.py::sgm_scan_with_carry
// over a volume addressed as [S, N, D]: S is the scan axis (path
// direction), N the parallel paths, D the disparities.  The reference's
// GPU design (semiglobal_gpu.cu) walks each path with one CUDA block and a
// __syncthreads min-reduction per step; here each path is walked by ONE
// WARP, D spread over its 32 lanes (VPT contiguous values per lane), and
// the whole path length is a loop inside the warp:
//   * d-1 / d+1 band neighbours inside a lane are registers, across lanes
//     one __shfl_up_sync / __shfl_down_sync each;
//   * min over D is a 5-level __shfl_xor_sync butterfly;
//   * each step reads one contiguous [D] row of the cost volume, prefetched
//     PF steps ahead into a register ring (the loads do not depend on the
//     recurrence, so their latency hides behind the previous steps).
// Diagonal families are enumerated as the reference does: N + S - 1
// independent lines per direction (paths entering through the first scan
// row and through the side edge the carry shift exposes), so no warp ever
// waits on another.  The horizontal family is addressed through strides
// (scan along W of an [H, W, D] volume), without a transposed copy.
//
// Arithmetic is the XLA formulation's, operation for operation, so the two
// round identically: normalize first (prev - min), band =
// min(min(prevn, up + P1), min(down + P1, P2_adj)), L = C + band, with
// P2_adj = max(P1, P2 / |dI|).  min/max propagate NaN like XLA's
// (min.NaN / max.NaN) and division is XLA's div.full.f32.  Accumulation
// across directions is out = acc + L in the caller's direction order, which
// is the XLA sum's association.

#include <cuda_runtime.h>

#include <cstdint>
#include <string>

#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr unsigned kFullMask = 0xffffffffu;

struct Sweep {
  int64_t S, N, D;
  int64_t stride_s, stride_n;     // volume element strides of (step, path)
  int64_t istride_s, istride_n;   // image element strides of (step, path)
  int64_t lines;                  // lines (paths) per batch element
  int64_t batch;
  int64_t out_batch;              // batch stride of out / acc
  int64_t vol_batch, img_batch;   // input batch strides (0 = shared)
  int64_t init_batch, int_batch, seed_batch;
  int flip_s, flip_n, shift;
  float p1, p2;
};

__device__ __forceinline__ float min_nan(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float max_nan(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

// XLA's GPU backend lowers f32 division to div.full.f32 (LLVM's
// -nvptx-prec-divf32=1), not the IEEE div.rn.f32 that `/` compiles to here;
// dividing the same way keeps P2_adj, and so every path cost, bit-equal.
__device__ __forceinline__ float div_full(float a, float b) {
  float r;
  asm("div.full.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {  // bfloat16 bits
  return __uint_as_float(static_cast<uint32_t>(v) << 16);
}

template <typename T, int VPT, int PF, bool ACC>
__global__ void __launch_bounds__(kWarpsPerBlock * 32)
sgm_sweep_kernel(const T* __restrict__ cost, const float* __restrict__ image,
                 const float* __restrict__ init_prev,
                 const float* __restrict__ init_int,
                 const int32_t* __restrict__ seed, const float* acc,
                 float* out, float* __restrict__ final_prev, Sweep g) {
  const float inf = __int_as_float(0x7f800000);
  const int lane = threadIdx.x & 31;
  const int64_t gline =
      static_cast<int64_t>(blockIdx.x) * kWarpsPerBlock + (threadIdx.x >> 5);
  if (gline >= g.batch * g.lines) return;
  const int64_t b = gline / g.lines;
  const int64_t line = gline - b * g.lines;

  // Line start (t0, n0) and length in logical (unflipped) coordinates.
  int64_t t0 = 0, n0 = line;
  if (g.shift != 0 && line >= g.N) {
    t0 = line - g.N + 1;
    n0 = g.shift > 0 ? 0 : g.N - 1;
  }
  int64_t len = g.S - t0;
  if (g.shift > 0) len = min(len, g.N - n0);
  if (g.shift < 0) len = min(len, n0 + 1);

  cost += b * g.vol_batch;
  out += b * g.out_batch;
  if (ACC) acc += b * g.out_batch;
  image += b * g.img_batch;
  const int d0 = lane * VPT;

  float prev[VPT];
  float prev_int = 0.f;
  bool start = true;
  if (t0 == 0 && seed[b * g.seed_batch] == 0) {
    const int64_t pn = n0 - g.shift;
    if (pn >= 0 && pn < g.N) {
      start = false;
      const float* ip = init_prev + b * g.init_batch + pn * g.D;
#pragma unroll
      for (int j = 0; j < VPT; ++j)
        prev[j] = d0 + j < g.D ? ip[d0 + j] : inf;
      prev_int = init_int[b * g.int_batch + pn];
    }
  }

  auto offsets = [&](int64_t k, int64_t& voff, int64_t& ioff) {
    int64_t t = t0 + k;
    int64_t n = n0 + g.shift * k;
    if (g.flip_s) t = g.S - 1 - t;
    if (g.flip_n) n = g.N - 1 - n;
    voff = t * g.stride_s + n * g.stride_n;
    ioff = t * g.istride_s + n * g.istride_n;
  };

  float cbuf[PF][VPT];
  float abuf[ACC ? PF : 1][VPT];
  float ibuf[PF];
  auto load = [&](int64_t k, int q) {
    if (k >= len) return;
    int64_t voff, ioff;
    offsets(k, voff, ioff);
#pragma unroll
    for (int j = 0; j < VPT; ++j) {
      const bool ok = d0 + j < g.D;
      cbuf[q][j] = ok ? widen(cost[voff + d0 + j]) : inf;
      if (ACC) abuf[q][j] = ok ? acc[voff + d0 + j] : 0.f;
    }
    ibuf[q] = image[ioff];
  };
#pragma unroll
  for (int q = 0; q < PF; ++q) load(q, q);

  for (int64_t kk = 0; kk < len; kk += PF) {
#pragma unroll
    for (int q = 0; q < PF; ++q) {
      const int64_t k = kk + q;
      if (k >= len) break;
      float c[VPT], a[VPT];
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        c[j] = cbuf[q][j];
        a[j] = ACC ? abuf[q][j] : 0.f;
      }
      const float img = ibuf[q];
      load(k + PF, q);

      float L[VPT];
      if (start) {
#pragma unroll
        for (int j = 0; j < VPT; ++j) L[j] = c[j];
        start = false;
      } else {
        float m = prev[0];
#pragma unroll
        for (int j = 1; j < VPT; ++j) m = min_nan(m, prev[j]);
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          m = min_nan(m, __shfl_xor_sync(kFullMask, m, o));
        const float p2a =
            max_nan(g.p1, div_full(g.p2, fabsf(img - prev_int)));
        float pn[VPT];
#pragma unroll
        for (int j = 0; j < VPT; ++j) pn[j] = prev[j] - m;
        float left = __shfl_up_sync(kFullMask, pn[VPT - 1], 1);
        const float right = __shfl_down_sync(kFullMask, pn[0], 1);
        if (lane == 0) left = inf;
#pragma unroll
        for (int j = 0; j < VPT; ++j) {
          const float up = j > 0 ? pn[j - 1] : left;
          float down = j < VPT - 1 ? pn[j + 1] : right;
          if (d0 + j + 1 >= g.D) down = inf;
          const float band = min_nan(min_nan(pn[j], up + g.p1),
                                     min_nan(down + g.p1, p2a));
          L[j] = c[j] + band;
        }
      }

      int64_t voff, ioff;
      offsets(k, voff, ioff);
#pragma unroll
      for (int j = 0; j < VPT; ++j) {
        if (d0 + j < g.D) out[voff + d0 + j] = ACC ? a[j] + L[j] : L[j];
        prev[j] = d0 + j < g.D ? L[j] : inf;
      }
      prev_int = img;
    }
  }

  if (t0 + len == g.S) {  // this line holds the carry of its last position
    const int64_t n_last = n0 + g.shift * (len - 1);
    float* fp = final_prev + b * g.N * g.D + n_last * g.D;
#pragma unroll
    for (int j = 0; j < VPT; ++j)
      if (d0 + j < g.D) fp[d0 + j] = prev[j];
  }
}

template <typename T, int VPT, bool ACC>
cudaError_t launch_vpt(cudaStream_t stream, const void* cost,
                       const float* image, const float* init_prev,
                       const float* init_int, const int32_t* seed,
                       const float* acc, float* out, float* final_prev,
                       const Sweep& g) {
  constexpr int PF = VPT >= 16 ? 2 : 4;
  const int64_t warps = g.batch * g.lines;
  const int64_t blocks = (warps + kWarpsPerBlock - 1) / kWarpsPerBlock;
  sgm_sweep_kernel<T, VPT, PF, ACC>
      <<<static_cast<unsigned>(blocks), kWarpsPerBlock * 32, 0, stream>>>(
          static_cast<const T*>(cost), image, init_prev, init_int, seed, acc,
          out, final_prev, g);
  return cudaGetLastError();
}

template <typename T, bool ACC>
cudaError_t launch(cudaStream_t stream, const void* cost, const float* image,
                   const float* init_prev, const float* init_int,
                   const int32_t* seed, const float* acc, float* out,
                   float* final_prev, const Sweep& g) {
  const int64_t vpt = (g.D + 31) / 32;
#define STM_SGM_CASE(V)                                                   \
  if (vpt <= V)                                                           \
    return launch_vpt<T, V, ACC>(stream, cost, image, init_prev, init_int, \
                                 seed, acc, out, final_prev, g);
  STM_SGM_CASE(1)
  STM_SGM_CASE(2)
  STM_SGM_CASE(4)
  STM_SGM_CASE(8)
  STM_SGM_CASE(16)
  STM_SGM_CASE(32)
#undef STM_SGM_CASE
  return cudaErrorInvalidValue;
}

// Batch stride of a buffer holding `count` elements of `per` each: `per`
// when it carries the whole batch, 0 when it is shared (vmap's
// expand_dims leaves unbatched operands with a leading 1).
int64_t batch_stride(int64_t count, int64_t per, int64_t batch) {
  return (batch > 1 && count == batch * per) ? per : 0;
}

ffi::Error sweep_impl(cudaStream_t stream, ffi::AnyBuffer cost,
                      ffi::Buffer<ffi::F32> image,
                      ffi::Buffer<ffi::F32> init_prev,
                      ffi::Buffer<ffi::F32> init_int,
                      ffi::Buffer<ffi::S32> seed, const float* acc,
                      ffi::Result<ffi::Buffer<ffi::F32>> out,
                      ffi::Result<ffi::Buffer<ffi::F32>> final_prev,
                      int32_t transpose, int32_t flip_s, int32_t flip_n,
                      int32_t shift, float p1, float p2) {
  const auto dims = cost.dimensions();
  if (dims.size() < 3)
    return ffi::Error::InvalidArgument("cost volume must have rank >= 3");
  const int64_t rows = dims[dims.size() - 3];
  const int64_t cols = dims[dims.size() - 2];
  const int64_t D = dims[dims.size() - 1];
  if (D > 1024)
    return ffi::Error::InvalidArgument(
        "the CUDA SGM sweep handles at most 1024 disparities");
  Sweep g;
  g.D = D;
  if (transpose) {  // scan along axis -2 (W of an [H, W, D] volume)
    g.S = cols, g.N = rows;
    g.stride_s = D, g.stride_n = cols * D;
    g.istride_s = 1, g.istride_n = cols;
  } else {
    g.S = rows, g.N = cols;
    g.stride_s = cols * D, g.stride_n = D;
    g.istride_s = cols, g.istride_n = 1;
  }
  const int64_t per_vol = rows * cols * D;
  g.batch = per_vol ? static_cast<int64_t>(out->element_count()) / per_vol
                    : 0;
  if (g.batch == 0 || g.S == 0 || g.N == 0 || D == 0)
    return ffi::Error::Success();
  g.out_batch = per_vol;
  g.vol_batch = batch_stride(cost.element_count(), per_vol, g.batch);
  g.img_batch = batch_stride(image.element_count(), rows * cols, g.batch);
  g.init_batch = batch_stride(init_prev.element_count(), g.N * D, g.batch);
  g.int_batch = batch_stride(init_int.element_count(), g.N, g.batch);
  g.seed_batch = batch_stride(seed.element_count(), 1, g.batch);
  g.flip_s = flip_s, g.flip_n = flip_n, g.shift = shift;
  g.p1 = p1, g.p2 = p2;
  g.lines = shift == 0 ? g.N : g.N + g.S - 1;

  cudaError_t err;
  const bool is_bf16 = cost.element_type() == ffi::DataType::BF16;
  if (!is_bf16 && cost.element_type() != ffi::DataType::F32)
    return ffi::Error::InvalidArgument("cost volume must be f32 or bf16");
#define STM_SGM_ARGS                                                      \
  stream, cost.untyped_data(), image.typed_data(), init_prev.typed_data(), \
      init_int.typed_data(), seed.typed_data(), acc, out->typed_data(),    \
      final_prev->typed_data(), g
  if (is_bf16)
    err = acc ? launch<uint16_t, true>(STM_SGM_ARGS)
              : launch<uint16_t, false>(STM_SGM_ARGS);
  else
    err = acc ? launch<float, true>(STM_SGM_ARGS)
              : launch<float, false>(STM_SGM_ARGS);
#undef STM_SGM_ARGS
  if (err != cudaSuccess)
    return ffi::Error::Internal(std::string("SGM sweep launch failed: ") +
                                cudaGetErrorString(err));
  return ffi::Error::Success();
}

ffi::Error sweep(cudaStream_t stream, ffi::AnyBuffer cost,
                 ffi::Buffer<ffi::F32> image, ffi::Buffer<ffi::F32> init_prev,
                 ffi::Buffer<ffi::F32> init_int, ffi::Buffer<ffi::S32> seed,
                 ffi::Result<ffi::Buffer<ffi::F32>> out,
                 ffi::Result<ffi::Buffer<ffi::F32>> final_prev,
                 int32_t transpose, int32_t flip_s, int32_t flip_n,
                 int32_t shift, float p1, float p2) {
  return sweep_impl(stream, cost, image, init_prev, init_int, seed, nullptr,
                    out, final_prev, transpose, flip_s, flip_n, shift, p1,
                    p2);
}

ffi::Error sweep_acc(cudaStream_t stream, ffi::AnyBuffer cost,
                     ffi::Buffer<ffi::F32> image,
                     ffi::Buffer<ffi::F32> init_prev,
                     ffi::Buffer<ffi::F32> init_int,
                     ffi::Buffer<ffi::S32> seed, ffi::Buffer<ffi::F32> acc,
                     ffi::Result<ffi::Buffer<ffi::F32>> out,
                     ffi::Result<ffi::Buffer<ffi::F32>> final_prev,
                     int32_t transpose, int32_t flip_s, int32_t flip_n,
                     int32_t shift, float p1, float p2) {
  return sweep_impl(stream, cost, image, init_prev, init_int, seed,
                    acc.typed_data(), out, final_prev, transpose, flip_s,
                    flip_n, shift, p1, p2);
}

}  // namespace

#define STM_SGM_ATTRS                \
  .Attr<int32_t>("transpose")        \
      .Attr<int32_t>("flip_s")       \
      .Attr<int32_t>("flip_n")       \
      .Attr<int32_t>("shift")        \
      .Attr<float>("p1")             \
      .Attr<float>("p2")

XLA_FFI_DEFINE_HANDLER_SYMBOL(StmSgmSweep, sweep,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                      STM_SGM_ATTRS);

XLA_FFI_DEFINE_HANDLER_SYMBOL(StmSgmSweepAcc, sweep_acc,
                              ffi::Ffi::Bind()
                                  .Ctx<ffi::PlatformStream<cudaStream_t>>()
                                  .Arg<ffi::AnyBuffer>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Arg<ffi::Buffer<ffi::S32>>()
                                  .Arg<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                  .Ret<ffi::Buffer<ffi::F32>>()
                                      STM_SGM_ATTRS);
