// CUDA target of the fused PDIPM (XLA FFI, platform "CUDA"): the per-env
// routine of pdipm_fused.h with a lane vector held as one float per thread,
// 16 threads per env, two envs per warp. Cross-lane operations are warp
// shuffles within the env's 16-lane segment; all Newton iterations of a
// solve run in one launch. Lane vectors sit in (n, B, 16) buffers, so a
// warp's load or store touches 32 consecutive words.
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
//        -Xcompiler -fPIC -I<jax.ffi.include_dir()>
#include <cstdint>

#include <cuda_runtime.h>

#include "pdipm_fused.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
namespace pf = pdipm_fused;

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int L = pf::LANES;
constexpr int kEnvsPerBlock = 8;  // 128 threads per block

struct GpuK {
  using V = float;
  using M = bool;
  using I = int;
  int lane;
  __device__ int lanes() const { return lane; }
  __device__ float bcast(float v, int src) const {
    return __shfl_sync(kFull, v, src, L);
  }
  __device__ float ubcast(float v, int src) const {
    return __shfl_sync(kFull, v, src, L);
  }
  __device__ float perm(float v, int src) const {
    return __shfl_sync(kFull, v, src, L);
  }
  // Butterfly reductions: every lane ends with the same value (IEEE
  // addition and min are commutative, so each lane sums in the same pairs).
  __device__ float usum(float v) const {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) v += __shfl_xor_sync(kFull, v, o, L);
    return v;
  }
  __device__ float umin(float v) const {
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1)
      v = fminf(v, __shfl_xor_sync(kFull, v, o, L));
    return v;
  }
  __device__ int argmax(float v) const {
    int i = lane;
#pragma unroll
    for (int o = L / 2; o > 0; o >>= 1) {
      const float v2 = __shfl_xor_sync(kFull, v, o, L);
      const int i2 = __shfl_xor_sync(kFull, i, o, L);
      const bool take = v2 > v || (v2 == v && i2 < i);
      v = take ? v2 : v;
      i = take ? i2 : i;
    }
    return i;
  }
  __device__ float sel(bool m, float a, float b) const { return m ? a : b; }
  __device__ int seli(bool m, int a, int b) const { return m ? a : b; }
  __device__ float vabs(float v) const { return fabsf(v); }
  __device__ float vmax(float a, float b) const { return fmaxf(a, b); }
  __device__ float vmin(float a, float b) const { return fminf(a, b); }
  __device__ float ld(const float* p) const { return *p; }
  __device__ void st(float* p, float v) const { *p = v; }
  __device__ float gather(const float* in, long ins, int e, bool valid) const {
    return valid ? __ldg(in + e * ins) : 0.0f;
  }
};

// The kernel takes 255 registers a thread (the constant matrices stay in
// registers); capping it at 168 or 128 to fit more envs per SM spills and
// measured slower on the H100.
__global__ void __launch_bounds__(kEnvsPerBlock * L)
pdipm_fused_kernel(const float* __restrict__ in, float* __restrict__ out,
                   float* __restrict__ scratch, long B, int T,
                   pf::Params prm) {
  // B is a multiple of kEnvsPerBlock, so every lane of every warp is
  // active for the shuffles.
  const int lane = threadIdx.x % L;
  const long b = (long)blockIdx.x * kEnvsPerBlock + threadIdx.x / L;
  pf::Solver<GpuK> s(GpuK{lane}, in + b, B, scratch + b * L + lane, B * L,
                     T, prm);
  s.solve();
  s.write_output(out + b * L + lane, B * L);
}

}  // namespace

static ffi::Error PdipmFusedCuda(cudaStream_t stream,
                                 ffi::Buffer<ffi::F32> packed,
                                 ffi::ResultBuffer<ffi::F32> out,
                                 ffi::ResultBuffer<ffi::F32> scratch,
                                 int32_t horizon, int32_t iterations,
                                 float beta, float delta, float frac,
                                 float alpha_min, float sz_floor) {
  const auto dims = packed.dimensions();
  if (dims.size() != 2 || dims[0] != pf::input_len(horizon))
    return ffi::Error::InvalidArgument("packed input must be (input_len, B)");
  const long B = dims[1];
  const auto od = out->dimensions(), sd = scratch->dimensions();
  if (od.size() != 3 || od[0] != pf::output_lvs(horizon) || od[1] != B ||
      od[2] != L || sd.size() != 3 || sd[0] != pf::scratch_lvs(horizon) ||
      sd[1] != B || sd[2] != L)
    return ffi::Error::InvalidArgument("output/scratch shape mismatch");
  if (B % kEnvsPerBlock != 0)
    return ffi::Error::InvalidArgument("batch must be padded to 8 envs");
  if (B == 0) return ffi::Error::Success();
  const pf::Params prm{beta, delta, frac, alpha_min, sz_floor, iterations};
  pdipm_fused_kernel<<<(unsigned)(B / kEnvsPerBlock), kEnvsPerBlock * L, 0,
                       stream>>>(packed.typed_data(), out->typed_data(),
                                 scratch->typed_data(), B, horizon, prm);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess)
    return ffi::Error::Internal(cudaGetErrorString(err));
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    PdipmFusedRicAugCuda, PdipmFusedCuda,
    ffi::Ffi::Bind()
        .Ctx<ffi::PlatformStream<cudaStream_t>>()
        .Arg<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Ret<ffi::Buffer<ffi::F32>>()
        .Attr<int32_t>("horizon")
        .Attr<int32_t>("iterations")
        .Attr<float>("beta")
        .Attr<float>("delta")
        .Attr<float>("frac_to_boundary")
        .Attr<float>("alpha_min")
        .Attr<float>("sz_floor"));
