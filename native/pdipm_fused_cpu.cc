// CPU target of the fused PDIPM (XLA FFI, platform "cpu"): runs the
// per-env routine of pdipm_fused.h with 16-entry arrays as lane vectors,
// one env after another.
// Build: g++ -std=c++17 -O2 -shared -fPIC -I<jax.ffi.include_dir()>
#include <cstdint>
#include <cstring>

#include "pdipm_fused.h"
#include "xla/ffi/api/ffi.h"

namespace ffi = xla::ffi;
namespace pf = pdipm_fused;

namespace {

constexpr int L = pf::LANES;

template <class T>
struct Lanes {
  T v[L];
  Lanes() = default;
  Lanes(T x) {  // NOLINT: broadcast a scalar, like a GPU lane's register
    for (int l = 0; l < L; ++l) v[l] = x;
  }
};
using VF = Lanes<float>;
using VI = Lanes<int>;
using VM = Lanes<bool>;

#define PF_LANEWISE(RET, OP, A, B)                        \
  inline RET operator OP(const A& a, const B& b) {        \
    RET r;                                                \
    for (int l = 0; l < L; ++l) r.v[l] = a.v[l] OP b.v[l]; \
    return r;                                             \
  }
PF_LANEWISE(VF, +, VF, VF)
PF_LANEWISE(VF, -, VF, VF)
PF_LANEWISE(VF, *, VF, VF)
PF_LANEWISE(VF, /, VF, VF)
PF_LANEWISE(VM, <, VF, VF)
PF_LANEWISE(VI, +, VI, VI)
PF_LANEWISE(VI, -, VI, VI)
PF_LANEWISE(VI, *, VI, VI)
PF_LANEWISE(VM, <, VI, VI)
PF_LANEWISE(VM, >=, VI, VI)
PF_LANEWISE(VM, ==, VI, VI)
PF_LANEWISE(VM, &, VM, VM)
PF_LANEWISE(VM, |, VM, VM)
#undef PF_LANEWISE

struct CpuK {
  using V = VF;
  using M = VM;
  using I = VI;
  VI lanes() const {
    VI r;
    for (int l = 0; l < L; ++l) r.v[l] = l;
    return r;
  }
  VF bcast(const VF& v, int src) const { return VF(v.v[src]); }
  float ubcast(const VF& v, int src) const { return v.v[src]; }
  VF perm(const VF& v, const VI& src) const {
    VF r;
    for (int l = 0; l < L; ++l) r.v[l] = v.v[src.v[l]];
    return r;
  }
  float usum(const VF& v) const {
    float s = 0.0f;
    for (int l = 0; l < L; ++l) s += v.v[l];
    return s;
  }
  float umin(const VF& v) const {
    float m = v.v[0];
    for (int l = 1; l < L; ++l) m = std::fmin(m, v.v[l]);
    return m;
  }
  int argmax(const VF& v) const {
    int p = 0;
    for (int l = 1; l < L; ++l)
      if (v.v[l] > v.v[p]) p = l;
    return p;
  }
  VF sel(const VM& m, const VF& a, const VF& b) const {
    VF r;
    for (int l = 0; l < L; ++l) r.v[l] = m.v[l] ? a.v[l] : b.v[l];
    return r;
  }
  VI seli(const VM& m, const VI& a, const VI& b) const {
    VI r;
    for (int l = 0; l < L; ++l) r.v[l] = m.v[l] ? a.v[l] : b.v[l];
    return r;
  }
  VF vabs(const VF& v) const {
    VF r;
    for (int l = 0; l < L; ++l) r.v[l] = std::fabs(v.v[l]);
    return r;
  }
  VF vmax(const VF& a, const VF& b) const {
    VF r;
    for (int l = 0; l < L; ++l) r.v[l] = std::fmax(a.v[l], b.v[l]);
    return r;
  }
  VF vmin(const VF& a, const VF& b) const {
    VF r;
    for (int l = 0; l < L; ++l) r.v[l] = std::fmin(a.v[l], b.v[l]);
    return r;
  }
  VF ld(const float* p) const {
    VF r;
    std::memcpy(r.v, p, sizeof(r.v));
    return r;
  }
  void st(float* p, const VF& v) const { std::memcpy(p, v.v, sizeof(v.v)); }
  VF gather(const float* in, long ins, const VI& e, const VM& valid) const {
    VF r;
    for (int l = 0; l < L; ++l) r.v[l] = valid.v[l] ? in[e.v[l] * ins] : 0.0f;
    return r;
  }
};

}  // namespace

static ffi::Error PdipmFusedCpu(ffi::Buffer<ffi::F32> packed,
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
  const pf::Params prm{beta, delta, frac, alpha_min, sz_floor, iterations};
  const float* in = packed.typed_data();
  for (long b = 0; b < B; ++b) {
    pf::Solver<CpuK> s(CpuK{}, in + b, B, scratch->typed_data() + b * L,
                       B * L, horizon, prm);
    s.solve();
    s.write_output(out->typed_data() + b * L, B * L);
  }
  return ffi::Error::Success();
}

XLA_FFI_DEFINE_HANDLER_SYMBOL(
    PdipmFusedRicAugCpu, PdipmFusedCpu,
    ffi::Ffi::Bind()
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
