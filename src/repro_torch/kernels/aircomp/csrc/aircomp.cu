// Fused AirComp aggregation (paper Eq. 5 -> 8) for Hopper, sm_90a.
//
//   yhat_b[d] = sum_i coeff_bi * g_bi[d] - W_b * M_b + (sqrt(max(V_b, EPS)) / a_b) * z_b[d] + M_b,
//   W_b = sum_i coeff_bi
//
// for every trial b of a batch (a lattice round's cells); one round is the
// batch of one trial. Replaces the TPU kernels
// src/repro/kernels/aircomp/kernel.py:132 `aircomp_fused` (body
// `_aircomp_kernel`, :50) and :82 `aircomp_fused_batch` (body
// `_aircomp_batch_kernel`, :65).
//
// Bound: bytes. Each call reads g (B*N*D*4 B) and z and writes yhat
// (2*B*D*4 B), and reads coeff and the scalars (B*(N+3)*4 B); it does
// 2*B*N*D flops, far below the fp32 rate for that traffic. At one CNN round
// (B=1, N=30, D=258,634) that is 33,105,284 B, 9.9 us at the H100's
// 3.35 TB/s; at the CNN lattice's 15 cells, 496.6 MB, 0.148 ms.
//
// Design: one pass over g. Each thread owns VEC consecutive elements of D of
// one trial (the trial is blockIdx.y) and loops over the N devices,
// accumulating in fp32, so every byte of g is read once, coalesced across
// the warp. VEC is 4 (16-byte loads) when D and every stride keep each row
// 16-byte aligned, else 2, else 1; threads past D exit (the ragged tail).
// Nothing is padded or copied: g, z and yhat are addressed through the
// trial and row strides they are given, so a strided view is read in
// place. The scalars M_g, V_g and a are (B,) device arrays read at the
// block's trial, so the caller never syncs to pass them, and each thread
// sums W from its trial's coeff row itself (N loads that hit L1).
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-30f;  // repro_torch.core.numerics.EPS
constexpr int kThreads = 256;
constexpr long long kMaxGridY = 65535;  // trials beyond it loop in the block

template <int VEC> struct VecType;
template <> struct VecType<1> { using T = float; };
template <> struct VecType<2> { using T = float2; };
template <> struct VecType<4> { using T = float4; };

template <int VEC>
__global__ void __launch_bounds__(kThreads) aircomp_fused_kernel(
    const float* __restrict__ g, long long g_trial, long long g_row,
    const float* __restrict__ coeff, const float* __restrict__ z, long long z_trial,
    const float* __restrict__ m_g_ptr, const float* __restrict__ v_g_ptr,
    const float* __restrict__ a_ptr, float* __restrict__ out, long long out_trial,
    long long trials, int n, long long d) {
  using V = typename VecType<VEC>::T;
  const long long base =
      (static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x) * VEC;
  if (base >= d) return;  // D % VEC == 0, so a live thread owns VEC elements

  for (long long b = blockIdx.y; b < trials; b += gridDim.y) {
    const float* gb = g + b * g_trial;
    const float* cb = coeff + b * n;
    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    float w = 0.f;
    for (int i = 0; i < n; ++i) {
      const float c = cb[i];
      w += c;
      const V gv = *reinterpret_cast<const V*>(gb + i * g_row + base);
      const float* gf = reinterpret_cast<const float*>(&gv);
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[j] += c * gf[j];
    }

    const float m_g = m_g_ptr[b];
    const float noise_scale = sqrtf(fmaxf(v_g_ptr[b], kEps)) / a_ptr[b];
    const V zv = *reinterpret_cast<const V*>(z + b * z_trial + base);
    const float* zf = reinterpret_cast<const float*>(&zv);
    V ov;
    float* of = reinterpret_cast<float*>(&ov);
#pragma unroll
    for (int j = 0; j < VEC; ++j) of[j] = acc[j] - w * m_g + noise_scale * zf[j] + m_g;
    *reinterpret_cast<V*>(out + b * out_trial + base) = ov;
  }
}

template <int VEC>
void launch(const float* g, long long g_trial, long long g_row, const float* coeff,
            const float* z, long long z_trial, const float* m_g, const float* v_g,
            const float* a, float* out, long long out_trial, long long trials, int n,
            long long d, cudaStream_t stream) {
  const long long groups = d / VEC;
  const dim3 blocks(static_cast<unsigned>((groups + kThreads - 1) / kThreads),
                    static_cast<unsigned>(trials < kMaxGridY ? trials : kMaxGridY));
  aircomp_fused_kernel<VEC><<<blocks, kThreads, 0, stream>>>(
      g, g_trial, g_row, coeff, z, z_trial, m_g, v_g, a, out, out_trial, trials, n, d);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// g is (trials, n, d) with trial stride g_trial and row stride g_row
// (elements, unit stride along d); coeff is (trials, n) contiguous; z and
// out are (trials, d) with trial strides z_trial and out_trial; m_g, v_g
// and a are (trials,) contiguous. vec must divide d and every stride.
extern "C" int aircomp_fused_batch_f32(
    const float* g, long long g_trial, long long g_row, const float* coeff,
    const float* z, long long z_trial, const float* m_g, const float* v_g,
    const float* a, float* out, long long out_trial, long long trials, int n,
    long long d, int vec, void* stream) {
  if (trials < 1 || n < 1 || d < 1 || g_row < 0 || g_trial < 0 || z_trial < 0 ||
      out_trial < d || d % vec != 0 || g_row % vec != 0 || g_trial % vec != 0 ||
      z_trial % vec != 0 || out_trial % vec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec) {
    case 4: launch<4>(g, g_trial, g_row, coeff, z, z_trial, m_g, v_g, a, out, out_trial, trials, n, d, s); break;
    case 2: launch<2>(g, g_trial, g_row, coeff, z, z_trial, m_g, v_g, a, out, out_trial, trials, n, d, s); break;
    case 1: launch<1>(g, g_trial, g_row, coeff, z, z_trial, m_g, v_g, a, out, out_trial, trials, n, d, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One round: the batch of one trial. g is (n, d) with row stride ld.
extern "C" int aircomp_fused_f32(const float* g, long long ld, const float* coeff,
                                 const float* z, const float* m_g, const float* v_g,
                                 const float* a, float* out, int n, long long d,
                                 int vec, void* stream) {
  if (ld < d) return static_cast<int>(cudaErrorInvalidValue);
  return aircomp_fused_batch_f32(g, 0, ld, coeff, z, 0, m_g, v_g, a, out, d, 1, n, d,
                                 vec, stream);
}

extern "C" const char* aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
