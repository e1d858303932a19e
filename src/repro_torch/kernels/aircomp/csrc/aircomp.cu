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
// 2*B*N*D flops, 0.5 a byte: no product for the tensor cores. At one CNN
// round (B=1, N=30, D=258,634) that is 33,105,284 B, 9.9 us at the H100's
// 3.35 TB/s; at the CNN lattice's 15 cells, 496.6 MB, 0.148 ms. What the
// design has to supply is bytes in flight: by Little's law 3.35 TB/s at
// HBM's loaded latency needs megabytes of loads outstanding across the card.
//
// Design: one pass over g. Each thread owns VEC consecutive elements of D of
// one trial (the trial is blockIdx.y) and sums its N devices in order,
// i = 0 .. N-1, one fp32 FMA chain per element, so every byte of g is read
// once, coalesced across the warp, and the order of summation is a plain
// loop's. The rows are loaded in groups of ROWS: all of a group's loads (g
// and coeff) are issued into registers before its FMAs, and the next
// group's before the current group's FMAs, so 2*ROWS rows are in flight a
// thread (the z load and the scalars go out with the first group; the tail
// group of N mod ROWS rows is masked). ROWS is 8 (62 registers at VEC 2, so
// four 256-thread blocks an SM and one CNN round in one wave), or 16 where
// the grid is too small to fill the SMs anyway (every row of up to 32
// devices in flight at once). The caller picks ROWS and the geometry
// (kernel.py `launch_geometry`): 256 threads a block unless the grid would
// then hold fewer than two blocks an SM, then 128 or 64. VEC is 4 (16-byte
// loads) when D and every stride keep each row 16-byte aligned, else 2,
// else 1; threads past D exit (the ragged tail).
//
// Neither TMA nor cp.async: at the port's D = 2 (mod 4) every odd device
// row starts on an 8-byte boundary only, and TMA's bulk copies need 16-byte
// addresses and sizes; an 8-byte load coalesced over a warp already moves
// 256 B an instruction; and a shared-memory ring would only re-stage what
// registers hold. Splitting the device axis over a block's warps (partial
// sums added through shared memory, another order of summation) measured
// no faster than groups of 16 at logreg's width, and its registers slowed
// the CNN round: it is not used.
//
// Nothing is padded or copied: g, z and yhat are addressed through the
// trial and row strides they are given, so a strided view is read in
// place. The scalars M_g, V_g and a are (B,) device arrays read at the
// block's trial, so the caller never syncs to pass them, and each thread
// sums W from its trial's coeff row itself (loads that hit L1).
#include <cuda_runtime.h>

namespace {

constexpr float kEps = 1e-30f;  // repro_torch.core.numerics.EPS
constexpr int kMaxThreads = 256;  // kernel.py MAX_THREADS
constexpr long long kMaxGridY = 65535;  // trials beyond it loop in the block

template <int VEC> struct VecType;
template <> struct VecType<1> { using T = float; };
template <> struct VecType<2> { using T = float2; };
template <> struct VecType<4> { using T = float4; };

// Issue the loads of rows i0 .. i0+ROWS-1 (those below n) of one thread's
// columns and their coefficients; the rest are zero and never summed.
template <int VEC, int ROWS>
__device__ __forceinline__ void load_group(const float* __restrict__ gb, long long g_row,
                                           const float* __restrict__ cb, int i0, int n,
                                           typename VecType<VEC>::T (&rows)[ROWS],
                                           float (&c)[ROWS]) {
  using V = typename VecType<VEC>::T;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    const int i = i0 + r;
    if (i < n) {
      rows[r] = *reinterpret_cast<const V*>(gb + i * g_row);
      c[r] = cb[i];
    } else {
      rows[r] = V{};
      c[r] = 0.f;
    }
  }
}

template <int VEC, int ROWS>
__global__ void __launch_bounds__(kMaxThreads) aircomp_fused_kernel(
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
    const float* gb = g + b * g_trial + base;
    const float* cb = coeff + b * n;
    V cur[ROWS], nxt[ROWS];
    float c_cur[ROWS], c_nxt[ROWS];
    load_group<VEC, ROWS>(gb, g_row, cb, 0, n, cur, c_cur);
    const V zv = *reinterpret_cast<const V*>(z + b * z_trial + base);
    const float m_g = m_g_ptr[b], v_g = v_g_ptr[b], a = a_ptr[b];

    float acc[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[j] = 0.f;
    float w = 0.f;
    for (int i0 = 0; i0 < n; i0 += ROWS) {
      // the next group's loads are in flight while this group is summed
      load_group<VEC, ROWS>(gb, g_row, cb, i0 + ROWS, n, nxt, c_nxt);
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        if (i0 + r < n) {  // the masked tail adds nothing, not even a zero
          const float* gf = reinterpret_cast<const float*>(&cur[r]);
          w += c_cur[r];
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[j] += c_cur[r] * gf[j];
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        cur[r] = nxt[r];
        c_cur[r] = c_nxt[r];
      }
    }

    const float noise_scale = sqrtf(fmaxf(v_g, kEps)) / a;
    const float* zf = reinterpret_cast<const float*>(&zv);
    V ov;
    float* of = reinterpret_cast<float*>(&ov);
#pragma unroll
    for (int j = 0; j < VEC; ++j) of[j] = acc[j] - w * m_g + noise_scale * zf[j] + m_g;
    *reinterpret_cast<V*>(out + b * out_trial + base) = ov;
  }
}

// The operands of one launch, as the C entries below describe them.
struct Operands {
  const float* g; long long g_trial, g_row;
  const float* coeff;
  const float* z; long long z_trial;
  const float *m_g, *v_g, *a;
  float* out; long long out_trial;
  long long trials; int n; long long d;
};

template <int VEC, int ROWS>
void launch(const Operands& p, dim3 grid, int threads, cudaStream_t stream) {
  aircomp_fused_kernel<VEC, ROWS><<<grid, threads, 0, stream>>>(
      p.g, p.g_trial, p.g_row, p.coeff, p.z, p.z_trial, p.m_g, p.v_g, p.a, p.out,
      p.out_trial, p.trials, p.n, p.d);
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// g is (trials, n, d) with trial stride g_trial and row stride g_row
// (elements, unit stride along d); coeff is (trials, n) contiguous; z and
// out are (trials, d) with trial strides z_trial and out_trial; m_g, v_g
// and a are (trials,) contiguous. vec must divide d and every stride. Each
// thread loads its rows in groups of `rows` (8 or 16). The grid is
// blocks_x x blocks_y blocks of `threads` (a warp multiple, at most
// kMaxThreads); it must cover d / vec column groups and at most `trials`
// (and 65,535) trials at once.
extern "C" int aircomp_fused_batch_f32(
    const float* g, long long g_trial, long long g_row, const float* coeff,
    const float* z, long long z_trial, const float* m_g, const float* v_g,
    const float* a, float* out, long long out_trial, long long trials, int n,
    long long d, int vec, int rows, int threads, int blocks_x, int blocks_y,
    void* stream) {
  if (trials < 1 || n < 1 || d < 1 || g_row < 0 || g_trial < 0 || z_trial < 0 ||
      out_trial < d || vec < 1 || d % vec != 0 || g_row % vec != 0 ||
      g_trial % vec != 0 || z_trial % vec != 0 || out_trial % vec != 0 ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 || blocks_x < 1 ||
      static_cast<long long>(blocks_x) * threads * vec < d || blocks_y < 1 ||
      blocks_y > trials || blocks_y > kMaxGridY) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Operands p{g, g_trial, g_row, coeff, z, z_trial, m_g, v_g, a, out, out_trial,
                   trials, n, d};
  const dim3 grid(static_cast<unsigned>(blocks_x), static_cast<unsigned>(blocks_y));
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (vec * 100 + rows) {
    case 408: launch<4, 8>(p, grid, threads, s); break;
    case 416: launch<4, 16>(p, grid, threads, s); break;
    case 208: launch<2, 8>(p, grid, threads, s); break;
    case 216: launch<2, 16>(p, grid, threads, s); break;
    case 108: launch<1, 8>(p, grid, threads, s); break;
    case 116: launch<1, 16>(p, grid, threads, s); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// One round: the batch of one trial. g is (n, d) with row stride ld.
extern "C" int aircomp_fused_f32(const float* g, long long ld, const float* coeff,
                                 const float* z, const float* m_g, const float* v_g,
                                 const float* a, float* out, int n, long long d,
                                 int vec, int rows, int threads, int blocks_x,
                                 void* stream) {
  if (ld < d) return static_cast<int>(cudaErrorInvalidValue);
  return aircomp_fused_batch_f32(g, 0, ld, coeff, z, 0, m_g, v_g, a, out, d, 1, n, d,
                                 vec, rows, threads, blocks_x, 1, stream);
}

extern "C" const char* aircomp_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
