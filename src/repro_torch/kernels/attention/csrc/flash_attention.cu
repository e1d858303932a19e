// Blocked online-softmax (flash) attention forward for Hopper, sm_90a.
//
//   out[b, i, hi, :] = sum_j softmax_j(q[b, i, hi, :] . k[b, j, kvh, :] / sqrt(dh)) v[b, j, kvh, :]
//
// over the keys j that query row i sees: j <= i + q_offset (causal),
// j > i + q_offset - window (sliding window), with kvh = hi / (h / kv)
// (GQA). A row that sees no key gives 0. Replaces the TPU kernel
// src/repro/kernels/attention/kernel.py:103 `flash_attention` (body
// `_flash_kernel`, :33): the same masks, -1e30 masking, fp32 softmax
// statistics and accumulator, and `safe_l`; the output is in q's type.
//
// Bound: operations. A causal call does 4 * b * h * dh * (visible pairs)
// flops (about 4 * b * h * dh * sq * sk / 2): at the qwen2-0.5b prefill
// shape (b 8, sq = sk 2048, 14 query / 2 kv heads, dh 64) that is 60.2
// GFLOP, 0.061 ms at the H100's 989 TFLOP/s bf16 dense rate, against
// 0.020 ms for its 66 MB of bf16 q, k, v and out at 3.35 TB/s.
//
// Design. The TPU walks the kv axis as a sequential grid dimension with
// (acc, m, l) in VMEM; here one block of 256 threads owns (batch, head,
// 64-row q tile) and loops over 64-key kv tiles itself. The loop's bounds
// come from the causal and window limits of the tile's first and last rows,
// which is where fully masked kv tiles are skipped; q tiles run heaviest
// first (the last causal tile sees the most keys). Per kv tile: K^T and V
// are staged in shared memory as fp32 (K and Q transposed so a thread reads
// four rows or four keys as one float4), each thread computes a 4 x 4 block
// of the 64 x 64 score tile on the CUDA cores, the row max and sum are
// reduced across the 16 threads of a row group by warp shuffles, P^T goes
// through shared memory, and each thread accumulates 4 rows x (DHP / 16)
// columns of P V in registers. Softmax statistics and the accumulator are
// fp32 throughout. dh is padded with zeros to DHP = 64 or 128 in shared
// memory (any multiple of 8 up to 128); the ragged edges of sq and sk are
// masked in the kernel, so no shape has to divide a tile. Operands are
// read through their batch, sequence and head strides (unit stride along
// dh), with 64-bit offsets. Shared memory is 68.6 KB (DHP 64) or 119.8 KB
// (DHP 128), above the 48 KB default, so the launch raises the limit with
// cudaFuncSetAttribute.
//
// What this simple design leaves on the table: no tensor cores (wgmma or
// mma.sync) -- the products run at the fp32 CUDA-core rate, about 67
// TFLOP/s, not 989 -- no TMA or cp.async double buffering of the kv tiles,
// no warp specialisation, and the DHP padding wastes work at dh 80.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;         // query rows of a block
constexpr int kBK = 64;         // keys of a kv tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kLd = kBQ + 4;    // row length (floats) of the transposed tiles:
                                // a multiple of 4 keeps float4 alignment
constexpr float kNegInf = -1e30f;

static_assert(kBQ == kBK, "the transposed tiles share one row length");

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  long long sq, sk;
  int h, kv, dh;
  long long q_b, q_s, q_h;  // element strides; unit stride along dh
  long long k_b, k_s, k_h;
  long long v_b, v_s, v_h;
  long long o_b, o_s, o_h;
  long long q_offset;
  long long window;         // 0: no sliding window
  int causal;
  float scale;
};

__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int DHP>
constexpr int smem_floats() {
  return 2 * DHP * kLd + kBK * DHP + kBK * kLd;
}

template <typename T, int DHP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel(const Params p) {
  constexpr int kU = DHP / 64;  // float4 column groups a thread owns in P V
  extern __shared__ float4 smem4[];
  float* qt = reinterpret_cast<float*>(smem4);  // [DHP][kLd]  (q * scale)^T
  float* kt = qt + DHP * kLd;                   // [DHP][kLd]  k^T
  float* vs = kt + DHP * kLd;                   // [kBK][DHP]  v
  float* pt = vs + kBK * DHP;                   // [kBK][kLd]  p^T

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys tx*4.. of a score tile; columns u*64 + tx*4.. of out
  const int ty = tid / 16;  // rows ty*4.. of the q tile
  const long long n_qt = (p.sq + kBQ - 1) / kBQ;
  const long long q0 = (n_qt - 1 - static_cast<long long>(blockIdx.x)) * kBQ;
  const int hi = blockIdx.y;
  const long long bi = blockIdx.z;
  const int kvh = hi / (p.h / p.kv);
  const T* qp = static_cast<const T*>(p.q) + bi * p.q_b + hi * p.q_h;
  const T* kp = static_cast<const T*>(p.k) + bi * p.k_b + kvh * p.k_h;
  const T* vp = static_cast<const T*>(p.v) + bi * p.v_b + kvh * p.v_h;
  T* op = static_cast<T*>(p.o) + bi * p.o_b + hi * p.o_h;

  for (int e = tid; e < kBQ * DHP; e += kThreads) {
    const int r = e / DHP, d = e % DHP;
    const long long row = q0 + r;
    float x = 0.f;
    if (row < p.sq && d < p.dh) x = to_float(qp[row * p.q_s + d]) * p.scale;
    qt[d * kLd + r] = x;
  }

  // the keys any row of this tile sees: [k_lo, k_hi)
  const long long pos_first = q0 + p.q_offset;
  const long long pos_last = min(q0 + kBQ, p.sq) - 1 + p.q_offset;
  long long k_lo = 0, k_hi = p.sk;
  if (p.causal) k_hi = min(k_hi, pos_last + 1);
  if (p.window > 0) k_lo = max(k_lo, pos_first - p.window + 1);

  float acc[4][4 * kU];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < 4 * kU; ++c) acc[i][c] = 0.f;
  }

  for (long long k0 = (k_hi > k_lo ? k_lo / kBK * kBK : k_hi); k0 < k_hi; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed (and q is staged)
    for (int e = tid; e < kBK * DHP; e += kThreads) {
      const int j = e / DHP, d = e % DHP;
      const long long key = k0 + j;
      float kx = 0.f, vx = 0.f;  // zeros past sk: 0 * garbage could be NaN
      if (key < p.sk && d < p.dh) {
        kx = to_float(kp[key * p.k_s + d]);
        vx = to_float(vp[key * p.v_s + d]);
      }
      kt[d * kLd + j] = kx;
      vs[j * DHP + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[i][c] = 0.f;
    for (int d0 = 0; d0 < p.dh; d0 += 8) {
#pragma unroll
      for (int d = d0; d < d0 + 8; ++d) {
        const float4 a = *reinterpret_cast<const float4*>(&qt[d * kLd + ty * 4]);
        const float4 b = *reinterpret_cast<const float4*>(&kt[d * kLd + tx * 4]);
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) s[i][c] = fmaf(av[i], bv[c], s[i][c]);
      }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long pos = q0 + ty * 4 + i + p.q_offset;
      bool seen[4];
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const long long key = k0 + tx * 4 + c;
        seen[c] = key < p.sk && (!p.causal || key <= pos) &&
                  (p.window <= 0 || key > pos - p.window);
        s[i][c] = seen[c] ? s[i][c] : kNegInf;
        tile_max = fmaxf(tile_max, s[i][c]);
      }
      const float m_new = fmaxf(m[i], group_max(tile_max));
      const float alpha = expf(m[i] - m_new);
      float row_sum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[i][c] = seen[c] ? expf(s[i][c] - m_new) : 0.f;
        row_sum += s[i][c];
      }
      l[i] = alpha * l[i] + group_sum(row_sum);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < 4 * kU; ++c) acc[i][c] *= alpha;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      *reinterpret_cast<float4*>(&pt[(tx * 4 + c) * kLd + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
    }
    __syncthreads();

#pragma unroll 4
    for (int j = 0; j < kBK; ++j) {
      const float4 pp = *reinterpret_cast<const float4*>(&pt[j * kLd + ty * 4]);
      const float pv[4] = {pp.x, pp.y, pp.z, pp.w};
#pragma unroll
      for (int u = 0; u < kU; ++u) {
        const float4 vv = *reinterpret_cast<const float4*>(&vs[j * DHP + u * 64 + tx * 4]);
        const float vval[4] = {vv.x, vv.y, vv.z, vv.w};
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[i][u * 4 + c] = fmaf(pv[i], vval[c], acc[i][u * 4 + c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const long long row = q0 + ty * 4 + i;
    if (row >= p.sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
#pragma unroll
    for (int u = 0; u < kU; ++u)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = u * 64 + tx * 4 + c;
        if (col < p.dh) store(&op[row * p.o_s + col], acc[i][u * 4 + c] / safe_l);
      }
  }
}

template <typename T, int DHP>
int launch(const Params& p, long long b, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DHP>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.sq + kBQ - 1) / kBQ), static_cast<unsigned>(p.h),
                  static_cast<unsigned>(b));
  flash_fwd_kernel<T, DHP><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// dtype: 0 float32, 1 bfloat16 (q, k, v and out alike). q is (b, sq, h, dh),
// k and v (b, sk, kv, dh), out (b, sq, h, dh), each given by its batch,
// sequence and head strides in elements (unit stride along dh). window <= 0
// means no sliding window.
extern "C" int flash_attention_fwd(
    const void* q, const void* k, const void* v, void* out, int dtype, long long b,
    long long sq, long long sk, int h, int kv, int dh, long long q_b, long long q_s,
    long long q_h, long long k_b, long long k_s, long long k_h, long long v_b, long long v_s,
    long long v_h, long long o_b, long long o_s, long long o_h, int causal, long long window,
    long long q_offset, float scale, void* stream) {
  if (b < 1 || b > 65535 || sq < 1 || sk < 1 || h < 1 || h > 65535 || kv < 1 || h % kv != 0 ||
      dh < 8 || dh > 128 || dh % 8 != 0 || (sq + kBQ - 1) / kBQ > 2147483647LL) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p{q, k, v, out, sq, sk, h, kv, dh, q_b, q_s, q_h, k_b, k_s, k_h, v_b, v_s, v_h,
           o_b, o_s, o_h, q_offset, window > 0 ? window : 0, causal, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return dh <= 64 ? launch<float, 64>(p, b, s) : launch<float, 128>(p, b, s);
  if (dtype == 1) {
    return dh <= 64 ? launch<__nv_bfloat16, 64>(p, b, s) : launch<__nv_bfloat16, 128>(p, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
