// Mamba2 SSD chunked scan forward for Hopper, sm_90a (arXiv:2405.21060).
//
//   S_t = exp(la_t) S_{t-1} + B_t (x) xdt_t      (state (n, p) per batch and head)
//   y_t = C_t . S_t
//
// computed chunk by chunk as the reference does: within a chunk of Q rows,
// with La = the inclusive cumulative sum of la over the chunk,
//   y_q = sum_{k <= q} (C_q . B_k) exp(La_q - La_k) xdt_k + exp(La_q) C_q . S,
// then S <- exp(La_last) S + sum_t exp(La_last - La_t) B_t (x) xdt_t.
// Replaces the TPU kernel src/repro/kernels/ssd/kernel.py:65 `ssd_pallas`
// (body `_ssd_kernel`, :28): the same chunking, the decay masked before the
// exp (a key after the query is skipped, never the exp of a positive
// difference), every product and the carried state in fp32, and y rounded
// once to xdt's type. xdt, B, C and y are fp32 or bf16 (all one type); la
// is fp32.
//
// Bound: bytes. At the mamba2-370m prefill (b 8, s 2048, h 32, p 64, n 128,
// chunk 256, bf16) one call moves 145 MB (xdt and y 67.1 MB each, la 2.1 MB,
// B and C 4.2 MB each): 0.043 ms at 3.35 TB/s, against 26.4 GFLOP (C B^T
// once a chunk, its causal half, 0.5; the intra-chunk product, the carried
// state's contribution to y and the state update, 8.6 each): 0.027 ms at
// 989 TFLOP/s bf16.
//
// Design. The TPU runs a sequential (batch, chunk) grid and carries the whole
// (h, n, p) fp32 state in VMEM: 1 MiB at mamba2-370m, more than an SM's
// shared memory. Here one block of 256 threads owns one (batch, head) and
// loops over the chunks in order itself, with that head's (n, p) state in
// shared memory (32 KB at n 128, p 64). Per chunk: the block loads la and
// one thread forms La in fp32 in the plain version's order, which is the
// reference's (XLA's cumsum on the CPU: in order within blocks of 16, then
// the block totals in order, each added to the blocks after it), so La is
// bitwise the plain version's: at |La| ~ 400 one ulp of La is 3e-5 of a
// decay weight, more than the fp32 tolerance. Then for each 64-row q tile:
// the carried state's term exp(La_q) C_q . S, then for each 64-row kv tile k <= q the
// 64 x 64 tile of C_q B_k^T over n, masked and scaled by exp(La_q - La_k),
// times xdt_k. The last q tile sees every kv tile of the chunk, so it also
// accumulates the state update sum_t exp(La_last - La_t) B_t (x) xdt_t in
// registers (rows n = ty + 16 r, a thread's p columns); after it the block
// writes S <- exp(La_last) S + that sum. C_q and B_k are staged transposed
// (a thread reads four rows as one float4), xdt_k and S row-major, all fp32;
// each thread owns a 4 x 4 block of the score tile and 4 rows x p/16 columns
// of y, like the flash kernel. p is padded with zeros to 32 or 64 in shared
// memory; ragged q and kv tiles (Q not a multiple of 64) are masked. Shared
// memory is 137.5 KB at n 128, p 64, chunk 256 (cudaFuncSetAttribute).
//
// What this simple design leaves on the table: no tensor cores -- every
// product runs at the fp32 CUDA-core rate, about 67 TFLOP/s -- and C B^T is
// formed again for every head and in whole 64 x 64 tiles: at the serving
// prefill the kernel does 49.4 GFLOP, 21.5 of them C B^T, where the call
// needs 26.4. One block per (batch, head) gives b * h blocks: 256 at the serving
// prefill (two waves on 132 SMs, one block an SM for its shared memory), but
// only 32 at batch 1. No TMA or cp.async double buffering; the state-passing
// split of the Mamba2 GPU implementation (chunk states, a scan over chunks,
// then outputs) would give more blocks.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kT = 64;          // rows of a q or kv tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kLd = kT + 4;     // row length (floats) of the transposed tiles:
                                // a multiple of 4 keeps float4 alignment
constexpr int kMaxN = 128;      // d_state
constexpr int kRows = kMaxN / 16;  // state rows a thread updates
constexpr int kMaxChunk = 256;  // La's scan has two levels of 16
constexpr int kScan = 16;       // the scan's block

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

struct Params {
  const void* x;
  const float* la;
  const void* b;
  const void* c;
  void* y;
  long long s;
  int p, n, chunk;
  long long x_b, x_s, x_h;  // element strides; unit stride along p
  long long la_b, la_s, la_h;
  long long b_b, b_s;       // unit stride along n
  long long c_b, c_s;
  long long y_b, y_s, y_h;
};

// float offsets of the shared-memory arrays; each a multiple of 4
template <int PP>
struct Smem {
  int st, ct, bt, xs, pt, la, w, floats;
  __host__ __device__ explicit Smem(int n, int chunk) {
    st = 0;                          // [n][PP]   the state entering the chunk
    ct = st + n * PP;                // [n][kLd]  C of the q tile, transposed
    bt = ct + n * kLd;               // [n][kLd]  B of the kv tile, transposed
    xs = bt + n * kLd;               // [kT][PP]  xdt of the kv tile
    pt = xs + kT * PP;               // [kT][kLd] the masked decay tile, transposed
    la = pt + kT * kLd;              // [chunk]   La of the chunk
    w = la + (chunk + 3) / 4 * 4;    // [kT]      exp(La_last - La_t) of the kv tile;
                                     //           the scan's block totals before it
    floats = w + kT;
  }
};

template <int CPT>
__device__ __forceinline__ void load_cols(const float* src, float (&v)[CPT]) {
  if constexpr (CPT == 4) {
    const float4 a = *reinterpret_cast<const float4*>(src);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  } else {
    const float2 a = *reinterpret_cast<const float2*>(src);
    v[0] = a.x; v[1] = a.y;
  }
}

__device__ __forceinline__ void load_rows(const float* src, float (&v)[4]) {
  const float4 a = *reinterpret_cast<const float4*>(src);
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

template <typename T, int PP>
__global__ void __launch_bounds__(kThreads) ssd_fwd_kernel(const Params p) {
  constexpr int CPT = PP / 16;  // p columns a thread owns
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Smem<PP> off(p.n, p.chunk);
  float* st = smem + off.st;
  float* ct = smem + off.ct;
  float* bt = smem + off.bt;
  float* xs = smem + off.xs;
  float* pt = smem + off.pt;
  float* La = smem + off.la;
  float* w = smem + off.w;

  const int tid = threadIdx.x;
  const int tx = tid % 16;  // keys tx*4.. of a score tile; columns tx*CPT.. of y and S
  const int ty = tid / 16;  // rows ty*4.. of a q tile; state rows ty + 16 r
  const int hi = blockIdx.x;
  const long long bi = blockIdx.y;
  const int n = p.n, q_len = p.chunk;
  const int n_tiles = (q_len + kT - 1) / kT;
  const T* xp = static_cast<const T*>(p.x) + bi * p.x_b + hi * p.x_h;
  const float* lap = p.la + bi * p.la_b + hi * p.la_h;
  const T* bp = static_cast<const T*>(p.b) + bi * p.b_b;
  const T* cp = static_cast<const T*>(p.c) + bi * p.c_b;
  T* yp = static_cast<T*>(p.y) + bi * p.y_b + hi * p.y_h;

  for (int e = tid; e < n * PP; e += kThreads) st[e] = 0.f;

  for (long long c0 = 0; c0 < p.s; c0 += q_len) {
    __syncthreads();  // the previous chunk's state update and La reads are done
    for (int t = tid; t < q_len; t += kThreads) La[t] = lap[(c0 + t) * p.la_s];
    __syncthreads();
    if (tid == 0) {  // inclusive cumsum in fp32, in ref.py's `cumsum` order
      const int nb = (q_len + kScan - 1) / kScan;  // at most kScan blocks
      for (int i = 0; i < nb; ++i) {
        float acc = 0.f;
        for (int t = i * kScan; t < min(q_len, (i + 1) * kScan); ++t) {
          acc += La[t];
          La[t] = acc;
        }
        w[i] = acc;
      }
      float prefix = 0.f;
      for (int i = 1; i < nb; ++i) {
        prefix += w[i - 1];
        for (int t = i * kScan; t < min(q_len, (i + 1) * kScan); ++t) La[t] = La[t] + prefix;
      }
    }
    __syncthreads();
    const float la_last = La[q_len - 1];

    for (int qi = 0; qi < n_tiles; ++qi) {
      const int q0 = qi * kT;
      const bool last = qi == n_tiles - 1;
      __syncthreads();  // the previous q tile's reads of ct are done
      for (int e = tid; e < kT * n; e += kThreads) {
        const int r = e / n, j = e % n;
        ct[j * kLd + r] = q0 + r < q_len ? to_float(cp[(c0 + q0 + r) * p.c_s + j]) : 0.f;
      }
      __syncthreads();

      // the carried state's term: exp(La_q) * (C_q . S)
      float acc[4][CPT];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
      for (int j = 0; j < n; ++j) {
        float a[4], sv[CPT];
        load_rows(&ct[j * kLd + ty * 4], a);
        load_cols<CPT>(&st[j * PP + tx * CPT], sv);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(a[i], sv[c], acc[i][c]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        const float decay = q < q_len ? expf(La[q]) : 0.f;
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] *= decay;
      }

      float ds[kRows][CPT];  // the state update, on the last q tile
#pragma unroll
      for (int r = 0; r < kRows; ++r)
#pragma unroll
        for (int c = 0; c < CPT; ++c) ds[r][c] = 0.f;

      for (int kj = 0; kj <= qi; ++kj) {
        const int k0 = kj * kT;
        __syncthreads();  // the previous kv tile is consumed
        for (int e = tid; e < kT * n; e += kThreads) {
          const int r = e / n, j = e % n;
          bt[j * kLd + r] = k0 + r < q_len ? to_float(bp[(c0 + k0 + r) * p.b_s + j]) : 0.f;
        }
        for (int e = tid; e < kT * PP; e += kThreads) {
          const int r = e / PP, d = e % PP;
          // zeros past the chunk and past p: 0 * garbage could be NaN
          xs[e] = k0 + r < q_len && d < p.p ? to_float(xp[(c0 + k0 + r) * p.x_s + d]) : 0.f;
        }
        if (last && tid < kT) w[tid] = k0 + tid < q_len ? expf(la_last - La[k0 + tid]) : 0.f;
        __syncthreads();

        // the score tile C_q B_k^T, masked and decayed, stored transposed
        float sc[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
        for (int j = 0; j < n; ++j) {
          float a[4], bv[4];
          load_rows(&ct[j * kLd + ty * 4], a);
          load_rows(&bt[j * kLd + tx * 4], bv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) sc[i][c] = fmaf(a[i], bv[c], sc[i][c]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int q = q0 + ty * 4 + i;
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int k = k0 + tx * 4 + c;
            sc[i][c] = k <= q && q < q_len ? sc[i][c] * expf(La[q] - La[k]) : 0.f;
          }
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          *reinterpret_cast<float4*>(&pt[(tx * 4 + c) * kLd + ty * 4]) =
              make_float4(sc[0][c], sc[1][c], sc[2][c], sc[3][c]);
        }
        __syncthreads();

#pragma unroll 4
        for (int k = 0; k < kT; ++k) {
          float pv[4], xv[CPT];
          load_rows(&pt[k * kLd + ty * 4], pv);
          load_cols<CPT>(&xs[k * PP + tx * CPT], xv);
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(pv[i], xv[c], acc[i][c]);
        }
        if (last) {  // ds[row][col] += w_t B_t[row] xdt_t[col]
#pragma unroll 4
          for (int k = 0; k < kT; ++k) {
            float xv[CPT];
            load_cols<CPT>(&xs[k * PP + tx * CPT], xv);
            const float wk = w[k];
#pragma unroll
            for (int r = 0; r < kRows; ++r) {
              const int j = ty + 16 * r;
              if (j < n) {
                const float bw = bt[j * kLd + k] * wk;
#pragma unroll
                for (int c = 0; c < CPT; ++c) ds[r][c] = fmaf(bw, xv[c], ds[r][c]);
              }
            }
          }
        }
      }

#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int q = q0 + ty * 4 + i;
        if (q >= q_len) continue;
#pragma unroll
        for (int c = 0; c < CPT; ++c) {
          const int d = tx * CPT + c;
          if (d < p.p) store(&yp[(c0 + q) * p.y_s + d], acc[i][c]);
        }
      }
      if (last) {
        __syncthreads();  // every thread is past its reads of S for this chunk
        const float chunk_decay = expf(la_last);
#pragma unroll
        for (int r = 0; r < kRows; ++r) {
          const int j = ty + 16 * r;
          if (j < n) {
#pragma unroll
            for (int c = 0; c < CPT; ++c) {
              float* sp = &st[j * PP + tx * CPT + c];
              *sp = fmaf(chunk_decay, *sp, ds[r][c]);
            }
          }
        }
      }
    }
  }
}

template <typename T, int PP>
int launch(const Params& p, long long b, int h, cudaStream_t stream) {
  const int bytes = Smem<PP>(p.n, p.chunk).floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<T, PP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(h), static_cast<unsigned>(b));
  ssd_fwd_kernel<T, PP><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// dtype: 0 float32, 1 bfloat16 (xdt, B, C and y alike; la is float32).
// xdt and y are (b, s, h, p), la (b, s, h), B and C (b, s, n), each given by
// its strides in elements (unit stride along p and n). s must be a multiple
// of chunk.
extern "C" int ssd_fwd(
    const void* x, const float* la, const void* bmat, const void* cmat, void* y, int dtype,
    long long b, long long s, int h, int p, int n, int chunk, long long x_b, long long x_s,
    long long x_h, long long la_b, long long la_s, long long la_h, long long b_b,
    long long b_s, long long c_b, long long c_s, long long y_b, long long y_s, long long y_h,
    void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || p < 1 || p > 64 || n < 1 || n > kMaxN ||
      chunk < 1 || chunk > kMaxChunk || s % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params prm{x, la, bmat, cmat, y, s, p, n, chunk, x_b, x_s, x_h, la_b, la_s, la_h,
             b_b, b_s, c_b, c_s, y_b, y_s, y_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return p <= 32 ? launch<float, 32>(prm, b, h, st) : launch<float, 64>(prm, b, h, st);
  if (dtype == 1) {
    return p <= 32 ? launch<__nv_bfloat16, 32>(prm, b, h, st)
                   : launch<__nv_bfloat16, 64>(prm, b, h, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
