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
// difference), every sum and the carried state in fp32, and y rounded once
// to xdt's type. xdt, B, C and y are fp32 or bf16 (all one type); la is
// fp32. Every kernel adds La in the plain version's order, which is the
// reference's (XLA's cumsum on the CPU: in order within blocks of 16, then
// the block totals in order, each added to the blocks after it), so La is
// bitwise the plain version's: at |La| ~ 400 one ulp of La is 3e-5 of a
// decay weight, more than the fp32 tolerance. Here 16 threads of a head
// each add one block, then each adds the totals before its own block.
//
// Bound: bytes. At the mamba2-370m prefill (b 8, s 2048, h 32, p 64, n 128,
// chunk 256, bf16) one call moves 145 MB (xdt and y 67.1 MB each, la 2.1 MB,
// B and C 4.2 MB each): 0.043 ms at 3.35 TB/s, against 26.4 GFLOP (C B^T
// once a chunk, its causal half, 0.5; the intra-chunk product, the carried
// state's term and the state update, 8.6 each): 0.027 ms at 989 TFLOP/s
// bf16.
//
// Two designs, chosen by dtype at `ssd_fwd`; neither stands in for the other.
//
// bfloat16: the state-passing split of the Mamba2 paper's GPU algorithm
// (its section 6), as three kernels on the caller's stream, all on the
// tensor cores (`mma.sync.aligned.m16n8k16` bf16 with an fp32 accumulator,
// fragments from `ldmatrix`, tiles of B, C, xdt and the state brought in by
// `cp.async`, double-buffered so the next tile loads while this one
// multiplies):
//   1. `ssd_fwd_states_bf16`, one block of 4 warps per (batch, chunk, head):
//      La in the order above, w_t = exp(La_last - La_t), and the chunk's
//      state S_c = (w B)^T xdt, an (n x Q)(Q x p) product over 64-row
//      slices; each warp owns 32 state rows. (w B)^T's A fragments come
//      from B's bf16 tile through `ldmatrix.trans` and are scaled in
//      registers. S_c goes in fp32 to a workspace (b, nc, h, np, PP) that
//      the wrapper allocates (67 MB at the serving prefill), La_last to a
//      (b, nc, h) scratch.
//   2. `ssd_fwd_pass`, parallel over (batch, head, 8 state columns a thread),
//      sequential over the chunks in fp32: it overwrites each chunk's S_c
//      with the state entering it, S_in[c] = carry, then carry =
//      exp(La_last[c]) carry + S_c[c] (the plain version's recurrence),
//      storing S_in already split: in the 32 bytes that held 8 fp32
//      columns, their 8 bf16 hi then their 8 bf16 lo. Loads run 4 chunks
//      ahead.
//   3. `ssd_fwd_outputs_bf16`, one block of 4 warps per (batch, chunk,
//      64-row q tile, group of 8 heads), the heaviest q tiles first; each
//      warp owns 16 rows. C_q B_k^T for the kv tiles k <= q is formed ONCE
//      for the group (exact products of bf16 inputs, summed in fp32), each
//      thread keeping its own fragments in shared memory. Then per head:
//      y = exp(La_q) C_q S_in (S_in's hi and lo tiles straight from the
//      workspace), plus, per kv tile, (C_q B_k^T masked to k <= q, times
//      exp(La_q - La_k)) xdt_k, the decayed scores becoming A fragments in
//      registers; y is rounded to bf16 once.
//   - The split. B, C and xdt are bf16, so C B^T and any product of two
//     inputs is exact. Three products have an fp32 operand: w B against
//     xdt (stage 1), C against S_in (stage 3), the decayed scores against
//     xdt (stage 3). Each such operand goes in as hi = bf16(v) plus lo =
//     bf16(v - hi) (the difference is exact in fp32), two mma passes that
//     share the other operand's fragments, so it keeps 16 significant bits.
//     Why: the check (kernels/ssd/cases.py) holds each bf16 output element
//     to 2^-8 |ref| + 1e-5 max(1, max|ref|) against the plain version in
//     fp32, and y's one rounding to bf16 takes about 0.97-0.99 of it.
//     Emulated on the CPU in plain torch (tests/test_torch_ssd_precision.py),
//     the bf16 cases stay at 0.95-0.99 of their limit with all three split
//     (0.97-0.99 on the card); rounding one operand once instead misses it:
//     w B by up to 75x, S_in by up to 94x, the scores by up to 105x (near_0,
//     where the state sums a thousand tokens), and the scores by 1.9x even
//     at strong decay (where the states vanish and w B and S_in alone would
//     pass). So no split is dropped: each of the three products takes two
//     mma passes.
//   - Shapes: p is zero-padded to PP = 32 or 64 and n to np, a multiple of
//     16 (the k of m16n8k16); ragged chunks (Q not a multiple of 64) are
//     zero-filled by cp.async's source size and masked. Shared rows are
//     padded to an odd number of 16-byte chunks, so each ldmatrix phase is
//     free of bank conflicts. xdt, B and C must start on 16 bytes with
//     batch, sequence and head strides that are multiples of 8 elements;
//     the wrapper (and `ssd_fwd`) refuse other views.
//   - Shared memory at the serving prefill (np 128, PP 64, Q 256): stage 1
//     54,336 bytes, stage 3 109,056 (two 64 x 136 bf16 tile slots, C B^T
//     of four kv tiles in fp32, La of 8 heads), so two stage-3 blocks
//     share an SM. Registers a thread (ptxas -v, which chip_smoke.py phase
//     `build` prints): stage 1 128 (PP 64 and 32), stage 2 64, stage 3 168
//     at PP 64 (12 bytes spilled) and 152 at PP 32; the fp32 kernel 127.
//   - Grid at the serving prefill: 2,048 stage-1 blocks, 2,048 stage-2
//     blocks of 128 threads, 1,024 stage-3 blocks; at (1, 32768): 4,096,
//     256 and 2,048. One block per (batch, head), as the float32 kernel
//     runs, gives 256 and 32.
//
// float32: `ssd_fwd_kernel`, on the CUDA cores, exact to the fp32 sum order
// (tensor cores would cost the fp32 check its 1e-5 limit). One block of 256
// threads owns one (batch, head) and loops over the chunks in order itself,
// with that head's (n, p) state in shared memory (32 KB at n 128, p 64).
// Per chunk: the block loads la and one thread forms La in the order above.
// Then for each 64-row q tile: the carried state's term exp(La_q) C_q . S,
// then for each 64-row kv tile k <= q the 64 x 64 tile of C_q B_k^T over n,
// masked and scaled by exp(La_q - La_k), times xdt_k. The last q tile sees
// every kv tile of the chunk, so it also accumulates the state update
// sum_t exp(La_last - La_t) B_t (x) xdt_t in registers (rows n = ty + 16 r,
// a thread's p columns); after it the block writes S <- exp(La_last) S +
// that sum. C_q and B_k are staged transposed (a thread reads four rows as
// one float4), xdt_k and S row-major, all fp32; each thread owns a 4 x 4
// block of the score tile and 4 rows x p/16 columns of y, like the flash
// kernel. p is padded with zeros to 32 or 64 in shared memory; ragged q and
// kv tiles are masked. Shared memory is 137.5 KB at n 128, p 64, chunk 256
// (cudaFuncSetAttribute). It forms C B^T again for every head, and one
// block per (batch, head) leaves most SMs idle at batch 1.
//
// What the bf16 design leaves on the table. On an H100 80GB HBM3 at 700 W
// a call takes 0.66 ms at the serving prefill, 15x its bound (chip_smoke.py
// phase `times`); inside the prefill stage 1 takes 0.12, stage 2 0.06 and
// stage 3 0.48 ms a call (phase `ssm_serve_breakdown`). Stage 3 issues
// 41.4 GFLOP of mma.sync (C B^T once a group, the two split products twice
// each): 86 TFLOP/s. Each of its 26-53 tiles a block
// carries 64 mma a warp and waits on the load issued one tile earlier, and
// the C B^T it keeps (64 KB at chunk 256) leaves room for two blocks (8
// warps) an SM and two slots a block. Levers: `wgmma` and
// TMA in place of mma.sync and cp.async, a deeper ring with warp
// specialisation, two heads a tile, the workspace's round trips (stage 1
// writes its 67 MB, stage 2 reads and rewrites them, stage 3 reads each
// head's state once per q tile, much of it from L2), and the per-element
// expf of the decay.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

namespace {

// -- float32: CUDA cores ---------------------------------------------------------

constexpr int kT = 64;          // rows of a q or kv tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kLd = kT + 4;     // row length (floats) of the transposed tiles:
                                // a multiple of 4 keeps float4 alignment
constexpr int kMaxN = 128;      // d_state
constexpr int kRows = kMaxN / 16;  // state rows a thread updates
constexpr int kMaxChunk = 256;  // La's scan has two levels of 16
constexpr int kScan = 16;       // the scan's block

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

template <int PP>
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
  const float* xp = static_cast<const float*>(p.x) + bi * p.x_b + hi * p.x_h;
  const float* lap = p.la + bi * p.la_b + hi * p.la_h;
  const float* bp = static_cast<const float*>(p.b) + bi * p.b_b;
  const float* cp = static_cast<const float*>(p.c) + bi * p.c_b;
  float* yp = static_cast<float*>(p.y) + bi * p.y_b + hi * p.y_h;

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
        ct[j * kLd + r] = q0 + r < q_len ? cp[(c0 + q0 + r) * p.c_s + j] : 0.f;
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
          bt[j * kLd + r] = k0 + r < q_len ? bp[(c0 + k0 + r) * p.b_s + j] : 0.f;
        }
        for (int e = tid; e < kT * PP; e += kThreads) {
          const int r = e / PP, d = e % PP;
          // zeros past the chunk and past p: 0 * garbage could be NaN
          xs[e] = k0 + r < q_len && d < p.p ? xp[(c0 + k0 + r) * p.x_s + d] : 0.f;
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
          if (d < p.p) yp[(c0 + q) * p.y_s + d] = acc[i][c];
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

template <int PP>
int launch(const Params& p, long long b, int h, cudaStream_t stream) {
  const int bytes = Smem<PP>(p.n, p.chunk).floats * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_kernel<PP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(h), static_cast<unsigned>(b));
  ssd_fwd_kernel<PP><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// -- bfloat16: tensor cores, three kernels ---------------------------------------

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kGroup = 8;         // heads of an output block: C B^T once for all of them
constexpr int kPassThreads = 128;
constexpr int kPassAhead = 4;     // chunks whose loads stage 2 keeps in flight
static_assert(kGroup * kScan == kMmaThreads, "stage 3 scans La of its heads in one step");

struct MmaParams {
  const __nv_bfloat16* x;
  const float* la;
  const __nv_bfloat16* b;
  const __nv_bfloat16* c;
  __nv_bfloat16* y;
  float* ws;       // (b, nc, h, np, PP): each chunk's state, then the state entering it
  float* la_last;  // (b, nc, h): La at each chunk's last row
  long long nc;
  int h, p, n, np, chunk;
  long long x_b, x_s, x_h;  // element strides; unit stride along p and n
  long long la_b, la_s, la_h;
  long long b_b, b_s;
  long long c_b, c_s;
  long long y_b, y_s, y_h;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes to shared memory: the first `bytes` (0 to 16) from global memory,
// the rest zero.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(dst), "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr) : "memory");
}

// c (16 x 8, fp32) += a (16 x 16, bf16, row) b (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 x) {
  return *reinterpret_cast<const uint32_t*>(&x);
}

// (x, y) = hi + lo to 16 significant bits: hi = bf16(x, y), lo = bf16 of
// the rest, which is exact in fp32. The lower column sits in the low half.
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x - hf.x, y - hf.y));
}

// Two bf16 values (k and k + 1) of a fragment times their weights in fp32,
// split into bf16 hi + lo.
__device__ __forceinline__ void scale_split(uint32_t v, float w0, float w1, uint32_t& hi,
                                            uint32_t& lo) {
  const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
  split_bf16(f.x * w0, f.y * w1, hi, lo);
}

// Rows [0, 64) of a tile, row r at src + r * stride, into shared rows of
// `ld` elements by cp.async, `chunks` 16-byte chunks a row; the bytes from
// column `cols` on and the rows from `rows` on are zero-filled.
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, int ld, const __nv_bfloat16* src,
                                          long long stride, int rows, int cols, int chunks,
                                          int tid) {
  for (int e = tid; e < kT * chunks; e += kMmaThreads) {
    const int r = e / chunks, c = e % chunks;
    const int valid = r < rows ? min(8, cols - c * 8) : 0;
    cp_async_16(smem_addr(tile + r * ld + c * 8), valid > 0 ? src + r * stride + c * 8 : src,
                valid > 0 ? 2 * valid : 0);
  }
}

// La[0, q) = the inclusive cumulative sum of la over the chunk (row t at
// lap[t * la_s]) in ref.py's `cumsum` order: the thread of block `blk` (0
// to 15; -1: none) adds its 16 rows in order, then the totals of the blocks
// before its own, in order, then adds that prefix to its rows. Every thread
// of the block calls it: it synchronises.
__device__ __forceinline__ void chunk_cumsum(float* La, float* tot, const float* lap,
                                             long long la_s, int q, int blk) {
  const int lo = blk * kScan, hi = min(q, lo + kScan);
  if (blk >= 0 && lo < q) {
    float acc = 0.f;
    for (int t = lo; t < hi; ++t) {
      acc += lap[t * la_s];
      La[t] = acc;
    }
    tot[blk] = acc;
  }
  __syncthreads();
  if (blk > 0 && lo < q) {
    float prefix = 0.f;
    for (int i = 0; i < blk; ++i) prefix += tot[i];
    for (int t = lo; t < hi; ++t) La[t] = La[t] + prefix;
  }
  __syncthreads();
}

// Stage 1: S_c = (w B)^T xdt for one (batch, chunk, head), w_t =
// exp(La_last - La_t); fp32 into the workspace, La_last into its scratch.
template <int PP>
__global__ void __launch_bounds__(kMmaThreads) ssd_fwd_states_bf16(const MmaParams p) {
  constexpr int kNT = PP / 8;  // 8-wide column tiles of a state row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q_len = p.chunk, n_sl = (q_len + kT - 1) / kT;
  const int ldb = p.np + 8, ldx = PP + 8;  // an odd number of 16-byte chunks a row
  __nv_bfloat16* bs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][64][ldb] B slices
  __nv_bfloat16* xs = bs + 2 * kT * ldb;                           // [2][64][ldx] xdt slices
  float* w = reinterpret_cast<float*>(xs + 2 * kT * ldx);          // [n_sl * 64] La, then w
  float* tot = w + n_sl * kT;                                      // [16] the scan's totals

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row (and row + 8), column pair
  const int hi = static_cast<int>(blockIdx.x % p.h);
  const long long ci = blockIdx.x / p.h, bi = blockIdx.y;
  const long long t0 = ci * q_len;
  const __nv_bfloat16* xp = p.x + bi * p.x_b + t0 * p.x_s + hi * p.x_h;
  const __nv_bfloat16* bp = p.b + bi * p.b_b + t0 * p.b_s;

  load_tile(bs, ldb, bp, p.b_s, q_len, p.n, p.np / 8, tid);  // slice 0 loads during the scan
  load_tile(xs, ldx, xp, p.x_s, q_len, p.p, PP / 8, tid);
  cp_async_commit();
  chunk_cumsum(w, tot, p.la + bi * p.la_b + t0 * p.la_s + hi * p.la_h, p.la_s, q_len,
               tid < kScan ? tid : -1);
  const float la_last = w[q_len - 1];
  __syncthreads();  // every thread has read La_last
  for (int i = tid; i < n_sl * kT; i += kMmaThreads) w[i] = i < q_len ? expf(la_last - w[i]) : 0.f;
  if (tid == 0) p.la_last[(bi * p.nc + ci) * p.h + hi] = la_last;

  const int m0 = warp * 32;  // this warp's state rows: two 16-row tiles
  const bool mt_ok[2] = {m0 < p.np, m0 + 16 < p.np};
  float acc[2][kNT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int d = 0; d < kNT; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[mt][d][c] = 0.f;

  for (int it = 0; it < n_sl; ++it) {
    const int buf = it & 1;
    if (it + 1 < n_sl) {  // the next slice loads while this one multiplies
      const int r1 = (it + 1) * kT;
      load_tile(bs + (buf ^ 1) * kT * ldb, ldb, bp + r1 * p.b_s, p.b_s, q_len - r1, p.n,
                p.np / 8, tid);
      load_tile(xs + (buf ^ 1) * kT * ldx, ldx, xp + r1 * p.x_s, p.x_s, q_len - r1, p.p, PP / 8,
                tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // the slice has landed for every thread (and w is written)
    const __nv_bfloat16* bt = bs + buf * kT * ldb;
    const __nv_bfloat16* xt = xs + buf * kT * ldx;
    const float* wt = w + it * kT;
#pragma unroll
    for (int kk = 0; kk < kT / 16; ++kk) {  // rows kk*16 .. kk*16 + 15 of the slice
      const int k = kk * 16 + 2 * t;
      const float w0 = wt[k], w1 = wt[k + 1], w8 = wt[k + 8], w9 = wt[k + 9];
      uint32_t ah[2][4], al[2][4];  // (w B)^T: A fragments, hi and lo
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) {
        if (!mt_ok[mt]) continue;
        uint32_t a[4];
        ldmatrix_x4_trans(a, smem_addr(bt + (kk * 16 + (lane & 7) + (lane >> 4) * 8) * ldb + m0 +
                                       mt * 16 + ((lane >> 3) & 1) * 8));
        scale_split(a[0], w0, w1, ah[mt][0], al[mt][0]);
        scale_split(a[1], w0, w1, ah[mt][1], al[mt][1]);
        scale_split(a[2], w8, w9, ah[mt][2], al[mt][2]);
        scale_split(a[3], w8, w9, ah[mt][3], al[mt][3]);
      }
#pragma unroll
      for (int dp = 0; dp < PP / 16; ++dp) {  // state columns dp*16 .. dp*16 + 15
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(xt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ldx +
                                       dp * 16 + (lane >> 4) * 8));
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          if (!mt_ok[mt]) continue;
          mma_bf16(acc[mt][2 * dp], ah[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], ah[mt], b[2], b[3]);
          mma_bf16(acc[mt][2 * dp], al[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * dp + 1], al[mt], b[2], b[3]);
        }
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

  float* sp = p.ws + ((bi * p.nc + ci) * p.h + hi) * static_cast<long long>(p.np) * PP;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    if (!mt_ok[mt]) continue;
    const int row = m0 + mt * 16 + g;
#pragma unroll
    for (int d = 0; d < kNT; ++d) {
      const int col = d * 8 + 2 * t;
      *reinterpret_cast<float2*>(sp + row * PP + col) = make_float2(acc[mt][d][0], acc[mt][d][1]);
      *reinterpret_cast<float2*>(sp + (row + 8) * PP + col) =
          make_float2(acc[mt][d][2], acc[mt][d][3]);
    }
  }
}

// Stage 2: the state entering each chunk, in place of the chunk's own state,
// for 8 columns of one state row of one (batch, head) a thread; stored as
// 8 bf16 hi then 8 bf16 lo in the 32 bytes that held the 8 fp32 values.
template <int PP>
__global__ void __launch_bounds__(kPassThreads) ssd_fwd_pass(const MmaParams p) {
  const int e = blockIdx.x * kPassThreads + threadIdx.x;
  if (e >= p.np * PP / 8) return;
  const int hi = blockIdx.y;
  const long long bi = blockIdx.z;
  const long long state = static_cast<long long>(p.np) * PP;  // floats of one state
  const long long step = p.h * state;                         // one chunk to the next
  float* sp = p.ws + (bi * p.nc * p.h + hi) * state + e * 8;
  const float* lp = p.la_last + bi * p.nc * p.h + hi;
  float carry[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) carry[i] = 0.f;
  for (long long c0 = 0; c0 < p.nc; c0 += kPassAhead) {
    float4 sv[kPassAhead][2];
    float ll[kPassAhead];
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {  // the next chunks' loads in flight together
      if (c0 + j < p.nc) {
        const float4* src = reinterpret_cast<const float4*>(sp + (c0 + j) * step);
        sv[j][0] = src[0];
        sv[j][1] = src[1];
        ll[j] = lp[(c0 + j) * p.h];
      }
    }
#pragma unroll
    for (int j = 0; j < kPassAhead; ++j) {
      if (c0 + j >= p.nc) break;
      uint32_t h[4], l[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) split_bf16(carry[2 * i], carry[2 * i + 1], h[i], l[i]);
      float4* dst = reinterpret_cast<float4*>(sp + (c0 + j) * step);
      dst[0] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                           __uint_as_float(h[3]));
      dst[1] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                           __uint_as_float(l[3]));
      const float d = expf(ll[j]);
      const float s[8] = {sv[j][0].x, sv[j][0].y, sv[j][0].z, sv[j][0].w,
                          sv[j][1].x, sv[j][1].y, sv[j][1].z, sv[j][1].w};
#pragma unroll
      for (int i = 0; i < 8; ++i) carry[i] = __fadd_rn(__fmul_rn(d, carry[i]), s[i]);
    }
  }
}

// acc += C_q (state k-steps 4R .. 4R + 3) S_in piece R (state rows 64R ..
// 64R + 63), S_in as bf16 hi + lo: a shared row holds, for each 8 columns,
// their 8 hi then their 8 lo values.
template <int R, int PP>
__device__ __forceinline__ void state_piece(float (&acc)[PP / 8][4], const uint32_t (&cf)[8][4],
                                            const __nv_bfloat16* tile, int ld, int nk, int lane) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    if (R * 4 + kk >= nk) break;
#pragma unroll
    for (int dp = 0; dp < PP / 16; ++dp) {  // y columns dp*16 .. dp*16 + 15
      const __nv_bfloat16* row = tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * ld +
                                 dp * 32 + (lane >> 4) * 16;
      uint32_t bh[4], bl[4];
      ldmatrix_x4_trans(bh, smem_addr(row));
      ldmatrix_x4_trans(bl, smem_addr(row + 8));
      mma_bf16(acc[2 * dp], cf[R * 4 + kk], bh[0], bh[1]);
      mma_bf16(acc[2 * dp + 1], cf[R * 4 + kk], bh[2], bh[3]);
      mma_bf16(acc[2 * dp], cf[R * 4 + kk], bl[0], bl[1]);
      mma_bf16(acc[2 * dp + 1], cf[R * 4 + kk], bl[2], bl[3]);
    }
  }
}

// Stage 3: y for one (batch, chunk, 64-row q tile) and a group of up to
// kGroup heads. One stream of tiles through two shared slots: C_q, then B_k
// for k = 0 .. q tile (C_q B_k^T, once for the group), then per head the
// pieces of S_in and xdt_k for k = 0 .. q tile.
template <int PP>
__global__ void __launch_bounds__(kMmaThreads) ssd_fwd_outputs_bf16(const MmaParams p) {
  constexpr int kNT = PP / 8;  // 8-wide column tiles of y
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int q_len = p.chunk, n_kt = (q_len + kT - 1) / kT;
  const int ldc = p.np + 8, lds = 2 * PP + 8, ldx = PP + 8;  // odd numbers of 16-byte chunks
  const int slot = kT * max(ldc, lds);
  __nv_bfloat16* slots = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [2][slot]
  float4* gs = reinterpret_cast<float4*>(slots + 2 * slot);           // [n_kt][8][128]
  float* La = reinterpret_cast<float*>(gs + n_kt * 8 * kMmaThreads);  // [kGroup][n_kt * 64]
  float* tot = La + kGroup * n_kt * kT;                               // [kGroup][16]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row (and row + 8), column pair
  const long long ci = blockIdx.x / n_kt;
  const int qi = n_kt - 1 - static_cast<int>(blockIdx.x % n_kt);  // heaviest q tiles first
  const int q0 = qi * kT;
  const int h0 = blockIdx.y * kGroup, hg = min(kGroup, p.h - h0);
  const long long bi = blockIdx.z;
  const long long t0 = ci * q_len;
  const int nk = p.np / 16;                 // k-steps over the state rows
  const int n_sp = (p.np + kT - 1) / kT;    // 64-row pieces of a state
  const int per_head = n_sp + qi + 1;
  const int n_items = 2 + qi + hg * per_head;
  const __nv_bfloat16* cp = p.c + bi * p.c_b + t0 * p.c_s;
  const __nv_bfloat16* bp = p.b + bi * p.b_b + t0 * p.b_s;
  const __nv_bfloat16* xp = p.x + bi * p.x_b + t0 * p.x_s + h0 * p.x_h;
  const __nv_bfloat16* sp = reinterpret_cast<const __nv_bfloat16*>(
      p.ws + ((bi * p.nc + ci) * p.h + h0) * static_cast<long long>(p.np) * PP);
  __nv_bfloat16* yp = p.y + bi * p.y_b + t0 * p.y_s + h0 * p.y_h;
  const bool paired = ((p.y_b | p.y_s | p.y_h) & 1) == 0 &&
                      reinterpret_cast<uintptr_t>(p.y) % 4 == 0;

  auto issue = [&](int u) {
    __nv_bfloat16* dst = slots + (u & 1) * slot;
    if (u == 0) {
      load_tile(dst, ldc, cp + q0 * p.c_s, p.c_s, q_len - q0, p.n, p.np / 8, tid);
    } else if (u <= qi + 1) {
      const int k0 = (u - 1) * kT;
      load_tile(dst, ldc, bp + k0 * p.b_s, p.b_s, q_len - k0, p.n, p.np / 8, tid);
    } else {
      const int j = (u - qi - 2) / per_head, r = (u - qi - 2) % per_head;
      if (r < n_sp) {
        load_tile(dst, lds, sp + (j * p.np + r * kT) * 2 * PP, 2 * PP, p.np - r * kT, 2 * PP,
                  PP / 4, tid);
      } else {
        const int k0 = (r - n_sp) * kT;
        load_tile(dst, ldx, xp + j * p.x_h + k0 * p.x_s, p.x_s, q_len - k0, p.p, PP / 8, tid);
      }
    }
  };

  issue(0);
  cp_async_commit();
  {
    const int j = tid / kScan;  // La of the group's heads, 16 threads each
    chunk_cumsum(La + j * n_kt * kT, tot + j * kScan,
                 p.la + bi * p.la_b + t0 * p.la_s + (h0 + j) * p.la_h, p.la_s, q_len,
                 j < hg ? tid % kScan : -1);
  }

  const int row0 = warp * 16 + g;  // this thread's rows of the tile: row0 and row0 + 8
  uint32_t cf[8][4];               // C_q's A fragments, state k-steps < nk
  float acc[kNT][4];
#pragma unroll
  for (int d = 0; d < kNT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
  float la_q[2] = {0.f, 0.f};

  for (int u = 0; u < n_items; ++u) {
    if (u + 1 < n_items) {  // the next tile loads while this one multiplies
      issue(u + 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const __nv_bfloat16* tile = slots + (u & 1) * slot;
    if (u == 0) {
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk < nk) {
          ldmatrix_x4(cf[kk], smem_addr(tile + (warp * 16 + (lane & 15)) * ldc + kk * 16 +
                                        (lane >> 4) * 8));
        }
      }
    } else if (u <= qi + 1) {  // C_q B_k^T: 16 rows x 64 keys a warp, kept for every head
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        if (kk >= nk) break;
#pragma unroll
        for (int np2 = 0; np2 < 4; ++np2) {  // keys np2*16 .. np2*16 + 15
          uint32_t b[4];
          ldmatrix_x4(b, smem_addr(tile + (np2 * 16 + (lane & 7) + ((lane >> 4) << 3)) * ldc +
                                   kk * 16 + ((lane >> 3) & 1) * 8));
          mma_bf16(s[2 * np2], cf[kk], b[0], b[1]);
          mma_bf16(s[2 * np2 + 1], cf[kk], b[2], b[3]);
        }
      }
      float4* gk = gs + (u - 1) * 8 * kMmaThreads + tid;
#pragma unroll
      for (int n = 0; n < 8; ++n) gk[n * kMmaThreads] = make_float4(s[n][0], s[n][1], s[n][2], s[n][3]);
    } else {
      const int j = (u - qi - 2) / per_head, r = (u - qi - 2) % per_head;
      const float* laj = La + j * n_kt * kT;
      if (r == 0) {
        la_q[0] = laj[q0 + row0];
        la_q[1] = laj[q0 + row0 + 8];
      }
      if (r < n_sp) {  // the carried state's term, then its decay exp(La_q)
        if (r == 0) {
          state_piece<0, PP>(acc, cf, tile, lds, nk, lane);
        } else {
          state_piece<1, PP>(acc, cf, tile, lds, nk, lane);
        }
        if (r == n_sp - 1) {
          const float e0 = expf(la_q[0]), e1 = expf(la_q[1]);
#pragma unroll
          for (int d = 0; d < kNT; ++d) {
            acc[d][0] *= e0;
            acc[d][1] *= e0;
            acc[d][2] *= e1;
            acc[d][3] *= e1;
          }
        }
      } else {  // kv tile kj: (C_q B_k^T, masked and decayed) xdt_k
        const int kj = r - n_sp, k0 = kj * kT;
        const float4* gk = gs + kj * 8 * kMmaThreads + tid;
        float s[8][4];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float4 v = gk[n * kMmaThreads];
          s[n][0] = v.x;
          s[n][1] = v.y;
          s[n][2] = v.z;
          s[n][3] = v.w;
        }
        // element c of column tile n: row q0 + row0 + (c / 2) * 8, key k0 + n*8 + 2t + c % 2;
        // masked before the exp, as the reference does
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            const int key = k0 + n * 8 + 2 * t + (c & 1);
            const int q = q0 + row0 + (c >> 1) * 8;
            s[n][c] = key <= q && q < q_len ? s[n][c] * expf(la_q[c >> 1] - laj[key]) : 0.f;
          }
#pragma unroll
        for (int kk = 0; kk < kT / 16; ++kk) {  // keys kk*16 .. kk*16 + 15, hi then lo
          uint32_t ph[4], pl[4];
          split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
          split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
          split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
          split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
          for (int dp = 0; dp < PP / 16; ++dp) {
            uint32_t b[4];
            ldmatrix_x4_trans(b, smem_addr(tile + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) *
                                                      ldx + dp * 16 + (lane >> 4) * 8));
            mma_bf16(acc[2 * dp], ph, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], ph, b[2], b[3]);
            mma_bf16(acc[2 * dp], pl, b[0], b[1]);
            mma_bf16(acc[2 * dp + 1], pl, b[2], b[3]);
          }
        }
        if (kj == qi) {  // the head's last tile: y rounded to bf16 once
          __nv_bfloat16* yh = yp + j * p.y_h;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int q = q0 + row0 + i * 8;
            if (q >= q_len) continue;
            __nv_bfloat16* yr = yh + q * p.y_s;
#pragma unroll
            for (int d = 0; d < kNT; ++d) {
              const int col = d * 8 + 2 * t;
              if (paired && col + 1 < p.p) {
                *reinterpret_cast<__nv_bfloat162*>(yr + col) =
                    __floats2bfloat162_rn(acc[d][2 * i], acc[d][2 * i + 1]);
              } else {
                if (col < p.p) yr[col] = __float2bfloat16(acc[d][2 * i]);
                if (col + 1 < p.p) yr[col + 1] = __float2bfloat16(acc[d][2 * i + 1]);
              }
            }
          }
#pragma unroll
          for (int d = 0; d < kNT; ++d)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[d][c] = 0.f;
        }
      }
    }
    __syncthreads();  // every warp is done with this slot before it is refilled
  }
}

struct Bf16Smem {
  int states, outputs;
  Bf16Smem(int np, int pp, int chunk) {
    const int n_kt = (chunk + kT - 1) / kT;
    states = 2 * kT * (np + 8) * 2 + 2 * kT * (pp + 8) * 2 + (n_kt * kT + kScan) * 4;
    outputs = 2 * kT * std::max(np + 8, 2 * pp + 8) * 2 + n_kt * 8 * kMmaThreads * 16 +
              kGroup * (n_kt * kT + kScan) * 4;
  }
};

template <int PP>
int launch_bf16(const MmaParams& p, long long b, cudaStream_t stream) {
  const Bf16Smem bytes(p.np, PP, p.chunk);
  cudaError_t err = cudaFuncSetAttribute(ssd_fwd_states_bf16<PP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes.states);
  if (err == cudaSuccess) {
    err = cudaFuncSetAttribute(ssd_fwd_outputs_bf16<PP>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, bytes.outputs);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_kt = (p.chunk + kT - 1) / kT;
  const dim3 states(static_cast<unsigned>(p.nc * p.h), static_cast<unsigned>(b));
  ssd_fwd_states_bf16<PP><<<states, kMmaThreads, bytes.states, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 pass(static_cast<unsigned>((p.np * PP / 8 + kPassThreads - 1) / kPassThreads),
                  static_cast<unsigned>(p.h), static_cast<unsigned>(b));
  ssd_fwd_pass<PP><<<pass, kPassThreads, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 outputs(static_cast<unsigned>(p.nc * n_kt),
                     static_cast<unsigned>((p.h + kGroup - 1) / kGroup), static_cast<unsigned>(b));
  ssd_fwd_outputs_bf16<PP><<<outputs, kMmaThreads, bytes.outputs, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool cp_async_ready(const void* x, long long s_b, long long s_s, long long s_h) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && s_b % 8 == 0 && s_s % 8 == 0 &&
         s_h % 8 == 0;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// dtype: 0 float32 (the CUDA-core kernel), 1 bfloat16 (the three
// tensor-core kernels); xdt, B, C and y alike, la is float32. xdt and y are
// (b, s, h, p), la (b, s, h), B and C (b, s, n), each given by its strides
// in elements (unit stride along p and n); in bfloat16 xdt, B and C must
// start on a 16-byte boundary with strides that are multiples of 8. s must
// be a multiple of chunk. ws (ws_len floats, 16-byte aligned, at least
// b * (s / chunk) * h * np * PP with np = n rounded up to 16 and PP = 32
// for p <= 32, else 64) and la_last (b * (s / chunk) * h floats) are the
// bfloat16 path's scratch; the float32 path takes null.
extern "C" int ssd_fwd(
    const void* x, const float* la, const void* bmat, const void* cmat, void* y, float* ws,
    float* la_last, long long ws_len, int dtype, long long b, long long s, int h, int p, int n,
    int chunk, long long x_b, long long x_s, long long x_h, long long la_b, long long la_s,
    long long la_h, long long b_b, long long b_s, long long c_b, long long c_s, long long y_b,
    long long y_s, long long y_h, void* stream) {
  if (b < 1 || b > 65535 || s < 1 || h < 1 || p < 1 || p > 64 || n < 1 || n > kMaxN ||
      chunk < 1 || chunk > kMaxChunk || s % chunk != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    Params prm{x, la, bmat, cmat, y, s, p, n, chunk, x_b, x_s, x_h, la_b, la_s, la_h,
               b_b, b_s, c_b, c_s, y_b, y_s, y_h};
    return p <= 32 ? launch<32>(prm, b, h, st) : launch<64>(prm, b, h, st);
  }
  if (dtype != 1) return static_cast<int>(cudaErrorInvalidValue);
  if (!cp_async_ready(x, x_b, x_s, x_h) || !cp_async_ready(bmat, b_b, b_s, 0) ||
      !cp_async_ready(cmat, c_b, c_s, 0)) {
    return static_cast<int>(cudaErrorMisalignedAddress);
  }
  const long long nc = s / chunk;
  const int np = (n + 15) / 16 * 16, pp = p <= 32 ? 32 : 64;
  if (h > 65535 || nc * h > 2147483647LL || nc * ((chunk + kT - 1) / kT) > 2147483647LL ||
      ws == nullptr || la_last == nullptr || reinterpret_cast<uintptr_t>(ws) % 16 != 0 ||
      ws_len < b * nc * h * np * pp) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  MmaParams prm{static_cast<const __nv_bfloat16*>(x), la, static_cast<const __nv_bfloat16*>(bmat),
                static_cast<const __nv_bfloat16*>(cmat), static_cast<__nv_bfloat16*>(y), ws,
                la_last, nc, h, p, n, np, chunk, x_b, x_s, x_h, la_b, la_s, la_h, b_b, b_s,
                c_b, c_s, y_b, y_s, y_h};
  return pp == 32 ? launch_bf16<32>(prm, b, st) : launch_bf16<64>(prm, b, st);
}

extern "C" const char* ssd_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
