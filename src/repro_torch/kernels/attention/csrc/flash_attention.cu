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
// Two kernels, chosen by dtype at `flash_attention_fwd`; neither stands in
// for the other.
//
// bfloat16: `flash_fwd_kernel_bf16`, on the tensor cores. One block of 4
// warps owns (batch, head, 64-row q tile); each warp owns 16 query rows and
// loops over 64-key kv tiles between the causal and window limits of the
// tile's rows (fully masked kv tiles are skipped; q tiles run heaviest
// first: the last causal tile sees the most keys). 64 rows and 4 warps, not
// 128 and 8: at the serving prefill that is 3,584 blocks (7,168 at 32k) of
// 46 KB of shared memory, several a streaming multiprocessor, and the
// diagonal tiles that need a mask are half as large.
//   - Both products are `mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32`
//     with fragments from `ldmatrix` (`.trans` for V). S = q k^T is exact
//     products summed in fp32. The scale enters in fp32 after the product
//     (it is exact at dh 64, not at 80 or 128, so never on a bf16 q):
//     S and the running max m stay unscaled, and p = exp2(s c - m c) with
//     c = scale log2(e), one FMA and one exp2 an element. The S
//     accumulator fragments become the A fragments of P V in registers (P
//     never goes through shared memory); the row max and row sum reduce
//     over the 4 threads of a quad. Statistics and accumulator stay fp32.
//   - P is split: P_hi = bf16(P), P_lo = bf16(P - P_hi) (the difference is
//     exact in fp32), and each k-step of P V issues two mma passes, P_hi V
//     then P_lo V, so P keeps 16 significant bits; V is exact in bf16. The
//     row sum l is taken from the fp32 P before the split. Why: the check
//     (kernels/attention/cases.py) holds each bf16 output element to
//     2^-8 |ref| + 1e-5 against the plain version in fp32, and one output
//     rounding takes 0.99 of that. Emulated on the CPU in plain torch at
//     (2, 1024, 14/2, 64) bf16 causal, the largest share of the limit is
//     0.990 with P in fp32, 129 with P rounded once to bf16 (the usual
//     habit of tensor-core flash kernels), 13.5 with P in fp16 and 0.990
//     with the hi + lo split (tests/test_torch_attention_precision.py pins
//     the split inside the limit and a single bf16 P outside it). A single
//     pass is refused by the unchanged check. The split costs a third mma
//     pass: q k^T once, P V twice.
//   - K and V tiles are double-buffered in shared memory by
//     `cp.async.cg.shared.global` (16 bytes a thread, zero-filled past sk
//     and past dh) and `cp.async.wait_group`: the next tile loads while
//     this one multiplies. Q is loaded once a block, into registers.
//   - Shared rows are padded: a row holds DHP + 8 bf16, an odd number of
//     16-byte chunks, so the 8 row addresses of each `ldmatrix` phase fall
//     on 8 different groups of 4 banks: no bank conflicts, for every DHP.
//   - dh is padded with zeros to DHP = 64, 80 or 128, the widths the
//     port's configurations use (each a multiple of 16, the k of
//     m16n8k16): dh 80 is 5 k-steps, dh 8 to 56 pad to 64, dh 72 to 80
//     and dh 88 to 120 to 128.
//   - Only kv tiles that the causal, window or ragged sk edge cuts are
//     masked element by element; a masked score becomes -inf, so its p is
//     exactly 0, and the running max starts at -1e30 (the reference's mask
//     value), so a row that sees no key keeps l = 0 and gives 0.
//   - Shared memory: 5 tiles of 64 x (DHP + 8) bf16 (q, two k, two v):
//     46,080 bytes at DHP 64, 56,320 at 80, 87,040 at 128. Registers a
//     thread (ptxas `-v`, which `chip_smoke.py` phase `build` prints; no
//     spills): 154 at DHP 64, 188 at 80, 248 at 128.
//
// float32: `flash_fwd_kernel_f32`, on the CUDA cores, exact to the fp32
// sum order (tensor cores would cost the fp32 check its 1e-5 limit). One
// block of 256 threads owns (batch, head, 64-row q tile) and loops over
// 64-key kv tiles the same way. Per kv tile: K^T and V are staged in shared
// memory (K and Q transposed so a thread reads four rows or four keys as
// one float4), each thread computes a 4 x 4 block of the 64 x 64 score tile,
// the row max and sum are reduced across the 16 threads of a row group by
// warp shuffles, P^T goes through shared memory, and each thread
// accumulates 4 rows x (DHP / 16) columns of P V in registers. dh is padded
// with zeros to DHP = 64 or 128. Shared memory is 68.6 KB (DHP 64) or
// 119.8 KB (DHP 128).
//
// Both read their operands through batch, sequence and head strides (unit
// stride along dh) with 64-bit offsets, mask the ragged edges of sq and sk
// themselves, and raise the shared-memory limit with cudaFuncSetAttribute.
// The bf16 kernel needs 16-byte-aligned q, k and v with strides that are
// multiples of 8 elements (cp.async); the wrapper refuses anything else.
//
// What this design leaves on the table: `wgmma` (on mma.sync this kernel
// does 146 useful TFLOP/s at the qwen2-0.5b prefill shape and 180-182 at
// (1, 32768), of the 989 TFLOP/s bf16 dense rate: `chip_smoke.py` phase
// `times` on an H100 80GB HBM3 at 700 W), TMA loads with mbarriers in place of
// cp.async, warp specialisation (a producer warp feeding consumer
// warpgroups), a third pipeline stage, overlapping one tile's softmax with
// the next tile's q k^T, and packing the 7 query heads of a GQA group into
// one block so K and V are loaded once for all of them.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr float kNegInf = -1e30f;

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

// -- bfloat16: tensor cores ------------------------------------------------------

constexpr int kMmaBQ = 64;                // query rows of a block, 16 a warp
constexpr int kMmaBK = 64;                // keys of a kv tile
constexpr int kMmaThreads = 32 * kMmaBQ / 16;

template <int DHP>
struct MmaTile {
  static constexpr int kLd = DHP + 8;            // bf16 a shared row: an odd number of chunks
  static constexpr int kElems = kMmaBQ * kLd;    // one 64-row tile
  static constexpr int kSmemBytes = 5 * kElems * 2;  // q, two k, two v
};
static_assert(kMmaBQ == kMmaBK, "q, k and v tiles share one shape");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory; `valid` false reads nothing and
// writes 16 zero bytes.
__device__ __forceinline__ void cp_async_16(uint32_t dst, const void* src, bool valid) {
  const int bytes = valid ? 16 : 0;
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

// Rows [0, 64) of a tile from `src` (row r at src + r * stride), rows from
// `rows_left` on and columns from dh on zero-filled, by cp.async.
template <int DHP>
__device__ __forceinline__ void load_tile(__nv_bfloat16* tile, const __nv_bfloat16* src,
                                          long long stride, long long rows_left, int dh,
                                          int tid) {
  constexpr int kChunks = DHP / 8;  // 16-byte chunks a row
#pragma unroll
  for (int i = 0; i < kMmaBQ * kChunks / kMmaThreads; ++i) {
    const int e = tid + i * kMmaThreads;
    const int r = e / kChunks, c = e % kChunks;
    const bool valid = r < rows_left && c * 8 < dh;
    cp_async_16(smem_addr(tile + r * MmaTile<DHP>::kLd + c * 8),
                valid ? src + r * stride + c * 8 : src, valid);
  }
}

template <int DHP>
__global__ void __launch_bounds__(kMmaThreads) flash_fwd_kernel_bf16(const Params p) {
  using Tile = MmaTile<DHP>;
  constexpr int kLd = Tile::kLd;
  constexpr int kKSteps = DHP / 16;  // k-steps of q k^T
  constexpr int kST = kMmaBK / 8;    // 8-key column tiles of S
  constexpr int kOT = DHP / 8;       // 8-wide column tiles of the output
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [64][kLd]
  __nv_bfloat16* ks = qs + Tile::kElems;                            // [2][64][kLd]
  __nv_bfloat16* vs = ks + 2 * Tile::kElems;                        // [2][64][kLd]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t = lane % 4;  // fragment row (and row + 8), column pair
  const long long n_qt = (p.sq + kMmaBQ - 1) / kMmaBQ;
  const long long q0 = (n_qt - 1 - static_cast<long long>(blockIdx.x)) * kMmaBQ;
  const int hi = blockIdx.y;
  const long long bi = blockIdx.z;
  const int kvh = hi / (p.h / p.kv);
  const __nv_bfloat16* qp = static_cast<const __nv_bfloat16*>(p.q) + bi * p.q_b + hi * p.q_h;
  const __nv_bfloat16* kp = static_cast<const __nv_bfloat16*>(p.k) + bi * p.k_b + kvh * p.k_h;
  const __nv_bfloat16* vp = static_cast<const __nv_bfloat16*>(p.v) + bi * p.v_b + kvh * p.v_h;
  __nv_bfloat16* op = static_cast<__nv_bfloat16*>(p.o) + bi * p.o_b + hi * p.o_h;

  // the keys any row of this tile sees: [k_lo, k_hi)
  const long long pos_first = q0 + p.q_offset;
  const long long pos_last = min(q0 + kMmaBQ, p.sq) - 1 + p.q_offset;
  long long k_lo = 0, k_hi = p.sk;
  if (p.causal) k_hi = min(k_hi, pos_last + 1);
  if (p.window > 0) k_lo = max(k_lo, pos_first - p.window + 1);
  const long long k_start = k_hi > k_lo ? k_lo / kMmaBK * kMmaBK : k_hi;
  const int n_tiles = static_cast<int>((k_hi - k_start + kMmaBK - 1) / kMmaBK);

  const float scale_log2e = p.scale * 1.4426950408889634f;  // exp(x) = exp2(x log2(e))
  const long long row0 = q0 + warp * 16 + g;  // this thread's rows: row0 and row0 + 8
  const long long pos0 = row0 + p.q_offset;
  float o[kOT][4];
#pragma unroll
  for (int d = 0; d < kOT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[d][c] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};  // this thread's part of the row sum; the quad's at the end
  uint32_t qf[kKSteps][4];

  if (n_tiles > 0) {
    load_tile<DHP>(qs, qp + q0 * p.q_s, p.q_s, p.sq - q0, p.dh, tid);
    load_tile<DHP>(ks, kp + k_start * p.k_s, p.k_s, p.sk - k_start, p.dh, tid);
    load_tile<DHP>(vs, vp + k_start * p.v_s, p.v_s, p.sk - k_start, p.dh, tid);
    cp_async_commit();
  }
  for (int it = 0; it < n_tiles; ++it) {
    const long long k0 = k_start + static_cast<long long>(it) * kMmaBK;
    const int buf = it & 1;
    if (it + 1 < n_tiles) {  // the next tile loads while this one multiplies
      const long long k1 = k0 + kMmaBK;
      load_tile<DHP>(ks + (buf ^ 1) * Tile::kElems, kp + k1 * p.k_s, p.k_s, p.sk - k1, p.dh, tid);
      load_tile<DHP>(vs + (buf ^ 1) * Tile::kElems, vp + k1 * p.v_s, p.v_s, p.sk - k1, p.dh, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        ldmatrix_x4(qf[kk], smem_addr(qs + (warp * 16 + (lane & 15)) * kLd + kk * 16 +
                                      (lane >> 4) * 8));
      }
    }
    const __nv_bfloat16* kt = ks + buf * Tile::kElems;
    const __nv_bfloat16* vt = vs + buf * Tile::kElems;

    // S = q k^T: 16 rows x 64 keys a warp, in kST column tiles of 8 keys
    float s[kST][4];
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
#pragma unroll
      for (int np = 0; np < kST / 2; ++np) {  // keys np*16 .. np*16 + 15
        uint32_t b[4];
        ldmatrix_x4(b, smem_addr(kt + (np * 16 + (lane & 7) + ((lane >> 4) << 3)) * kLd +
                                 kk * 16 + ((lane >> 3) & 1) * 8));
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // element c of column tile n: row row0 + (c / 2) * 8, key k0 + n*8 + 2t + c % 2;
    // S, m and the mask stay unscaled: the scale enters with log2(e) in exp2's FMA
    const bool masked = k0 + kMmaBK > p.sk || (p.causal && k0 + kMmaBK - 1 > pos_first) ||
                        (p.window > 0 && k0 <= pos_last - p.window);
    if (masked) {
#pragma unroll
      for (int n = 0; n < kST; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const long long key = k0 + n * 8 + 2 * t + (c & 1);
          const long long pos = pos0 + (c >> 1) * 8;
          const bool seen = key < p.sk && (!p.causal || key <= pos) &&
                            (p.window <= 0 || key > pos - p.window);
          if (!seen) s[n][c] = __int_as_float(0xff800000);  // -inf
        }
    }

    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < kST; ++n) {
      mx[0] = fmaxf(mx[0], fmaxf(s[n][0], s[n][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[n][2], s[n][3]));
    }
    float alpha[2], row_sum[2] = {0.f, 0.f};
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      alpha[i] = exp2f((m[i] - mx[i]) * scale_log2e);
      m[i] = mx[i];
      mx[i] *= scale_log2e;
    }
#pragma unroll
    for (int n = 0; n < kST; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {  // exp(scale (s - m)); 0 where masked: mx is finite
        s[n][c] = exp2f(fmaf(s[n][c], scale_log2e, -mx[c >> 1]));
        row_sum[c >> 1] += s[n][c];
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = alpha[i] * l[i] + row_sum[i];
#pragma unroll
    for (int d = 0; d < kOT; ++d) {
      o[d][0] *= alpha[0];
      o[d][1] *= alpha[0];
      o[d][2] *= alpha[1];
      o[d][3] *= alpha[1];
    }

    // O += P V over 4 k-steps of 16 keys, P_hi V then P_lo V
#pragma unroll
    for (int kk = 0; kk < kMmaBK / 16; ++kk) {
      uint32_t ph[4], pl[4];  // A fragments: keys kk*16 + 2t (0, 1) and + 8 (2, 3)
      split_bf16(s[2 * kk][0], s[2 * kk][1], ph[0], pl[0]);
      split_bf16(s[2 * kk][2], s[2 * kk][3], ph[1], pl[1]);
      split_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1], ph[2], pl[2]);
      split_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3], ph[3], pl[3]);
#pragma unroll
      for (int dp = 0; dp < kOT / 2; ++dp) {  // output columns dp*16 .. dp*16 + 15
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_addr(vt + (kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * kLd +
                                       dp * 16 + (lane >> 4) * 8));
        mma_bf16(o[2 * dp], ph, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], ph, b[2], b[3]);
        mma_bf16(o[2 * dp], pl, b[0], b[1]);
        mma_bf16(o[2 * dp + 1], pl, b[2], b[3]);
      }
    }
    __syncthreads();  // every warp is done with this buffer before it is refilled
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const long long row = row0 + i * 8;
    if (row >= p.sq) continue;
    const float safe_l = l[i] > 0.f ? l[i] : 1.f;
    __nv_bfloat16* orow = op + row * p.o_s;
#pragma unroll
    for (int d = 0; d < kOT; ++d) {
      const int col = d * 8 + 2 * t;
      if (col < p.dh) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(o[d][2 * i] / safe_l, o[d][2 * i + 1] / safe_l);
      }
    }
  }
}

template <int DHP>
int launch_bf16(const Params& p, long long b, cudaStream_t stream) {
  constexpr int bytes = MmaTile<DHP>::kSmemBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_bf16<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.sq + kMmaBQ - 1) / kMmaBQ), static_cast<unsigned>(p.h),
                  static_cast<unsigned>(b));
  flash_fwd_kernel_bf16<DHP><<<grid, kMmaThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

int launch_bf16_dh(const Params& p, long long b, cudaStream_t stream) {
  if (p.dh <= 64) return launch_bf16<64>(p, b, stream);
  if (p.dh <= 80) return launch_bf16<80>(p, b, stream);
  return launch_bf16<128>(p, b, stream);
}

// -- float32: CUDA cores ---------------------------------------------------------

constexpr int kBQ = 64;         // query rows of a block
constexpr int kBK = 64;         // keys of a kv tile
constexpr int kThreads = 256;   // 16 row groups x 16 column groups
constexpr int kLd = kBQ + 4;    // row length (floats) of the transposed tiles:
                                // a multiple of 4 keeps float4 alignment

static_assert(kBQ == kBK, "the transposed tiles share one row length");

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

template <int DHP>
__global__ void __launch_bounds__(kThreads) flash_fwd_kernel_f32(const Params p) {
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
  const float* qp = static_cast<const float*>(p.q) + bi * p.q_b + hi * p.q_h;
  const float* kp = static_cast<const float*>(p.k) + bi * p.k_b + kvh * p.k_h;
  const float* vp = static_cast<const float*>(p.v) + bi * p.v_b + kvh * p.v_h;
  float* op = static_cast<float*>(p.o) + bi * p.o_b + hi * p.o_h;

  for (int e = tid; e < kBQ * DHP; e += kThreads) {
    const int r = e / DHP, d = e % DHP;
    const long long row = q0 + r;
    float x = 0.f;
    if (row < p.sq && d < p.dh) x = qp[row * p.q_s + d] * p.scale;
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
        kx = kp[key * p.k_s + d];
        vx = vp[key * p.v_s + d];
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
        if (col < p.dh) op[row * p.o_s + col] = acc[i][u * 4 + c] / safe_l;
      }
  }
}

template <int DHP>
int launch_f32(const Params& p, long long b, cudaStream_t stream) {
  constexpr int bytes = smem_floats<DHP>() * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel_f32<DHP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.sq + kBQ - 1) / kBQ), static_cast<unsigned>(p.h),
                  static_cast<unsigned>(b));
  flash_fwd_kernel_f32<DHP><<<grid, kThreads, bytes, stream>>>(p);
  return static_cast<int>(cudaGetLastError());
}

bool cp_async_ready(const void* x, long long s_b, long long s_s, long long s_h) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && s_b % 8 == 0 && s_s % 8 == 0 &&
         s_h % 8 == 0;
}

}  // namespace

// Launch on `stream`; returns the cudaError_t of the launch (0 on success).
// dtype: 0 float32 (the CUDA-core kernel), 1 bfloat16 (the tensor-core
// kernel); q, k, v and out alike. q is (b, sq, h, dh), k and v (b, sk, kv,
// dh), out (b, sq, h, dh), each given by its batch, sequence and head
// strides in elements (unit stride along dh); in bfloat16 each must start
// on a 16-byte boundary with strides that are multiples of 8. window <= 0
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
  if (dtype == 0) return dh <= 64 ? launch_f32<64>(p, b, s) : launch_f32<128>(p, b, s);
  if (dtype == 1) {
    if (!cp_async_ready(q, q_b, q_s, q_h) || !cp_async_ready(k, k_b, k_s, k_h) ||
        !cp_async_ready(v, v_b, v_s, v_h) || !cp_async_ready(out, o_b, o_s, o_h)) {
      return static_cast<int>(cudaErrorMisalignedAddress);
    }
    return launch_bf16_dh(p, b, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
