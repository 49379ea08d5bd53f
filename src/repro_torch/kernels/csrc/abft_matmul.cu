// Fused block-ABFT matmul for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel ``abft_matmul_kernel`` in
// src/repro/kernels/abft_matmul.py (body ``_kernel``, fault ``_apply_fault``).
// Y = X . W with f32 accumulation; from the same shared-memory tiles it
// accumulates the ABFT checksums of the logical (bm, bk, bn) block:
//   mode 1s      chk[row] += A . rowsum(B),  bnd[row] += |A| . rowsum|B|,
//                residual |chk - rowsum(acc)| per (block_i, block_j, row);
//   mode 2s      the same per-row sums folded to one scalar per block;
//   mode replica the block product issued a second time and summed per row,
//                flushed at every logical bk boundary like the TPU grid step.
// An optional fault corrupts one f32 accumulator element after the checksums
// have read the tiles and before the y store and the row sum.
//
// What bounds it on the H100: at decode (M = 4 tokens) the weight bytes —
// the whole GEMM is a stream of W at 3.35 TB/s; at prefill and in the
// full-sequence forward (M = 512 .. 2048) the multiply-adds: 989 TFLOP/s
// on the bf16 tensor cores, 67 TFLOP/s in f32 on the CUDA cores (the f32
// train step; TF32 stays off).  In f32 the old CUDA-core tile (64 x 64,
// 32 FMAs per 12 shared-memory reads, scalar loads, no load in flight
// during the FMAs, a serial checksum phase on 64 of 128 threads and an
// (S, M, N) round trip through HBM on every K split) ran far below that
// peak; the SIMT route below is a register-blocked SGEMM (PERF.md).
//
// Design.  The logical BlockShape (default 256/512/256, clamped by the
// wrapper) fixes the residual's shape and the cost model; it is kept apart
// from the CUDA tile, which never straddles a logical block.  Pass 1 has
// three routes, picked by the wrapper before the launch, which also passes
// the tile it sized the scratch for (kernels/abft_matmul.py::route, tile):
//   - tensor cores (bf16, modes 1s/2s, 16-byte aligned rows; decode
//     included, where it beats the GEMV on bf16): the paper's
//     split — the product on the matrix unit, the checksums on the
//     otherwise idle CUDA cores from the same shared-memory tiles, no extra
//     HBM traffic.  A CUDA block owns a 64 or 128 x 128 tile; TMA keeps a
//     ring of stages in flight (128-byte swizzle, zero fill past the
//     edges); MMA warpgroups run wgmma m64n128k16 (W row-major through the
//     transpose flag, the tied head's embed^T K-major: no copy of it) and
//     take their rows' checksums A . bsum; checksum warpgroups take the
//     stage's column sums bsum, babs of W in f32 (abft_tc_pass1).  With one
//     K slice the epilogue applies the fault and stores y itself and pass 2
//     only folds per-row partials (abft_tc_pass2); with a few tiles K is
//     split and abft_tc_reduce sums the slices first;
//   - decode GEMV (f32, M <= 8, row-major W): 16-byte loads, whole
//     128-byte lines per 8-lane group, the checksum from the same
//     registers (its bf16 form is only launched when forced, to time it
//     against the tensor cores);
//   - SIMT (f32, M > 8, modes 1s/2s, 16-byte aligned rows; W row-major or
//     the tied head's embed^T): a 128 x 128 tile (a smaller clamped block
//     masks its rows and columns within it) of 256 threads with 8 x 8
//     accumulators each, A
//     k-major through registers one stage ahead, a ring of 16-deep B
//     stages by cp.async, and the paper's split again: the column sums of
//     each B stage and the rows' A . bsum on all threads from the same
//     shared-memory tiles (abft_simt_pass1).  The same epilogue and pass 2
//     as the tensor-core route: one K slice stores y and the row sums, no
//     (S, M, N) round trip;
//   - CUDA-core tiles (mode replica, and operands whose rows are not
//     16-byte aligned): a TM x 64 tile (TM = 8, 32 or 64 rows, 4 x RM
//     outputs a thread, plain FMA) of one logical block and one K slice.
// The GEMV and tiled routes write partial accumulators and per-row partial
// checksums to scratch; pass 2 sums the K slices in a fixed order, applies
// the fault, stores y and reduces rows over the logical block's bn
// columns.  There are no floating-point atomics: every sum has a fixed
// order, so a retry reproduces the attempt bit for bit.  K slicing is what
// fills the 132 SMs where one block row gives few tiles.  Ragged edges are
// masked in the loads (zero fill) — nothing is padded or copied.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int TN = 64;    // CUDA tile columns (16 column groups x 4)
constexpr int TK = 32;    // k depth of one shared-memory stage
constexpr int NT = 128;   // threads per CUDA block (16 x 8)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Geo {
  int M, K, N;
  int bm, bk, bn;         // logical (clamped) block shape
  int gm, gn;             // logical grid
  int row_tiles;          // CUDA row tiles per logical block row
  int col_tiles;          // CUDA column tiles per logical block column
  int tn;                 // CUDA tile columns (TN, or TC_TN on tensor cores)
  int tm;                 // CUDA tile rows of the tensor-core route
  int S, kc;              // K slices and their depth
  long long lda;          // row stride of A (unit column stride)
  long long sbk, sbn;     // strides of B along k and n
};

struct Fault {
  int enabled, bi, bj, row, col, bit;
  float delta;
};

// Pass 1: partial products and partial checksums of one CUDA tile over one
// K slice.  REPLICA selects the replica checksum; otherwise the one-sided
// checksum (also the per-row input of the two-sided fold).
template <typename TI, int RM, bool REPLICA>
__global__ void __launch_bounds__(NT)
abft_pass1(const TI* __restrict__ A, const TI* __restrict__ B, Geo g,
           float* __restrict__ part_acc, float* __restrict__ part_chk,
           float* __restrict__ part_bnd) {
  constexpr int TM = 8 * RM;
  const int cx = blockIdx.x, ry = blockIdx.y, s = blockIdx.z;
  const int j = cx / g.col_tiles, sub = cx % g.col_tiles;
  const int i = ry / g.row_tiles, rt = ry % g.row_tiles;
  const int col0 = j * g.bn + sub * TN;
  const int col_end = min(min(col0 + TN, (j + 1) * g.bn), g.N);
  const int row0 = i * g.bm + rt * TM;
  const int row_end = min(min(row0 + TM, (i + 1) * g.bm), g.M);
  const int k0 = s * g.kc;
  const int k1 = min(k0 + g.kc, g.K);
  if (col0 >= col_end || row0 >= row_end || k0 >= k1) return;

  // rows padded by one float: threads that walk the row index (the
  // transposed loads, the checksum loop) hit distinct banks
  __shared__ float As[TK][TM + 1];
  __shared__ float Bs[TK][TN + 1];
  __shared__ float bsum[TK], babs[TK];
  __shared__ float red_c[TM][17], red_b[TM][17];

  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  float acc[RM][4], redo[RM][4];
  float rchk[RM], rbnd[RM];
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    rchk[a] = 0.f;
    rbnd[a] = 0.f;
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = redo[a][b] = 0.f;
  }
  float chk_r = 0.f, bnd_r = 0.f;   // one-sided sums, thread tid < TM

  for (int kt = k0; kt < k1;) {
    // a stage never crosses a logical bk boundary (the replica flush
    // point) nor the slice end
    const int kend = min(min(kt + TK, k1), (kt / g.bk + 1) * g.bk);
    const int kw = kend - kt;
    for (int e = tid; e < TM * TK; e += NT) {
      const int r = e / TK, kk = e % TK;
      const int row = row0 + r;
      As[kk][r] = (row < row_end && kk < kw)
                      ? to_f32(A[(long long)row * g.lda + kt + kk]) : 0.f;
    }
    if (g.sbn == 1) {       // row-major W: neighbouring threads along n
      for (int e = tid; e < TK * TN; e += NT) {
        const int kk = e / TN, c = e % TN, col = col0 + c;
        Bs[kk][c] = (kk < kw && col < col_end)
            ? to_f32(B[(long long)(kt + kk) * g.sbk + col]) : 0.f;
      }
    } else {                // transposed view (tied head): along k
      for (int e = tid; e < TK * TN; e += NT) {
        const int kk = e % TK, c = e / TK, col = col0 + c;
        Bs[kk][c] = (kk < kw && col < col_end)
            ? to_f32(B[(long long)(kt + kk) * g.sbk +
                       (long long)col * g.sbn]) : 0.f;
      }
    }
    __syncthreads();

#pragma unroll 8
    for (int kk = 0; kk < TK; ++kk) {
      float av[RM], bv[4];
#pragma unroll
      for (int a = 0; a < RM; ++a) av[a] = As[kk][ty * RM + a];
#pragma unroll
      for (int b = 0; b < 4; ++b) bv[b] = Bs[kk][tx * 4 + b];
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
          if (REPLICA) redo[a][b] = fmaf(av[a], bv[b], redo[a][b]);
        }
    }

    if (!REPLICA) {
      // b_sum / |b| sums of this stage over the tile's columns (CUDA
      // cores, independent of the product's data path)
      if (tid < TK) {
        float sum = 0.f;
        for (int c = 0; c < TN; ++c) sum += Bs[tid][c];
        bsum[tid] = sum;
      } else if (tid < 2 * TK) {
        float sum = 0.f;
        for (int c = 0; c < TN; ++c) sum += fabsf(Bs[tid - TK][c]);
        babs[tid - TK] = sum;
      }
      __syncthreads();
      if (tid < TM) {
        for (int kk = 0; kk < TK; ++kk) {
          const float a = As[kk][tid];
          chk_r = fmaf(a, bsum[kk], chk_r);
          bnd_r = fmaf(fabsf(a), babs[kk], bnd_r);
        }
      }
    } else if (kend == k1 || kend % g.bk == 0) {
      // end of a logical bk step: fold the replicated product into the
      // row checksum, as the TPU kernel does once per grid step
#pragma unroll
      for (int a = 0; a < RM; ++a)
#pragma unroll
        for (int b = 0; b < 4; ++b) {
          rchk[a] += redo[a][b];
          rbnd[a] += fabsf(redo[a][b]);
          redo[a][b] = 0.f;
        }
    }
    __syncthreads();
    kt = kend;
  }

  const long long base = (long long)s * g.M;
#pragma unroll
  for (int a = 0; a < RM; ++a) {
    const int row = row0 + ty * RM + a;
    if (row >= row_end) continue;
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      const int col = col0 + tx * 4 + b;
      if (col < col_end)
        part_acc[(base + row) * g.N + col] = acc[a][b];
    }
  }
  const int gx = g.gn * g.col_tiles;
  if (REPLICA) {
#pragma unroll
    for (int a = 0; a < RM; ++a) {
      red_c[ty * RM + a][tx] = rchk[a];
      red_b[ty * RM + a][tx] = rbnd[a];
    }
    __syncthreads();
    if (tid < TM) {
      float c = 0.f, b = 0.f;
      for (int t = 0; t < 16; ++t) {
        c += red_c[tid][t];
        b += red_b[tid][t];
      }
      chk_r = c;
      bnd_r = b;
    }
  }
  if (tid < TM && row0 + tid < row_end) {
    part_chk[(base + row0 + tid) * gx + cx] = chk_r;
    part_bnd[(base + row0 + tid) * gx + cx] = bnd_r;
  }
}

__device__ __forceinline__ void load8(const __nv_bfloat16* p, float* w) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    w[2 * i] = f.x;
    w[2 * i + 1] = f.y;
  }
}
__device__ __forceinline__ void load8(const float* p, float* w) {
  const float4 a = __ldg(reinterpret_cast<const float4*>(p));
  const float4 b = __ldg(reinterpret_cast<const float4*>(p) + 1);
  w[0] = a.x; w[1] = a.y; w[2] = a.z; w[3] = a.w;
  w[4] = b.x; w[5] = b.y; w[6] = b.z; w[7] = b.w;
}

// Pass 1, decode fast path (M <= MR rows, row-major W with 16-byte rows,
// bn a multiple of 64; one-sided partials, also the two-sided input).
// A CUDA block owns one 64-column tile and one K slice: each 8-lane group
// streams one k-row of the tile (8 columns per lane, one 128-byte line per
// group), the block's 32 groups take 32 k-rows per iteration.  The row
// checksum uses the same registers: chk += x * sum(w[k, 8 cols]).  Partials
// are reduced over groups by shuffles and over warps through shared memory,
// in a fixed order, into the same scratch layout as the tiled pass 1.
template <typename TI, int MR>
__global__ void __launch_bounds__(256)
abft_gemv_pass1(const TI* __restrict__ A, const TI* __restrict__ B, Geo g,
                float* __restrict__ part_acc, float* __restrict__ part_chk,
                float* __restrict__ part_bnd) {
  const int cx = blockIdx.x, s = blockIdx.y;
  const int col0 = cx * TN;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int grp = lane >> 3, c8 = (lane & 7) * 8;
  const int k0 = s * g.kc;
  const int k1 = min(k0 + g.kc, g.K);
  const bool col_ok = col0 + c8 < g.N;
  __shared__ float red[8][MR][TN];
  __shared__ float red_c[8][MR], red_b[8][MR];

  float acc[MR][8], chk[MR], bnd[MR];
#pragma unroll
  for (int m = 0; m < MR; ++m) {
    chk[m] = bnd[m] = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[m][j] = 0.f;
  }
#pragma unroll 4
  for (int k = k0 + warp * 4 + grp; k < k1; k += 32) {
    float w[8];
    if (col_ok) {
      load8(B + (long long)k * g.sbk + col0 + c8, w);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) w[j] = 0.f;
    }
    float s8 = 0.f, a8 = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      s8 += w[j];
      a8 += fabsf(w[j]);
    }
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      if (m < g.M) {
        const float xv = to_f32(A[(long long)m * g.lda + k]);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[m][j] = fmaf(xv, w[j], acc[m][j]);
        chk[m] = fmaf(xv, s8, chk[m]);
        bnd[m] = fmaf(fabsf(xv), a8, bnd[m]);
      }
    }
  }
#pragma unroll
  for (int m = 0; m < MR; ++m) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float v = acc[m][j];
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      acc[m][j] = v;
    }
    float c = chk[m], b = bnd[m];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      c += __shfl_xor_sync(0xffffffffu, c, o);
      b += __shfl_xor_sync(0xffffffffu, b, o);
    }
    chk[m] = c;
    bnd[m] = b;
  }
  if (grp == 0) {
#pragma unroll
    for (int m = 0; m < MR; ++m)
#pragma unroll
      for (int j = 0; j < 8; ++j) red[warp][m][c8 + j] = acc[m][j];
  }
  if (lane == 0) {
#pragma unroll
    for (int m = 0; m < MR; ++m) {
      red_c[warp][m] = chk[m];
      red_b[warp][m] = bnd[m];
    }
  }
  __syncthreads();
  const long long base = (long long)s * g.M;
  for (int e = tid; e < MR * TN; e += 256) {
    const int m = e / TN, c = e % TN;
    if (m < g.M && col0 + c < g.N) {
      float v = 0.f;
      for (int w_ = 0; w_ < 8; ++w_) v += red[w_][m][c];
      part_acc[(base + m) * g.N + col0 + c] = v;
    }
  }
  if (tid < g.M && tid < MR) {
    float c = 0.f, b = 0.f;
    for (int w_ = 0; w_ < 8; ++w_) {
      c += red_c[w_][tid];
      b += red_b[w_][tid];
    }
    const int gx = g.gn * g.col_tiles;
    part_chk[(base + tid) * gx + cx] = c;
    part_bnd[(base + tid) * gx + cx] = b;
  }
}

// ------------------------------------------------ tensor-core pass 1

constexpr int TC_TN = 128;   // CUDA tile columns (one m64n128 wgmma)
constexpr int TC_TK = 64;    // k depth of a stage: one 128-byte smem row

__device__ __forceinline__ float fault_value(const Fault& f, float v) {
  return f.bit >= 0 ? __uint_as_float(__float_as_uint(v) ^ (1u << f.bit))
                    : v + f.delta;
}

__device__ __forceinline__ float sum8(const float* x) {
  return ((x[0] + x[1]) + (x[2] + x[3])) + ((x[4] + x[5]) + (x[6] + x[7]));
}
__device__ __forceinline__ float asum8(const float* x) {
  return ((fabsf(x[0]) + fabsf(x[1])) + (fabsf(x[2]) + fabsf(x[3]))) +
         ((fabsf(x[4]) + fabsf(x[5])) + (fabsf(x[6]) + fabsf(x[7])));
}

// Shared memory of the tensor-core pass 1 (bytes): 1 KB of slack to align
// the ring to the 128-byte swizzle's 1024-byte atom, the ring of NS
// stages (A then B), each stage's column sums, the cross-warp partials,
// and a full, a sums-ready and an empty mbarrier a stage.
template <int WG>
struct TcSmem {
  static constexpr int TM = 64 * WG;
  static constexpr int MT = 128 * WG;             // MMA threads
  static constexpr int CK = 128 * WG;             // checksum threads
  static constexpr int NS = WG == 2 ? 5 : 4;      // stages in the ring
  // the producer refills the slot of stage it - 2 after the column sums of
  // stage it: the MMA warps released it an iteration ago, so the checksum
  // warps never wait on the MMA warps of the current stage
  static constexpr int LAG = 2;
  static constexpr int A_BYTES = TM * 128;        // TM rows x 64 bf16
  static constexpr int B_BYTES = TC_TN * 128;     // 128 cols x 64 bf16
  static constexpr int STAGE = A_BYTES + B_BYTES;
  static constexpr int RING = NS * STAGE;
  static constexpr int CW = CK / 32;
  static constexpr int F32S = NS * 2 * 64 + CW * 2 * 64;
  static constexpr int BYTES = 1024 + RING + 4 * F32S + 24 * NS;
};

// Pass 1 on the tensor cores, bf16 operands, modes 1s/2s.  One CUDA block
// owns a (64 WG) x 128 tile of ONE logical block and one K slice, with
// three roles over a ring of NS stages:
//   - one thread (the first checksum thread) loads A and B by TMA (128-byte
//     swizzle, zero fill out of bounds), each stage completing on its full
//     mbarrier, and refills a slot once its empty mbarrier says both
//     consumers are done with it;
//   - WG checksum warpgroups take each stage's column sums of B on the
//     CUDA cores in f32: bsum[k] = sum_c B[k, c] and babs[k] =
//     sum_c |B[k, c]| over the tile's columns inside the logical block (a
//     box may reach into the next block: those columns are masked here
//     and never stored), and signal them on the stage's sums-ready
//     mbarrier;
//   - WG MMA warpgroups read each stage's A tile once, by ldmatrix into
//     registers, and issue wgmma with A from those registers and B from
//     shared memory; once a stage's wgmma has retired, the same registers
//     give their rows' checksums on the CUDA cores: chk[row] +=
//     A[row, :] . bsum and bnd[row] += |A[row, :]| . babs.  At the end
//     they store y (or the partial accumulator) and the rows' partial
//     rowsum(acc).
// On the H100 the checksums' shared-memory reads compete with the tensor
// cores' operand fetch: the CUDA-core phases, not the wgmma, set the pace
// of a stage (PERF.md).
// A is K-major in shared memory; B is K-major (KMAJ: a column-major W, the
// tied head's embed^T) or MN-major (a row-major W, in two 64-column
// swizzle atoms 8 KB apart; wgmma's transpose flag).  With one K slice
// (g.S == 1) the epilogue applies the fault and stores y itself;
// otherwise it stores the partial accumulator for abft_tc_reduce.
template <int WG, bool KMAJ>
__global__ void __launch_bounds__(256 * WG, 1)
abft_tc_pass1(const __grid_constant__ CUtensorMap tma_a,
              const __grid_constant__ CUtensorMap tma_b, Geo g, Fault f,
              void* __restrict__ Y, int out_bf16,
              float* __restrict__ part_acc, float* __restrict__ part_chk,
              float* __restrict__ part_bnd, float* __restrict__ part_rs) {
  using L = TcSmem<WG>;
  constexpr int TM = L::TM, MT = L::MT, CK = L::CK, NS = L::NS;
  const int rt_all = blockIdx.x, cx = blockIdx.y, s = blockIdx.z;
  const int i = rt_all / g.row_tiles, rt = rt_all % g.row_tiles;
  const int j = cx / g.col_tiles, sub = cx % g.col_tiles;
  const int row0 = i * g.bm + rt * TM;
  const int row_end = min(min(row0 + TM, (i + 1) * g.bm), g.M);
  const int col0 = j * g.bn + sub * TC_TN;
  const int col_end = min(min(col0 + TC_TN, (j + 1) * g.bn), g.N);
  const int k0 = s * g.kc;
  const int k1 = min(k0 + g.kc, g.K);
  if (row0 >= row_end || col0 >= col_end || k0 >= k1) return;
  const int lim = col_end - col0;      // live columns of the tile

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = hk::smem_u32(smem_raw);
  const uint32_t ring = (raw + 1023u) & ~1023u;
  uint8_t* ring_p = smem_raw + (ring - raw);
  float* sums = reinterpret_cast<float*>(ring_p + L::RING);  // NS x {s, a}
  float* red = sums + NS * 2 * 64;     // CW x {sum, abs} x 64 (K-major B)
  const uint32_t full = ring + L::RING + 4 * L::F32S;
  const uint32_t empty = full + 8 * NS;
  const uint32_t ready = empty + 8 * NS;

  const int tid = threadIdx.x, lane = tid & 31;
  const int nk = (k1 - k0 + TC_TK - 1) / TC_TK;
  const long long pbase = (long long)s * g.M;
  const int gx = g.gn * g.col_tiles;

  auto issue = [&](int it) {           // the producer: stage it by TMA
    const int st = it % NS, kt = k0 + it * TC_TK;
    const uint32_t sa = ring + st * L::STAGE, sb = sa + L::A_BYTES;
    const uint32_t bar = full + st * 8;
    hk::mbar_expect_tx(bar, L::STAGE);
    hk::tma_load_2d(sa, &tma_a, bar, kt, row0);
    if (KMAJ) {
      hk::tma_load_2d(sb, &tma_b, bar, kt, col0);
    } else {
      hk::tma_load_2d(sb, &tma_b, bar, col0, kt);
      hk::tma_load_2d(sb + 8192, &tma_b, bar, col0 + 64, kt);
    }
  };
  if (tid == 0) {
    for (int st = 0; st < NS; ++st) {
      hk::mbar_init(full + st * 8, 1);
      hk::mbar_init(empty + st * 8, MT / 32 + 1);
      hk::mbar_init(ready + st * 8, 1);
    }
    hk::mbar_fence_init();
  }
  __syncthreads();
  if (tid == MT)
    for (int p = 0; p < NS && p < nk; ++p) issue(p);

  if (tid < MT) {
    // ------------------------------------------------ MMA warpgroups
    const int wg = tid >> 7, wq = (tid >> 5) & 3;
    const int gr = lane >> 2, qd = lane & 3;
    // A reaches the tensor cores from registers (ldmatrix from the stage's
    // swizzled tile, the m16n8k16 A-fragment layout): the same registers
    // give this thread's share of its two rows' checksums, so A is read
    // from shared memory once a stage.  Two chains per quantity.
    float chk_r[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float bnd_r[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float acc[64];
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = 0.f;
    using Frag = uint32_t[TC_TK / 16][4];
    auto fetch_a = [&](int it, Frag& dst) {   // A fragments of stage it
      const int st = it % NS;
      hk::mbar_wait(full + st * 8, (it / NS) & 1);
      const uint32_t sa = ring + st * L::STAGE;
#pragma unroll
      for (int kk = 0; kk < TC_TK / 16; ++kk) {
        const int r = wg * 64 + wq * 16 + (lane & 15);
        const int c = kk * 2 + (lane >> 4);
        hk::ldmatrix_x4(dst[kk], sa + r * 128 + ((c ^ (r & 7)) << 4));
      }
    };
    // chk[row] += A . bsum, bnd[row] += |A| . babs over this thread's k of
    // stage it (fragment register 2 j + h holds row gr + 8 h, k = 16 kk +
    // 8 j + 2 qd and + 1), once its column sums are ready
    auto row_checksums = [&](int it, const Frag& fa) {
      const int st = it % NS;
      hk::mbar_wait(ready + st * 8, (it / NS) & 1);
      const float* bsum = sums + st * 128;
      const float* babs = bsum + 64;
#pragma unroll
      for (int kk = 0; kk < TC_TK / 16; ++kk) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          const int k = kk * 16 + jj * 8 + 2 * qd;
          const float2 bs = *reinterpret_cast<const float2*>(bsum + k);
          const float2 ba = *reinterpret_cast<const float2*>(babs + k);
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float2 x = __bfloat1622float2(
                *reinterpret_cast<const __nv_bfloat162*>(&fa[kk][2 * jj + h]));
            float& c = chk_r[h][kk & 1];
            float& bd = bnd_r[h][kk & 1];
            c = fmaf(x.y, bs.y, fmaf(x.x, bs.x, c));
            bd = fmaf(fabsf(x.y), ba.y, fmaf(fabsf(x.x), ba.x, bd));
          }
        }
      }
    };
    // one stage: wgmma(it) from `cur` (A of stage it) runs while, once
    // wgmma(it - 1) has retired, `prev` (A of stage it - 1) gives that
    // stage's row checksums and is refilled with A of stage it + 1.  The
    // two register buffers alternate, so no wgmma's A registers are
    // touched while it is in flight.
    auto step = [&](int it, Frag& cur, Frag& prev) {
      const uint32_t sb = ring + (it % NS) * L::STAGE + L::A_BYTES;
#pragma unroll
      for (int e = 0; e < 64; ++e) hk::fence_operand(acc[e]);
      hk::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < TC_TK / 16; ++kk) {
        const uint64_t db = KMAJ
            ? hk::wgmma_desc(sb + kk * 32, 16, 1024)
            : hk::wgmma_desc(sb + kk * 16 * 128, 8192, 1024);
        hk::wgmma_m64n128k16_rs<KMAJ ? 0 : 1>(acc, cur[kk], db);
      }
      hk::wgmma_commit();
      hk::wgmma_wait<1>();               // wgmma(it - 1) has retired
#pragma unroll
      for (int e = 0; e < 64; ++e) hk::fence_operand(acc[e]);
      if (it >= 1) {
        row_checksums(it - 1, prev);
        __syncwarp();       // every lane is done reading the stage's sums
        if (lane == 0) hk::mbar_arrive(empty + ((it - 1) % NS) * 8);
      }
      if (it + 1 < nk) fetch_a(it + 1, prev);
    };
    Frag fa0, fa1;
    fetch_a(0, fa0);
    for (int it = 0; it < nk; it += 2) {
      step(it, fa0, fa1);
      if (it + 1 < nk) step(it + 1, fa1, fa0);
    }
    hk::wgmma_wait<0>();
#pragma unroll
    for (int e = 0; e < 64; ++e) hk::fence_operand(acc[e]);
    if (nk & 1)
      row_checksums(nk - 1, fa0);
    else
      row_checksums(nk - 1, fa1);

    // epilogue.  Accumulator fragment of m64n128: warp w of the warpgroup
    // owns rows 16 w + lane / 4 (+ 8); register 4 nb + 2 h + e holds
    // column 8 nb + 2 (lane % 4) + e of row half h.
    const bool split = g.S > 1;
    const bool pairs = (g.N & 1) == 0;
    float rs[2] = {0.f, 0.f};
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = row0 + wg * 64 + wq * 16 + (lane >> 2) + 8 * h;
      if (row >= row_end) continue;
      const long long yrow = split ? (pbase + row) * g.N
                                   : (long long)row * g.N;
#pragma unroll
      for (int nb = 0; nb < 16; ++nb) {
        const int col = col0 + nb * 8 + (lane & 3) * 2;
        if (col >= col_end) continue;
        float v0 = acc[nb * 4 + h * 2], v1 = acc[nb * 4 + h * 2 + 1];
        const bool both = col + 1 < col_end;
        if (split) {
          if (both && pairs) {
            *reinterpret_cast<float2*>(&part_acc[yrow + col]) =
                make_float2(v0, v1);
          } else {
            part_acc[yrow + col] = v0;
            if (both) part_acc[yrow + col + 1] = v1;
          }
          continue;
        }
        if (f.enabled && f.bi == i && f.bj == j &&
            row - i * g.bm == f.row) {
          if (col - j * g.bn == f.col) v0 = fault_value(f, v0);
          if (both && col + 1 - j * g.bn == f.col) v1 = fault_value(f, v1);
        }
        if (out_bf16) {
          __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(Y) + yrow +
                             col;
          if (both && pairs) {
            *reinterpret_cast<__nv_bfloat162*>(y) =
                __floats2bfloat162_rn(v0, v1);
          } else {
            y[0] = __float2bfloat16(v0);
            if (both) y[1] = __float2bfloat16(v1);
          }
        } else {
          float* y = reinterpret_cast<float*>(Y) + yrow + col;
          if (both && pairs) {
            *reinterpret_cast<float2*>(y) = make_float2(v0, v1);
          } else {
            y[0] = v0;
            if (both) y[1] = v1;
          }
        }
        rs[h] += both ? v0 + v1 : v0;
      }
    }
    if (!split) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 1);
        rs[h] += __shfl_xor_sync(0xffffffffu, rs[h], 2);
        const int row = row0 + wg * 64 + wq * 16 + (lane >> 2) + 8 * h;
        if ((lane & 3) == 0 && row < row_end)
          part_rs[(long long)row * gx + cx] = rs[h];
      }
    }
    // each row's checksums: its quad's four shares, in a fixed order
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float c = chk_r[h][0] + chk_r[h][1], bd = bnd_r[h][0] + bnd_r[h][1];
      c += __shfl_xor_sync(0xffffffffu, c, 1);
      c += __shfl_xor_sync(0xffffffffu, c, 2);
      bd += __shfl_xor_sync(0xffffffffu, bd, 1);
      bd += __shfl_xor_sync(0xffffffffu, bd, 2);
      const int row = row0 + wg * 64 + wq * 16 + gr + 8 * h;
      if (qd == 0 && row < row_end) {
        const long long o = (pbase + row) * gx + cx;
        part_chk[o] = c;
        part_bnd[o] = bd;
      }
    }
    return;
  }

  // -------------------------------------------------- checksum warpgroups
  const int ct = tid - MT, cwarp = ct >> 5;
  for (int it = 0; it < nk; ++it) {
    const int st = it % NS;
    hk::mbar_wait(full + st * 8, (it / NS) & 1);
    const uint8_t* pb = ring_p + st * L::STAGE + L::A_BYTES;
    float* bsum = sums + st * 128;
    float* babs = bsum + 64;
    // the stage's column sums of B over the tile's live columns
    if (KMAJ) {
      const int c = ct & 7, ng = ct >> 3;
      constexpr int G = CK / 8;
      float sm[8], ab[8];
#pragma unroll
      for (int e = 0; e < 8; ++e) sm[e] = ab[e] = 0.f;
#pragma unroll
      for (int n = ng; n < TC_TN; n += G) {
        if (n < lim) {
          float x[8];
          hk::unpack8(*reinterpret_cast<const uint4*>(
                          pb + n * 128 + ((c ^ (n & 7)) << 4)), x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            sm[e] += x[e];
            ab[e] += fabsf(x[e]);
          }
        }
      }
#pragma unroll
      for (int e = 0; e < 8; ++e) {
        sm[e] += __shfl_xor_sync(0xffffffffu, sm[e], 8);
        sm[e] += __shfl_xor_sync(0xffffffffu, sm[e], 16);
        ab[e] += __shfl_xor_sync(0xffffffffu, ab[e], 8);
        ab[e] += __shfl_xor_sync(0xffffffffu, ab[e], 16);
      }
      if (lane < 8) {
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          red[(cwarp * 2) * 64 + c * 8 + e] = sm[e];
          red[(cwarp * 2 + 1) * 64 + c * 8 + e] = ab[e];
        }
      }
      hk::named_bar_sync(1, CK);
      if (ct < 128) {
        const int k = ct & 63, which = ct >> 6;
        float t = 0.f;
#pragma unroll
        for (int w = 0; w < L::CW; ++w) t += red[(w * 2 + which) * 64 + k];
        (which ? babs : bsum)[k] = t;
      }
    } else {
      constexpr int TPK = CK / 64, CPT = 16 / TPK;
      const int kk = ct / TPK, p = ct % TPK;
      float sm = 0.f, ab = 0.f;
#pragma unroll
      for (int q = 0; q < CPT; ++q) {
        const int c16 = q * TPK + p;
        float x[8];
        hk::unpack8(*reinterpret_cast<const uint4*>(
                        pb + (c16 >> 3) * 8192 + kk * 128 +
                        (((c16 & 7) ^ (kk & 7)) << 4)), x);
        if (c16 * 8 + 8 > lim) {
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (c16 * 8 + e >= lim) x[e] = 0.f;
        }
        sm += sum8(x);
        ab += asum8(x);
      }
#pragma unroll
      for (int o = 1; o < TPK; o <<= 1) {
        sm += __shfl_xor_sync(0xffffffffu, sm, o);
        ab += __shfl_xor_sync(0xffffffffu, ab, o);
      }
      if (p == 0) {
        bsum[kk] = sm;
        babs[kk] = ab;
      }
    }
    // the sums of stage it are ready and this group is done with its B
    // tile; refill the slot of stage it - LAG once the MMA warps release it
    hk::named_bar_sync(1, CK);
    if (ct == 0) {
      hk::mbar_arrive(ready + st * 8);
      hk::mbar_arrive(empty + st * 8);
      const int old = it - L::LAG;
      if (old >= 0 && old + NS < nk) {
        hk::mbar_wait(empty + (old % NS) * 8, (old / NS) & 1);
        issue(old + NS);
      }
    }
  }
}

// ------------------------------------------------ SIMT pass 1 (f32)

constexpr int ST_K = 16;    // k depth of a stage
constexpr int ST_NS = 4;    // B stages in the ring (ST_NS - 1 in flight)
constexpr int ST_TM = 128;  // tile rows
constexpr int ST_TN = 128;  // tile columns

// Shared memory of the SIMT pass 1 (bytes): A double-buffered k-major, the
// ring of B stages k-major, the stages' column sums (two parities).  The
// epilogue's cross-warp partials reuse A's buffers.
struct SimtSmem {
  static constexpr int A_F = 2 * ST_K * ST_TM;
  static constexpr int B_F = ST_NS * ST_K * ST_TN;
  static constexpr int BYTES = 4 * (A_F + B_F + 2 * 2 * ST_K);
};

__device__ __forceinline__ float4 ld4_masked(const float* p, int ok, int n) {
  // the four consecutive floats at p, of which the first n exist (ok = 0:
  // none); 16-byte aligned when n >= 4
  if (ok && n >= 4) return __ldg(reinterpret_cast<const float4*>(p));
  float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
  if (ok && n > 0) v.x = __ldg(p);
  if (ok && n > 1) v.y = __ldg(p + 1);
  if (ok && n > 2) v.z = __ldg(p + 2);
  return v;
}

// Pass 1 on the CUDA cores for f32 operands, modes 1s/2s (TF32 stays off:
// plain FMA).  One CUDA block owns a TM x TN = 128 x 128 tile of ONE
// logical block and one K slice (rows and columns past the block's end
// are masked); TM * TN / 64 threads each hold 8 x 8
// accumulators in registers: rows 4 ty + {0..3} and TM/2 + 4 ty + {0..3},
// columns 4 tx + {0..3} and TN/2 + 4 tx + {0..3}, so every operand read is
// a float4 and a warp's B reads cover 128 consecutive bytes.
//   - A (rows of x, k contiguous) goes to shared memory k-major, transposed
//     on its way through registers: the next stage's float4 loads are
//     issued before the current stage is multiplied and stored after it;
//   - B: a row-major W fills a ring of ST_NS stages by 16-byte cp.async
//     (zero fill past the tile), ST_NS - 1 stages in flight; a K-major W
//     (the tied head's embed^T) goes the way A goes, ST_NS - 1 stages
//     ahead.
//   - Checksums, all threads, every stage: the column sums bsum[k] =
//     sum_c B[k, c] and babs[k] = sum_c |B[k, c]| over the tile's live
//     columns (the zero fill masks the rest) by fixed shuffle trees, one
//     stage ahead of the product; then each row's chk += A . bsum and
//     bnd += |A| . babs, TN/64 threads a row.  About 2/TM of the product's
//     FMAs.
// One barrier a stage.  With one K slice the epilogue applies the fault,
// stores y and the rows' partial row sums (part_rs) for abft_tc_pass2;
// with several it stores the partial accumulator for abft_tc_reduce.
template <bool KMAJ>
__global__ void __launch_bounds__(ST_TM * ST_TN / 64)
abft_simt_pass1(const float* __restrict__ A, const float* __restrict__ B,
                Geo g, Fault f, void* __restrict__ Y, int out_bf16,
                float* __restrict__ part_acc, float* __restrict__ part_chk,
                float* __restrict__ part_bnd, float* __restrict__ part_rs) {
  constexpr int TM = ST_TM, TN = ST_TN, NT = TM * TN / 64;
  constexpr int BK = ST_K, NS = ST_NS, LOOK = ST_NS - 1;
  constexpr int AL = TM * BK / 4 / NT;   // float4 of A a thread, a stage
  constexpr int BL = TN * BK / 4 / NT;   // float4 of B a thread, a stage
  constexpr int KH = NT / TM;            // threads per row (checksums)
  constexpr int CG = NT / BK;            // threads per k row (column sums)
  constexpr int CQ = TN / 4 / CG;        // float4 a thread (column sums)
  const int rt_all = blockIdx.x, cx = blockIdx.y, s = blockIdx.z;
  const int i = rt_all / g.row_tiles, rt = rt_all % g.row_tiles;
  const int j = cx / g.col_tiles, sub = cx % g.col_tiles;
  const int row0 = i * g.bm + rt * TM;
  const int row_end = min(min(row0 + TM, (i + 1) * g.bm), g.M);
  const int col0 = j * g.bn + sub * TN;
  const int col_end = min(min(col0 + TN, (j + 1) * g.bn), g.N);
  const int k0 = s * g.kc;
  const int k1 = min(k0 + g.kc, g.K);
  if (row0 >= row_end || col0 >= col_end || k0 >= k1) return;

  extern __shared__ float4 smem4[];
  float* As = reinterpret_cast<float*>(smem4);   // [2][BK][TM]
  float* Bs = As + SimtSmem::A_F;        // [NS][BK][TN]
  float* sums = Bs + SimtSmem::B_F;      // [2][{sum, abs}][BK]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wx = warp % (TN / 64), wy = warp / (TN / 64);
  const int tx = wx * 8 + (lane & 7), ty = wy * 4 + (lane >> 3);
  const int nk = (k1 - k0 + BK - 1) / BK;

  float4 ra[AL];
  float4 rb[KMAJ ? BL : 1];
  auto load_a = [&](int it) {
    const int kt = k0 + it * BK;
#pragma unroll
    for (int a = 0; a < AL; ++a) {
      const int idx = tid + a * NT, r = idx % TM, kq = idx / TM;
      const int row = row0 + r, k = kt + kq * 4;
      ra[a] = ld4_masked(A + (long long)row * g.lda + k, row < row_end,
                         k1 - k);
    }
  };
  auto store_a = [&](int par) {
    float* as = As + par * BK * TM;
#pragma unroll
    for (int a = 0; a < AL; ++a) {
      const int idx = tid + a * NT, r = idx % TM, kq = idx / TM;
      as[(kq * 4 + 0) * TM + r] = ra[a].x;
      as[(kq * 4 + 1) * TM + r] = ra[a].y;
      as[(kq * 4 + 2) * TM + r] = ra[a].z;
      as[(kq * 4 + 3) * TM + r] = ra[a].w;
    }
  };
  auto load_b = [&](int it) {          // K-major W: columns k-contiguous
    const int kt = k0 + it * BK;
#pragma unroll
    for (int b = 0; b < BL; ++b) {
      const int idx = tid + b * NT, c = idx % TN, kq = idx / TN;
      const int col = col0 + c, k = kt + kq * 4;
      rb[b] = ld4_masked(B + (long long)col * g.sbn + k, col < col_end,
                         k1 - k);
    }
  };
  auto store_b = [&](int it) {
    float* bs = Bs + (it % NS) * BK * TN;
#pragma unroll
    for (int b = 0; b < BL; ++b) {
      const int idx = tid + b * NT, c = idx % TN, kq = idx / TN;
      bs[(kq * 4 + 0) * TN + c] = rb[b].x;
      bs[(kq * 4 + 1) * TN + c] = rb[b].y;
      bs[(kq * 4 + 2) * TN + c] = rb[b].z;
      bs[(kq * 4 + 3) * TN + c] = rb[b].w;
    }
  };
  auto issue_b = [&](int it) {         // row-major W: cp.async, zero fill
    if (it < nk) {
      const int kt = k0 + it * BK;
      float* bs = Bs + (it % NS) * BK * TN;
#pragma unroll
      for (int b = 0; b < BL; ++b) {
        const int idx = tid + b * NT, kk = idx / (TN / 4), c4 = idx % (TN / 4);
        const int k = kt + kk, col = col0 + c4 * 4;
        const int bytes = k < k1 ? max(0, min(16, (col_end - col) * 4)) : 0;
        hk::cp_async16(hk::smem_u32(bs + kk * TN + c4 * 4),
                       bytes ? B + (long long)k * g.sbk + col : B, bytes);
      }
    }
    hk::cp_async_commit();
  };
  // column sums of stage it over the tile's columns, CG threads a k row
  auto col_sums = [&](int it) {
    const float* bs = Bs + (it % NS) * BK * TN;
    const int kk = tid / CG, p = tid % CG;
    float sm = 0.f, ab = 0.f;
#pragma unroll
    for (int q = 0; q < CQ; ++q) {
      const float4 v =
          *reinterpret_cast<const float4*>(bs + kk * TN + (q * CG + p) * 4);
      sm += (v.x + v.y) + (v.z + v.w);
      ab += (fabsf(v.x) + fabsf(v.y)) + (fabsf(v.z) + fabsf(v.w));
    }
#pragma unroll
    for (int o = 1; o < CG; o <<= 1) {
      sm += __shfl_xor_sync(0xffffffffu, sm, o);
      ab += __shfl_xor_sync(0xffffffffu, ab, o);
    }
    if (p == 0) {
      sums[(it & 1) * 2 * BK + kk] = sm;
      sums[(it & 1) * 2 * BK + BK + kk] = ab;
    }
  };

  float acc[8][8];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int b = 0; b < 8; ++b) acc[a][b] = 0.f;
  float chk_r = 0.f, bnd_r = 0.f;      // row tid % TM, k share tid / TM

  load_a(0);
  store_a(0);
#pragma unroll
  for (int p = 0; p < LOOK; ++p) {
    if (KMAJ) {
      if (p < nk) {
        load_b(p);
        store_b(p);
      }
    } else {
      issue_b(p);
    }
  }
  if (!KMAJ) hk::cp_async_wait<0>();
  __syncthreads();
  col_sums(0);

  for (int it = 0; it < nk; ++it) {
    // B of stage it + 1 has landed (the groups of it + 2 .. it + LOOK - 1
    // may still be in flight); A of stage it and the sums of stage it are
    // stored; every thread is done with stage it - 1's slots
    if (!KMAJ) hk::cp_async_wait<LOOK - 2>();
    __syncthreads();
    const int nxt = it + LOOK;
    if (KMAJ) {
      if (nxt < nk) load_b(nxt);
    } else {
      issue_b(nxt);
    }
    if (it + 1 < nk) {
      load_a(it + 1);
      col_sums(it + 1);
    }
    const float* as = As + (it & 1) * BK * TM;
    const float* bs = Bs + (it % NS) * BK * TN;
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(as + kk * TM + ty * 4);
      const float4 a1 =
          *reinterpret_cast<const float4*>(as + kk * TM + TM / 2 + ty * 4);
      const float4 b0 = *reinterpret_cast<const float4*>(bs + kk * TN + tx * 4);
      const float4 b1 =
          *reinterpret_cast<const float4*>(bs + kk * TN + TN / 2 + tx * 4);
      const float av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int a = 0; a < 8; ++a)
#pragma unroll
        for (int b = 0; b < 8; ++b) acc[a][b] = fmaf(av[a], bv[b], acc[a][b]);
    }
    {   // this stage's row checksums: KH threads a row, BK / KH k each
      const float* bsum = sums + (it & 1) * 2 * BK;
      const int r = tid % TM, kb = (tid / TM) * (BK / KH);
#pragma unroll
      for (int kk = 0; kk < BK / KH; ++kk) {
        const float a = as[(kb + kk) * TM + r];
        chk_r = fmaf(a, bsum[kb + kk], chk_r);
        bnd_r = fmaf(fabsf(a), bsum[BK + kb + kk], bnd_r);
      }
    }
    if (it + 1 < nk) store_a((it + 1) & 1);
    if (KMAJ && nxt < nk) store_b(nxt);
  }
  if (!KMAJ) hk::cp_async_wait<0>();
  __syncthreads();                      // A's buffers become the partials

  float* red = As;                      // [3][2][TM]: row sums, chk, bnd
  const bool split = g.S > 1;
  const long long pbase = (long long)s * g.M;
  const int gx = g.gn * g.col_tiles;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int r = (a < 4 ? 0 : TM / 2) + ty * 4 + (a & 3);
    const int row = row0 + r;
    float rs = 0.f;
    if (row < row_end) {
      const long long yrow = split ? (pbase + row) * g.N : (long long)row * g.N;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int col = col0 + h * (TN / 2) + tx * 4;
        float v[4];
#pragma unroll
        for (int e = 0; e < 4; ++e) v[e] = acc[a][h * 4 + e];
        const bool all4 = col + 4 <= col_end && (g.N & 3) == 0;
        if (split) {
          if (all4) {
            *reinterpret_cast<float4*>(&part_acc[yrow + col]) =
                make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < col_end) part_acc[yrow + col + e] = v[e];
          }
          continue;
        }
        if (f.enabled && f.bi == i && f.bj == j && row - i * g.bm == f.row) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e - j * g.bn == f.col && col + e < col_end)
              v[e] = fault_value(f, v[e]);
        }
        if (out_bf16) {
          __nv_bfloat16* y = reinterpret_cast<__nv_bfloat16*>(Y) + yrow + col;
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (col + e < col_end) y[e] = __float2bfloat16(v[e]);
        } else {
          float* y = reinterpret_cast<float*>(Y) + yrow + col;
          if (all4) {
            *reinterpret_cast<float4*>(y) = make_float4(v[0], v[1], v[2], v[3]);
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (col + e < col_end) y[e] = v[e];
          }
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < col_end) rs += v[e];
      }
    }
    // the row's share over this warp's 8 column groups, a fixed tree
    rs += __shfl_xor_sync(0xffffffffu, rs, 1);
    rs += __shfl_xor_sync(0xffffffffu, rs, 2);
    rs += __shfl_xor_sync(0xffffffffu, rs, 4);
    if ((lane & 7) == 0) red[wx * TM + r] = rs;
  }
  red[2 * TM + (tid / TM) * TM + tid % TM] = chk_r;
  red[4 * TM + (tid / TM) * TM + tid % TM] = bnd_r;
  __syncthreads();
  if (tid < TM && row0 + tid < row_end) {
    float rs = 0.f, c = 0.f, b = 0.f;
#pragma unroll
    for (int w = 0; w < TN / 64; ++w) rs += red[w * TM + tid];
#pragma unroll
    for (int h = 0; h < KH; ++h) {
      c += red[2 * TM + h * TM + tid];
      b += red[4 * TM + h * TM + tid];
    }
    const long long o = (pbase + row0 + tid) * gx + cx;
    part_chk[o] = c;
    part_bnd[o] = b;
    if (!split) part_rs[(long long)(row0 + tid) * gx + cx] = rs;
  }
}

// After a split tensor-core or SIMT pass 1: one CUDA block per 16 rows of a
// pass-1 tile (a warp per row, lanes over the tile's columns) sums the K
// slices' partial accumulators in a fixed order, applies the fault,
// stores y and the row's partial rowsum(acc), and folds the slices'
// partial checksums into slice 0.
constexpr int TC_RED_ROWS = 16;

__global__ void __launch_bounds__(256)
abft_tc_reduce(const float* __restrict__ part_acc,
               float* __restrict__ part_chk, float* __restrict__ part_bnd,
               Geo g, Fault f, void* __restrict__ Y, int out_bf16,
               float* __restrict__ part_rs) {
  const int chunks = g.tm / TC_RED_ROWS;
  const int rt_all = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int cx = blockIdx.y;
  const int i = rt_all / g.row_tiles, rt = rt_all % g.row_tiles;
  const int j = cx / g.col_tiles, sub = cx % g.col_tiles;
  const int row0 = i * g.bm + rt * g.tm;
  const int row_end = min(min(row0 + g.tm, (i + 1) * g.bm), g.M);
  const int col0 = j * g.bn + sub * g.tn;
  const int col_end = min(min(col0 + g.tn, (j + 1) * g.bn), g.N);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int gx = g.gn * g.col_tiles;
  const long long slice = (long long)g.M * g.N;
  for (int row = row0 + chunk * TC_RED_ROWS + warp;
       row < min(row_end, row0 + (chunk + 1) * TC_RED_ROWS); row += 8) {
    float rs = 0.f;
    for (int q = 0; q < g.tn / 32; ++q) {
      const int col = col0 + q * 32 + lane;
      if (col >= col_end) continue;
      const float* p = part_acc + (long long)row * g.N + col;
      float v = 0.f;
      for (int s = 0; s < g.S; ++s) v += p[s * slice];
      if (f.enabled && f.bi == i && f.bj == j && row - i * g.bm == f.row &&
          col - j * g.bn == f.col)
        v = fault_value(f, v);
      if (out_bf16)
        reinterpret_cast<__nv_bfloat16*>(Y)[(long long)row * g.N + col] =
            __float2bfloat16(v);
      else
        reinterpret_cast<float*>(Y)[(long long)row * g.N + col] = v;
      rs += v;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      rs += __shfl_xor_sync(0xffffffffu, rs, o);
    if (lane == 0) {
      const long long o = (long long)row * gx + cx;
      float c = 0.f, b = 0.f;
      for (int s = 0; s < g.S; ++s) {
        c += part_chk[s * (long long)g.M * gx + o];
        b += part_bnd[s * (long long)g.M * gx + o];
      }
      part_chk[o] = c;
      part_bnd[o] = b;
      part_rs[o] = rs;
    }
  }
}

// Pass 2 of the tensor-core and SIMT routes (y already stored): one CUDA block per
// logical (block_i, block_j) sums each row's per-tile partials in a fixed
// order into the residual and bound.  Rows and columns past the problem
// edge are the TPU kernel's zero padding: their checksums are 0, and a
// fault that lands there enters the row sum here.
template <bool TWO_SIDED>
__global__ void __launch_bounds__(256)
abft_tc_pass2(const float* __restrict__ part_chk,
              const float* __restrict__ part_bnd,
              const float* __restrict__ part_rs, Geo g, Fault f,
              float* __restrict__ res, float* __restrict__ bnd) {
  const int j = blockIdx.x, i = blockIdx.y, tid = threadIdx.x;
  const int gx = g.gn * g.col_tiles;
  float t_sum = 0.f, t_chk = 0.f, t_bnd = 0.f;
  for (int rl = tid; rl < g.bm; rl += 256) {
    const int row = i * g.bm + rl;
    float c = 0.f, b = 0.f, rs = 0.f;
    if (row < g.M) {
      for (int sub = 0; sub < g.col_tiles; ++sub) {
        if (j * g.bn + sub * g.tn >= g.N) break;
        const long long idx = (long long)row * gx + j * g.col_tiles + sub;
        c += part_chk[idx];
        b += part_bnd[idx];
        rs += part_rs[idx];
      }
    }
    if (f.enabled && f.bi == i && f.bj == j && f.row == rl && f.col >= 0 &&
        f.col < g.bn && (row >= g.M || j * g.bn + f.col >= g.N))
      rs += fault_value(f, 0.f);
    if (TWO_SIDED) {
      t_sum += rs;
      t_chk += c;
      t_bnd += b;
    } else {
      const long long o = ((long long)i * g.gn + j) * g.bm + rl;
      res[o] = fabsf(c - rs);
      bnd[o] = b;
    }
  }
  if (TWO_SIDED) {
    __shared__ float w_s[8][3];
    const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      t_sum += __shfl_xor_sync(0xffffffffu, t_sum, o);
      t_chk += __shfl_xor_sync(0xffffffffu, t_chk, o);
      t_bnd += __shfl_xor_sync(0xffffffffu, t_bnd, o);
    }
    if (lane == 0) {
      w_s[warp][0] = t_sum;
      w_s[warp][1] = t_chk;
      w_s[warp][2] = t_bnd;
    }
    __syncthreads();
    if (tid == 0) {
      float s_ = 0.f, c = 0.f, b = 0.f;
      for (int w = 0; w < 8; ++w) {
        s_ += w_s[w][0];
        c += w_s[w][1];
        b += w_s[w][2];
      }
      res[(long long)i * g.gn + j] = fabsf(c - s_);
      bnd[(long long)i * g.gn + j] = b;
    }
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Pass 2: one CUDA block per logical (block_i, block_j); 8 warps stride
// over its bm rows, lanes over its bn columns.  Rows/columns past the
// problem edge are the TPU kernel's zero padding: they enter the row sum
// (and may carry the fault) but are never stored.
template <typename TO, bool TWO_SIDED>
__global__ void __launch_bounds__(256)
abft_pass2(const float* __restrict__ part_acc,
           const float* __restrict__ part_chk,
           const float* __restrict__ part_bnd, Geo g, Fault f,
           TO* __restrict__ Y, float* __restrict__ res,
           float* __restrict__ bnd) {
  const int j = blockIdx.x, i = blockIdx.y;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gx = g.gn * g.col_tiles;
  const bool here = f.enabled && f.bi == i && f.bj == j;
  __shared__ float w_res[8], w_chk[8], w_bnd[8];
  float t_sum = 0.f, t_chk = 0.f, t_bnd = 0.f;   // two-sided, lane 0

  for (int rl = warp; rl < g.bm; rl += 8) {
    const int row = i * g.bm + rl;
    const bool row_ok = row < g.M;
    float rs = 0.f;
    for (int cl = lane; cl < g.bn; cl += 32) {
      const int col = j * g.bn + cl;
      const bool ok = row_ok && col < g.N;
      float a = 0.f;
      if (ok) {
        // four independent sums keep four partial loads in flight; the
        // order is fixed, so the result is the same on every run
        const float* p = part_acc + (long long)row * g.N + col;
        const long long stride = (long long)g.M * g.N;
        float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
        int s = 0;
        for (; s + 4 <= g.S; s += 4) {
          a0 += p[s * stride];
          a1 += p[(s + 1) * stride];
          a2 += p[(s + 2) * stride];
          a3 += p[(s + 3) * stride];
        }
        for (; s < g.S; ++s) a0 += p[s * stride];
        a = (a0 + a1) + (a2 + a3);
      }
      if (here && rl == f.row && cl == f.col) {
        if (f.bit >= 0)
          a = __uint_as_float(__float_as_uint(a) ^ (1u << f.bit));
        else
          a = a + f.delta;
      }
      if (ok) store_out(&Y[(long long)row * g.N + col], a);
      rs += a;
    }
    rs = warp_sum(rs);
    if (lane == 0) {
      float c = 0.f, b = 0.f;
      if (row_ok) {
        for (int s = 0; s < g.S; ++s)
          for (int sub = 0; sub < g.col_tiles; ++sub) {
            if (j * g.bn + sub * g.tn >= g.N) break;
            const long long idx =
                ((long long)s * g.M + row) * gx + j * g.col_tiles + sub;
            c += part_chk[idx];
            b += part_bnd[idx];
          }
      }
      if (TWO_SIDED) {
        t_sum += rs;
        t_chk += c;
        t_bnd += b;
      } else {
        const long long o = ((long long)i * g.gn + j) * g.bm + rl;
        res[o] = fabsf(c - rs);
        bnd[o] = b;
      }
    }
  }
  if (TWO_SIDED) {
    if (lane == 0) {
      w_res[warp] = t_sum;
      w_chk[warp] = t_chk;
      w_bnd[warp] = t_bnd;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      float s_ = 0.f, c = 0.f, b = 0.f;
      for (int w = 0; w < 8; ++w) {
        s_ += w_res[w];
        c += w_chk[w];
        b += w_bnd[w];
      }
      res[(long long)i * g.gn + j] = fabsf(c - s_);
      bnd[(long long)i * g.gn + j] = b;
    }
  }
}

template <typename TI, int RM>
void launch_pass1(const void* A, const void* B, const Geo& g, bool replica,
                  float* pa, float* pc, float* pb, cudaStream_t st) {
  dim3 grid(g.gn * g.col_tiles, g.gm * g.row_tiles, g.S);
  if (replica)
    abft_pass1<TI, RM, true><<<grid, NT, 0, st>>>(
        (const TI*)A, (const TI*)B, g, pa, pc, pb);
  else
    abft_pass1<TI, RM, false><<<grid, NT, 0, st>>>(
        (const TI*)A, (const TI*)B, g, pa, pc, pb);
}

template <typename TI>
void dispatch_pass1(int rm, const void* A, const void* B, const Geo& g,
                    bool replica, float* pa, float* pc, float* pb,
                    cudaStream_t st) {
  if (rm == 0) {        // decode fast path (the wrapper checked its terms)
    dim3 grid((g.N + TN - 1) / TN, g.S);
    if (g.M <= 4)
      abft_gemv_pass1<TI, 4><<<grid, 256, 0, st>>>(
          (const TI*)A, (const TI*)B, g, pa, pc, pb);
    else
      abft_gemv_pass1<TI, 8><<<grid, 256, 0, st>>>(
          (const TI*)A, (const TI*)B, g, pa, pc, pb);
  } else if (rm == 1) launch_pass1<TI, 1>(A, B, g, replica, pa, pc, pb, st);
  else if (rm == 4) launch_pass1<TI, 4>(A, B, g, replica, pa, pc, pb, st);
  else launch_pass1<TI, 8>(A, B, g, replica, pa, pc, pb, st);
}

// cuTensorMapEncodeTiled from the driver, through the runtime (no link
// against libcuda)
typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (!fn) {
    void* p = nullptr;
#if CUDART_VERSION >= 12050
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#else
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault) == cudaSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
#endif
  }
  return fn;
}

// 2-d bf16 tensor map: `inner` x `outer` elements, `stride` bytes between
// outer rows, boxes of box_inner x box_outer with the 128-byte swizzle
bool tensor_map(CUtensorMap* m, const void* base, long long inner,
                long long outer, long long stride, int box_inner,
                int box_outer) {
  EncodeTiled fn = encode_tiled();
  if (!fn) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)inner, (cuuint64_t)outer};
  const cuuint64_t strides[1] = {(cuuint64_t)stride};
  const cuuint32_t box[2] = {(cuuint32_t)box_inner, (cuuint32_t)box_outer};
  const cuuint32_t estr[2] = {1, 1};
  return fn(m, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base),
            dims, strides, box, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int WG, bool KMAJ>
cudaError_t launch_tc(const void* A, const void* B, const Geo& g,
                      const Fault& f, void* Y, int out_bf16, float* pa,
                      float* pc, float* pb, float* pr, cudaStream_t st) {
  CUtensorMap ta, tb;
  const bool ok =
      tensor_map(&ta, A, g.K, g.M, g.lda * 2, TC_TK, 64 * WG) &&
      (KMAJ ? tensor_map(&tb, B, g.K, g.N, g.sbn * 2, TC_TK, TC_TN)
            : tensor_map(&tb, B, g.N, g.K, g.sbk * 2, 64, TC_TK));
  if (!ok) return cudaErrorInvalidValue;
  static unsigned long long capped = 0;   // devices, one bit each
  cudaError_t err = hk::raise_smem_cap(abft_tc_pass1<WG, KMAJ>,
                                       TcSmem<WG>::BYTES, &capped);
  if (err != cudaSuccess) return err;
  dim3 grid(g.gm * g.row_tiles, g.gn * g.col_tiles, g.S);
  abft_tc_pass1<WG, KMAJ><<<grid, 256 * WG, TcSmem<WG>::BYTES, st>>>(
      ta, tb, g, f, Y, out_bf16, pa, pc, pb, pr);
  return cudaGetLastError();
}

template <bool KMAJ>
cudaError_t launch_simt(const void* A, const void* B, const Geo& g,
                        const Fault& f, void* Y, int out_bf16, float* pa,
                        float* pc, float* pb, float* pr, cudaStream_t st) {
  constexpr int bytes = SimtSmem::BYTES;
  static unsigned long long capped = 0;   // devices, one bit each
  cudaError_t err =
      hk::raise_smem_cap(abft_simt_pass1<KMAJ>, bytes, &capped);
  if (err != cudaSuccess) return err;
  dim3 grid(g.gm * g.row_tiles, g.gn * g.col_tiles, g.S);
  abft_simt_pass1<KMAJ><<<grid, ST_TM * ST_TN / 64, bytes, st>>>(
      (const float*)A, (const float*)B, g, f, Y, out_bf16, pa, pc, pb, pr);
  return cudaGetLastError();
}

}  // namespace

// route: 0 = CUDA-core tiled pass 1 (tile tm x tn = 8, 32 or 64 x 64),
// 1 = the decode GEMV pass 1 (M <= 8, modes 1s/2s, row-major W with
// 16-byte aligned rows, bn % 64 == 0; tile 8 x 64; K slices a multiple of
// 32 deep), 2 / 3 = the tensor-core pass 1 (bf16, modes 1s/2s, 16-byte
// aligned rows of A and of W; W row-major for 2, K-major for 3; tile 64 or
// 128 x 128; K slices a multiple of 64 deep; with S > 1 abft_tc_reduce
// folds the slices), 4 = the SIMT pass 1 (f32, modes 1s/2s, 16-byte
// aligned rows of A, W row-major (sbn == 1) or K-major (sbk == 1) with
// 16-byte aligned rows or columns, bn % 4 == 0; tile 128 x 128; K
// slices a multiple of 16 deep; the same pass 2 as routes 2 / 3).
// The tile comes from the caller, which sized the scratch and the K split
// by it; any other tile is rejected.
// mode: 0 = '1s', 1 = '2s', 2 = 'replica'.  dtypes: 0 = f32, 1 = bf16.
// part_rs (M x column tiles) is used by routes 2 to 4 only.
// Returns cudaGetLastError() after the last launch.
extern "C" int abft_matmul_launch(
    const void* A, const void* B, void* Y, void* res, void* bnd,
    void* part_acc, void* part_chk, void* part_bnd, void* part_rs,
    int M, int K, int N, long long lda, long long sbk, long long sbn,
    int bm, int bk, int bn, int S, int kc, int route, int tm, int tn,
    int mode,
    int in_dtype, int out_dtype,
    int f_enabled, int f_bi, int f_bj, int f_row, int f_col, int f_bit,
    float f_delta, void* stream) {
  Geo g;
  g.M = M; g.K = K; g.N = N;
  g.bm = bm; g.bk = bk; g.bn = bn;
  g.gm = (M + bm - 1) / bm;
  g.gn = (N + bn - 1) / bn;
  g.S = S; g.kc = kc;
  g.lda = lda; g.sbk = sbk; g.sbn = sbn;
  Fault f{f_enabled, f_bi, f_bj, f_row, f_col, f_bit, f_delta};
  cudaStream_t st = (cudaStream_t)stream;
  float* pa = (float*)part_acc;
  float* pc = (float*)part_chk;
  float* pb = (float*)part_bnd;
  const bool two = mode == 1;
  if (route >= 2) {
    const bool simt = route == 4;
    if (simt ? (in_dtype != 0 || mode == 2 || tm != ST_TM || tn != ST_TN ||
                bn % 4 || (sbn != 1 && sbk != 1))
             : (in_dtype != 1 || mode == 2 || (tm != 64 && tm != 128) ||
                tn != TC_TN))
      return (int)cudaErrorInvalidValue;
    const int wgs = tm / 64;
    g.tm = tm;
    g.tn = tn;
    g.row_tiles = (bm + g.tm - 1) / g.tm;
    g.col_tiles = (bn + g.tn - 1) / g.tn;
    cudaError_t err;
    if (simt)
      err = sbn == 1
          ? launch_simt<false>(A, B, g, f, Y, out_dtype, pa, pc, pb,
                               (float*)part_rs, st)
          : launch_simt<true>(A, B, g, f, Y, out_dtype, pa, pc, pb,
                              (float*)part_rs, st);
    else if (wgs == 2)
      err = route == 3
          ? launch_tc<2, true>(A, B, g, f, Y, out_dtype, pa, pc, pb,
                               (float*)part_rs, st)
          : launch_tc<2, false>(A, B, g, f, Y, out_dtype, pa, pc, pb,
                                (float*)part_rs, st);
    else
      err = route == 3
          ? launch_tc<1, true>(A, B, g, f, Y, out_dtype, pa, pc, pb,
                               (float*)part_rs, st)
          : launch_tc<1, false>(A, B, g, f, Y, out_dtype, pa, pc, pb,
                                (float*)part_rs, st);
    if (err != cudaSuccess) return (int)err;
    if (S > 1) {
      dim3 grid(g.gm * g.row_tiles * (g.tm / TC_RED_ROWS),
                g.gn * g.col_tiles);
      abft_tc_reduce<<<grid, 256, 0, st>>>(pa, pc, pb, g, f, Y, out_dtype,
                                           (float*)part_rs);
    }
    dim3 grid2(g.gn, g.gm);
    if (two) abft_tc_pass2<true><<<grid2, 256, 0, st>>>(
        pc, pb, (const float*)part_rs, g, f, (float*)res, (float*)bnd);
    else abft_tc_pass2<false><<<grid2, 256, 0, st>>>(
        pc, pb, (const float*)part_rs, g, f, (float*)res, (float*)bnd);
    return (int)cudaGetLastError();
  } else {
    const bool gemv = route == 1;
    if (tn != TN || (gemv ? (tm != 8 || M > 8 || mode == 2 || bn % TN)
                          : (tm != 8 && tm != 32 && tm != 64)))
      return (int)cudaErrorInvalidValue;
    g.row_tiles = gemv ? 1 : (bm + tm - 1) / tm;
    g.col_tiles = (bn + TN - 1) / TN;
    g.tn = TN;
    const int r = gemv ? 0 : tm / 8;
    if (in_dtype == 1)
      dispatch_pass1<__nv_bfloat16>(r, A, B, g, mode == 2, pa, pc, pb, st);
    else
      dispatch_pass1<float>(r, A, B, g, mode == 2, pa, pc, pb, st);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid2(g.gn, g.gm);
  if (out_dtype == 1) {
    if (two) abft_pass2<__nv_bfloat16, true><<<grid2, 256, 0, st>>>(
        pa, pc, pb, g, f, (__nv_bfloat16*)Y, (float*)res, (float*)bnd);
    else abft_pass2<__nv_bfloat16, false><<<grid2, 256, 0, st>>>(
        pa, pc, pb, g, f, (__nv_bfloat16*)Y, (float*)res, (float*)bnd);
  } else {
    if (two) abft_pass2<float, true><<<grid2, 256, 0, st>>>(
        pa, pc, pb, g, f, (float*)Y, (float*)res, (float*)bnd);
    else abft_pass2<float, false><<<grid2, 256, 0, st>>>(
        pa, pc, pb, g, f, (float*)Y, (float*)res, (float*)bnd);
  }
  return (int)cudaGetLastError();
}

