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
// the whole GEMM is a stream of W at 3.35 TB/s; at prefill (M ~ 1k) the
// multiply-adds, here on CUDA cores (67 TFLOP/s f32), far from the 989
// TFLOP/s bf16 tensor-core roofline.
//
// Design.  The logical BlockShape (default 256/512/256, clamped by the
// wrapper) fixes the residual's shape and the cost model; it is kept apart
// from the CUDA tile.  A 256 x 256 f32 accumulator does not fit one CUDA
// block, so each CUDA block owns a TM x 64 sub-tile (TM = 8, 32 or 64 rows,
// 4 x RM outputs per thread, plain FMA) of ONE logical block and one slice
// of K, and never straddles a logical block or a logical bk boundary.
// Pass 1 writes its partial accumulators and per-row partial checksums to
// scratch; pass 2 sums the K slices in a fixed order, applies the fault,
// stores y and reduces rows over the logical block's bn columns.  There
// are no floating-point atomics: every sum has a fixed order, so a retry
// reproduces the attempt bit for bit.  At decode (M <= 8 rows, row-major
// W) a GEMV-shaped pass 1 replaces the tiled one: 16-byte loads, whole
// 128-byte lines per 8-lane group, the checksum from the same registers.
// K slicing (split-K over CUDA blocks)
// is what fills the 132 SMs at decode, where one block row of 4 tokens would
// otherwise give only N/64 CUDA blocks.  Ragged edges are masked in the
// loads (zero fill) — nothing is padded or copied.  B is read through its
// row and column strides, so the tied head W = embed^T is read in place.
// wgmma/TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

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
            if (j * g.bn + sub * TN >= g.N) break;
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

}  // namespace

// mode: 0 = '1s', 1 = '2s', 2 = 'replica'.  dtypes: 0 = f32, 1 = bf16.
// rm: rows per thread of the CUDA tile (1, 4 or 8; TM = 8 * rm), or 0 for
// the decode fast path (M <= 8, modes 1s/2s, row-major W with 16-byte
// aligned rows, bn % 64 == 0; K slices a multiple of 32 deep).
// Returns cudaGetLastError() after both launches.
extern "C" int abft_matmul_launch(
    const void* A, const void* B, void* Y, void* res, void* bnd,
    void* part_acc, void* part_chk, void* part_bnd,
    int M, int K, int N, long long lda, long long sbk, long long sbn,
    int bm, int bk, int bn, int S, int kc, int rm, int mode,
    int in_dtype, int out_dtype,
    int f_enabled, int f_bi, int f_bj, int f_row, int f_col, int f_bit,
    float f_delta, void* stream) {
  Geo g;
  g.M = M; g.K = K; g.N = N;
  g.bm = bm; g.bk = bk; g.bn = bn;
  g.gm = (M + bm - 1) / bm;
  g.gn = (N + bn - 1) / bn;
  g.row_tiles = rm ? (bm + 8 * rm - 1) / (8 * rm) : 1;
  g.col_tiles = (bn + TN - 1) / TN;
  g.S = S; g.kc = kc;
  g.lda = lda; g.sbk = sbk; g.sbn = sbn;
  Fault f{f_enabled, f_bi, f_bj, f_row, f_col, f_bit, f_delta};
  cudaStream_t st = (cudaStream_t)stream;
  float* pa = (float*)part_acc;
  float* pc = (float*)part_chk;
  float* pb = (float*)part_bnd;
  const bool replica = mode == 2;
  if (in_dtype == 1)
    dispatch_pass1<__nv_bfloat16>(rm, A, B, g, replica, pa, pc, pb, st);
  else
    dispatch_pass1<float>(rm, A, B, g, replica, pa, pc, pb, st);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid2(g.gn, g.gm);
  const bool two = mode == 1;
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
