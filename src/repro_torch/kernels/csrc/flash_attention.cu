// Fused-ABFT flash attention over a full sequence for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel ``flash_attention_kernel`` in
// src/repro/kernels/flash_attention.py (body ``_kernel``), which the
// reference wrapper vmaps over (batch, head) after repeating kv heads and
// zero-padding q/k/v to block multiples.  Here one CUDA block owns 64 (f32)
// or 128 (bf16) query rows of one (batch, head) and walks every logical k
// block of the padded key range in order, with both fused checks of the
// TPU kernel:
//   scores  chk_s = (Q . colsum(K_blk)) * scale vs rowsum(S_blk), and the
//           bound (|Q| . colsum|K_blk|) * |scale|; residual and bound are
//           per-row maxima over ALL k blocks.  As in ``_kernel`` they are
//           taken BEFORE the causal mask, so blocks wholly above the
//           diagonal enter them too: S is computed for every (q, k block)
//           pair;
//   PV      the checksum chk = sum corr * (P . rowsum(V_blk)) and its bound
//           rescale with the online softmax's correction, and are held
//           against rowsum(acc) after the last block.
// The k tile IS the logical block bk (<= 128), so residual and bound follow
// the reference's block partition exactly; the q tile is free (rows are
// independent) and the check arrays come back in the reference's
// (B, H, gq, bq) layout.
//
// Reading q, k, v: q (B, Lq, H, D) and k/v (B, Lk, KV, D) are read in place
// through their strides, query head h on kv head h / G: no kv-head repeat
// and no pad copy.  Rows at or past Lq and keys at or past Lk read as zeros,
// which is exactly the reference's zero padding: padded keys enter both
// checks (and, where the causal test admits them, the softmax) as zero
// keys; padded rows are computed and their checks returned, their outputs
// dropped.
//
// Skipping: for a causal tile whose keys all lie above the diagonal of
// every row of the block (k_lo past the block's last row) the PV half is
// skipped.  That
// changes no bit: every score of the block is masked, so p == 0 and
// corr == exp(m - max(m, -1e30)) == 1 exactly, since k block 0 is never
// wholly masked for a causal row (key 0 <= every row) and m is finite after
// it.  The score check still runs there.
//
// The fault (the reference's (6,) encoding: q block, -, row, col, enabled,
// delta bits) is added to the output accumulator after the last k block,
// before o = acc / l and before the PV residual, in EVERY (batch, head)
// block, as the reference's vmap shares one fault vector across them.
//
// What bounds it on the H100: at llama3.2-1b's shapes (D = 64, L = 1024)
// the tensor-core operations: S over every (query, key) pair, 2 B H L^2 D,
// since the score check precedes the mask, and PV over the pairs the
// causal mask admits, B H D L (L + 1); 13.0 us per launch at B = 2,
// H = 32, against 6.3 us of q/k/v/o bytes.
//
// Two kernels, routed by the wrapper (kernels/flash_attention.py::tc_path):
//   - bf16 (flash_attention_tc): the FlashAttention-2 shape on the tensor
//     cores.  A CUDA block of 8 warps owns 128 query rows; S and PV are
//     mma.sync m16n8k16 (bf16 -> f32) fed by ldmatrix from swizzled shared
//     memory, K and V of the next logical block land by cp.async (zero fill
//     past Lk) while this one computes, and the S fragments become PV's A
//     operand in registers; p = 2^((s - m) log2 e) by ex2.approx, the
//     same p in the output, l and the PV checksum.  The checks stay on the
//     CUDA cores in f32:
//     colsum(K_blk) and rowsum(V_blk) from the same tiles.  P is split into
//     p_hi = bf16(p) and p_lo = bf16(p - p_hi) and PV issued as two MMAs,
//     so the product matches the reference's f32 P to about 2^-17 — one
//     bf16 rounding of P (2^-9) would be ~30 times the PV threshold at
//     Lk = 1024 — and the PV checksum is taken from p_hi + p_lo, the
//     operand the tensor cores multiply (1.5x the MMA work of plain PV);
//   - f32 (flash_attention_kernel), and bf16 whose rows are not 16-byte
//     aligned: f32 FMA on CUDA cores (the f32 path must, with TF32 off),
//     K (transposed) and V of one k block staged in shared memory, a 4 x 8
//     register tile of S and of the output accumulator per thread.
// Reductions are sequential loops or fixed warp-shuffle trees and there
// are no atomics: a retried step reproduces its attempt bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 256;       // threads per block: 16 x 16
constexpr int BQ = 64;        // query rows per block (4 per thread row)
constexpr int MAXT = 128;     // largest logical k block
constexpr int MAXD = 128;     // largest head dim (q/k and v)

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}
__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

struct Args {
  int B, H, G;                // G = H / KV
  int Lq, Lk, Lq_pad, Lk_pad; // true and padded lengths
  int D, DV;
  int bq, bk;                 // logical blocks (bq_eff, bk_eff)
  int causal;
  long long sqb, sql, sqh;    // strides in elements (last dim unit)
  long long skb, skl, skh;
  long long svb, svl, svh;
  float scale;
  int f_qblock, f_row, f_col, f_enabled;
  float f_delta;
};

// shared-memory row strides (floats): chosen so the S and PV phases'
// two half-warps (rows 4 apart) and the column walks hit distinct banks
__host__ __device__ __forceinline__ int qs_ld(int D) { return D + 4; }
__host__ __device__ __forceinline__ int kt_ld(int T) { return T + 1; }
__host__ __device__ __forceinline__ int vs_ld(int DV) { return DV + 1; }
__host__ __device__ __forceinline__ int ss_ld(int T, int DV) {
  return (T + 4 > DV + 4 ? T + 4 : DV + 4);
}

template <typename TI>
__global__ void __launch_bounds__(NT)
flash_attention_kernel(const TI* __restrict__ q, const TI* __restrict__ k,
                       const TI* __restrict__ v, Args a,
                       TI* __restrict__ out, float* __restrict__ rs,
                       float* __restrict__ bs, float* __restrict__ rp,
                       float* __restrict__ bp) {
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int ty = tid >> 4, tx = tid & 15;
  constexpr int NW = NT / 32;
  const int hk = h / a.G;
  const int D = a.D, DV = a.DV, T = a.bk;
  const int QL = qs_ld(D), KL = kt_ld(T), VL = vs_ld(DV), SL = ss_ld(T, DV);
  extern __shared__ float sm[];
  float* Qs = sm;                   // BQ x QL   q rows (zeros past Lq)
  float* Kt = Qs + BQ * QL;         // D x KL    k block, transposed
  float* Vs = Kt + D * KL;          // T x VL    v block
  float* Ss = Vs + T * VL;          // BQ x SL   scores, then p, then acc
  float* ksum = Ss + BQ * SL;       // D
  float* kabs = ksum + D;           // D
  float* vsum = kabs + D;           // T
  float* vabs = vsum + T;           // T
  float* m_ = vabs + T;             // BQ each:
  float* l_ = m_ + BQ;
  float* chk = l_ + BQ;
  float* bndc = chk + BQ;
  float* ress = bndc + BQ;
  float* bnds = ress + BQ;
  float* corr = bnds + BQ;

  const long long qoff = (long long)b * a.sqb + (long long)h * a.sqh;
  const long long koff = (long long)b * a.skb + (long long)hk * a.skh;
  const long long voff = (long long)b * a.svb + (long long)hk * a.svh;
  for (int e = tid; e < BQ * D; e += NT) {
    const int r = e / D, d = e % D, p = q0 + r;
    Qs[r * QL + d] = p < a.Lq ? to_f32(q[qoff + p * a.sql + d]) : 0.f;
  }
  for (int r = tid; r < BQ; r += NT) {
    m_[r] = NEG_INF; l_[r] = 0.f; chk[r] = 0.f; bndc[r] = 0.f;
    ress[r] = 0.f; bnds[r] = 0.f;
  }
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  const float ascale = fabsf(a.scale);
  const int gk = a.Lk_pad / T;

  for (int kb = 0; kb < gk; ++kb) {
    const int k_lo = kb * T;
    // PV may be skipped only where every score of the block is masked
    const bool pv = !a.causal || k_lo <= q0 + BQ - 1;
    for (int e = tid; e < T * D; e += NT) {
      const int t = e / D, d = e % D, kp = k_lo + t;
      Kt[d * KL + t] = kp < a.Lk ? to_f32(k[koff + kp * a.skl + d]) : 0.f;
    }
    for (int e = tid; e < T * DV; e += NT) {
      const int t = e / DV, d = e % DV, kp = k_lo + t;
      Vs[t * VL + d] = kp < a.Lk ? to_f32(v[voff + kp * a.svl + d]) : 0.f;
    }
    __syncthreads();

    for (int d = tid; d < D; d += NT) {
      float s = 0.f, sa = 0.f;
      for (int t = 0; t < T; ++t) {
        const float x = Kt[d * KL + t];
        s += x;
        sa += fabsf(x);
      }
      ksum[d] = s;
      kabs[d] = sa;
    }
    if (pv) {
      for (int t = tid; t < T; t += NT) {
        float s = 0.f, sa = 0.f;
        for (int d = 0; d < DV; ++d) {
          const float x = Vs[t * VL + d];
          s += x;
          sa += fabsf(x);
        }
        vsum[t] = s;
        vabs[t] = sa;
      }
    }
    // S = Q K^T * scale: rows ty*4 + i, columns tx + 16 j
    {
      float s[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
      for (int d = 0; d < D; ++d) {
        float qv[4], kv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) qv[i] = Qs[(ty * 4 + i) * QL + d];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          kv[j] = c < T ? Kt[d * KL + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          if (c < T) Ss[(ty * 4 + i) * SL + c] = s[i][j] * a.scale;
        }
    }
    __syncthreads();

    // per row (one warp per row, lanes over d and t): the score check,
    // then the masked online-softmax update and the PV checksum
    for (int r = warp; r < BQ; r += NW) {
      const int qp = q0 + r;
      float c = 0.f, bd = 0.f;
      for (int d = lane; d < D; d += 32) {
        const float x = Qs[r * QL + d];
        c = fmaf(x, ksum[d], c);
        bd = fmaf(fabsf(x), kabs[d], bd);
      }
      float srow = 0.f;
      for (int t = lane; t < T; t += 32) srow += Ss[r * SL + t];
      c = warp_sum(c) * a.scale;
      bd = warp_sum(bd) * ascale;
      srow = warp_sum(srow);
      if (lane == 0) {
        ress[r] = fmaxf(ress[r], fabsf(c - srow));
        bnds[r] = fmaxf(bnds[r], bd);
      }
      if (!pv) continue;
      float mx = NEG_INF;
      for (int t = lane; t < T; t += 32) {
        const bool ok = !a.causal || qp >= k_lo + t;
        mx = fmaxf(mx, ok ? Ss[r * SL + t] : NEG_INF);
      }
      const float m_old = m_[r];
      const float m_new = fmaxf(m_old, warp_max(mx));
      float ps = 0.f, pc = 0.f, pb = 0.f;
      for (int t = lane; t < T; t += 32) {
        const bool ok = !a.causal || qp >= k_lo + t;
        const float p = ok ? expf(Ss[r * SL + t] - m_new) : 0.f;
        Ss[r * SL + t] = p;
        ps += p;
        pc = fmaf(p, vsum[t], pc);
        pb = fmaf(p, vabs[t], pb);
      }
      ps = warp_sum(ps);
      pc = warp_sum(pc);
      pb = warp_sum(pb);
      if (lane == 0) {
        const float cr = expf(m_old - m_new);
        corr[r] = cr;
        l_[r] = l_[r] * cr + ps;
        chk[r] = chk[r] * cr + pc;
        bndc[r] = bndc[r] * cr + pb;
        m_[r] = m_new;
      }
    }
    __syncthreads();

    if (pv) {
      float pvv[4][8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) pvv[i][j] = 0.f;
      for (int t = 0; t < T; ++t) {
        float pr[4], vv[8];
#pragma unroll
        for (int i = 0; i < 4; ++i) pr[i] = Ss[(ty * 4 + i) * SL + t];
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = tx + 16 * j;
          vv[j] = c < DV ? Vs[t * VL + c] : 0.f;
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j)
            pvv[i][j] = fmaf(pr[i], vv[j], pvv[i][j]);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float cr = corr[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = acc[i][j] * cr + pvv[i][j];
      }
    }
    __syncthreads();
  }

  // the fault lands on the accumulator, then o, then the PV residual
  const long long orow = (long long)b * a.Lq * a.H + h;   // (b, 0, h)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, p = q0 + r;
    const float inv = 1.f / fmaxf(l_[r], 1e-30f);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = tx + 16 * j;
      if (c >= DV) continue;
      float x = acc[i][j];
      if (a.f_enabled == 1 && p / a.bq == a.f_qblock &&
          p % a.bq == a.f_row && c == a.f_col)
        x += a.f_delta;
      Ss[r * SL + c] = x;
      if (p < a.Lq)
        store_out(&out[(orow + (long long)p * a.H) * DV + c],
                  x * inv);
    }
  }
  __syncthreads();
  const long long cbase = ((long long)b * a.H + h) * a.Lq_pad;
  for (int r = warp; r < BQ; r += NW) {
    const int p = q0 + r;
    if (p >= a.Lq_pad) continue;
    float s = 0.f;
    for (int c = lane; c < DV; c += 32) s += Ss[r * SL + c];
    s = warp_sum(s);
    if (lane == 0) {
      rp[cbase + p] = fabsf(chk[r] - s);
      bp[cbase + p] = bndc[r];
      rs[cbase + p] = ress[r];
      bs[cbase + p] = bnds[r];
    }
  }
}

// ------------------------------------------- bf16 on the tensor cores

// Shared memory of the tensor-core kernel (bytes): the Q tile, two K and
// two V tiles (double buffer), rows of DP bf16 with the 16-byte chunks of
// row r at chunk ^ (r & 7) (ldmatrix reads 8 rows without bank
// conflicts), then f32 colsums of K, rowsums of V and the colsum partials.
constexpr int TQ = 128;       // query rows of a tensor-core block
constexpr int TNT = 256;      // its threads: 8 warps of 16 rows

template <int DP>
struct FaTc {
  static constexpr int RB = DP * 2;
  static constexpr int Q_BYTES = TQ * RB;
  static constexpr int KV_BYTES = MAXT * RB;
  static constexpr int OFF_K = Q_BYTES;
  static constexpr int OFF_V = OFF_K + 2 * KV_BYTES;
  static constexpr int OFF_F = OFF_V + 2 * KV_BYTES;
  static constexpr int G = 2 * TNT / DP;        // row groups of a colsum
  static constexpr int F32S = 2 * DP + 2 * MAXT + G * 2 * DP;
  static constexpr int BYTES = OFF_F + 4 * F32S;
};

__device__ __forceinline__ float2 unpack_bf16x2(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// p0, p1 -> hi = bf16(p) and lo = bf16(p - hi) as packed pairs, and
// hi + lo in f32 (the value the tensor cores multiply)
__device__ __forceinline__ float2 split_bf16(float p0, float p1,
                                             uint32_t& hi, uint32_t& lo) {
  hi = hk::pack_bf16(p0, p1);
  const float2 fh = unpack_bf16x2(hi);
  lo = hk::pack_bf16(p0 - fh.x, p1 - fh.y);
  const float2 fl = unpack_bf16x2(lo);
  return make_float2(fh.x + fl.x, fh.y + fl.y);
}

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float LOG2E = 1.4426950408889634f;

// One CUDA block of 8 warps owns TQ = 128 query rows of one (batch,
// head); warp w owns rows 16 w .. 16 w + 15.  Per logical k block (T = bk
// <= 128 keys, padded to TP = T rounded up to 16 with zero rows):
//   S = Q K^T with mma.sync m16n8k16 (Q fragments kept in registers,
//   K through ldmatrix), f32 accumulators in registers;
//   the score check from colsum(K_blk) (CUDA cores, f32) and the S
//   fragments' row sums, before the causal mask;
//   the online softmax on the fragments; P split into p_hi = bf16(p) and
//   p_lo = bf16(p - p_hi), PV as two MMAs on V through ldmatrix.trans; the
//   PV checksum from p_hi + p_lo, the operand the tensor cores multiply.
// The next block's K and V land by cp.async while this one computes.
template <int DP>
__global__ void __launch_bounds__(TNT)
flash_attention_tc(const __nv_bfloat16* __restrict__ q,
                   const __nv_bfloat16* __restrict__ k,
                   const __nv_bfloat16* __restrict__ v, Args a,
                   __nv_bfloat16* __restrict__ out, float* __restrict__ rs,
                   float* __restrict__ bs, float* __restrict__ rp,
                   float* __restrict__ bp) {
  using L = FaTc<DP>;
  constexpr int NC = DP / 8;        // 16-byte chunks in a row
  constexpr int RB = L::RB;
  const int q0 = blockIdx.x * TQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gr = lane >> 2, qd = lane & 3;
  const int hk = h / a.G;
  const int T = a.bk, TP = (T + 15) & ~15;
  extern __shared__ __align__(16) uint8_t tc_sm[];
  const uint32_t sbase = hk::smem_u32(tc_sm);
  float* ksum = reinterpret_cast<float*>(tc_sm + L::OFF_F);
  float* kabs = ksum + DP;
  float* vsum = kabs + DP;
  float* vabs = vsum + MAXT;
  float* red = vabs + MAXT;         // G x {sum, abs} x DP

  const long long qoff = (long long)b * a.sqb + (long long)h * a.sqh;
  const long long koff = (long long)b * a.skb + (long long)hk * a.skh;
  const long long voff = (long long)b * a.svb + (long long)hk * a.svh;
  const float scale = a.scale, ascale = fabsf(a.scale);

  // rows [0, nrows) of a tile from positions p0 + r; rows at or past
  // `limit` (and dims at or past `dims`) are zero-filled
  auto load_tile = [&](uint32_t dst, const __nv_bfloat16* base,
                       long long rstride, int p0, int nrows, int valid,
                       int limit, int dims) {
    for (int e = tid; e < nrows * NC; e += TNT) {
      const int r = e / NC, c = e % NC, pos = p0 + r, d = c * 8;
      int bytes = 0;
      const __nv_bfloat16* src = base;
      if (r < valid && pos < limit && d < dims) {
        bytes = 16;
        src = base + (long long)pos * rstride + d;
      }
      hk::cp_async16(dst + r * RB + ((c ^ (r & 7)) << 4), src, bytes);
    }
  };
  auto needs_pv = [&](int kb) {
    return !a.causal || kb * T <= q0 + TQ - 1;
  };
  // the TP rows of a k block: this thread's chunk lc of rows lr, lr + RPP,
  // ...; rows at or past T or Lk (and dims past `dims`) land as zeros
  constexpr int RPP = TNT / NC;
  const int lc = tid % NC, lr = tid / NC;
  auto load_kv = [&](uint32_t dst, const __nv_bfloat16* base,
                     long long rstride, int kb, int dims) {
    const int p0 = kb * T;
    const __nv_bfloat16* src = base + (long long)(p0 + lr) * rstride + lc * 8;
    const long long step = (long long)RPP * rstride;
    const bool dok = lc * 8 < dims;
#pragma unroll
    for (int r = lr; r < MAXT; r += RPP, src += step) {
      if (r >= TP) break;
      const bool ok = dok && r < T && p0 + r < a.Lk;
      hk::cp_async16(dst + r * RB + ((lc ^ (r & 7)) << 4), ok ? src : base,
                     ok ? 16 : 0);
    }
  };
  auto load_block = [&](int kb) {
    const int buf = kb & 1;
    load_kv(sbase + L::OFF_K + buf * L::KV_BYTES, k + koff, a.skl, kb, a.D);
    if (needs_pv(kb))
      load_kv(sbase + L::OFF_V + buf * L::KV_BYTES, v + voff, a.svl, kb,
              a.DV);
  };

  load_tile(sbase, q + qoff, a.sql, q0, TQ, TQ, a.Lq, a.D);
  load_block(0);
  hk::cp_async_commit();

  float o[NC][4];
#pragma unroll
  for (int n = 0; n < NC; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m_r[2] = {NEG_INF, NEG_INF}, l_r[2] = {0.f, 0.f};
  float chk[2] = {0.f, 0.f}, bndc[2] = {0.f, 0.f};
  float ress[2] = {0.f, 0.f}, bnds[2] = {0.f, 0.f};
  uint32_t qa[DP / 16][4];
  const int gk = a.Lk_pad / T;

  for (int kb = 0; kb < gk; ++kb) {
    const int buf = kb & 1, k_lo = kb * T;
    const bool pv = needs_pv(kb);
    hk::cp_async_wait<0>();
    __syncthreads();          // block kb landed; block kb - 1 fully read
    if (kb + 1 < gk) load_block(kb + 1);
    hk::cp_async_commit();
    if (kb == 0) {
#pragma unroll
      for (int kc = 0; kc < DP / 16; ++kc) {
        const int r = warp * 16 + (lane & 15), c = kc * 2 + (lane >> 4);
        hk::ldmatrix_x4(qa[kc], sbase + r * RB + ((c ^ (r & 7)) << 4));
      }
    }
    const uint32_t kbase = sbase + L::OFF_K + buf * L::KV_BYTES;
    const uint32_t vbase = sbase + L::OFF_V + buf * L::KV_BYTES;
    const uint8_t* kp = tc_sm + L::OFF_K + buf * L::KV_BYTES;
    const uint8_t* vp = tc_sm + L::OFF_V + buf * L::KV_BYTES;

    // S = Q K^T on the tensor cores
    float sacc[16][4];
#pragma unroll
    for (int n = 0; n < 16; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) sacc[n][e] = 0.f;
#pragma unroll
    for (int np = 0; np < 8; ++np) {
      if (np * 16 < TP) {
#pragma unroll
        for (int kc = 0; kc < DP / 16; ++kc) {
          const int mi = lane >> 3;
          const int t = np * 16 + (mi >> 1) * 8 + (lane & 7);
          const int c = kc * 2 + (mi & 1);
          uint32_t r[4];
          hk::ldmatrix_x4(r, kbase + t * RB + ((c ^ (t & 7)) << 4));
          hk::mma_16816(sacc[2 * np], qa[kc], r[0], r[1]);
          hk::mma_16816(sacc[2 * np + 1], qa[kc], r[2], r[3]);
        }
      }
    }
    // CUDA cores: colsum(K_blk), colsum|K_blk| partials per row group,
    // and (for PV) rowsum(V_blk), rowsum|V_blk| per key
    {
      const int dp = tid % (DP / 2), gi = tid / (DP / 2);
      float s0 = 0.f, s1 = 0.f, a0 = 0.f, a1 = 0.f;
      for (int t = gi; t < TP; t += L::G) {
        const float2 x = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(
                kp + t * RB + (((dp >> 2) ^ (t & 7)) << 4) + (dp & 3) * 4));
        s0 += x.x;
        s1 += x.y;
        a0 += fabsf(x.x);
        a1 += fabsf(x.y);
      }
      red[(gi * 2) * DP + 2 * dp] = s0;
      red[(gi * 2) * DP + 2 * dp + 1] = s1;
      red[(gi * 2 + 1) * DP + 2 * dp] = a0;
      red[(gi * 2 + 1) * DP + 2 * dp + 1] = a1;
    }
    if (pv) {                 // two threads a key row, a half each
      const int t = tid >> 1, hv = tid & 1;
      float s = 0.f, sa = 0.f;
      if (t < TP) {
#pragma unroll
        for (int cc = 0; cc < NC / 2; ++cc) {
          const int c = hv * (NC / 2) + cc;
          float x[8];
          hk::unpack8(*reinterpret_cast<const uint4*>(
                          vp + t * RB + ((c ^ (t & 7)) << 4)), x);
#pragma unroll
          for (int e = 0; e < 8; ++e) {
            s += x[e];
            sa += fabsf(x[e]);
          }
        }
      }
      s += __shfl_xor_sync(0xffffffffu, s, 1);
      sa += __shfl_xor_sync(0xffffffffu, sa, 1);
      if (hv == 0 && t < TP) {
        vsum[t] = s;
        vabs[t] = sa;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < 2 * DP; idx += TNT) {
      const int which = idx / DP, d = idx % DP;
      float t = 0.f;
#pragma unroll
      for (int gi = 0; gi < L::G; ++gi) t += red[(gi * 2 + which) * DP + d];
      (which ? kabs : ksum)[d] = t;
    }
    __syncthreads();

    // score check per row half hh (rows gr and gr + 8 of the warp):
    // scale (Q . colsum K) against rowsum(S), before the causal mask; quad
    // lane qd takes a quarter of the head dims
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int r = warp * 16 + gr + 8 * hh;
      float cs = 0.f, bd = 0.f;
#pragma unroll
      for (int cc = 0; cc < DP / 32; ++cc) {
        const int c = qd * (DP / 32) + cc;
        float x[8];
        hk::unpack8(*reinterpret_cast<const uint4*>(
                        tc_sm + r * RB + ((c ^ (r & 7)) << 4)), x);
        const float4* ks4 = reinterpret_cast<const float4*>(ksum + c * 8);
        const float4* ka4 = reinterpret_cast<const float4*>(kabs + c * 8);
        const float4 s0 = ks4[0], s1 = ks4[1], a0 = ka4[0], a1 = ka4[1];
        const float ks[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
        const float ka[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          cs = fmaf(x[e], ks[e], cs);
          bd = fmaf(fabsf(x[e]), ka[e], bd);
        }
      }
      float srow = 0.f;
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          sacc[n][2 * hh + e] *= scale;
          if (n * 8 + 2 * qd + e < T) srow += sacc[n][2 * hh + e];
        }
#pragma unroll
      for (int o_ = 1; o_ < 4; o_ <<= 1) {
        cs += __shfl_xor_sync(0xffffffffu, cs, o_);
        bd += __shfl_xor_sync(0xffffffffu, bd, o_);
        srow += __shfl_xor_sync(0xffffffffu, srow, o_);
      }
      ress[hh] = fmaxf(ress[hh], fabsf(cs * scale - srow));
      bnds[hh] = fmaxf(bnds[hh], bd * ascale);
    }
    if (pv) {
      // masked online softmax on the fragments: key t of the block is live
      // for row half hh iff t < lim[hh]
      int lim[2];
      float m_new[2], corr[2];
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int qp = q0 + warp * 16 + gr + 8 * hh;
        lim[hh] = a.causal ? max(0, min(T, qp - k_lo + 1)) : T;
        float mx = NEG_INF;
#pragma unroll
        for (int n = 0; n < 16; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e)
            if (n * 8 + 2 * qd + e < lim[hh])
              mx = fmaxf(mx, sacc[n][2 * hh + e]);
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        m_new[hh] = fmaxf(m_r[hh], mx);
        corr[hh] = ex2((m_r[hh] - m_new[hh]) * LOG2E);
      }
      // p = 2^(s log2 e - m log2 e), split into p_hi + p_lo in place (the
      // S registers then hold the packed bf16 pairs of PV's A operand), the
      // sums from p_hi + p_lo
      float ps[2] = {0.f, 0.f}, pc[2] = {0.f, 0.f}, pb[2] = {0.f, 0.f};
      const float ml[2] = {m_new[0] * LOG2E, m_new[1] * LOG2E};
#pragma unroll
      for (int n = 0; n < 16; ++n) {
        const int t0 = n * 8 + 2 * qd;
        const bool in = t0 < TP;
        const float2 vs = in ? *reinterpret_cast<const float2*>(vsum + t0)
                             : make_float2(0.f, 0.f);
        const float2 va = in ? *reinterpret_cast<const float2*>(vabs + t0)
                             : make_float2(0.f, 0.f);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const float p0 = t0 < lim[hh]
              ? ex2(fmaf(sacc[n][2 * hh], LOG2E, -ml[hh])) : 0.f;
          const float p1 = t0 + 1 < lim[hh]
              ? ex2(fmaf(sacc[n][2 * hh + 1], LOG2E, -ml[hh])) : 0.f;
          uint32_t hi, lo;
          const float2 q = split_bf16(p0, p1, hi, lo);
          ps[hh] += q.x + q.y;
          pc[hh] = fmaf(q.y, vs.y, fmaf(q.x, vs.x, pc[hh]));
          pb[hh] = fmaf(q.y, va.y, fmaf(q.x, va.x, pb[hh]));
          sacc[n][2 * hh] = __uint_as_float(hi);
          sacc[n][2 * hh + 1] = __uint_as_float(lo);
        }
      }
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
        for (int o_ = 1; o_ < 4; o_ <<= 1) {
          ps[hh] += __shfl_xor_sync(0xffffffffu, ps[hh], o_);
          pc[hh] += __shfl_xor_sync(0xffffffffu, pc[hh], o_);
          pb[hh] += __shfl_xor_sync(0xffffffffu, pb[hh], o_);
        }
        l_r[hh] = l_r[hh] * corr[hh] + ps[hh];
        chk[hh] = chk[hh] * corr[hh] + pc[hh];
        bndc[hh] = bndc[hh] * corr[hh] + pb[hh];
        m_r[hh] = m_new[hh];
#pragma unroll
        for (int n = 0; n < NC; ++n) {
          o[n][2 * hh] *= corr[hh];
          o[n][2 * hh + 1] *= corr[hh];
        }
      }
      // PV = p_hi V + p_lo V: the S fragments of two key octets are the
      // A fragment of one 16-key step
#pragma unroll
      for (int kt = 0; kt < 8; ++kt) {
        if (kt * 16 < TP) {
          const uint32_t ah[4] = {
              __float_as_uint(sacc[2 * kt][0]),
              __float_as_uint(sacc[2 * kt][2]),
              __float_as_uint(sacc[2 * kt + 1][0]),
              __float_as_uint(sacc[2 * kt + 1][2])};
          const uint32_t al[4] = {
              __float_as_uint(sacc[2 * kt][1]),
              __float_as_uint(sacc[2 * kt][3]),
              __float_as_uint(sacc[2 * kt + 1][1]),
              __float_as_uint(sacc[2 * kt + 1][3])};
#pragma unroll
          for (int dp = 0; dp < DP / 16; ++dp) {
            const int mi = lane >> 3;
            const int t = kt * 16 + (mi & 1) * 8 + (lane & 7);
            const int c = dp * 2 + (mi >> 1);
            uint32_t r[4];
            hk::ldmatrix_x4_trans(r, vbase + t * RB + ((c ^ (t & 7)) << 4));
            hk::mma_16816(o[2 * dp], ah, r[0], r[1]);
            hk::mma_16816(o[2 * dp], al, r[0], r[1]);
            hk::mma_16816(o[2 * dp + 1], ah, r[2], r[3]);
            hk::mma_16816(o[2 * dp + 1], al, r[2], r[3]);
          }
        }
      }
    }
  }

  // the fault lands on the accumulator, then o, then the PV residual
  const long long orow = (long long)b * a.Lq * a.H + h;   // (b, 0, h)
  const long long cbase = ((long long)b * a.H + h) * a.Lq_pad;
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int r = warp * 16 + gr + 8 * hh, p = q0 + r;
    float rsum = 0.f;
#pragma unroll
    for (int n = 0; n < NC; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = n * 8 + 2 * qd + e;
        float x = o[n][2 * hh + e];
        if (a.f_enabled == 1 && p / a.bq == a.f_qblock &&
            p % a.bq == a.f_row && c == a.f_col)
          x += a.f_delta;
        o[n][2 * hh + e] = x;
        if (c < a.DV) rsum += x;
      }
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
    rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
    const float l = fmaxf(l_r[hh], 1e-30f);
    if (p < a.Lq) {
#pragma unroll
      for (int n = 0; n < NC; ++n) {
        const int c = n * 8 + 2 * qd;
        if (c < a.DV)
          *reinterpret_cast<__nv_bfloat162*>(
              &out[(orow + (long long)p * a.H) * a.DV + c]) =
              __floats2bfloat162_rn(o[n][2 * hh] / l, o[n][2 * hh + 1] / l);
      }
    }
    if (qd == 0 && p < a.Lq_pad) {
      rp[cbase + p] = fabsf(chk[hh] - rsum);
      bp[cbase + p] = bndc[hh];
      rs[cbase + p] = ress[hh];
      bs[cbase + p] = bnds[hh];
    }
  }
}

}  // namespace

extern "C" int flash_attention_smem_bytes(int D, int DV, int T) {
  return (int)sizeof(float) *
         (BQ * qs_ld(D) + D * kt_ld(T) + T * vs_ld(DV) +
          BQ * ss_ld(T, DV) + 2 * D + 2 * T + 7 * BQ);
}

// dtype: 0 = f32, 1 = bf16.  q (B, Lq, H, D), k (B, Lk, KV, D),
// v (B, Lk, KV, DV) with unit stride in the last dim; out (B, Lq, H, DV)
// contiguous; rs/bs/rp/bp (B, H, Lq_pad) f32 with Lq_pad = gq * bq.
extern "C" int flash_attention_launch(
    const void* q, const void* k, const void* v, void* out, float* rs,
    float* bs, float* rp, float* bp, int B, int H, int KV, int Lq, int Lk,
    int Lq_pad, int Lk_pad, int D, int DV, int bq, int bk, int causal,
    long long sqb, long long sql, long long sqh, long long skb,
    long long skl, long long skh, long long svb, long long svl,
    long long svh, float scale, int f_qblock, int f_row, int f_col,
    int f_enabled, int f_delta_bits, int dtype, void* stream) {
  if (D > MAXD || DV > MAXD || bk > MAXT || bk <= 0 || bq <= 0 ||
      H % KV != 0 || Lk_pad % bk != 0 || Lq_pad % bq != 0)
    return (int)cudaErrorInvalidValue;
  float delta;
  memcpy(&delta, &f_delta_bits, sizeof(float));
  Args a{B, H, H / KV, Lq, Lk, Lq_pad, Lk_pad, D, DV, bq, bk, causal,
         sqb, sql, sqh, skb, skl, skh, svb, svl, svh, scale,
         f_qblock, f_row, f_col, f_enabled, delta};
  const int smem = flash_attention_smem_bytes(D, DV, bk);
  dim3 grid((Lq_pad + BQ - 1) / BQ, H, B);
  cudaStream_t st = (cudaStream_t)stream;
  static unsigned long long capped[2] = {0, 0};   // devices, one bit each
  cudaError_t err = dtype == 1
      ? hk::raise_smem_cap(flash_attention_kernel<__nv_bfloat16>, 232448,
                           &capped[1])
      : hk::raise_smem_cap(flash_attention_kernel<float>, 232448,
                           &capped[0]);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1)
    flash_attention_kernel<__nv_bfloat16><<<grid, NT, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
        (const __nv_bfloat16*)v, a, (__nv_bfloat16*)out, rs, bs, rp, bp);
  else
    flash_attention_kernel<float><<<grid, NT, smem, st>>>(
        (const float*)q, (const float*)k, (const float*)v, a, (float*)out,
        rs, bs, rp, bp);
  return (int)cudaGetLastError();
}

// The bf16 tensor-core kernel: the same arguments as
// flash_attention_launch (dtype must be 1), plus the terms its loads need:
// D and DV multiples of 8, every row stride of q, k and v a multiple of 8
// elements and the three base pointers 16-byte aligned (the wrapper
// checks them).
extern "C" int flash_attention_tc_launch(
    const void* q, const void* k, const void* v, void* out, float* rs,
    float* bs, float* rp, float* bp, int B, int H, int KV, int Lq, int Lk,
    int Lq_pad, int Lk_pad, int D, int DV, int bq, int bk, int causal,
    long long sqb, long long sql, long long sqh, long long skb,
    long long skl, long long skh, long long svb, long long svl,
    long long svh, float scale, int f_qblock, int f_row, int f_col,
    int f_enabled, int f_delta_bits, int dtype, void* stream) {
  if (dtype != 1 || D > MAXD || DV > MAXD || D % 8 || DV % 8 ||
      bk > MAXT || bk <= 0 || bk % 8 || bq <= 0 || H % KV != 0 ||
      Lk_pad % bk != 0 || Lq_pad % bq != 0)
    return (int)cudaErrorInvalidValue;
  float delta;
  memcpy(&delta, &f_delta_bits, sizeof(float));
  Args a{B, H, H / KV, Lq, Lk, Lq_pad, Lk_pad, D, DV, bq, bk, causal,
         sqb, sql, sqh, skb, skl, skh, svb, svl, svh, scale,
         f_qblock, f_row, f_col, f_enabled, delta};
  dim3 grid((Lq_pad + TQ - 1) / TQ, H, B);
  cudaStream_t st = (cudaStream_t)stream;
  const bool wide = D > 64 || DV > 64;
  static unsigned long long capped[2] = {0, 0};   // devices, one bit each
  cudaError_t err = wide
      ? hk::raise_smem_cap(flash_attention_tc<128>, FaTc<128>::BYTES,
                           &capped[1])
      : hk::raise_smem_cap(flash_attention_tc<64>, FaTc<64>::BYTES,
                           &capped[0]);
  if (err != cudaSuccess) return (int)err;
  const __nv_bfloat16* qq = (const __nv_bfloat16*)q;
  const __nv_bfloat16* kk = (const __nv_bfloat16*)k;
  const __nv_bfloat16* vv = (const __nv_bfloat16*)v;
  __nv_bfloat16* oo = (__nv_bfloat16*)out;
  if (wide)
    flash_attention_tc<128><<<grid, TNT, FaTc<128>::BYTES, st>>>(
        qq, kk, vv, a, oo, rs, bs, rp, bp);
  else
    flash_attention_tc<64><<<grid, TNT, FaTc<64>::BYTES, st>>>(
        qq, kk, vv, a, oo, rs, bs, rp, bp);
  return (int)cudaGetLastError();
}

