// Fused-ABFT flash attention over a full sequence for Hopper (sm_90a),
// CUDA C++.
//
// Replaces the TPU kernel ``flash_attention_kernel`` in
// src/repro/kernels/flash_attention.py (body ``_kernel``), which the
// reference wrapper vmaps over (batch, head) after repeating kv heads and
// zero-padding q/k/v to block multiples.  Here one CUDA block owns BQ = 64
// query rows of one (batch, head) and walks every logical k block of the
// padded key range in order, with both fused checks of the TPU kernel:
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
// every row of the block (k_lo > q0 + BQ - 1) the PV half is skipped.  That
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
// H = 32, against 6.3 us of q/k/v/o bytes.  This first kernel does not reach that bound: it computes
// in f32 FMA on CUDA cores (the f32 path must, with TF32 off), stages K
// (transposed) and V of one k block in shared memory, and keeps a 4 x 8
// register tile of S and of the output accumulator per thread.  wgmma/TMA
// tiles for bf16 and skipping the masked score blocks' GEMM (their checks
// need only their colsums) are later work.  Reductions are sequential loops
// or fixed warp-shuffle trees and there are no atomics: a retried step
// reproduces its attempt bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

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
  // raise the dynamic shared-memory cap once per instantiation (outside
  // any CUDA-graph capture that later launches replay)
  static bool configured[2] = {false, false};
  if (!configured[dtype == 1]) {
    cudaError_t err = dtype == 1
        ? cudaFuncSetAttribute(flash_attention_kernel<__nv_bfloat16>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448)
        : cudaFuncSetAttribute(flash_attention_kernel<float>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               232448);
    if (err != cudaSuccess) return (int)err;
    configured[dtype == 1] = true;
  }
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
