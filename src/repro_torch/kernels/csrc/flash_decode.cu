// Fused-ABFT paged flash decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel ``flash_decode_paged_kernel`` in
// src/repro/kernels/flash_attention.py (body ``_paged_decode_kernel``; the
// dense form ``flash_decode_kernel`` runs the same body through an identity
// block table).  One CUDA block per (batch row, kv head) holds the gq query
// heads of that kv head, walks the row's block table, reads physical block
// table[j] of the pool in place, and runs the online softmax with both
// fused checks:
//   scores  Q . colsum(K_tile) vs rowsum(S), both sides restricted to the
//           valid columns (< length) — invalid slots may hold another
//           request's KV;
//   PV      the checksum rescaled by the softmax correction vs rowsum(acc).
// The score residual and bound are running maxima over k-blocks, so they
// depend on the block partition: the block size is a run-time argument
// (the pool's block size, or min(128, round_up(S, 8)) for a dense cache).
//
// What bounds it on the H100: the KV bytes (decode attention does 2 FLOPs
// per byte read).  Design: no gathered or head-replicated copy of the
// cache is ever made — the dense cache (B, S, KV, D) and the paged pool
// (NB, BS, KV, D) are read in place, each K/V row once per kv head for all
// gq query heads.  Blocks wholly past the row's length are skipped: their
// scores are masked, p == 0 and the correction is exactly 1, so skipping
// them changes no bit of the result (the row's first block is always
// valid, length >= 1).  Sentinel table entries are clamped in the kernel.
// Reductions are sequential loops or fixed warp-shuffle trees (one warp
// per query head): deterministic.  One
// block per (row, kv head) under-fills 132 SMs at small batch; splitting the
// KV walk (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NT = 128;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

struct Args {
  int B, KV, G, D, DV;
  int T;            // block size (pool block, or dense bk)
  int W;            // table width (paged) / number of dense blocks
  int NB;           // pool blocks (paged) / S (dense)
  int dense;        // 1: identity table over a (B, S, KV, D) cache
  long long tstride;
  float scale;
};

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

template <typename TI>
__global__ void __launch_bounds__(NT)
flash_decode_kernel(const TI* __restrict__ q, const TI* __restrict__ kc,
                    const TI* __restrict__ vc, const int* __restrict__ table,
                    const int* __restrict__ lengths, Args a,
                    TI* __restrict__ out, float* __restrict__ rs,
                    float* __restrict__ bs, float* __restrict__ rp,
                    float* __restrict__ bp) {
  const int b = blockIdx.x, h = blockIdx.y, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  constexpr int NW = NT / 32;     // warps; warp w owns query heads w, w+NW..
  const int G = a.G, D = a.D, DV = a.DV, T = a.T;
  extern __shared__ float sm[];
  float* qs = sm;                 // G*D
  // K/V rows padded by one float (D1, DV1): threads that walk t hit
  // distinct banks
  const int D1 = D + 1, DV1 = DV + 1;
  float* ks = qs + G * D;         // T*D1
  float* vs = ks + T * D1;        // T*DV1
  float* ss = vs + T * DV1;       // G*T   scores, then p
  float* acc = ss + G * T;        // G*DV
  float* vmask = acc + G * DV;    // T
  float* vsum = vmask + T;        // T
  float* vabs = vsum + T;         // T
  float* ksum = vabs + T;         // D
  float* kabs = ksum + D;         // D
  float* st = kabs + D;           // 8*G: m l chk bndc ress bnds corr mnew
  float* m_ = st;
  float* l_ = st + G;
  float* chk = st + 2 * G;
  float* bndc = st + 3 * G;
  float* ress = st + 4 * G;
  float* bnds = st + 5 * G;
  float* corr = st + 6 * G;
  float* mnew = st + 7 * G;

  const int len = lengths[b];
  const long long qbase = ((long long)b * a.KV * G + (long long)h * G) * D;
  for (int e = tid; e < G * D; e += NT) qs[e] = to_f32(q[qbase + e]);
  for (int e = tid; e < G * DV; e += NT) acc[e] = 0.f;
  for (int g = tid; g < G; g += NT) {
    m_[g] = NEG_INF; l_[g] = 0.f; chk[g] = 0.f; bndc[g] = 0.f;
    ress[g] = 0.f; bnds[g] = 0.f;
  }
  const int nvis = min(a.W, (len + T - 1) / T);
  const float ascale = fabsf(a.scale);
  __syncthreads();

  for (int j = 0; j < nvis; ++j) {
    long long row0;     // cache row (before the kv-head index) of slot t=0
    int limit;          // loadable slots in this block
    if (a.dense) {
      row0 = (long long)b * a.NB + (long long)j * T;
      limit = min(T, a.NB - j * T);
    } else {
      int blk = table[(long long)b * a.tstride + j];
      blk = min(max(blk, 0), a.NB - 1);      // clamp sentinel entries
      row0 = (long long)blk * T;
      limit = T;
    }
    for (int e = tid; e < T * D; e += NT) {
      const int t = e / D, d = e % D;
      ks[t * D1 + d] = t < limit
          ? to_f32(kc[((row0 + t) * a.KV + h) * D + d]) : 0.f;
    }
    for (int e = tid; e < T * DV; e += NT) {
      const int t = e / DV, d = e % DV;
      vs[t * DV1 + d] = t < limit
          ? to_f32(vc[((row0 + t) * a.KV + h) * DV + d]) : 0.f;
    }
    for (int t = tid; t < T; t += NT)
      vmask[t] = (j * T + t < len) ? 1.f : 0.f;
    __syncthreads();

    for (int e = tid; e < G * T; e += NT) {
      const int g = e / T, t = e % T;
      float s = 0.f;
      for (int d = 0; d < D; ++d) s = fmaf(qs[g * D + d], ks[t * D1 + d], s);
      ss[e] = s * a.scale;
    }
    for (int d = tid; d < D; d += NT) {
      float s = 0.f, sa = 0.f;
      for (int t = 0; t < T; ++t) {
        s += ks[t * D1 + d] * vmask[t];
        sa += fabsf(ks[t * D1 + d]) * vmask[t];
      }
      ksum[d] = s;
      kabs[d] = sa;
    }
    for (int t = tid; t < T; t += NT) {
      float s = 0.f, sa = 0.f;
      for (int d = 0; d < DV; ++d) {
        s += vs[t * DV1 + d];
        sa += fabsf(vs[t * DV1 + d]);
      }
      vsum[t] = s;
      vabs[t] = sa;
    }
    __syncthreads();

    // score check and softmax statistics: one warp per query head, lanes
    // over d and t, fixed shuffle trees
    for (int g = warp; g < G; g += NW) {
      float c = 0.f, bd = 0.f;
      for (int d = lane; d < D; d += 32) {
        c = fmaf(qs[g * D + d], ksum[d], c);
        bd = fmaf(fabsf(qs[g * D + d]), kabs[d], bd);
      }
      float srow = 0.f, mx = NEG_INF;
      for (int t = lane; t < T; t += 32) {
        const float s = ss[g * T + t];
        srow += s * vmask[t];
        if (vmask[t] > 0.f) mx = fmaxf(mx, s);
      }
      c = warp_sum(c) * a.scale;
      bd = warp_sum(bd) * ascale;
      srow = warp_sum(srow);
      mx = fmaxf(warp_max(mx), m_[g]);
      if (lane == 0) {
        ress[g] = fmaxf(ress[g], fabsf(c - srow));
        bnds[g] = fmaxf(bnds[g], bd);
        mnew[g] = mx;
        corr[g] = expf(m_[g] - mx);
      }
    }
    __syncthreads();

    for (int e = tid; e < G * T; e += NT) {
      const int g = e / T, t = e % T;
      ss[e] = vmask[t] > 0.f ? expf(ss[e] - mnew[g]) : 0.f;
    }
    __syncthreads();

    for (int g = warp; g < G; g += NW) {
      float ps = 0.f, pc = 0.f, pb = 0.f;
      for (int t = lane; t < T; t += 32) {
        const float p = ss[g * T + t];
        ps += p;
        pc = fmaf(p, vsum[t], pc);
        pb = fmaf(p, vabs[t], pb);
      }
      ps = warp_sum(ps);
      pc = warp_sum(pc);
      pb = warp_sum(pb);
      if (lane == 0) {
        l_[g] = l_[g] * corr[g] + ps;
        chk[g] = chk[g] * corr[g] + pc;
        bndc[g] = bndc[g] * corr[g] + pb;
        m_[g] = mnew[g];
      }
    }
    for (int e = tid; e < G * DV; e += NT) {
      const int g = e / DV, d = e % DV;
      float pv = 0.f;
      for (int t = 0; t < T; ++t)
        pv = fmaf(ss[g * T + t], vs[t * DV1 + d], pv);
      acc[e] = acc[e] * corr[g] + pv;
    }
    __syncthreads();
  }

  const long long obase = ((long long)b * a.KV * G + (long long)h * G);
  for (int e = tid; e < G * DV; e += NT) {
    const int g = e / DV;
    store_out(&out[obase * DV + e], acc[e] / fmaxf(l_[g], 1e-30f));
  }
  for (int g = warp; g < G; g += NW) {
    float s = 0.f;
    for (int d = lane; d < DV; d += 32) s += acc[g * DV + d];
    s = warp_sum(s);
    if (lane == 0) {
      rp[obase + g] = fabsf(chk[g] - s);
      bp[obase + g] = bndc[g];
      rs[obase + g] = ress[g];
      bs[obase + g] = bnds[g];
    }
  }
}

}  // namespace

extern "C" int flash_decode_smem_bytes(int G, int D, int DV, int T) {
  return (int)sizeof(float) *
         (G * D + T * (D + 1) + T * (DV + 1) + G * T + G * DV + 3 * T +
          2 * D + 8 * G);
}

// dtype: 0 = f32, 1 = bf16.  dense = 1: kc/vc are (B, S, KV, D) caches with
// NB = S and an implicit identity table of W = ceil(S / T) blocks; else
// (NB, T, KV, D) pools with a (B, tstride) int32 table of width W.
extern "C" int flash_decode_launch(
    const void* q, const void* kc, const void* vc, const int* table,
    const int* lengths, void* out, float* rs, float* bs, float* rp,
    float* bp, int B, int KV, int G, int D, int DV, int T, int W, int NB,
    int dense, long long tstride, float scale, int dtype, void* stream) {
  Args a{B, KV, G, D, DV, T, W, NB, dense, tstride, scale};
  const int smem = flash_decode_smem_bytes(G, D, DV, T);
  dim3 grid(B, KV);
  cudaStream_t st = (cudaStream_t)stream;
  // the dynamic shared-memory cap goes to the whole 227 KB a block may use
  static unsigned long long capped[2] = {0, 0};   // devices, one bit each
  cudaError_t err = dtype == 1
      ? hk::raise_smem_cap(flash_decode_kernel<__nv_bfloat16>, 232448,
                           &capped[1])
      : hk::raise_smem_cap(flash_decode_kernel<float>, 232448, &capped[0]);
  if (err != cudaSuccess) return (int)err;
  if (dtype == 1)
    flash_decode_kernel<__nv_bfloat16><<<grid, NT, smem, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)kc,
        (const __nv_bfloat16*)vc, table, lengths, a, (__nv_bfloat16*)out,
        rs, bs, rp, bp);
  else
    flash_decode_kernel<float><<<grid, NT, smem, st>>>(
        (const float*)q, (const float*)kc, (const float*)vc, table, lengths,
        a, (float*)out, rs, bs, rp, bp);
  return (int)cudaGetLastError();
}
