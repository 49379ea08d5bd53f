// Fused-ABFT paged flash decode for Hopper (sm_90a), CUDA C++.
//
// Replaces the TPU kernel ``flash_decode_paged_kernel`` in
// src/repro/kernels/flash_attention.py (body ``_paged_decode_kernel``; the
// dense form ``flash_decode_kernel`` runs the same body through an identity
// block table).  For one (batch row, kv head) it holds the G query heads of
// that kv head, walks the row's block table, reads physical block table[j]
// of the pool in place, and runs the online softmax with both fused checks:
//   scores  Q . colsum(K_block) vs rowsum(S), both sides restricted to the
//           valid columns (< length) — invalid slots may hold another
//           request's KV;
//   PV      the checksum rescaled by the softmax correction vs rowsum(acc).
// The score residual and bound are maxima over the logical k-blocks, so they
// depend on the block partition: the block size is a run-time argument (the
// pool's block size, or min(128, round_up(S, 8)) for a dense cache), and
// every sum of the score check is taken over exactly one logical block.
//
// What bounds it on the H100: not the KV bytes (decode attention does 2
// FLOPs per byte read; ~0.4 us a layer at the serving shapes) but latency:
// one CTA per (row, kv head) gave 32 CTAs on 132 SMs, each walking its row
// alone through a chain of dependent loads, shuffles and barriers.  Each CTA
// runs its code about once, so every phase costs its latency chain (and
// instruction fetch), not its arithmetic (clock64 probe, PERF.md).
//
// Design: split-KV flash decoding.  The grid is (B, KV, splits); split s
// owns the contiguous run of logical blocks [s * per, (s + 1) * per) of the
// row (the host picks `splits` from B, KV, W and T alone —
// kernels/flash_attention.py::decode_splits — never from the lengths, so a
// launch's shape is fixed and can be captured in a CUDA graph).  Inside a
// CTA each of the 8 warps walks its own chunks of 16 keys:
//   - a chunk's K and V rows land in the warp's shared-memory double
//     buffer by 16-byte cp.async while the previous chunk is computed (the
//     first chunk is issued before q is staged); rows past the length are
//     never read (zero fill), so stale KV in a reused block reaches no sum;
//   - scores lane by key, the two half-warps taking alternate 16-byte units
//     of the key's row (q in shared memory as f32, read as broadcasts; each
//     K row is read once for all G query heads), the score check's K column
//     sums lanes by 16-byte unit, the PV product lanes by V unit, all
//     reductions fixed shuffle trees, interleaved over the G heads;
//   - each warp keeps its own online-softmax state and each lane its share
//     of acc; the CTA merges them in shared memory, and the last CTA of a
//     (row, kv head) — elected by an integer ticket that it resets — merges
//     the splits, both in a fixed order: m = max m_i, w_i = exp(m_i - m)
//     taken once, l, acc, chk, bndc the w_i-weighted sums, the score
//     check's residual and bound maxima.  No launch is added and no
//     floating-point atomic is used: a retry is bit-identical.
// The score check's block sums: with T | 16 a chunk holds whole blocks
// (segmented shuffle trees of width T); otherwise the CTA takes one block
// at a time, its chunks spread over the warps, and adds the warps' sums of
// that block in shared memory before the max is taken.  A split whose keys
// all lie past the length keeps m = -1e30, l = 0 and contributes weight
// exp(-1e30 - m) = 0 (the sentinel is finite: no inf - inf).
// Shapes: a kv head's G query heads go to ceil(G / 8) CTAs of at most 8
// heads (the grid's y is kv head x head group), each run by the smallest
// instantiation of 1, 2, 4 or 8 heads that holds them; the extra heads get
// q = 0 and are not stored.  A row of any whole number of 16-byte units
// (at most 32) is padded in shared memory to a power of two of them; the
// padding is zero-filled by cp.async and q's padding is zero, so it adds
// nothing to any sum.  Rows padded to 512 bytes (bf16 past 128 values,
// f32 past 64), whose double buffers would not fit, take one buffer a
// warp: the next chunk is loaded after the current one is used.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;
constexpr int NW = 8;             // warps a CTA
constexpr int NT = 32 * NW;
constexpr int KC = 16;            // keys a warp chunk: one a half-warp lane
constexpr int NSTAT = 6;          // m l chk bndc ress bnds
constexpr int MAX_SPLITS = 64;    // the split merge stages their stats
constexpr int SMEM_CAP = 232448;  // dynamic shared memory a CTA may take

__host__ __device__ inline int pow2_at_least(int v) {
  int p = 1;
  while (p < v) p <<= 1;
  return p;
}

struct Args {
  int B, KV, G, D, DV;  // G query heads a kv head; D, DV the rows' values
  int NSG, HG;      // CTAs (head groups) a kv head, heads a group
  int DP, DVP;      // D, DV padded to a power of two of 16-byte units
  int T;            // block size (pool block, or dense bk)
  int W;            // table width (paged) / number of dense blocks
  int NB;           // pool blocks (paged) / S (dense)
  int dense;        // 1: identity table over a (B, S, KV, D) cache
  int splits, per;  // K splits of the block walk, blocks per split
  int nstage;       // a warp's chunk buffers: 2, or 1 for wide rows
  long long tstride;
  float scale;
};

__device__ __forceinline__ void unit_f32(const float4& u, float* f) {
  f[0] = u.x; f[1] = u.y; f[2] = u.z; f[3] = u.w;
}
__device__ __forceinline__ void unit_f32(const uint4& u, float* f) {
  hk::unpack8(u, f);
}
template <typename TI>
struct Unit;      // 16 bytes of a row: VPU values
template <>
struct Unit<float> { using T = float4; static constexpr int VPU = 4; };
template <>
struct Unit<__nv_bfloat16> { using T = uint4; static constexpr int VPU = 8; };

__device__ __forceinline__ void store_out(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_out(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}
__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Bytes of dynamic shared memory: each warp's `ns` buffers (2: double
// buffered; 1 for rows too wide for two) of K and V
// chunks (rows padded by one 16-byte unit: lanes reading one unit of 8
// consecutive rows hit distinct banks), each warp's p values, q, the
// warps' stats, every lane's share of acc (also the staging area of the
// split merge), the block partials, the merged state, the elected flag,
// each warp's first chunk's block ids and its chunk's cache rows (no
// static shared memory: the launch may take all of the 227 KB).
__host__ __device__ inline int decode_smem(int G, int D, int DV, int esz,
                                           int ns) {
  const int krow = (D * esz / 16 + 1) * 16, vrow = (DV * esz / 16 + 1) * 16;
  const int stage = KC * (krow + vrow);
  const int vpu = 16 / esz;
  return NW * ns * stage +
         4 * (NW * KC * G + G * D + NW * G * NSTAT + NT * G * vpu +
              2 * NW * G * 3 + G * (NSTAT + DV) + 2 * G + MAX_SPLITS * G +
              G + 4 + 2 * NW * KC);
}

// Merge n <= MAX_SPLITS online-softmax states into one, in index order:
// stats of state i at st + i * G * NSTAT in shared memory (m l chk bndc
// ress bnds a head), its acc element e the sum over r < nr of acc(i, r,
// e) — shares of one acc kept apart, added in r order.  The weights
// w_i = exp(m_i - max m) are taken once into `wts` (n x G, then G maxima;
// each thread finds the max itself, in the same order); the acc loads are
// issued four at a time.  Every thread of the CTA calls it (it holds
// barriers); the result is in out_st / out_acc after the final barrier.
template <int G, typename ACC>
__device__ void merge_states(int n, int nr, const float* st, ACC acc,
                             int DV, float* wts, float* out_st,
                             float* out_acc, int tid) {
  float* mxs = wts + MAX_SPLITS * G;
  for (int e = tid; e < n * G; e += NT) {
    const float* sg = st + (e % G) * NSTAT;
    float mx = NEG_INF;
    for (int i = 0; i < n; ++i) mx = fmaxf(mx, sg[i * G * NSTAT]);
    wts[e] = expf(sg[(e / G) * G * NSTAT] - mx);
    if (e < G) mxs[e] = mx;
  }
  __syncthreads();
  for (int e = tid; e < G * DV; e += NT) {
    const float* w = wts + e / DV;
    auto share = [&](int i) {       // state i's acc element, r in order
      float v0 = 0.f, v1 = 0.f, v2 = 0.f, v3 = 0.f;
      int r = 0;
      for (; r + 4 <= nr; r += 4) {
        v0 += acc(i, r, e);
        v1 += acc(i, r + 1, e);
        v2 += acc(i, r + 2, e);
        v3 += acc(i, r + 3, e);
      }
      for (; r < nr; ++r) v0 += acc(i, r, e);
      return (v0 + v1) + (v2 + v3);
    };
    float a = 0.f;
    int i = 0;
    for (; i + 4 <= n; i += 4) {    // four states' loads in flight
      const float x0 = share(i), x1 = share(i + 1), x2 = share(i + 2),
                  x3 = share(i + 3);
      a = fmaf(w[i * G], x0, a);
      a = fmaf(w[(i + 1) * G], x1, a);
      a = fmaf(w[(i + 2) * G], x2, a);
      a = fmaf(w[(i + 3) * G], x3, a);
    }
    for (; i < n; ++i) a = fmaf(w[i * G], share(i), a);
    out_acc[e] = a;
  }
  if (tid < G) {
    float l = 0.f, c = 0.f, b = 0.f, r = 0.f, bs = 0.f;
    for (int i = 0; i < n; ++i) {
      const float* s = st + i * G * NSTAT + tid * NSTAT;
      const float w = wts[i * G + tid];
      l = fmaf(w, s[1], l);
      c = fmaf(w, s[2], c);
      b = fmaf(w, s[3], b);
      r = fmaxf(r, s[4]);
      bs = fmaxf(bs, s[5]);
    }
    float* o = out_st + tid * NSTAT;
    o[0] = mxs[tid]; o[1] = l; o[2] = c; o[3] = b; o[4] = r; o[5] = bs;
  }
  __syncthreads();
}

template <typename TI, int G>
__global__ void __launch_bounds__(NT)
flash_decode_split(const TI* __restrict__ q, const TI* __restrict__ kc,
                   const TI* __restrict__ vc, const int* __restrict__ table,
                   const int* __restrict__ lengths, Args a,
                   TI* __restrict__ out, float* __restrict__ rs,
                   float* __restrict__ bs, float* __restrict__ rp,
                   float* __restrict__ bp, float* __restrict__ scratch,
                   int* __restrict__ tickets, float* __restrict__ lse) {
  using U = typename Unit<TI>::T;
  constexpr int VPU = Unit<TI>::VPU;
  const int b = blockIdx.x, hy = blockIdx.y, sp = blockIdx.z;
  const int h = hy / a.NSG, g0 = (hy % a.NSG) * a.HG;
  const int ng = min(a.HG, a.G - g0);             // live heads of the G
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // D, DV: the padded rows of shared memory; DR, DVR: the cache's rows
  const int D = a.DP, DV = a.DVP, DR = a.D, DVR = a.DV, T = a.T;
  const int UK = D / VPU, UV = DV / VPU;          // 16-byte units a row
  const int UKR = DR / VPU, UVR = DVR / VPU;      // of them in the cache
  const int KROW = (UK + 1) * 16, VROW = (UV + 1) * 16;
  const int RSK = 32 / UK, RSV = 32 / UV;         // rows a warp-wide pass
  const int kr = lane / UK, ku = lane % UK;
  const int vr = lane / UV, vu = lane % UV;
  const int key = lane % KC, half = lane / KC;    // scores: lane by key

  extern __shared__ __align__(16) uint8_t smem[];
  const int STAGE = KC * (KROW + VROW);
  uint8_t* wbuf = smem + warp * a.nstage * STAGE;
  float* fbase = reinterpret_cast<float*>(smem + NW * a.nstage * STAGE);
  float* ps = fbase + warp * KC * G;              // [KC][G] this warp's p
  float* qs = fbase + NW * KC * G;                // [G][D] f32
  float* wst = qs + G * D;                        // [NW][G][NSTAT]
  float* wacc = wst + NW * G * NSTAT;             // [NW][RSV][G][DV]
  float* bpart = wacc + NT * G * VPU;             // [2][NW][G][3]
  float* fst = bpart + 2 * NW * G * 3;            // [G][NSTAT]
  float* facc = fst + G * NSTAT;                  // [G][DV]
  float* lmax = facc + G * DV;                    // [G][2] block-check max
  float* wts = lmax + 2 * G;                      // merge weights, maxima
  int& last = *reinterpret_cast<int*>(wts + MAX_SPLITS * G + G);
  int* wblk = reinterpret_cast<int*>(wts + MAX_SPLITS * G + G + 4) +
              warp * KC;                          // [NW][KC]
  int* wrow = wblk + NW * KC;                     // [NW][KC]

  const int len = lengths[b];
  const long long qbase = ((long long)b * a.KV + h) * a.G + g0;
  // q of shared-memory slot e (head e / D, value e % D): zero for the
  // padding and for heads past the group
  auto qval = [&](int e) {
    const int g = e / D, d = e - g * D;
    return g < ng && d < DR ? to_f32(q[(qbase + g) * DR + d]) : 0.f;
  };
  // the warp's first chunk starts at fc0 whatever the length: its block
  // ids are read beside the length, not after it
  const int fc0 = sp * a.per * T + warp * KC;
  if (!a.dense && lane < KC)
    wblk[lane] = table[(long long)b * a.tstride +
                       min((fc0 + lane) / T, a.W - 1)];
  float qreg[4];                   // q in flight beside the length
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int e = tid + i * NT;
    qreg[i] = e < G * D ? qval(e) : 0.f;
  }
  const int nvis = min(a.W, (len + T - 1) / T);
  const int j0 = sp * a.per, j1 = min(j0 + a.per, nvis);
  const int kbeg = j0 * T, kend = j1 > j0 ? min(j1 * T, len) : kbeg;
  // T | KC: a chunk holds whole blocks and the CTA walks its keys in one
  // round; otherwise one round a block, its chunks over the warps
  const bool small = (KC % T) == 0;
  const int rounds = small ? (kend > kbeg ? 1 : 0) : max(0, j1 - j0);
  const int seg = small ? T : KC;
  const float ascale = fabsf(a.scale);

  auto round_range = [&](int r, int& rb, int& re) {
    if (small) {
      rb = kbeg;
      re = kend;
    } else {
      rb = (j0 + r) * T;
      re = min(rb + T, kend);
    }
  };
  const int uks = __ffs(UK) - 1, uvs = __ffs(UV) - 1;   // powers of two
  // the chunk's K and V rows by cp.async: first each key's cache row
  // (before the kv-head index), one lane a key, the table read and the
  // division by T done once
  auto issue = [&](int c0, int n, int stage) {
    uint8_t* kb = wbuf + stage * STAGE;
    uint8_t* vb = kb + KC * KROW;
    if (lane < n) {
      const int pos = c0 + lane;
      int row = b * a.NB + pos;
      if (!a.dense) {
        int blk = c0 == fc0 ? wblk[lane]
                            : table[(long long)b * a.tstride + pos / T];
        blk = min(max(blk, 0), a.NB - 1);          // clamp sentinels
        row = blk * T + pos % T;
      }
      wrow[lane] = row;
    }
    __syncwarp();
    for (int idx = lane; idx < KC * UK; idx += 32) {
      const int t = idx >> uks, u = idx & (UK - 1);
      const TI* src = kc;
      int bytes = 0;
      if (t < n && u < UKR) {
        src = kc + ((long long)wrow[t] * a.KV + h) * DR + u * VPU;
        bytes = 16;
      }
      hk::cp_async16(hk::smem_u32(kb + t * KROW + u * 16), src, bytes);
    }
    for (int idx = lane; idx < KC * UV; idx += 32) {
      const int t = idx >> uvs, u = idx & (UV - 1);
      const TI* src = vc;
      int bytes = 0;
      if (t < n && u < UVR) {
        src = vc + ((long long)wrow[t] * a.KV + h) * DVR + u * VPU;
        bytes = 16;
      }
      hk::cp_async16(hk::smem_u32(vb + t * VROW + u * 16), src, bytes);
    }
  };

  // this warp's online-softmax state (equal in every lane) and its share
  // of acc: query head g, V unit vu, rows t == vr mod RSV
  float m[G], l[G], ck[G], bc[G], rmax[G], bmax[G];
  float acc[G][VPU];
#pragma unroll
  for (int g = 0; g < G; ++g) {
    m[g] = NEG_INF; l[g] = ck[g] = bc[g] = rmax[g] = bmax[g] = 0.f;
#pragma unroll
    for (int e = 0; e < VPU; ++e) acc[g][e] = 0.f;
  }

  // one chunk: keys c0 .. c0 + n - 1 of the row, landed in `stage`.  Adds
  // the score check's sums of the chunk's segments to (pc, psr, pb) for
  // large blocks, or folds each block's residual into rmax / bmax.
  auto chunk = [&](int c0, int n, int stage, float* pc, float* psr,
                   float* pb) {
    const uint8_t* kb = wbuf + stage * STAGE;
    const uint8_t* vb = kb + KC * KROW;
    const bool valid = key < n;
    // scores, lane by key: the two half-warps take alternate 16-byte units
    // of the key's row, then add their halves
    float s[G];
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] = 0.f;
    for (int u = half; u < UKR; u += 2) {
      float kv[VPU];
      unit_f32(*reinterpret_cast<const U*>(kb + key * KROW + u * 16), kv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * D + u * VPU;
#pragma unroll
        for (int e = 0; e < VPU; e += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(qg + e);
          s[g] = fmaf(q4.x, kv[e], s[g]);
          s[g] = fmaf(q4.y, kv[e + 1], s[g]);
          s[g] = fmaf(q4.z, kv[e + 2], s[g]);
          s[g] = fmaf(q4.w, kv[e + 3], s[g]);
        }
      }
    }
    // the row sums of the lane's V row, halves as for the scores
    float vsum = 0.f, vabs = 0.f;
    for (int u = half; u < UVR; u += 2) {
      float vv[VPU];
      unit_f32(*reinterpret_cast<const U*>(vb + key * VROW + u * 16), vv);
#pragma unroll
      for (int e = 0; e < VPU; ++e) {
        vsum += vv[e];
        vabs += fabsf(vv[e]);
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) s[g] += __shfl_xor_sync(0xffffffffu, s[g], KC);
    vsum += __shfl_xor_sync(0xffffffffu, vsum, KC);
    vabs += __shfl_xor_sync(0xffffffffu, vabs, KC);
    // rowsum(S) over each segment's valid keys (segmented tree)
    float sr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      s[g] *= a.scale;
      sr[g] = valid ? s[g] : 0.f;
    }
    for (int o = 1; o < seg; o <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g)
        sr[g] += __shfl_xor_sync(0xffffffffu, sr[g], o);
    }
    // Q . colsum(K) and |Q| . colsum|K| of each segment: lanes by unit
    // sum the segment's rows t == kr mod RSK, then trees over rows and
    // over units (rows past n are zero: never loaded)
    float cs[G], bsg[G];
    const int nseg = KC / seg;
    for (int sg = 0; sg < nseg; ++sg) {
      float ksm[VPU], kab[VPU];
#pragma unroll
      for (int e = 0; e < VPU; ++e) ksm[e] = kab[e] = 0.f;
      for (int t = kr; t < KC; t += RSK) {
        if (t / seg != sg || t >= n) continue;
        float kv[VPU];
        unit_f32(*reinterpret_cast<const U*>(kb + t * KROW + ku * 16), kv);
#pragma unroll
        for (int e = 0; e < VPU; ++e) {
          ksm[e] += kv[e];
          kab[e] += fabsf(kv[e]);
        }
      }
      for (int o = UK; o < 32; o <<= 1) {
#pragma unroll
        for (int e = 0; e < VPU; ++e) {
          ksm[e] += __shfl_xor_sync(0xffffffffu, ksm[e], o);
          kab[e] += __shfl_xor_sync(0xffffffffu, kab[e], o);
        }
      }
      float c[G], bd[G];
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float* qg = qs + g * D + ku * VPU;
        c[g] = bd[g] = 0.f;
#pragma unroll
        for (int e = 0; e < VPU; ++e) {
          c[g] = fmaf(qg[e], ksm[e], c[g]);
          bd[g] = fmaf(fabsf(qg[e]), kab[e], bd[g]);
        }
      }
      for (int o = 1; o < UK; o <<= 1) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          c[g] += __shfl_xor_sync(0xffffffffu, c[g], o);
          bd[g] += __shfl_xor_sync(0xffffffffu, bd[g], o);
        }
      }
#pragma unroll
      for (int g = 0; g < G; ++g) {
        c[g] *= a.scale;
        bd[g] *= ascale;
        if (small) {
          if (key / seg == sg) {
            cs[g] = c[g];
            bsg[g] = bd[g];
          }
        } else {
          pc[g] += c[g];
          pb[g] += bd[g];
        }
      }
    }
#pragma unroll
    for (int g = 0; g < G; ++g) {
      if (small) {
        rmax[g] = fmaxf(rmax[g], fabsf(cs[g] - sr[g]));
        bmax[g] = fmaxf(bmax[g], bsg[g]);
      } else {
        psr[g] += sr[g];
      }
    }
    // online softmax over the chunk, lane by key
    float corr[G];
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float mx = valid ? s[g] : NEG_INF;
#pragma unroll
      for (int o = KC / 2; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[g], mx);
      const float p = valid ? expf(s[g] - mn) : 0.f;
      float pl = p, pc_ = p * vsum, pa = p * vabs;
#pragma unroll
      for (int o = KC / 2; o > 0; o >>= 1) {
        pl += __shfl_xor_sync(0xffffffffu, pl, o);
        pc_ += __shfl_xor_sync(0xffffffffu, pc_, o);
        pa += __shfl_xor_sync(0xffffffffu, pa, o);
      }
      corr[g] = expf(m[g] - mn);
      l[g] = fmaf(l[g], corr[g], pl);
      ck[g] = fmaf(ck[g], corr[g], pc_);
      bc[g] = fmaf(bc[g], corr[g], pa);
      m[g] = mn;
      if (half == 0) ps[key * G + g] = p;
    }
    __syncwarp();
    // PV: lanes by V unit, rows t == vr mod RSV
#pragma unroll
    for (int g = 0; g < G; ++g)
#pragma unroll
      for (int e = 0; e < VPU; ++e) acc[g][e] *= corr[g];
    for (int t = vr; t < n; t += RSV) {
      float vv[VPU];
      unit_f32(*reinterpret_cast<const U*>(vb + t * VROW + vu * 16), vv);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float p = ps[t * G + g];
#pragma unroll
        for (int e = 0; e < VPU; ++e) acc[g][e] = fmaf(p, vv[e], acc[g][e]);
      }
    }
    __syncwarp();
  };

  // the warp's chunks, round by round: chunk cb of round r starts at
  // rb + 32 cb, cb = warp, warp + NW, ...
  auto next = [&](int& r, int& cb) {
    int rb, re;
    round_range(r, rb, re);
    if (rb + (cb + NW) * KC < re) {
      cb += NW;
      return;
    }
    for (++r; r < rounds; ++r) {
      round_range(r, rb, re);
      if (rb + warp * KC < re) {
        cb = warp;
        return;
      }
    }
  };
  int r = 0, cb = warp;
  if (rounds > 0) {
    int rb, re;
    round_range(0, rb, re);
    if (rb + warp * KC >= re) next(r, cb);
  } else {
    r = rounds;
  }
  int stage = 0;
  __syncwarp();                    // wblk
  if (r < rounds) {
    int rb, re;
    round_range(r, rb, re);
    issue(rb + cb * KC, min(KC, re - rb - cb * KC), 0);
  }
  hk::cp_async_commit();
  // q (loaded beside the length) while the first chunk is in flight
#pragma unroll
  for (int i = 0; i < 4; ++i)
    if (tid + i * NT < G * D) qs[tid + i * NT] = qreg[i];
  for (int e = tid + 4 * NT; e < G * D; e += NT) qs[e] = qval(e);
  if (tid < 2 * G) lmax[tid] = 0.f;
  __syncthreads();
  const bool two = a.nstage == 2;
  bool first = true;               // the warp's first chunk, in flight
  for (int rr = 0; rr < rounds; ++rr) {
    float pc[G], psr[G], pb[G];      // this warp's block sums (large T)
#pragma unroll
    for (int g = 0; g < G; ++g) pc[g] = psr[g] = pb[g] = 0.f;
    while (r == rr) {
      int rb, re;
      round_range(r, rb, re);
      const int c0 = rb + cb * KC, n = min(KC, re - c0);
      int r2 = r, cb2 = cb;
      next(r2, cb2);
      // two buffers: the next chunk lands in the other one while this one
      // is used; one buffer: this chunk now (the first was issued before
      // the loop).  One call site each keeps the loop's code small.
      const int lr = two ? r2 : r, lcb = two ? cb2 : cb;
      if (lr < rounds && (two || !first)) {
        int lrb, lre;
        round_range(lr, lrb, lre);
        issue(lrb + lcb * KC, min(KC, lre - lrb - lcb * KC),
              two ? stage ^ 1 : 0);
      }
      hk::cp_async_commit();
      if (two)
        hk::cp_async_wait<1>();
      else
        hk::cp_async_wait<0>();
      __syncwarp();
      chunk(c0, n, stage, pc, psr, pb);
      if (two) stage ^= 1;
      first = false;
      r = r2;
      cb = cb2;
    }
    if (!small) {
      // the block's sums over the warps, added before the max is taken
      float* bq = bpart + (rr & 1) * NW * G * 3 + warp * G * 3;
      if (lane == 0) {
#pragma unroll
        for (int g = 0; g < G; ++g) {
          bq[g * 3] = pc[g];
          bq[g * 3 + 1] = psr[g];
          bq[g * 3 + 2] = pb[g];
        }
      }
      __syncthreads();
      if (tid < G) {
        const float* bb = bpart + (rr & 1) * NW * G * 3 + tid * 3;
        float c = 0.f, sr = 0.f, bd = 0.f;
        for (int w = 0; w < NW; ++w) {
          c += bb[w * G * 3];
          sr += bb[w * G * 3 + 1];
          bd += bb[w * G * 3 + 2];
        }
        lmax[tid * 2] = fmaxf(lmax[tid * 2], fabsf(c - sr));
        lmax[tid * 2 + 1] = fmaxf(lmax[tid * 2 + 1], bd);
      }
    }
  }
  hk::cp_async_wait<0>();

  // the warp's state: each lane's share of acc to shared memory (added
  // over vr in the merge), the blocks' check maxima over the segments
  // (lanes of one segment hold the same values)
#pragma unroll
  for (int g = 0; g < G; ++g) {
    float* w = wacc + ((warp * RSV + vr) * G + g) * DV + vu * VPU;
#pragma unroll
    for (int e = 0; e < VPU; e += 4)
      *reinterpret_cast<float4*>(w + e) =
          make_float4(acc[g][e], acc[g][e + 1], acc[g][e + 2], acc[g][e + 3]);
  }
  if (small) {
    for (int o = seg; o < KC; o <<= 1) {
#pragma unroll
      for (int g = 0; g < G; ++g) {
        rmax[g] = fmaxf(rmax[g], __shfl_xor_sync(0xffffffffu, rmax[g], o));
        bmax[g] = fmaxf(bmax[g], __shfl_xor_sync(0xffffffffu, bmax[g], o));
      }
    }
  }
  if (lane == 0) {
#pragma unroll
    for (int g = 0; g < G; ++g) {
      float* o = wst + (warp * G + g) * NSTAT;
      o[0] = m[g]; o[1] = l[g]; o[2] = ck[g]; o[3] = bc[g];
      o[4] = rmax[g]; o[5] = bmax[g];
    }
  }
  __syncthreads();
  merge_states<G>(
      NW, RSV, wst,
      [&](int i, int r, int e) {
        return wacc[(i * RSV + r) * G * DV + e];
      },
      DV, wts, fst, facc, tid);
  if (!small && tid < G) {
    fst[tid * NSTAT + 4] = fmaxf(fst[tid * NSTAT + 4], lmax[tid * 2]);
    fst[tid * NSTAT + 5] = fmaxf(fst[tid * NSTAT + 5], lmax[tid * 2 + 1]);
  }

  if (a.splits > 1) {
    // publish this split's state; the last CTA of (b, h) merges them all
    const int KVY = gridDim.y;      // kv heads x head groups
    const long long slot = ((long long)sp * a.B + b) * KVY + hy;
    float* my = scratch + slot * G * (NSTAT + DV);
    __syncthreads();
    for (int e = tid; e < G * NSTAT; e += NT) my[e] = fst[e];
    for (int e = tid; e < G * DV; e += NT) my[G * NSTAT + e] = facc[e];
    __syncthreads();
    if (tid == 0) {
      __threadfence();              // cumulative: the CTA's stores above
      const int t = atomicAdd(&tickets[b * KVY + hy], 1);
      last = t == a.splits - 1;
      if (last) tickets[b * KVY + hy] = 0;    // ready for the next launch
    }
    __syncthreads();
    if (!last) return;
    __threadfence();
    // every split's stats to shared memory at once (wacc is free now; the
    // wrapper caps splits so that they fit), then acc straight from L2,
    // four splits' loads in flight
    const long long sstride = (long long)a.B * KVY * G * (NSTAT + DV);
    const float* s0 = scratch + ((long long)b * KVY + hy) * G * (NSTAT + DV);
    for (int e = tid; e < a.splits * G * NSTAT; e += NT)
      wacc[e] = __ldcg(s0 + (e / (G * NSTAT)) * sstride + e % (G * NSTAT));
    __syncthreads();
    merge_states<G>(
        a.splits, 1, wacc,
        [&](int i, int, int e) {
          return __ldcg(s0 + i * sstride + G * NSTAT + e);
        },
        DV, wts, fst, facc, tid);
  }
  __syncthreads();

  // o = acc / l; the PV residual |chk - rowsum(acc)| (a warp a head)
  for (int e = tid; e < G * DV; e += NT) {
    const int g = e / DV, d = e - g * DV;
    if (g < ng && d < DVR)
      store_out(&out[(qbase + g) * DVR + d],
                facc[e] / fmaxf(fst[g * NSTAT + 1], 1e-30f));
  }
  for (int g = warp; g < ng; g += NW) {
    float sm = 0.f;
    for (int d = lane; d < DV; d += 32) sm += facc[g * DV + d];
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) sm += __shfl_xor_sync(0xffffffffu, sm, o);
    if (lane == 0) {
      const float* f = fst + g * NSTAT;
      rp[qbase + g] = fabsf(f[2] - sm);
      bp[qbase + g] = f[3];
      rs[qbase + g] = f[4];
      bs[qbase + g] = f[5];
      // the log-sum-exp of the row's scaled scores: -inf where no key was
      // valid (l = 0; the output is 0 there)
      if (lse) lse[qbase + g] = f[1] > 0.f ? f[0] + logf(f[1])
                                  : __int_as_float(0xff800000);
    }
  }
}

template <typename TI, int G>
cudaError_t launch(const void* q, const void* kc, const void* vc,
                   const int* table, const int* lengths, const Args& a,
                   void* out, float* rs, float* bs, float* rp, float* bp,
                   float* scratch, int* tickets, float* lse,
                   cudaStream_t st) {
  const int smem = decode_smem(G, a.DP, a.DVP, sizeof(TI), a.nstage);
  static unsigned long long capped = 0;   // devices, one bit each
  cudaError_t err =
      hk::raise_smem_cap(flash_decode_split<TI, G>, SMEM_CAP, &capped);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B, a.KV * a.NSG, a.splits);
  flash_decode_split<TI, G><<<grid, NT, smem, st>>>(
      (const TI*)q, (const TI*)kc, (const TI*)vc, table, lengths, a,
      (TI*)out, rs, bs, rp, bp, scratch, tickets, lse);
  return cudaGetLastError();
}

template <typename TI>
cudaError_t dispatch(const void* q, const void* kc, const void* vc,
                     const int* table, const int* lengths, const Args& a,
                     void* out, float* rs, float* bs, float* rp, float* bp,
                     float* scratch, int* tickets, float* lse,
                     cudaStream_t st) {
  switch (pow2_at_least(a.HG)) {
    case 1: return launch<TI, 1>(q, kc, vc, table, lengths, a, out, rs, bs,
                                 rp, bp, scratch, tickets, lse, st);
    case 2: return launch<TI, 2>(q, kc, vc, table, lengths, a, out, rs, bs,
                                 rp, bp, scratch, tickets, lse, st);
    case 4: return launch<TI, 4>(q, kc, vc, table, lengths, a, out, rs, bs,
                                 rp, bp, scratch, tickets, lse, st);
    case 8: return launch<TI, 8>(q, kc, vc, table, lengths, a, out, rs, bs,
                                 rp, bp, scratch, tickets, lse, st);
    default: return cudaErrorInvalidValue;
  }
}

bool units_ok(int d, int esz) {     // whole 16-byte units, at most 32
  return d * esz % 16 == 0 && d * esz >= 16 && d * esz <= 512;
}

// The launch's geometry: head groups of at most 8 heads a kv head, the
// group rounded up to an instantiated G (1, 2, 4, 8; the extra heads
// have q = 0 and are not stored), rows padded to 2^i 16-byte units, and
// each warp's chunk buffers double unless two do not fit.
struct Geometry {
  int nsg, hg, gt, dp, dvp, nstage, smem;
};

Geometry geometry(int G, int D, int DV, int esz) {
  Geometry m;
  m.nsg = (G + 7) / 8;
  m.hg = (G + m.nsg - 1) / m.nsg;
  m.gt = pow2_at_least(m.hg);
  m.dp = pow2_at_least(D * esz / 16) * 16 / esz;
  m.dvp = pow2_at_least(DV * esz / 16) * 16 / esz;
  m.nstage = decode_smem(m.gt, m.dp, m.dvp, esz, 2) <= SMEM_CAP ? 2 : 1;
  m.smem = decode_smem(m.gt, m.dp, m.dvp, esz, m.nstage);
  return m;
}

}  // namespace

extern "C" int flash_decode_smem_bytes(int G, int D, int DV, int esz) {
  return geometry(G, D, DV, esz).smem;
}

// The id of the CUDA-graph capture running on `stream`, 0 when none: the
// wrapper keeps one ticket buffer a capture.
extern "C" unsigned long long flash_decode_capture_id(void* stream) {
  cudaStreamCaptureStatus status;
  unsigned long long id = 0;
  if (cudaStreamGetCaptureInfo((cudaStream_t)stream, &status, &id) !=
          cudaSuccess ||
      status != cudaStreamCaptureStatusActive)
    return 0;
  return id;
}

// Floats of scratch a launch with `splits` splits needs (1 when unsplit).
extern "C" long long flash_decode_scratch_floats(int B, int KV, int G, int DV,
                                                 int esz, int splits) {
  const Geometry m = geometry(G, DV, DV, esz);
  return splits > 1
      ? (long long)splits * B * KV * m.nsg * m.gt * (NSTAT + m.dvp) : 1;
}

// dtype: 0 = f32, 1 = bf16.  dense = 1: kc/vc are (B, S, KV, D) caches with
// NB = S and an implicit identity table of W = ceil(S / T) blocks; else
// (NB, T, KV, D) pools with a (B, tstride) int32 table of width W.  splits
// CTAs a (row, kv head), each over `per` blocks; with splits > 1, scratch
// holds flash_decode_scratch_floats floats and tickets B x KV x ceil(G / 8)
// int32 zeros (each launch leaves them zero); splits <= 64.  Any G; D and
// DV rows of whole 16-byte units, at most 512 bytes.  lse, where not null,
// gets each (row, kv head, head) m + log(l) of the merged state: the
// log-sum-exp of its scaled scores over the valid keys, -inf for none.
// Returns cudaGetLastError() after the launch.
extern "C" int flash_decode_launch(
    const void* q, const void* kc, const void* vc, const int* table,
    const int* lengths, void* out, float* rs, float* bs, float* rp,
    float* bp, float* scratch, int* tickets, float* lse, int B, int KV,
    int G, int D,
    int DV, int T, int W, int NB, int dense, int splits, int per,
    long long tstride, float scale, int dtype, void* stream) {
  const int esz = dtype == 1 ? 2 : 4;
  if (G < 1 || !units_ok(D, esz) || !units_ok(DV, esz) || splits < 1 ||
      splits > MAX_SPLITS || per < 1 || (long long)splits * per < W || T < 1)
    return (int)cudaErrorInvalidValue;
  const Geometry m = geometry(G, D, DV, esz);
  if (m.smem > SMEM_CAP) return (int)cudaErrorInvalidValue;
  Args a{B, KV, G, D, DV, m.nsg, m.hg, m.dp, m.dvp, T, W, NB, dense,
         splits, per, m.nstage, tstride, scale};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = dtype == 1
      ? dispatch<__nv_bfloat16>(q, kc, vc, table, lengths, a, out, rs, bs,
                                rp, bp, scratch, tickets, lse, st)
      : dispatch<float>(q, kc, vc, table, lengths, a, out, rs, bs, rp, bp,
                        scratch, tickets, lse, st);
  return (int)err;
}
