// STTR relative-position epipolar attention for Hopper (sm_90a), layout [B, W, E].
//
// Replaces the TPU kernel `_rel_attn_kernel` / `rel_attention`
// (openstereo_tpu/ops/pallas/rel_attention.py), which `rel_attention_trainable`
// also reaches. Per line b, head h (hd = E / nheads channels), query i, key j:
//
//     s[i,j] = q_i.k_j + q_i.ke[W-1-i+j] + k_j.qe[W-1-i+j]
//     s[i,j] = -1e30 for j > i when `masked`;  p = softmax_j(s);  out_i = sum_j p_ij v_j
//     raw[i,j] = sum_h s[i,j]  (f32, only when raw != nullptr)
//
// q and qe arrive scaled by hd^-1/2; ke and qe are the unpadded [2W-1, E] tables.
//
// What bounds it on this card: operations. On the STTR main path (W = 320,
// E = 128, 8 heads) a line does 8*W^2*E = 105 MFLOP on 0.33 MB of bf16 q, k,
// v and out, about 320 flops per byte, above the ~295 where the tensor cores
// are the limit; and W^2 * nheads exponentials.
//
// bf16, the main path: all four products on the tensor cores (mma.sync
// m16n8k16, bf16 operands, f32 sums). A block owns one line and TQ = 64 query
// rows (four warps of 16 rows), loops over the heads and, inside a head, over
// key tiles of JC = 64 keys. Per key tile it has k, v and the TQ+JC-1 rows of
// ke and qe the tile touches (table row W-1-i+j sits at window row
// TQ-1-il+jl). The two relative terms are dense products against a window,
// sheared through shared memory: warp w computes P2 = Q_w . KE[48-16w, +80)^T
// for its 16 queries and P3 = K_w . QE[16w, +80)^T for its 16 keys (1.25x
// the work the scores need) and stores both in f32; after a barrier, score
// (il, jl) adds P2[il][15 - il%16 + jl] and P3[jl][63 - il + jl%16]: the
// shear is the read address (row stride 88 floats: conflict-free float2
// stores, 2-way skewed reads). p is exp(s - m) / l with the row's exact max
// m and sum l, rounded to bf16 as the A operand of p.v, where the TPU kernel
// rounds it. A masked launch skips the key tiles wholly above the diagonal;
// the raw sum (template flag RAW) is a [TQ, W] f32 tile in shared memory,
// written once per block, its masked entries nheads * -1e30.
//  - `tc::rel_attn_stash`, for hd <= 32 and W <= 320 (the STTR main path):
//    one pass. The warp's 16 x W scores stay in registers (W/2 floats a
//    thread); after the last tile one reduction gives m, and the exponentials
//    and their sum follow for all tiles at once, with independent partial
//    sums: the per-tile online softmax left the kernel latency-bound. The
//    next tile's k, v and table chunk arrive by cp.async while the current
//    tile is scored; the line's table windows and v stay in shared memory.
//  - `tc::rel_attn_tc`, for any other W or hd: two passes. Pass 0 finds m and
//    l online over the tiles (and adds raw); pass 1 computes the scores again
//    and takes p . v. No score row is kept, so without raw W is unbounded;
//    the raw tile alone bounds it.

// f32, for the agreement checks with TF32 off and not on the bf16 main path:
// `simt::rel_attn_kernel`, the first CUDA-core version. A block owns a line
// and 32 query rows, stages k and the 95 table rows of each 64-key chunk as
// f32, scores with scalar FMAs, and keeps a 32 x W f32 score tile (and the raw
// sum) in shared memory for the softmax and p.v, which bounds its W.

#include <cmath>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace simt {

constexpr int TQ = 32;            // query rows per block
constexpr int JC = 64;            // keys per staged chunk
constexpr int NT = 256;           // threads per block
constexpr int RT = TQ + JC - 1;   // table rows one chunk touches
constexpr float MASK_VALUE = -1e30f;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__host__ __device__ constexpr int smem_floats(int hd, int sw, bool raw) {
  return (TQ + JC + 2 * RT) * (hd + 1) + TQ * sw * (raw ? 2 : 1);
}

// rows [r0, r0+n) of a [rows, E] matrix, channels [c0, c0+HD), into dst[n][HD+1] as
// f32; rows outside [0, rows) are staged as 0
template <typename T, int HD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src, int r0, int n,
                                      int rows, int E, int c0) {
  for (int idx = threadIdx.x; idx < n * HD; idx += NT) {
    const int r = idx / HD, c = idx % HD, gr = r0 + r;
    dst[r * (HD + 1) + c] = (gr >= 0 && gr < rows) ? to_f(src[(size_t)gr * E + c0 + c]) : 0.f;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(NT)
rel_attn_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                const T* __restrict__ ke, const T* __restrict__ qe, T* __restrict__ out,
                float* __restrict__ raw, int W, int E, int nheads, int masked, int sw) {
  constexpr int HP = HD + 1;
  constexpr int IG = NT / JC;         // query rows scored at once (threads per key: IG)
  constexpr int PR = NT / HD;         // query rows per p.v pass
  constexpr int OPT = TQ / PR;        // outputs per thread in p.v
  static_assert(TQ % IG == 0 && NT % HD == 0 && TQ % PR == 0, "tile shape");

  extern __shared__ float sm[];
  float* qs = sm;                     // [TQ][HP]
  float* ks = qs + TQ * HP;           // [JC][HP]: k chunk, then v chunk
  float* kes = ks + JC * HP;          // [RT][HP]
  float* qes = kes + RT * HP;         // [RT][HP]
  float* S = qes + RT * HP;           // [TQ][sw] scores, then probabilities
  float* R = S + TQ * sw;             // [TQ][sw] head-summed scores (raw only)

  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int i0 = blockIdx.x * TQ;
  const int nq = min(TQ, W - i0);
  const int nrows = 2 * W - 1;
  const T* ql = q + (size_t)b * W * E;
  const T* kl = k + (size_t)b * W * E;
  const T* vl = v + (size_t)b * W * E;

  for (int h = 0; h < nheads; ++h) {
    const int c0 = h * HD;
    stage<T, HD>(qs, ql, i0, TQ, W, E, c0);

    // scores: thread (ig, jl) takes key j0+jl and query rows ig, ig+IG, ...
    const int jl = t % JC, ig = t / JC;
    for (int j0 = 0; j0 < W; j0 += JC) {
      __syncthreads();  // earlier readers of ks / S are done; qs is staged
      stage<T, HD>(ks, kl, j0, JC, W, E, c0);
      const int rbase = W - i0 - TQ + j0;  // table row of local row 0
      stage<T, HD>(kes, ke, rbase, RT, nrows, E, c0);
      stage<T, HD>(qes, qe, rbase, RT, nrows, E, c0);
      __syncthreads();
      const int j = j0 + jl;
      float kr[HD];
#pragma unroll
      for (int c = 0; c < HD; ++c) kr[c] = ks[jl * HP + c];
#pragma unroll 2
      for (int m = 0; m < TQ / IG; ++m) {
        const int i = ig + IG * m;
        const float* qrow = qs + i * HP;
        const int rl = TQ - 1 - i + jl;
        const float* kerow = kes + rl * HP;
        const float* qerow = qes + rl * HP;
        float s = 0.f;
#pragma unroll
        for (int c = 0; c < HD; ++c) s += qrow[c] * (kr[c] + kerow[c]) + kr[c] * qerow[c];
        if (masked && j > i0 + i) s = MASK_VALUE;
        if (i < nq && j < W) {
          S[i * sw + j] = s;
          if (raw) R[i * sw + j] = (h == 0) ? s : R[i * sw + j] + s;
        }
      }
    }
    __syncthreads();

    // softmax over j < W, one warp per row
    const int lane = t % 32, warp = t / 32;
    for (int i = warp; i < nq; i += NT / 32) {
      float* row = S + i * sw;
      float mx = -INFINITY;
      for (int j = lane; j < W; j += 32) mx = fmaxf(mx, row[j]);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      float sum = 0.f;
      for (int j = lane; j < W; j += 32) {
        const float e = __expf(row[j] - mx);
        row[j] = e;
        sum += e;
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float inv = 1.f / sum;
      for (int j = lane; j < W; j += 32) row[j] *= inv;
    }

    // out = p.v: thread (pi, c) takes channel c of rows pi, pi+PR, ...
    const int c = t % HD, pi = t / HD;
    float acc[OPT];
#pragma unroll
    for (int m = 0; m < OPT; ++m) acc[m] = 0.f;
    for (int j0 = 0; j0 < W; j0 += JC) {
      __syncthreads();  // softmax done / previous v chunk read
      stage<T, HD>(ks, vl, j0, JC, W, E, c0);
      __syncthreads();
      const int jn = min(JC, W - j0);
      for (int jj = 0; jj < jn; ++jj) {
        const float vv = ks[jj * HP + c];
#pragma unroll
        for (int m = 0; m < OPT; ++m) acc[m] += S[(pi + PR * m) * sw + j0 + jj] * vv;
      }
    }
#pragma unroll
    for (int m = 0; m < OPT; ++m) {
      const int i = pi + PR * m;
      if (i < nq) out[((size_t)b * W + i0 + i) * E + c0 + c] = from_f<T>(acc[m]);
    }
  }

  if (raw) {
    __syncthreads();
    for (int idx = t; idx < nq * W; idx += NT) {
      const int i = idx / W, j = idx % W;
      raw[((size_t)b * W + i0 + i) * W + j] = R[i * sw + j];
    }
  }
}


template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* ke,
                      const void* qe, void* out, float* raw, int B, int W, int E, int nheads,
                      int masked, cudaStream_t stream) {
  const int sw = W | 1;  // odd row stride: rows of S start in different banks
  const size_t bytes = sizeof(float) * (size_t)smem_floats(HD, sw, raw != nullptr);
  auto kernel = rel_attn_kernel<float, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TQ - 1) / TQ, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const float*>(ke), static_cast<const float*>(qe), static_cast<float*>(out), raw,
      W, E, nheads, masked, sw);
  return cudaGetLastError();
}

}  // namespace simt

namespace tc {

constexpr int TQ = 64;             // query rows per block: 4 warps x 16
constexpr int JC = 64;             // keys per tile
constexpr int NT = 128;            // threads per block
constexpr int TR = TQ + JC;        // table rows staged per tile (TQ + JC - 1 used)
constexpr int WIN = 80;            // window columns of P2 / P3 per warp (79 used)
constexpr int SP = 88;             // row stride (floats) of P2 / P3
constexpr int NS = JC / 8;         // n8 tiles of a warp's 16 x 64 score tile
constexpr int STASH = 5;           // key tiles the one-pass kernel keeps in registers
constexpr float MASK_VALUE = -1e30f;
constexpr float L2E = 1.4426950408889634f;  // exp(x) = exp2(x * L2E)

__host__ __device__ constexpr int kpad(int hd) { return hd < 16 ? 16 : hd; }
__host__ __device__ constexpr int raw_stride(int w) { return (w + 31) / 32 * 32 + 4; }

// 2^x by the special-function unit (ex2.approx, relative error ~2^-22), 0 for -inf
__device__ __forceinline__ float exp2_fast(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

constexpr size_t SMEM_LIMIT = 232448;  // bytes of shared memory a block may use

// dynamic shared memory (bytes): bf16 tiles, then P2 [TQ][SP] | P3 [JC][SP] | raw sum
// [TQ][raw_stride(W)] (f32, raw only). Two-pass: Q, K [64][LD] | KE, QE [TR][LD] |
// V [64][LD]; one-pass: Q [64][LD] | K [2][64][LD] | KE, QE [(STASH+1) 64][LD] |
// V [STASH 64][LD].
__host__ __device__ constexpr size_t smem_bytes(int hd, int w, bool raw, bool one) {
  return 2 * (one ? (size_t)(TQ + 2 * JC + (3 * STASH + 2) * JC) * (kpad(hd) + 8)
                  : (size_t)(TQ + 2 * JC + 2 * TR) * (kpad(hd) + 8)) +
         4 * ((size_t)(TQ + JC) * SP + (raw ? (size_t)TQ * raw_stride(w) : 0));
}

// whether the one-pass kernel takes (hd, W, raw): its scores fit the registers
// and its tiles the shared memory
__host__ __device__ constexpr bool one_pass(int hd, int w, bool raw) {
  return hd <= 32 && w <= STASH * JC && smem_bytes(hd, w, raw, true) <= SMEM_LIMIT;
}

struct Smem {
  __nv_bfloat16 *qs, *ks, *kes, *qes, *vs;
  float *p2, *p3, *rs;
};

template <int HD>
__device__ __forceinline__ Smem carve(uint4* base) {
  constexpr int LD = kpad(HD) + 8;
  Smem s;
  s.qs = reinterpret_cast<__nv_bfloat16*>(base);
  s.ks = s.qs + TQ * LD;
  s.kes = s.ks + JC * LD;
  s.qes = s.kes + TR * LD;
  s.vs = s.qes + TR * LD;
  s.p2 = reinterpret_cast<float*>(s.vs + JC * LD);
  s.p3 = s.p2 + TQ * SP;
  s.rs = s.p3 + JC * SP;
  return s;
}

// rows [r0, r0 + n) of a [rows, E] bf16 matrix, channels [c0, c0 + HD), into
// dst[n][LD] by 16-byte copies; rows outside [0, rows) and columns [HD, KP) are 0
template <int HD>
__device__ __forceinline__ void stage_rows(__nv_bfloat16* dst, const __nv_bfloat16* src, int r0,
                                           int n, int rows, int E, int c0) {
  constexpr int LD = kpad(HD) + 8, V = kpad(HD) / 8;  // 16-byte vectors per row
  for (int idx = threadIdx.x; idx < n * V; idx += NT) {
    const int r = idx / V, c = idx % V * 8, gr = r0 + r;
    uint4 val = make_uint4(0, 0, 0, 0);
    if (c < HD && gr >= 0 && gr < rows)
      val = *reinterpret_cast<const uint4*>(src + (size_t)gr * E + c0 + c);
    *reinterpret_cast<uint4*>(dst + r * LD + c) = val;
  }
}

// stage key tile j0: k, the table windows (row W-1-i+j at window row TQ-1-il+jl)
// and, with_v, v; keys beyond W are 0
template <int HD>
__device__ __forceinline__ void stage_tile(const Smem& sm, const __nv_bfloat16* kl,
                                           const __nv_bfloat16* vl, const __nv_bfloat16* ke,
                                           const __nv_bfloat16* qe, int j0, int i0, int W, int E,
                                           int c0, bool with_v) {
  stage_rows<HD>(sm.ks, kl, j0, JC, W, E, c0);
  const int rbase = W - i0 - TQ + j0;
  stage_rows<HD>(sm.kes, ke, rbase, TR, 2 * W - 1, E, c0);
  stage_rows<HD>(sm.qes, qe, rbase, TR, 2 * W - 1, E, c0);
  if (with_v) stage_rows<HD>(sm.vs, vl, j0, JC, W, E, c0);
}

// The warp's 16 x 64 scores of the staged key tile j0 (all threads call it:
// it holds a barrier). S1 = Q_w . K^T stays in registers; P2 = Q_w . KE[48 -
// 16w, +80)^T and P3 = K_w . QE[16w, +80)^T go through shared memory, and
// score (il, jl) adds P2[il][15 - il%16 + jl] and P3[jl][63 - il + jl%16]: the
// shear is the read address. EDGE tiles (keys beyond W, or the diagonal of a
// masked launch) also set -1e30 above the diagonal and -inf beyond W. With
// RAW, the scores are summed over the heads into sm.rs (h == 0 stores).
template <int HD, bool RAW, bool EDGE, class Tab>
__device__ __forceinline__ void scores(float (&s)[NS][4], const Smem& sm, const Tab& tab, int j0,
                                       int i0, int W, int masked, int h) {
  constexpr int KS = kpad(HD) / 16, LD = kpad(HD) + 8;
  const int lane = threadIdx.x % 32, r16 = threadIdx.x / 32 * 16, g = lane / 4, t = lane % 4;
  uint32_t qa[KS][4], ka[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
    mma::ldsm_a(qa[kk], sm.qs, LD, r16, 16 * kk, lane);
    mma::ldsm_a(ka[kk], sm.ks, LD, r16, 16 * kk, lane);
  }
  // window rows of this lane's ldmatrix addresses: P2 from TQ - 16 - r16, P3 from r16
  const int rl = lane % 8 + 8 * (lane / 16), cl = 8 * (lane / 8 % 2);
#pragma unroll
  for (int n = 0; n < NS; n += 2) {
    s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    s[n + 1][0] = s[n + 1][1] = s[n + 1][2] = s[n + 1][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b[4];
      mma::ldsm_b2(b, sm.ks, LD, 8 * n, 16 * kk, lane);
      mma::bf16_16816(s[n], qa[kk], b[0], b[1]);
      mma::bf16_16816(s[n + 1], qa[kk], b[2], b[3]);
    }
  }
#pragma unroll
  for (int nb = 0; nb < WIN / 8; nb += 2) {
    float a2[2][4] = {}, a3[2][4] = {};
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t b2[4], b3[4];
      mma::ldsm_x4(b2, tab.ke(TQ - 16 - r16 + 8 * nb + rl) + 16 * kk + cl);
      mma::ldsm_x4(b3, tab.qe(r16 + 8 * nb + rl) + 16 * kk + cl);
      mma::bf16_16816(a2[0], qa[kk], b2[0], b2[1]);
      mma::bf16_16816(a2[1], qa[kk], b2[2], b2[3]);
      mma::bf16_16816(a3[0], ka[kk], b3[0], b3[1]);
      mma::bf16_16816(a3[1], ka[kk], b3[2], b3[3]);
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      float* d2 = sm.p2 + (r16 + g) * SP + 8 * (nb + u) + 2 * t;
      float* d3 = sm.p3 + (r16 + g) * SP + 8 * (nb + u) + 2 * t;
      *reinterpret_cast<float2*>(d2) = make_float2(a2[u][0], a2[u][1]);
      *reinterpret_cast<float2*>(d2 + 8 * SP) = make_float2(a2[u][2], a2[u][3]);
      *reinterpret_cast<float2*>(d3) = make_float2(a3[u][0], a3[u][1]);
      *reinterpret_cast<float2*>(d3 + 8 * SP) = make_float2(a3[u][2], a3[u][3]);
    }
  }
  __syncthreads();  // P3's rows come from every warp
  const float* p2r = sm.p2 + (r16 + g) * SP + 15 - g + 2 * t;     // (ir = g, jl = 2t)
  const float* p3r = sm.p3 + 2 * t * SP + 63 - r16 - g + 2 * t;   // (il = r16 + g, jl = 2t)
#pragma unroll
  for (int n = 0; n < NS; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int hi = e / 2, lo = e & 1;  // row g + 8 hi, key 8n + 2t + lo
      float val = s[n][e] + p2r[hi * 8 * (SP - 1) + 8 * n + lo] +
                  p3r[(8 * n + lo) * SP - 8 * hi + (8 * n) % 16 + lo];
      if (EDGE) {
        const int il = r16 + g + 8 * hi, j = j0 + 8 * n + 2 * t + lo;
        if (masked && j > i0 + il) val = MASK_VALUE;
        if (RAW && j < W) {
          float* r = sm.rs + il * raw_stride(W) + j;
          *r = h == 0 ? val : *r + val;
        }
        if (j >= W) val = -INFINITY;
      } else if (RAW) {
        float* r = sm.rs + (r16 + g + 8 * hi) * raw_stride(W) + j0 + 8 * n + 2 * t + lo;
        *r = h == 0 ? val : *r + val;
      }
      s[n][e] = val;
    }
  }
}

// scores of the key tile at j0 with the EDGE variant where it is needed
template <int HD, bool RAW, class Tab>
__device__ __forceinline__ void tile_scores(float (&s)[NS][4], const Smem& sm, const Tab& tab,
                                            int j0, int i0, int W, int masked, int h) {
  if (j0 + JC > W || (masked && j0 + JC - 1 > i0))
    scores<HD, RAW, true>(s, sm, tab, j0, i0, W, masked, h);
  else
    scores<HD, RAW, false>(s, sm, tab, j0, i0, W, masked, h);
}

// table windows staged in order: window row r at kes / qes + r * LD
template <int HD>
struct LinearTab {
  const __nv_bfloat16 *kes, *qes;
  __device__ const __nv_bfloat16* ke(int r) const { return kes + r * (kpad(HD) + 8); }
  __device__ const __nv_bfloat16* qe(int r) const { return qes + r * (kpad(HD) + 8); }
};


// the row maxima (rows g and g + 8) of a score tile, over the quad
__device__ __forceinline__ void row_max(float (&mt)[2], const float (&s)[NS][4]) {
  mt[0] = mt[1] = -INFINITY;
#pragma unroll
  for (int n = 0; n < NS; ++n) {
    mt[0] = fmaxf(mt[0], fmaxf(s[n][0], s[n][1]));
    mt[1] = fmaxf(mt[1], fmaxf(s[n][2], s[n][3]));
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
    mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
  }
}

// o += p . v for one key tile: p (f32, rows g and g + 8) rounded to bf16 as the A
// operand; v stored [key][ld] from key0, its B fragments by ldmatrix.trans
template <int HD>
__device__ __forceinline__ void pv(float (&o)[HD / 8][4], const float (&p)[NS][4],
                                        const __nv_bfloat16* vs, int ld, int key0, int lane) {
#pragma unroll
  for (int kk = 0; kk < JC / 16; ++kk) {
    const uint32_t pa[4] = {mma::pack(p[2 * kk][0], p[2 * kk][1]),
                            mma::pack(p[2 * kk][2], p[2 * kk][3]),
                            mma::pack(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            mma::pack(p[2 * kk + 1][2], p[2 * kk + 1][3])};
    if (HD == 8) {
      uint32_t b[2];
      mma::ldsm_bt1(b, vs, ld, key0 + 16 * kk, 0, lane);
      mma::bf16_16816(o[0], pa, b[0], b[1]);
    } else {
#pragma unroll
      for (int n = 0; n < HD / 8; n += 2) {
        uint32_t b[4];
        mma::ldsm_bt2(b, vs, ld, key0 + 16 * kk, 8 * n, lane);
        mma::bf16_16816(o[n], pa, b[0], b[1]);
        mma::bf16_16816(o[n + 1], pa, b[2], b[3]);
      }
    }
  }
}

// out rows of the warp: o (rows g and g + 8) as bf16 pairs
template <int HD>
__device__ __forceinline__ void store_out(__nv_bfloat16* out, const float (&o)[HD / 8][4], int b,
                                          int i0, int nq, int W, int E, int c0) {
  const int lane = threadIdx.x % 32, r16 = threadIdx.x / 32 * 16, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int il = r16 + g + 8 * r;
    if (il >= nq) continue;
    __nv_bfloat16* dst = out + ((size_t)b * W + i0 + il) * E + c0 + 2 * t;
#pragma unroll
    for (int n = 0; n < HD / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * n) =
          __floats2bfloat162_rn(o[n][2 * r], o[n][2 * r + 1]);
  }
}

// the raw sum of the block's rows, masked entries nheads * -1e30
__device__ __forceinline__ void store_raw(float* raw, const float* rs, int b, int i0, int nq,
                                          int W, int nheads, int masked) {
  const float masked_sum = nheads * MASK_VALUE;
  for (int idx = threadIdx.x; idx < nq * W; idx += NT) {
    const int il = idx / W, j = idx % W;
    raw[((size_t)b * W + i0 + il) * W + j] =
        masked && j > i0 + il ? masked_sum : rs[il * raw_stride(W) + j];
  }
}

// One pass, for W <= STASH * JC and hd <= 32 (where its shared memory fits):
// per head, each key tile's scores stay in registers (the warp's 16 x W scores,
// W / 2 floats a thread) with a lane-local running max; after the last tile,
// one reduction gives each row's max m, the exponentials exp(s - m) and their
// sum l follow for all tiles at once, and p = exp(s - m) / l is rounded to
// bf16 for p . v. The staging is asynchronous (cp.async): while tile kt is
// scored, k of tile kt + 1 (two slots), the next 64-row chunk of each table
// window and v of tile kt + 1 are in flight. The table windows (rows W-1-i+j
// for the block's 64 queries, chunk c at rows [64c, 64c + 64)) and v ([W][LD],
// read by p . v through ldmatrix.trans) are kept for the whole line.
template <int HD, bool RAW>
__global__ void __launch_bounds__(NT, 2)
rel_attn_stash(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ ke,
               const __nv_bfloat16* __restrict__ qe, __nv_bfloat16* __restrict__ out,
               float* __restrict__ raw, int W, int E, int nheads, int masked) {
  constexpr int LD = kpad(HD) + 8, VEC = kpad(HD) / 8;  // 16-byte vectors per row
  constexpr int PER = JC * VEC / NT;                       // vectors a thread copies per 64 rows
  static_assert(JC * VEC % NT == 0, "copy split");
  extern __shared__ uint4 smem[];
  // Q [TQ][LD] | K [2][JC][LD] | KE, QE [(STASH+1) JC][LD] | V [STASH JC][LD] | P2, P3 | raw
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* ks = qs + TQ * LD;
  __nv_bfloat16* kes = ks + 2 * JC * LD;
  __nv_bfloat16* qes = kes + (STASH + 1) * JC * LD;
  __nv_bfloat16* vs = qes + (STASH + 1) * JC * LD;
  Smem sm;
  sm.qs = qs;
  sm.p2 = reinterpret_cast<float*>(vs + STASH * JC * LD);
  sm.p3 = sm.p2 + TQ * SP;
  sm.rs = sm.p3 + JC * SP;
  const int lane = threadIdx.x % 32, b = blockIdx.y, i0 = blockIdx.x * TQ;
  const int nq = min(TQ, W - i0), rb0 = W - i0 - TQ, nrows = 2 * W - 1;
  const int ntiles = masked ? (i0 + nq - 1) / JC + 1 : (W + JC - 1) / JC;
  // this thread's rows and columns of every 64-row copy
  int cr[PER], cc[PER];
#pragma unroll
  for (int u = 0; u < PER; ++u) {
    cr[u] = (threadIdx.x + NT * u) / VEC;
    cc[u] = (threadIdx.x + NT * u) % VEC * 8;
  }
  // rows [r0, r0 + 64) of a [rows, E] matrix from channel c0 to dst[64][LD], 0 outside
  auto fetch64 = [&](__nv_bfloat16* dst, const __nv_bfloat16* src, int r0, int rows) {
#pragma unroll
    for (int u = 0; u < PER; ++u) {
      const int gr = r0 + cr[u];
      const bool ok = cc[u] < HD && gr >= 0 && gr < rows;
      mma::cp16(dst + cr[u] * LD + cc[u], src + (ok ? (ptrdiff_t)gr * E + cc[u] : 0), ok);
    }
  };

  for (int h = 0; h < nheads; ++h) {
    const int c0 = h * HD;
    const __nv_bfloat16* ql = q + (size_t)b * W * E + c0;
    const __nv_bfloat16* kl = k + (size_t)b * W * E + c0;
    const __nv_bfloat16* vl = v + (size_t)b * W * E + c0;
    __syncthreads();  // the previous head is done with every buffer
    fetch64(qs, ql, i0, W);
    fetch64(kes, ke + c0, rb0, nrows);  // table chunk 0
    fetch64(qes, qe + c0, rb0, nrows);
    // k, v of tile kt and table chunk kt + 1
    auto fetch_tile = [&](int kt) {
      fetch64(ks + kt % 2 * JC * LD, kl, kt * JC, W);
      fetch64(vs + kt * JC * LD, vl, kt * JC, W);
      fetch64(kes + (kt + 1) * JC * LD, ke + c0, rb0 + (kt + 1) * JC, nrows);
      fetch64(qes + (kt + 1) * JC * LD, qe + c0, rb0 + (kt + 1) * JC, nrows);
      mma::cp_commit();
    };
    fetch_tile(0);
    float s[STASH][NS][4];
    float mx[2][2] = {{-INFINITY, -INFINITY}, {-INFINITY, -INFINITY}};  // rows g, g + 8
#pragma unroll
    for (int kt = 0; kt < STASH; ++kt) {
      if (kt >= ntiles) break;
      // tile kt + 1 reuses the k slot of tile kt - 1, which every warp finished
      // reading before the barrier inside scores of tile kt - 1
      if (kt + 1 < ntiles) {
        fetch_tile(kt + 1);
        mma::cp_wait<1>();
      } else {
        mma::cp_wait<0>();
      }
      __syncthreads();  // tile kt has landed; P2 / P3 of tile kt - 1 are read
      sm.ks = ks + kt % 2 * JC * LD;
      tile_scores<HD, RAW>(s[kt], sm, LinearTab<HD>{kes + kt * JC * LD, qes + kt * JC * LD},
                           kt * JC, i0, W, masked, h);
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        mx[n % 2][0] = fmaxf(mx[n % 2][0], fmaxf(s[kt][n][0], s[kt][n][1]));
        mx[n % 2][1] = fmaxf(mx[n % 2][1], fmaxf(s[kt][n][2], s[kt][n][3]));
      }
    }
    // m: the row max over the quad (finite: key 0 is in tile 0, never masked)
    float m[2], l[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      m[r] = fmaxf(mx[0][r], mx[1][r]);
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 1));
      m[r] = fmaxf(m[r], __shfl_xor_sync(0xffffffffu, m[r], 2));
    }
    const float ms[2] = {-m[0] * L2E, -m[1] * L2E};
#pragma unroll
    for (int kt = 0; kt < STASH; ++kt) {
      if (kt >= ntiles) break;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          s[kt][n][u] = exp2_fast(fmaf(s[kt][n][u], L2E, ms[u / 2]));
          l[n % 2][u / 2] += s[kt][n][u];
        }
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {  // a row's l is spread over the 4 lanes of its quad
      float lr = l[0][r] + l[1][r];
      lr += __shfl_xor_sync(0xffffffffu, lr, 1);
      lr += __shfl_xor_sync(0xffffffffu, lr, 2);
      inv[r] = 1.f / lr;
    }
    float o[HD / 8][4] = {};
#pragma unroll
    for (int kt = 0; kt < STASH; ++kt) {
      if (kt >= ntiles) break;
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) s[kt][n][u] *= inv[u / 2];
      pv<HD>(o, s[kt], vs, LD, kt * JC, lane);
    }
    store_out<HD>(out, o, b, i0, nq, W, E, c0);
  }
  if (RAW) {
    __syncthreads();
    store_raw(raw, sm.rs, b, i0, nq, W, nheads, masked);
  }
}

// Two passes, for any W: per head, pass 0 finds each row's max m and sum l over
// the key tiles (and adds raw); pass 1 computes the same scores again and takes
// p = exp(s - m) / l, rounded to bf16, into p . v.
template <int HD, bool RAW>
__global__ void __launch_bounds__(NT)
rel_attn_tc(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
            const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ ke,
            const __nv_bfloat16* __restrict__ qe, __nv_bfloat16* __restrict__ out,
            float* __restrict__ raw, int W, int E, int nheads, int masked) {
  extern __shared__ uint4 smem[];
  const Smem sm = carve<HD>(smem);
  const int lane = threadIdx.x % 32, b = blockIdx.y, i0 = blockIdx.x * TQ;
  const int nq = min(TQ, W - i0);
  const int ntiles = masked ? (i0 + nq - 1) / JC + 1 : (W + JC - 1) / JC;
  const __nv_bfloat16* kl = k + (size_t)b * W * E;
  const __nv_bfloat16* vl = v + (size_t)b * W * E;

  for (int h = 0; h < nheads; ++h) {
    const int c0 = h * HD;
    __syncthreads();  // the previous head is done with qs
    stage_rows<HD>(sm.qs, q + (size_t)b * W * E, i0, TQ, W, E, c0);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // rows g and g + 8
    float o[HD / 8][4] = {};
    for (int kt = 0; kt < ntiles; ++kt) {  // pass 0
      __syncthreads();  // readers of ks, kes, qes, p2, p3 are done
      stage_tile<HD>(sm, kl, vl, ke, qe, kt * JC, i0, W, E, c0, false);
      __syncthreads();
      float s[NS][4], mt[2];
      tile_scores<HD, RAW>(s, sm, LinearTab<HD>{sm.kes, sm.qes}, kt * JC, i0, W, masked, h);
      row_max(mt, s);
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float mn = fmaxf(m[r], mt[r]);  // finite: key 0 is in tile 0, never masked
        l[r] *= exp2_fast((m[r] - mn) * L2E);
        m[r] = mn;
      }
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u) l[u / 2] += exp2_fast(fmaf(s[n][u], L2E, -m[u / 2] * L2E));
    }
    float inv[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      inv[r] = 1.f / l[r];
    }
    for (int kt = 0; kt < ntiles; ++kt) {  // pass 1
      __syncthreads();  // readers of ks, kes, qes, vs, p2, p3 are done
      stage_tile<HD>(sm, kl, vl, ke, qe, kt * JC, i0, W, E, c0, true);
      __syncthreads();
      float s[NS][4];
      tile_scores<HD, false>(s, sm, LinearTab<HD>{sm.kes, sm.qes}, kt * JC, i0, W, masked, h);
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int u = 0; u < 4; ++u)
          s[n][u] = exp2_fast(fmaf(s[n][u], L2E, -m[u / 2] * L2E)) * inv[u / 2];
      pv<HD>(o, s, sm.vs, kpad(HD) + 8, 0, lane);
    }
    store_out<HD>(out, o, b, i0, nq, W, E, c0);
  }
  if (RAW) {
    __syncthreads();
    store_raw(raw, sm.rs, b, i0, nq, W, nheads, masked);
  }
}

template <int HD, bool RAW>
cudaError_t launch_raw(const void* q, const void* k, const void* v, const void* ke,
                       const void* qe, void* out, float* raw, int B, int W, int E, int nheads,
                       int masked, cudaStream_t stream) {
  using bf = __nv_bfloat16;
  // one pass where the line's key tiles fit the registers, else two
  auto kernel = rel_attn_tc<HD, RAW>;
  const bool one = one_pass(HD, W, RAW);
  if constexpr (HD <= 32)
    if (one) kernel = rel_attn_stash<HD, RAW>;
  const size_t bytes = smem_bytes(HD, W, RAW, one);
  if (bytes > SMEM_LIMIT) return cudaErrorInvalidValue;  // the raw tile of a W this wide
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TQ - 1) / TQ, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const bf*>(q), static_cast<const bf*>(k), static_cast<const bf*>(v),
      static_cast<const bf*>(ke), static_cast<const bf*>(qe), static_cast<bf*>(out), raw, W, E,
      nheads, masked);
  return cudaGetLastError();
}

template <int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* ke,
                      const void* qe, void* out, float* raw, int B, int W, int E, int nheads,
                      int masked, cudaStream_t s) {
  if (raw) return launch_raw<HD, true>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
  return launch_raw<HD, false>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
}

}  // namespace tc

namespace {

// the kernel of `dtype` (0 = float32: simt, 1 = bfloat16: tc) at head width hd
template <int HD>
cudaError_t launch_dtype(const void* q, const void* k, const void* v, const void* ke,
                         const void* qe, void* out, float* raw, int B, int W, int E, int nheads,
                         int masked, int dtype, cudaStream_t s) {
  if (dtype == 0) return simt::launch_hd<HD>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
  if (dtype == 1) return tc::launch_hd<HD>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: contiguous [B, W, E]; ke, qe:
// contiguous [2W-1, E]; raw: contiguous [B, W, W] f32, or null to skip it.
// bf16 pointers are 16-byte aligned. Returns cudaErrorInvalidValue, launching
// nothing, for a shape the kernels do not take: a head width other than 8, 16,
// 32, 64, B > 65535, or a W whose tiles exceed a block's shared memory (f32:
// the [32, W] score tile; bf16: the [64, W] raw tile, so only with raw).
extern "C" cudaError_t rel_attention_launch(const void* q, const void* k, const void* v,
                                            const void* ke, const void* qe, void* out,
                                            void* raw, int B, int W, int E, int nheads,
                                            int masked, int dtype, void* stream) {
  if (B <= 0 || W <= 0 || nheads <= 0 || E % nheads != 0 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(raw);
  switch (E / nheads) {
    case 8: return launch_dtype<8>(q, k, v, ke, qe, out, r, B, W, E, nheads, masked, dtype, s);
    case 16: return launch_dtype<16>(q, k, v, ke, qe, out, r, B, W, E, nheads, masked, dtype, s);
    case 32: return launch_dtype<32>(q, k, v, ke, qe, out, r, B, W, E, nheads, masked, dtype, s);
    case 64: return launch_dtype<64>(q, k, v, ke, qe, out, r, B, W, E, nheads, masked, dtype, s);
    default: return cudaErrorInvalidValue;
  }
}
