// Fused inference MBConv for Hopper (sm_90a): pw-expand -> dw3x3 -> pw-linear,
// stride 1, BatchNorms folded into weights and biases. x and out are NCHW.
//
// Replaces the TPU kernel `_mbconv_kernel` / `fused_mbconv`
// (openstereo_tpu/ops/pallas/fused_mbconv.py). Per output pixel:
//
//     h = relu6(x . W1 + b1), zeroed outside the image   (Cin -> Ch)
//     d = relu6(dw3x3(h) + b2)                            (Ch, depthwise)
//     y = d . W2 + b3 (+ x when residual)                 (Ch -> Cout)
//
// h and d are rounded to x's dtype before the next product, as in the TPU
// kernel; every sum is f32. Weights arrive in the JAX kernel's layouts: W1
// [Cin,Ch], dw [9,Ch] (tap 3*di+dj), W2 [Ch,Cout]; biases are f32.
//
// What bounds it on this card: on the LightStereo main path the hidden width
// Ch is 4-6x the block width (up to 960), so the unfused chain writes and
// reads the hidden tensor twice in device memory. Fused, the block reads x
// once and writes y once, 2*(Cin*Ch + 9*Ch + Ch*Cout) flops per pixel; at
// these widths the bound is operations, but small: 15.8 GFLOP per frame.
// What costs time is latency and parallelism: the 34x60 and 17x30 maps give
// a few dozen output tiles for 132 SMs.
//
// bf16, the main path: `tc::mbconv_tc`. A block owns an 8 x 16 output tile
// (its 10 x 18 halo padded to 192 pixel rows) and walks its share of the
// hidden channels 32 at a time:
//   1. x's halo tile is staged once, transposed to [pixel][channel] bf16
//      (the A operand), Cin zero-padded to a multiple of 16;
//   2. per chunk, the expand [192 x Cin] . [Cin x 32] runs on the tensor cores
//      (mma.sync m16n8k16, f32 sums; 8 warps x 3 m16n16 units); + b1, relu6,
//      zero outside the image, bf16 to shared memory;
//   3. the depthwise 3x3 + b2 + relu6 on CUDA cores (a thread owns 2 channels
//      and one column, sliding 3 rows of taps down the 8 rows), bf16;
//   4. the project [128 x 32] . [32 x Cout] on the tensor cores; warp w owns
//      output row w and all of Cout in f32 registers.
// Depthwise channels are independent, so the chunking is exact; the weight
// chunks are staged transposed (k-contiguous for the B fragments), rows padded
// by 8 bf16 so every fragment load is free of bank conflicts. Where a launch
// would give fewer than two waves of tiles on the card's SMs, the hidden
// chunks are split over S blocks per tile (grid z; `fused_mbconv_splits`
// picks S, the wrapper sizes the workspace by it): each writes its f32 partial
// projection to a workspace [S,B,Cout,H,W], and `mbconv_reduce` sums the S
// partials in a fixed order, adds b3 and the residual and stores in x's
// dtype: deterministic, no atomics. With S = 1 the block stores directly.
//
// f32, for the agreement checks with TF32 off and not on the bf16 main path:
// `simt::mbconv_kernel`, the first CUDA-core version (4 x 16 tiles, both
// 1x1 products as scalar f32 FMAs, never split).

#include <algorithm>
#include <cstdint>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace simt {

constexpr int TH = 4, TWD = 16;    // output tile rows x cols
constexpr int P = TH * TWD;        // output pixels per block
constexpr int QW = TWD + 2;        // halo tile width
constexpr int NQ = (TH + 2) * QW;  // halo pixels per block
constexpr int NT = 256;            // threads per block
constexpr int NQT = 128;           // expand: threads along the halo pixels
constexpr int HC = 32;             // hidden channels per chunk
constexpr int JPT = HC / (NT / NQT);  // expand: hidden channels per thread
constexpr int NG = NT / P;         // project: channel groups per pixel
constexpr int MAX_SMEM = 232448;   // bytes a block may use on sm_90

static_assert(NQ <= NQT, "halo tile must fit the expand threads");
static_assert(JPT % 4 == 0, "float4 reads of W1");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

__host__ __device__ constexpr int cout_pad(int opt) { return NG * opt; }

// Shared-memory floats: W2 chunk [HC][CP] | W1 chunk [Cin][HC] | h [HC][NQ] |
// d [HC][P] | x halo [Cin][NQ]. Each section is a multiple of 4 floats, so
// the float4 reads of the two weight chunks stay 16-byte aligned.
__host__ __device__ inline size_t smem_floats(int cin, int cp) {
  return (size_t)HC * cp + (size_t)cin * HC + (size_t)HC * NQ + (size_t)HC * P +
         (size_t)cin * NQ + ((4 - (cin * NQ) % 4) % 4);
}

template <typename T, int OPT>
__global__ void __launch_bounds__(NT)
mbconv_kernel(const T* __restrict__ x, const T* __restrict__ w1, const float* __restrict__ b1,
              const T* __restrict__ dw, const float* __restrict__ b2,
              const T* __restrict__ w2, const float* __restrict__ b3, T* __restrict__ out,
              int Cin, int Ch, int Cout, int H, int W, int tiles_w, int residual) {
  constexpr int CP = cout_pad(OPT);
  extern __shared__ float4 smem4[];
  float* w2s = reinterpret_cast<float*>(smem4);  // [HC][CP]
  float* w1s = w2s + HC * CP;                    // [Cin][HC]
  float* hs = w1s + Cin * HC;                    // [HC][NQ]
  float* ds = hs + HC * NQ;                      // [HC][P]
  float* xs = ds + HC * P;                       // [Cin][NQ]

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int h0 = (blockIdx.x / tiles_w) * TH;
  const int wo = (blockIdx.x % tiles_w) * TWD;
  const size_t plane = (size_t)H * W;

  // 1. x halo tile, zero outside the image
  const T* xb = x + (size_t)b * Cin * plane;
  for (int i = tid; i < Cin * NQ; i += NT) {
    const int c = i / NQ, q = i % NQ;
    const int gh = h0 - 1 + q / QW, gw = wo - 1 + q % QW;
    xs[i] = (gh >= 0 && gh < H && gw >= 0 && gw < W)
                ? to_f(xb[(size_t)c * plane + (size_t)gh * W + gw]) : 0.f;
  }

  // expand thread role: halo pixel q, hidden channels [jg*JPT, jg*JPT+JPT) of a chunk
  const int q = tid % NQT, jg = tid / NQT;
  const int qh = h0 - 1 + q / QW, qw = wo - 1 + q % QW;
  const bool q_in = q < NQ && qh >= 0 && qh < H && qw >= 0 && qw < W;
  // project thread role: pixel p, output channels [og*OPT, og*OPT+OPT)
  const int p = tid % P, og = tid / P;

  float acc[OPT];
#pragma unroll
  for (int k = 0; k < OPT; ++k) acc[k] = 0.f;

  for (int j0 = 0; j0 < Ch; j0 += HC) {
    const int jn = min(HC, Ch - j0);
    for (int i = tid; i < Cin * HC; i += NT) {
      const int c = i / HC, j = i % HC;
      w1s[i] = j < jn ? to_f(w1[(size_t)c * Ch + j0 + j]) : 0.f;
    }
    for (int i = tid; i < HC * CP; i += NT) {
      const int j = i / CP, o = i % CP;
      w2s[i] = (j < jn && o < Cout) ? to_f(w2[(size_t)(j0 + j) * Cout + o]) : 0.f;
    }
    __syncthreads();

    // 2. expand + b1 + relu6 on the halo tile, zero outside the image
    if (q < NQ) {
      float e[JPT];
#pragma unroll
      for (int t = 0; t < JPT; ++t) e[t] = 0.f;
      for (int c = 0; c < Cin; ++c) {
        const float xv = xs[c * NQ + q];
        const float4* wr = reinterpret_cast<const float4*>(w1s + c * HC + jg * JPT);
#pragma unroll
        for (int t4 = 0; t4 < JPT / 4; ++t4) {
          const float4 wv = wr[t4];
          e[4 * t4 + 0] += xv * wv.x;
          e[4 * t4 + 1] += xv * wv.y;
          e[4 * t4 + 2] += xv * wv.z;
          e[4 * t4 + 3] += xv * wv.w;
        }
      }
#pragma unroll
      for (int t = 0; t < JPT; ++t) {
        const int j = jg * JPT + t;
        hs[j * NQ + q] = (q_in && j < jn) ? relu6(e[t] + b1[j0 + j]) : 0.f;
      }
    }
    __syncthreads();

    // 3. depthwise 3x3 + b2 + relu6 on the tile's pixels
    for (int i = tid; i < HC * P; i += NT) {
      const int j = i / P, pp = i % P;
      float v = 0.f;
      if (j < jn) {
        const int pr = pp / TWD, pc = pp % TWD;
        const float* hj = hs + j * NQ + pr * QW + pc;
        float s = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dj = 0; dj < 3; ++dj)
            s += hj[di * QW + dj] * to_f(dw[(size_t)(di * 3 + dj) * Ch + j0 + j]);
        v = relu6(s + b2[j0 + j]);
      }
      ds[i] = v;
    }
    __syncthreads();

    // 4. this chunk's share of the Cout projection
    for (int j = 0; j < HC; ++j) {
      const float dv = ds[j * P + p];
      const float4* wr = reinterpret_cast<const float4*>(w2s + j * CP + og * OPT);
#pragma unroll
      for (int k4 = 0; k4 < OPT / 4; ++k4) {
        const float4 wv = wr[k4];
        acc[4 * k4 + 0] += dv * wv.x;
        acc[4 * k4 + 1] += dv * wv.y;
        acc[4 * k4 + 2] += dv * wv.z;
        acc[4 * k4 + 3] += dv * wv.w;
      }
    }
    __syncthreads();
  }

  // 5. + b3 (+ x), store
  const int gh = h0 + p / TWD, gw = wo + p % TWD;
  if (gh >= H || gw >= W) return;
  const int qc = (p / TWD + 1) * QW + p % TWD + 1;  // pixel's index in the halo tile
  T* ob = out + (size_t)b * Cout * plane + (size_t)gh * W + gw;
#pragma unroll
  for (int k = 0; k < OPT; ++k) {
    const int o = og * OPT + k;
    if (o < Cout) {
      float v = acc[k] + b3[o];
      if (residual) v += xs[o * NQ + qc];
      ob[(size_t)o * plane] = from_f<T>(v);
    }
  }
}

template <typename T, int OPT>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* dw,
                   const void* b2, const void* w2, const void* b3, void* out, int B,
                   int Cin, int Ch, int Cout, int H, int W, int residual,
                   cudaStream_t stream) {
  const size_t smem = smem_floats(Cin, cout_pad(OPT)) * sizeof(float);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kern = mbconv_kernel<T, OPT>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TWD - 1) / TWD, tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_h * tiles_w, B);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w1), static_cast<const float*>(b1),
      static_cast<const T*>(dw), static_cast<const float*>(b2), static_cast<const T*>(w2),
      static_cast<const float*>(b3), static_cast<T*>(out), Cin, Ch, Cout, H, W, tiles_w,
      residual);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* w1, const void* b1, const void* dw,
                     const void* b2, const void* w2, const void* b3, void* out, int B,
                     int Cin, int Ch, int Cout, int H, int W, int residual, cudaStream_t s) {
  using T = float;
  if (Cout <= NG * 8)
    return launch<T, 8>(x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W, residual, s);
  if (Cout <= NG * 16)
    return launch<T, 16>(x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W, residual, s);
  if (Cout <= NG * 24)
    return launch<T, 24>(x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W, residual, s);
  if (Cout <= NG * 48)
    return launch<T, 48>(x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W, residual, s);
  return cudaErrorInvalidValue;
}

}  // namespace simt

namespace tc {

constexpr int TH = 8, TWD = 16;     // output tile rows x cols: warp w owns row w
constexpr int P = TH * TWD;         // output pixels per block
constexpr int QW = TWD + 2;         // halo tile width
constexpr int NQ = (TH + 2) * QW;   // halo pixels
constexpr int NQP = 192;            // halo pixels padded to 12 m16 tiles
constexpr int NT = 256;             // threads per block
constexpr int HC = 32;              // hidden channels per chunk
constexpr int HLD = HC + 8;         // bf16 row stride of h, d and W2^T
constexpr int UNITS = (NQP / 16) * (HC / 16) / (NT / 32);  // expand m16n16 units per warp
static_assert(NQ <= NQP && UNITS * (NT / 32) * 16 * 16 == NQP * HC, "expand tiling");
static_assert(P == 16 * (NT / 32) && TWD == 16, "project: one 16-pixel row per warp");

__host__ __device__ constexpr int cin_pad(int cin) { return (cin + 15) / 16 * 16; }

// dynamic shared memory (bytes): x halo [NQP][XLD] | W1^T [HC][XLD] | h [NQP][HLD] |
// d [P][HLD] | W2^T [CP][HLD], all bf16, XLD = cin_pad + 8
__host__ __device__ constexpr size_t smem_bytes(int cin, int cp) {
  return 2 * ((size_t)(NQP + HC) * (cin_pad(cin) + 8) + (size_t)(NQP + P + cp) * HLD);
}

__device__ __forceinline__ float relu6(float v) { return fminf(fmaxf(v, 0.f), 6.f); }

// NTILE n8 tiles of Cout (Cout <= 8 * NTILE); chunks [cps * z, cps * z + cps) of the
// hidden channels; ws == nullptr: + b3 (+ x), store out; else store the f32 partial
template <int NTILE>
__global__ void __launch_bounds__(NT)
mbconv_tc(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w1,
          const float* __restrict__ b1, const __nv_bfloat16* __restrict__ dw,
          const float* __restrict__ b2, const __nv_bfloat16* __restrict__ w2,
          const float* __restrict__ b3, __nv_bfloat16* __restrict__ out, float* __restrict__ ws,
          int Cin, int Ch, int Cout, int H, int W, int tiles_w, int residual, int cps) {
  constexpr int CP = 8 * NTILE;
  const int CINP = cin_pad(Cin), XLD = CINP + 8;
  extern __shared__ uint4 smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [NQP][XLD]
  __nv_bfloat16* w1s = xs + NQP * XLD;                           // [HC][XLD]
  __nv_bfloat16* hs = w1s + HC * XLD;                            // [NQP][HLD]
  __nv_bfloat16* ds = hs + NQP * HLD;                            // [P][HLD]
  __nv_bfloat16* w2s = ds + P * HLD;                             // [CP][HLD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
  const int b = blockIdx.y, split = blockIdx.z;
  const int h0 = blockIdx.x / tiles_w * TH, wo = blockIdx.x % tiles_w * TWD;
  const size_t plane = (size_t)H * W;
  const int nchunks = (Ch + HC - 1) / HC;
  const int cbeg = split * cps, cend = min(nchunks, cbeg + cps);

  // 1. x halo tile as [pixel][channel], 0 outside the image and in the padding
  const __nv_bfloat16* xb = x + (size_t)b * Cin * plane;
  const __nv_bfloat16 zero = __float2bfloat16(0.f);
  for (int i = tid; i < CINP * NQP; i += NT) {
    const int c = i / NQP, q = i % NQP;
    const int gh = h0 - 1 + q / QW, gw = wo - 1 + q % QW;
    xs[q * XLD + c] = (c < Cin && q < NQ && gh >= 0 && gh < H && gw >= 0 && gw < W)
                          ? xb[(size_t)c * plane + (size_t)gh * W + gw] : zero;
  }

  float acc[NTILE][4];
#pragma unroll
  for (int n = 0; n < NTILE; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int ck = cbeg; ck < cend; ++ck) {
    const int j0 = ck * HC;
    __syncthreads();  // the previous chunk is done with w1s, hs, ds, w2s
    for (int i = tid; i < CINP * HC; i += NT) {  // W1^T chunk
      const int c = i / HC, j = i % HC;
      w1s[j * XLD + c] = (c < Cin && j0 + j < Ch) ? w1[(size_t)c * Ch + j0 + j] : zero;
    }
    for (int i = tid; i < HC * CP; i += NT) {  // W2^T chunk
      const int j = i / CP, o = i % CP;
      w2s[o * HLD + j] = (o < Cout && j0 + j < Ch) ? w2[(size_t)(j0 + j) * Cout + o] : zero;
    }
    __syncthreads();

    // 2. expand + b1 + relu6 on the halo tile, 0 outside the image; bf16
#pragma unroll
    for (int u = 0; u < UNITS; ++u) {
      const int unit = warp + (NT / 32) * u;
      const int mt = unit / (HC / 16), n16 = unit % (HC / 16);
      float e[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
      for (int k0 = 0; k0 < CINP; k0 += 16) {
        uint32_t a[4];
        mma::load_a(a, xs, XLD, 16 * mt, k0, g, t);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const __nv_bfloat16* bp = w1s + (16 * n16 + 8 * nt + g) * XLD + k0 + 2 * t;
          mma::bf16_16816(e[nt], a, mma::ld32(bp), mma::ld32(bp + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int j = 16 * n16 + 8 * nt + 2 * t;  // chunk channels j, j + 1
        const float bj0 = j0 + j < Ch ? b1[j0 + j] : 0.f;
        const float bj1 = j0 + j + 1 < Ch ? b1[j0 + j + 1] : 0.f;
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const int q = 16 * mt + g + 8 * r;
          const int gh = h0 - 1 + q / QW, gw = wo - 1 + q % QW;
          const bool in = q < NQ && gh >= 0 && gh < H && gw >= 0 && gw < W;
          *reinterpret_cast<uint32_t*>(hs + q * HLD + j) =
              in ? mma::pack(relu6(e[nt][2 * r] + bj0), relu6(e[nt][2 * r + 1] + bj1))
                 : 0u;
        }
      }
    }
    __syncthreads();

    // 3. depthwise 3x3 + b2 + relu6: thread (column c, channels 2jp, 2jp + 1)
    //    slides down the tile's 8 rows; bf16
    {
      const int jp = tid % (HC / 2), c = tid / (HC / 2);
      const int j = j0 + 2 * jp;
      float wt[9][2], bb[2];
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const bool ok = j + u < Ch;
        bb[u] = ok ? b2[j + u] : 0.f;
#pragma unroll
        for (int k = 0; k < 9; ++k) wt[k][u] = ok ? __bfloat162float(dw[(size_t)k * Ch + j + u]) : 0.f;
      }
      float2 win[3][3];  // halo rows r..r+2, columns c..c+2
      auto load_row = [&](float2 (&row)[3], int hr) {
#pragma unroll
        for (int dc = 0; dc < 3; ++dc)
          row[dc] = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(
              hs + (hr * QW + c + dc) * HLD + 2 * jp));
      };
      load_row(win[0], 0);
      load_row(win[1], 1);
#pragma unroll
      for (int r = 0; r < TH; ++r) {
        load_row(win[(r + 2) % 3], r + 2);
        float s0 = 0.f, s1 = 0.f;
#pragma unroll
        for (int di = 0; di < 3; ++di)
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const float2 hv = win[(r + di) % 3][dc];
            s0 += hv.x * wt[3 * di + dc][0];
            s1 += hv.y * wt[3 * di + dc][1];
          }
        *reinterpret_cast<uint32_t*>(ds + (r * TWD + c) * HLD + 2 * jp) =
            mma::pack(relu6(s0 + bb[0]), relu6(s1 + bb[1]));
      }
    }
    __syncthreads();

    // 4. this chunk's share of the projection: warp w, pixels of row w
#pragma unroll
    for (int k0 = 0; k0 < HC; k0 += 16) {
      uint32_t a[4];
      mma::load_a(a, ds, HLD, 16 * warp, k0, g, t);
#pragma unroll
      for (int n = 0; n < NTILE; ++n) {
        const __nv_bfloat16* bp = w2s + (8 * n + g) * HLD + k0 + 2 * t;
        mma::bf16_16816(acc[n], a, mma::ld32(bp), mma::ld32(bp + 8));
      }
    }
  }

  // 5. store: pixels (row warp, columns g and g + 8), channels 8n + 2t, 8n + 2t + 1
  const int gh = h0 + warp;
  if (gh >= H) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int col = g + 8 * r, gw = wo + col;
    if (gw >= W) continue;
    const int qc = (warp + 1) * QW + col + 1;  // the pixel in the halo tile
#pragma unroll
    for (int n = 0; n < NTILE; ++n) {
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int o = 8 * n + 2 * t + u;
        if (o >= Cout) continue;
        const size_t at = ((size_t)b * Cout + o) * plane + (size_t)gh * W + gw;
        const float v = acc[n][2 * r + u];
        if (ws) {
          ws[(size_t)split * gridDim.y * Cout * plane + at] = v;
        } else {
          float y = v + b3[o];
          if (residual) y += __bfloat162float(xs[qc * XLD + o]);
          out[at] = __float2bfloat16(y);
        }
      }
    }
  }
}

// the card's SM count (the current device's), 0 if it cannot be read
inline int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return 0;
  return sms;
}

// how many blocks share one output tile's hidden chunks: 1 where the tiles alone
// fill two waves of the SMs, else enough blocks to fill them, at most one per
// chunk, every split taking ceil(chunks / S) chunks (so none is left without)
inline int pick_splits(int B, int H, int W, int Ch, int sms) {
  const long tiles = (long)B * ((H + TH - 1) / TH) * ((W + TWD - 1) / TWD);
  const long target = 2L * sms, chunks = (Ch + HC - 1) / HC;
  if (tiles >= target) return 1;
  const long want = std::min(chunks, (target + tiles - 1) / tiles);
  const long per = (chunks + want - 1) / want;
  return (int)((chunks + per - 1) / per);
}

// out = sum over s of ws[s] (in order) + b3 (+ x), for the S > 1 launches
__global__ void __launch_bounds__(256)
mbconv_reduce(const float* __restrict__ ws, const __nv_bfloat16* __restrict__ x,
              const float* __restrict__ b3, __nv_bfloat16* __restrict__ out, int S, size_t n,
              int Cout, size_t plane, int residual) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float y = 0.f;
    for (int s = 0; s < S; ++s) y += ws[(size_t)s * n + i];
    y += b3[i / plane % Cout];
    if (residual) y += __bfloat162float(x[i]);
    out[i] = __float2bfloat16(y);
  }
}

template <int NTILE>
cudaError_t launch(const void* x, const void* w1, const void* b1, const void* dw,
                   const void* b2, const void* w2, const void* b3, void* out, float* ws, int B,
                   int Cin, int Ch, int Cout, int H, int W, int residual, int splits,
                   cudaStream_t stream) {
  using bf = __nv_bfloat16;
  const int nchunks = (Ch + HC - 1) / HC;
  const int cps = (nchunks + splits - 1) / splits;
  if (splits < 1 || splits > nchunks || (splits - 1) * cps >= nchunks || (splits > 1) != (ws != nullptr))
    return cudaErrorInvalidValue;
  const size_t smem = smem_bytes(Cin, 8 * NTILE);
  auto kern = mbconv_tc<NTILE>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int tiles_w = (W + TWD - 1) / TWD, tiles_h = (H + TH - 1) / TH;
  dim3 grid(tiles_h * tiles_w, B, splits);
  kern<<<grid, NT, smem, stream>>>(
      static_cast<const bf*>(x), static_cast<const bf*>(w1), static_cast<const float*>(b1),
      static_cast<const bf*>(dw), static_cast<const float*>(b2), static_cast<const bf*>(w2),
      static_cast<const float*>(b3), static_cast<bf*>(out), ws, Cin, Ch, Cout, H, W, tiles_w,
      residual, cps);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return err;
  const size_t plane = (size_t)H * W, n = (size_t)B * Cout * plane;
  const int blocks = (int)std::min((n + 255) / 256, (size_t)std::max(sm_count(), 1) * 16);
  mbconv_reduce<<<blocks, 256, 0, stream>>>(ws, static_cast<const bf*>(x),
                                           static_cast<const float*>(b3), static_cast<bf*>(out),
                                           splits, n, Cout, plane, residual);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* x, const void* w1, const void* b1, const void* dw, const void* b2,
                     const void* w2, const void* b3, void* out, float* ws, int B, int Cin, int Ch,
                     int Cout, int H, int W, int residual, int splits, cudaStream_t s) {
  switch ((Cout + 31) / 32) {
    case 1: return launch<4>(x, w1, b1, dw, b2, w2, b3, out, ws, B, Cin, Ch, Cout, H, W, residual, splits, s);
    case 2: return launch<8>(x, w1, b1, dw, b2, w2, b3, out, ws, B, Cin, Ch, Cout, H, W, residual, splits, s);
    case 3: return launch<12>(x, w1, b1, dw, b2, w2, b3, out, ws, B, Cin, Ch, Cout, H, W, residual, splits, s);
    case 4: return launch<16>(x, w1, b1, dw, b2, w2, b3, out, ws, B, Cin, Ch, Cout, H, W, residual, splits, s);
    case 5: return launch<20>(x, w1, b1, dw, b2, w2, b3, out, ws, B, Cin, Ch, Cout, H, W, residual, splits, s);
    case 6: return launch<24>(x, w1, b1, dw, b2, w2, b3, out, ws, B, Cin, Ch, Cout, H, W, residual, splits, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace tc

// dtype: 0 = float32, 1 = bfloat16 (x, w1, dw, w2, out); b1, b2, b3 are float32.
// x [B,Cin,H,W], w1 [Cin,Ch], dw [9,Ch] (tap = 3*di + dj), w2 [Ch,Cout],
// out [B,Cout,H,W], all contiguous on the device; Cin <= 256, Cout <= 192.
// splits: how many blocks share a tile's hidden channels (bf16 only; f32 takes
// 1; `fused_mbconv_splits` gives the launcher's choice, and any S that leaves
// no split without chunks is taken); with splits > 1, ws is an f32 workspace
// [splits,B,Cout,H,W], else null.
extern "C" cudaError_t fused_mbconv_launch(const void* x, const void* w1, const void* b1,
                                           const void* dw, const void* b2, const void* w2,
                                           const void* b3, void* out, void* ws, int B, int Cin,
                                           int Ch, int Cout, int H, int W, int residual,
                                           int splits, int dtype, void* stream) {
  if (B <= 0 || Cin <= 0 || Ch <= 0 || Cout <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      Cin > 256 || Cout > 192 || (residual && Cin != Cout))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (splits != 1 || ws != nullptr) return cudaErrorInvalidValue;
    return simt::dispatch(x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W, residual, s);
  }
  if (dtype == 1)
    return tc::dispatch(x, w1, b1, dw, b2, w2, b3, out, static_cast<float*>(ws), B, Cin, Ch,
                        Cout, H, W, residual, splits, s);
  return cudaErrorInvalidValue;
}

// The split count the launcher picks for a call (1 for f32), from the current
// device's SM count; 0 if that cannot be read.
extern "C" int fused_mbconv_splits(int B, int H, int W, int Ch, int dtype) {
  if (dtype != 1) return 1;
  const int sms = tc::sm_count();
  return sms > 0 ? tc::pick_splits(B, H, W, Ch, sms) : 0;
}
