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
// What bounds it on this card: on the LightStereo main path the hidden width
// Ch is 4-6x the block width (up to 960), so the unfused chain writes and
// reads the hidden tensor twice in device memory, and that traffic bounds
// it. Fused, the block reads x once and writes y once; the work is then
// 2*(Cin*Ch + 9*Ch + Ch*Cout) flops per pixel, which at these widths is
// still below the bf16 ridge point, so bytes remain the floor.
//
// The design trouble is the hidden width: a tile's hidden activations with
// their 1-pixel halo do not fit in shared memory (an 8x32 tile at Ch=960 in
// bf16 is ~650 KB against 227 KB). So a block owns a TH x TW output tile and
// walks the hidden channels in chunks of HC:
//   1. x's halo tile (all Cin) is staged in shared memory once, as f32;
//   2. per chunk, the expand for the halo tile goes to shared memory, with
//      out-of-image positions zeroed after relu6 (the dw conv sees zero
//      padding of h, as in the TPU kernel);
//   3. the depthwise 3x3 + b2 + relu6 for the tile's pixels goes to shared
//      memory;
//   4. the chunk's contribution to the Cout projection accumulates in f32
//      registers (each thread owns one pixel and OPT output channels).
// Depthwise channels are independent, so the chunking is exact. b3 and the
// residual are added at the end. Weights arrive in the layouts the loops
// read contiguously: W1 [Cin,Ch], dw [9,Ch], W2 [Ch,Cout] (the JAX kernel's
// layouts); biases are f32. All arithmetic is f32 on CUDA cores; moving the
// two 1x1 products onto the tensor cores (wgmma) is later work.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

template <typename T>
cudaError_t dispatch(const void* x, const void* w1, const void* b1, const void* dw,
                     const void* b2, const void* w2, const void* b3, void* out, int B,
                     int Cin, int Ch, int Cout, int H, int W, int residual,
                     cudaStream_t s) {
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

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, w1, dw, w2, out); b1, b2, b3 are float32.
// x [B,Cin,H,W], w1 [Cin,Ch], dw [9,Ch] (tap = 3*di + dj), w2 [Ch,Cout],
// out [B,Cout,H,W], all contiguous on the device. Cout <= 192.
extern "C" cudaError_t fused_mbconv_launch(const void* x, const void* w1, const void* b1,
                                           const void* dw, const void* b2, const void* w2,
                                           const void* b3, void* out, int B, int Cin, int Ch,
                                           int Cout, int H, int W, int residual, int dtype,
                                           void* stream) {
  if (B <= 0 || Cin <= 0 || Ch <= 0 || Cout <= 0 || H <= 0 || W <= 0 || B > 65535 ||
      (residual && Cin != Cout))
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch<float>(x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W, residual, s);
  if (dtype == 1)
    return dispatch<__nv_bfloat16>(x, w1, b1, dw, b2, w2, b3, out, B, Cin, Ch, Cout, H, W,
                                   residual, s);
  return cudaErrorInvalidValue;
}
