// Correlation volume for Hopper (sm_90a), NCHW.
//
// Replaces the TPU kernel `_corr_kernel` / `correlation_volume_pallas`
// (openstereo_tpu/ops/pallas/corr_volume.py, num_groups = 1):
//
//     out[b,d,h,w] = (1/C) * sum_c L[b,c,h,w] * R[b,c,h,w-d],  0 where w-d < 0
//
// What bounds it on this card: bytes. On the LightStereo main path
// (C=24, D=48, H=136, W=240, bf16) it reads 1.6 MB and writes 3.1 MB while
// doing 2*C*D = 2304 flops per output pixel column, far below the ~295
// flops/byte where the tensor cores would be the limit; at this size the
// launch itself is a large share of the time.
//
// What the design does about it: one block owns one image row h, a tile of
// TW output columns and a band of DB disparities. It stages the left tile and
// the right window [w0-d0-DB+1, w0-d0+TW) in shared memory CC channels at a
// time (f32), so each input element is read from device memory about once
// per block instead of once per disparity. Threads run along w, so every
// global load and store is coalesced along the contiguous W axis. Each thread
// keeps DPT disparities of one column in registers and accumulates in f32.
// Right columns outside the frame are staged as 0, which makes the planes
// with d > w (and all planes with d >= W) exactly 0.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TW = 64;            // output columns per block (threadIdx.x)
constexpr int DY = 8;             // disparity lanes (threadIdx.y)
constexpr int DPT = 6;            // disparities per thread
constexpr int DB = DY * DPT;      // disparities per block
constexpr int CC = 16;            // channels staged per step
constexpr int RW = TW + DB - 1;   // right-window width

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(TW * DY)
corr_kernel(const T* __restrict__ left, const T* __restrict__ right, T* __restrict__ out,
            int C, int H, int W, int D, int n_dblk) {
  __shared__ float ls[CC][TW];
  __shared__ float rs[CC][RW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  const int b = blockIdx.z / n_dblk;
  const int d0 = (blockIdx.z % n_dblk) * DB;
  const int ws = w0 - d0 - (DB - 1);  // image column of rs[.][0]
  const size_t plane = (size_t)H * W;
  const T* lrow = left + (size_t)b * C * plane + (size_t)h * W;
  const T* rrow = right + (size_t)b * C * plane + (size_t)h * W;

  float acc[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) acc[k] = 0.f;

  for (int c0 = 0; c0 < C; c0 += CC) {
    for (int i = tid; i < CC * TW; i += TW * DY) {
      const int c = i / TW, x = i % TW, gw = w0 + x;
      ls[c][x] = (c0 + c < C && gw < W) ? to_f(lrow[(size_t)(c0 + c) * plane + gw]) : 0.f;
    }
    for (int i = tid; i < CC * RW; i += TW * DY) {
      const int c = i / RW, x = i % RW, gw = ws + x;
      rs[c][x] = (c0 + c < C && gw >= 0 && gw < W)
                     ? to_f(rrow[(size_t)(c0 + c) * plane + gw]) : 0.f;
    }
    __syncthreads();
    const int cn = min(CC, C - c0);
    for (int c = 0; c < cn; ++c) {
      const float l = ls[c][tx];
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        // d = d0 + ty + DY*k reads image column w0 + tx - d = ws + (local index)
        acc[k] += l * rs[c][tx - ty - DY * k + DB - 1];
      }
    }
    __syncthreads();
  }

  const int w = w0 + tx;
  if (w >= W) return;
  const float cf = (float)C;
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
    const int d = d0 + ty + DY * k;
    if (d < D) out[((size_t)b * D + d) * plane + (size_t)h * W + w] = from_f<T>(acc[k] / cf);
  }
}

template <typename T>
cudaError_t launch(const void* left, const void* right, void* out, int B, int C, int H,
                   int W, int D, cudaStream_t stream) {
  const int n_dblk = (D + DB - 1) / DB;
  dim3 block(TW, DY);
  dim3 grid((W + TW - 1) / TW, H, B * n_dblk);
  corr_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(left),
                                             static_cast<const T*>(right),
                                             static_cast<T*>(out), C, H, W, D, n_dblk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Tensors are contiguous NCHW on the device.
extern "C" cudaError_t corr_volume_launch(const void* left, const void* right, void* out,
                                          int B, int C, int H, int W, int D, int dtype,
                                          void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || D <= 0 || H > 65535 ||
      B * ((D + DB - 1) / DB) > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(left, right, out, B, C, H, W, D, s);
  if (dtype == 1) return launch<__nv_bfloat16>(left, right, out, B, C, H, W, D, s);
  return cudaErrorInvalidValue;
}
