// Group-wise correlation volume for Hopper (sm_90a), NCHW in, NCDHW out.
//
// Replaces the TPU kernel `build_gwc_volume_pallas`, which runs the
// `pallas_call` of `correlation_volume_pallas` with num_groups > 1
// (openstereo_tpu/ops/pallas/corr_volume.py):
//
//     out[b,g,d,h,w] = (1/cg) * sum_{c<cg} L[b,g*cg+c,h,w] * R[b,g*cg+c,h,w-d],
//     cg = C/G,  0 where w-d < 0
//
// What bounds it on this card: bytes. At GwcNet's shape (C=320, G=40, D=48,
// H=136, W=240, bf16) it reads 41.8 MB and writes 125.3 MB against 0.90
// GFLOP, about 5 flops per byte where the tensor cores would need ~295: the
// volume it writes, D*G values per pixel, is 3x the features it reads.
//
// What the design does about it: every output value is written once, with
// coalesced stores, and every input value is read from device memory about
// once per block. One block owns one image row h, a tile of TW output
// columns, a band of DB disparities and a band of groups. Threads run along
// w, so each store to out[b,g,d,h,w] is a run of consecutive w. The block
// walks the channels of its groups CC at a time, staging the left tile and
// the right window [w0-d0-DB+1, w0+TW) as f32 in shared memory; right
// columns outside the frame are staged as 0, which makes the planes with
// d > w (and all planes with d >= W) exactly 0. Each thread keeps DPT
// disparities of its column in f32 registers; when the channel walk reaches
// the end of a group (the same step for every thread, so no divergence) it
// writes that group's DPT values and starts the next group. A chunk may
// span groups, so any cg = C/G is taken, and small groups cost no extra
// barriers.

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

constexpr int TW = 64;            // output columns per block (threadIdx.x)
constexpr int DY = 8;             // disparity lanes (threadIdx.y)
constexpr int DPT = 6;            // disparities per thread
constexpr int DB = DY * DPT;      // disparities per block
constexpr int CC = 32;            // channels staged per step
constexpr int RW = TW + DB - 1;   // right-window width
constexpr int TARGET_BLOCKS = 2112;  // 4 resident 512-thread blocks on each of 132 SMs, x4

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void __launch_bounds__(TW * DY)
gwc_kernel(const T* __restrict__ left, const T* __restrict__ right, T* __restrict__ out,
           int C, int H, int W, int D, int G, int gpb, int n_gblk, int n_dblk) {
  __shared__ float ls[CC][TW];
  __shared__ float rs[CC][RW];

  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int w0 = blockIdx.x * TW;
  const int h = blockIdx.y;
  int z = blockIdx.z;
  const int d0 = (z % n_dblk) * DB;
  z /= n_dblk;
  const int g_begin = (z % n_gblk) * gpb;
  const int b = z / n_gblk;
  const int cg = C / G;
  const int c_end = min(G, g_begin + gpb) * cg;
  const int ws = w0 - d0 - (DB - 1);  // image column of rs[.][0]
  const size_t plane = (size_t)H * W;
  const T* lrow = left + (size_t)b * C * plane + (size_t)h * W;
  const T* rrow = right + (size_t)b * C * plane + (size_t)h * W;
  const int w = w0 + tx;
  const float cgf = (float)cg;

  float acc[DPT];
#pragma unroll
  for (int k = 0; k < DPT; ++k) acc[k] = 0.f;
  int g = g_begin, in_group = 0;

  for (int c0 = g_begin * cg; c0 < c_end; c0 += CC) {
    const int cn = min(CC, c_end - c0);
    for (int i = tid; i < cn * TW; i += TW * DY) {
      const int c = i / TW, x = i % TW, gw = w0 + x;
      ls[c][x] = gw < W ? to_f(lrow[(size_t)(c0 + c) * plane + gw]) : 0.f;
    }
    for (int i = tid; i < cn * RW; i += TW * DY) {
      const int c = i / RW, x = i % RW, gw = ws + x;
      rs[c][x] = (gw >= 0 && gw < W) ? to_f(rrow[(size_t)(c0 + c) * plane + gw]) : 0.f;
    }
    __syncthreads();
    for (int c = 0; c < cn; ++c) {
      const float l = ls[c][tx];
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        // d = d0 + ty + DY*k reads image column w - d = ws + (local index)
        acc[k] += l * rs[c][tx - ty - DY * k + DB - 1];
      }
      if (++in_group == cg) {  // the same step for every thread of the block
        if (w < W) {
          T* o = out + (size_t)(b * G + g) * D * plane + (size_t)h * W + w;
#pragma unroll
          for (int k = 0; k < DPT; ++k) {
            const int d = d0 + ty + DY * k;
            if (d < D) o[(size_t)d * plane] = from_f<T>(acc[k] / cgf);
          }
        }
#pragma unroll
        for (int k = 0; k < DPT; ++k) acc[k] = 0.f;
        in_group = 0;
        ++g;
      }
    }
    __syncthreads();
  }
}

template <typename T>
cudaError_t launch(const void* left, const void* right, void* out, int B, int C, int H,
                   int W, int D, int G, cudaStream_t stream) {
  const int n_wblk = (W + TW - 1) / TW;
  const int n_dblk = (D + DB - 1) / DB;
  // split the groups into bands until the grid has about TARGET_BLOCKS blocks
  const long base = (long)n_wblk * H * B * n_dblk;
  int n_gblk = (int)((TARGET_BLOCKS + base - 1) / base);
  n_gblk = n_gblk < 1 ? 1 : (n_gblk > G ? G : n_gblk);
  const int gpb = (G + n_gblk - 1) / n_gblk;
  n_gblk = (G + gpb - 1) / gpb;
  if ((long)B * n_gblk * n_dblk > 65535) return cudaErrorInvalidValue;
  dim3 block(TW, DY);
  dim3 grid(n_wblk, H, B * n_gblk * n_dblk);
  gwc_kernel<T><<<grid, block, 0, stream>>>(static_cast<const T*>(left),
                                            static_cast<const T*>(right),
                                            static_cast<T*>(out), C, H, W, D, G, gpb,
                                            n_gblk, n_dblk);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. left/right are contiguous [B,C,H,W] and
// out a contiguous [B,G,D,H,W] on the device; G divides C.
extern "C" cudaError_t gwc_volume_launch(const void* left, const void* right, void* out,
                                         int B, int C, int H, int W, int D, int G, int dtype,
                                         void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || D <= 0 || G <= 0 || C % G != 0 || H > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(left, right, out, B, C, H, W, D, G, s);
  if (dtype == 1) return launch<__nv_bfloat16>(left, right, out, B, C, H, W, D, G, s);
  return cudaErrorInvalidValue;
}
