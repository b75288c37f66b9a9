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
// would be the limit; and W^2 * nheads exponentials. This first version runs
// on the CUDA cores in f32, so its real limit is the FMA and shared-memory
// load rate of the SMs, far below the tensor-core bound.
//
// What the design does about it: the TPU kernel contracts against a 128-padded
// table and realigns the Toeplitz terms with a hardware shear (pltpu.roll). Here
// shared memory is indexed directly: a block owns one line and TQ query rows,
// and for each key chunk of JC keys it stages k and the TQ+JC-1 table rows that
// the tile touches (row W-1-i+j sits at local row TQ-1-i+jl), so there is no
// skew, padding or reversal. The loop over heads stays inside the block, so the
// head-summed raw scores accumulate in shared memory without atomics. The score
// tile (TQ x W, f32) stays in shared memory for the softmax (one warp per row,
// shuffles for max and sum) and for p.v. Rows are padded to HD+1 floats so the
// lanes of a warp, which walk consecutive keys, hit distinct banks.

#include <cmath>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

namespace {

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

template <typename T, int HD>
cudaError_t launch_hd(const void* q, const void* k, const void* v, const void* ke,
                      const void* qe, void* out, float* raw, int B, int W, int E, int nheads,
                      int masked, cudaStream_t stream) {
  const int sw = W | 1;  // odd row stride: rows of S start in different banks
  const size_t bytes = sizeof(float) * (size_t)smem_floats(HD, sw, raw != nullptr);
  auto kernel = rel_attn_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TQ - 1) / TQ, B);
  kernel<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<const T*>(ke), static_cast<const T*>(qe), static_cast<T*>(out), raw, W, E,
      nheads, masked, sw);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* q, const void* k, const void* v, const void* ke, const void* qe,
                   void* out, float* raw, int B, int W, int E, int nheads, int masked,
                   cudaStream_t s) {
  switch (E / nheads) {
    case 8: return launch_hd<T, 8>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
    case 16: return launch_hd<T, 16>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
    case 32: return launch_hd<T, 32>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
    case 64: return launch_hd<T, 64>(q, k, v, ke, qe, out, raw, B, W, E, nheads, masked, s);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. q, k, v, out: contiguous [B, W, E]; ke, qe:
// contiguous [2W-1, E]; raw: contiguous [B, W, W] f32, or null to skip it.
extern "C" cudaError_t rel_attention_launch(const void* q, const void* k, const void* v,
                                            const void* ke, const void* qe, void* out,
                                            void* raw, int B, int W, int E, int nheads,
                                            int masked, int dtype, void* stream) {
  if (B <= 0 || W <= 0 || nheads <= 0 || E % nheads != 0 || B > 65535)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  float* r = static_cast<float*>(raw);
  if (dtype == 0) return launch<float>(q, k, v, ke, qe, out, r, B, W, E, nheads, masked, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(q, k, v, ke, qe, out, r, B, W, E, nheads, masked, s);
  return cudaErrorInvalidValue;
}
