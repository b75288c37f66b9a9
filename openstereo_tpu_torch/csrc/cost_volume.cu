// Correlation volumes for Hopper (sm_90a), NCHW in, NCDHW out: K1 and K3 in one kernel.
//
// Replaces the TPU kernel `_corr_kernel` and its one `pallas_call` in
// `correlation_volume_pallas` (openstereo_tpu/ops/pallas/corr_volume.py), which
// serves both functions: num_groups = 1 is the correlation volume (K1,
// LightStereo), num_groups > 1 the group-wise volume of `build_gwc_volume_pallas`
// (K3, GwcNet):
//
//     out[b,g,d,h,w] = (1/div) * sum_{c<cg} round_T(L[b,g*cg+c,h,w] * R[b,g*cg+c,h,w-d]),
//     cg = C/G,  0 where w-d < 0 (so planes with d >= W are 0)
//
// The divisor `div` is cg for the mean of K1 and K3, and 1 for the plain sum
// that FoundationStereo's cosine volume takes over its L2-normalised features
// (`openstereo_tpu/models/foundationstereo/foundationstereo.py:60-74`).
//
// round_T rounds each product to T, as JAX's `l * r` does
// (`openstereo_tpu/ops/cost_volume.py:correlation_volume` and
// `groupwise_correlation`, which the JAX models run) and as the plain version
// (`ops/cost_volume.py:groupwise_correlation`) does. The sum is f32, divided by
// div, and rounded once to T. A [B,1,D,H,W] volume is the same memory as
// [B,D,H,W], so G = 1 is K1.
//
// In f32 the kernel sums in the order of PyTorch's CUDA mean over the group's
// channels (four partial sums, partial k taking channels c = k mod 4 in
// channel order, then ((s0 + s1) + s2) + s3) and multiplies by the f32
// reciprocal of div, as that mean does (and by 1, exactly, for the sum), so that it equals the plain version bit
// for bit where cg < 64 (from 64 on, that mean splits a sum over warps, and
// the two differ by about an ulp). A model whose sample grids are floors of
// its prediction (CFNet) then takes the same grids on both paths: one ulp in
// the volume moves a floor at some pixels. In bf16 the order is the tiling's;
// the rounding to bf16 hides it at all but a few values.
//
// What bounds it on this card: bytes. At GwcNet's shape (C 320, G 40, D 48,
// 136x240, bf16) it reads 41.8 MB and writes 125.3 MB for 0.90 GFLOP, about 5
// flops per byte: the tensor cores would idle at that intensity (and `mma`
// would not round the products where JAX does). The volume it writes is 3x
// what it reads, so the aim is to write it at the memory rate. The products
// come next: each is a bf16 rounding and an f32 add, 0.5 G of them at that
// shape, and on the H100 they, not the bytes, set the time (PERF.md).
//
// What the design does about it:
// - A block owns a tile: one row h of one group g, 8*twc columns and every
//   disparity. It stages the tile's left rows and right rows (with 8*n_dc
//   columns more on the left, the disparity range) in shared memory, bf16 as
//   bf16, cc channels at a time, by 16-byte `cp.async`: three stages in a ring,
//   so the next two chunks or tiles are in flight while one is computed.
//   Columns outside the frame are staged as zeros (the copy's zero fill), so
//   planes with d > w come out 0 with no test in the inner loop.
// - A thread owns 8 consecutive columns x 8 disparities of the tile and keeps
//   their 64 sums in f32 registers. Per channel it reads 3 16-byte vectors from
//   shared memory: 8 left values and the right window of 16 columns. bf16: each
//   product is one `fma.rn.bf16x2` of (0, l) and a pair whose high half is the
//   right value, plus (+0, +0): the high half is the rounded product, the low
//   half +0, so the 32-bit word is that product as an f32 and goes straight
//   into an f32 add (2 instructions a product, no unpacking).
// - Where the tiles would leave the card's resident threads idle (K1), each
//   item's channels are split over `cs` adjacent lanes whose partial sums meet
//   in a butterfly of shuffles; tiles shrink until there are enough of them.
//   f32 always takes cs = 4: lane k holds the partial sum of channels k mod 4,
//   and the four meet in lane order (PyTorch's order, above).
// - Each disparity's 8 results leave as one 16-byte store from registers,
//   lanes along w, so a warp's stores are runs along W.
// - The grid is what the card holds at once (SM count x resident blocks per
//   SM), each block taking tiles a grid apart.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>

#include "mma_bf16.cuh"

namespace {

constexpr int CW = 8;       // columns per thread
constexpr int DPT = 8;      // disparities per thread
constexpr int STAGES = 3;   // shared-memory ring
constexpr int CC_MAX = 32;  // channels per staged chunk
constexpr int NT_MAX = 192;  // threads per block at most; 2 blocks per SM leave 170 registers
constexpr int F32_LANES = 4;  // PyTorch's CUDA reduction keeps 4 partial sums a thread

struct Plan {
  int n_dc, n_wc, twc, n_wt, cs, cc, n_chunks, nt, tiles, pad;
  size_t stage;  // elements of one stage
};

// 8 consecutive values (16 bytes of bf16, 32 of f32) from shared memory
template <typename T> struct Vec8;
template <> struct Vec8<__nv_bfloat16> {
  uint32_t u[4];  // pairs, the lower column in the low half
  __device__ __forceinline__ void load(const __nv_bfloat16* p) {
    const uint4 q = *reinterpret_cast<const uint4*>(p);
    u[0] = q.x, u[1] = q.y, u[2] = q.z, u[3] = q.w;
  }
};
template <> struct Vec8<float> {
  float f[8];
  __device__ __forceinline__ void load(const float* p) {
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    f[0] = a.x, f[1] = a.y, f[2] = a.z, f[3] = a.w, f[4] = b.x, f[5] = b.y, f[6] = b.z, f[7] = b.w;
  }
};

__device__ __forceinline__ uint32_t fma_bf16x2(uint32_t a, uint32_t b, uint32_t c) {
  uint32_t d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// one channel: acc[k][j] += round_T(l[j] * win[j - k + 8]) for disparity d0 + k
// and column w0 + j, where win = ra ++ rb holds the right columns w0 - d0 - 8 + i
__device__ __forceinline__ void step(float (&acc)[DPT][CW], const Vec8<__nv_bfloat16>& l,
                                     const Vec8<__nv_bfloat16>& ra,
                                     const Vec8<__nv_bfloat16>& rb) {
  uint32_t lz[CW];  // (+0, l[j]): l[j] in the high half
#pragma unroll
  for (int m = 0; m < 4; ++m) lz[2 * m] = l.u[m] << 16, lz[2 * m + 1] = l.u[m] & 0xffff0000u;
  const uint32_t wd[8] = {ra.u[0], ra.u[1], ra.u[2], ra.u[3], rb.u[0], rb.u[1], rb.u[2], rb.u[3]};
  uint32_t sh[7];  // (win[2i+1], win[2i+2]): win[2i+2] in the high half
#pragma unroll
  for (int i = 0; i < 7; ++i) sh[i] = __byte_perm(wd[i], wd[i + 1], 0x5432);
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int i = j - k + 8;  // 1..15; win[i] is the high half of wd[i/2] (i odd) or sh[i/2-1]
      const uint32_t x = (i % 2) ? wd[i / 2] : sh[i / 2 - 1];
      // high half: l[j] * win[i] rounded to bf16; low half: 0 * x + 0 = +0
      acc[k][j] += __uint_as_float(fma_bf16x2(lz[j], x, 0u));
    }
  }
}

// f32: each product rounded, then added (no FMA), as the plain version's
// product tensor and mean round
__device__ __forceinline__ void step(float (&acc)[DPT][CW], const Vec8<float>& l,
                                     const Vec8<float>& ra, const Vec8<float>& rb) {
#pragma unroll
  for (int k = 0; k < DPT; ++k) {
#pragma unroll
    for (int j = 0; j < CW; ++j) {
      const int i = j - k + 8;
      acc[k][j] = __fadd_rn(acc[k][j], __fmul_rn(l.f[j], i < 8 ? ra.f[i] : rb.f[i - 8]));
    }
  }
}

// 8 results of one disparity to columns w .. w+7 of a row, those < W
__device__ __forceinline__ void store8(__nv_bfloat16* row, const float (&v)[CW], int w, int W,
                                       bool vec) {
  uint32_t u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = mma::pack(v[2 * i], v[2 * i + 1]);
  if (vec && w + CW <= W) {
    *reinterpret_cast<uint4*>(row + w) = make_uint4(u[0], u[1], u[2], u[3]);
  } else {
    unsigned short* r = reinterpret_cast<unsigned short*>(row);
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (w + j < W) r[w + j] = static_cast<unsigned short>(u[j / 2] >> (16 * (j % 2)));
  }
}

__device__ __forceinline__ void store8(float* row, const float (&v)[CW], int w, int W, bool vec) {
  if (vec && w + CW <= W) {
    *reinterpret_cast<float4*>(row + w) = make_float4(v[0], v[1], v[2], v[3]);
    *reinterpret_cast<float4*>(row + w + 4) = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int j = 0; j < CW; ++j)
      if (w + j < W) row[w + j] = v[j];
  }
}

// Stage channels [c0, c0 + n) of a tile into `s` (`row` points at channel c0):
// left rows [n][tw] of columns w_s .., then right rows [n][pad + tw] of columns
// w_s - pad .., zeros outside the frame. With `vec` (16-byte aligned rows, W a
// multiple of 16 bytes, so a vector is wholly in or out) by cp.async, else
// element by element.
template <typename T>
__device__ __forceinline__ void stage(T* s, const T* left, const T* right, const Plan& p,
                                      size_t row, int w_s, int n, int W, size_t plane, bool vec) {
  constexpr int E = 16 / sizeof(T);  // elements per 16-byte vector
  const int tw = p.twc * CW, rw = p.pad + tw;
  T* sl = s;
  T* sr = s + static_cast<size_t>(p.cc) * tw;
  if (vec) {
    const int vl = tw / E, vr = rw / E;
    for (int v = threadIdx.x; v < n * (vl + vr); v += blockDim.x) {
      const bool is_l = v < n * vl;
      const int u = is_l ? v : v - n * vl, per = is_l ? vl : vr;
      const int c = u / per, col = (u % per) * E + (is_l ? w_s : w_s - p.pad);
      const T* src = (is_l ? left : right) + row + c * plane;
      const bool in = col >= 0 && col < W;
      mma::cp16((is_l ? sl + c * tw : sr + c * rw) + (u % per) * E, in ? src + col : src, in);
    }
  } else {
    for (int e = threadIdx.x; e < n * (tw + rw); e += blockDim.x) {
      const bool is_l = e < n * tw;
      const int u = is_l ? e : e - n * tw, per = is_l ? tw : rw;
      const int c = u / per, col = u % per + (is_l ? w_s : w_s - p.pad);
      const T* src = (is_l ? left : right) + row + c * plane;
      (is_l ? sl + c * tw : sr + c * rw)[u % per] = (col >= 0 && col < W) ? src[col] : T(0.f);
    }
  }
}

// tile t: (b, g, h, w-tile), the w-tile fastest
struct Tile {
  size_t in, out;  // offsets of its first input row and of row h of output plane (b, g, 0)
  int w_s;         // its first column
};

__device__ __forceinline__ Tile tile_at(int t, const Plan& p, int C, int H, int W, int D, int G) {
  const int wt = t % p.n_wt;
  t /= p.n_wt;
  const int h = t % H;
  t /= H;
  const int g = t % G, b = t / G;
  const size_t plane = static_cast<size_t>(H) * W;
  return {(static_cast<size_t>(b) * C + static_cast<size_t>(g) * (C / G)) * plane +
              static_cast<size_t>(h) * W,
          (static_cast<size_t>(b) * G + g) * D * plane + static_cast<size_t>(h) * W,
          wt * p.twc * CW};
}

// Thread x of a block: lane `part` = x % cs of item x / cs of the tile, the
// item's column chunk (x / cs) % twc fastest, then its disparity chunk. A
// block's threads run every task of the block (the same trip count), so whole
// warps take part in the shuffles; threads without an item compute zeros or
// columns beyond the tile and store nothing.
template <typename T>
__global__ void __launch_bounds__(NT_MAX, 2)
cv_kernel(const T* __restrict__ left, const T* __restrict__ right, T* __restrict__ out, int C,
          int H, int W, int D, int G, int div, Plan p, bool vec) {
  constexpr bool f32 = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* smem = reinterpret_cast<T*>(smem_raw);
  const int cg = C / G, tw = p.twc * CW, rw = p.pad + tw;
  const size_t plane = static_cast<size_t>(H) * W;
  const int x = threadIdx.x, part = x % p.cs, item = x / p.cs;
  const int wcl = item % p.twc, dc = item / p.twc;
  const bool has_item = dc < p.n_dc;
  const int w0l = wcl * CW, d0 = (has_item ? dc : 0) * DPT;
  const int run = (p.cc + p.cs - 1) / p.cs;  // a lane's channels of a chunk
  const int my_tiles =
      static_cast<int>(blockIdx.x) < p.tiles ? (p.tiles - 1 - blockIdx.x) / gridDim.x + 1 : 0;
  const int tasks = my_tiles * p.n_chunks;

  // task q's copies into stage q % STAGES; every thread commits a group, empty
  // or not, so that the groups count alike
  auto issue = [&](int q) {
    if (q < tasks) {
      const Tile t = tile_at(blockIdx.x + (q / p.n_chunks) * gridDim.x, p, C, H, W, D, G);
      const int c0 = (q % p.n_chunks) * p.cc;
      stage(smem + (q % STAGES) * p.stage, left, right, p, t.in + c0 * plane, t.w_s,
            min(p.cc, cg - c0), W, plane, vec);
    }
    mma::cp_commit();
  };

  float acc[DPT][CW];
#pragma unroll
  for (int k = 0; k < DPT; ++k)
#pragma unroll
    for (int j = 0; j < CW; ++j) acc[k][j] = 0.f;

  for (int q = 0; q < STAGES - 1; ++q) issue(q);
  for (int q = 0; q < tasks; ++q) {
    mma::cp_wait<STAGES - 2>();
    __syncthreads();  // task q's stage has landed, and every thread is done with task q - 1
    issue(q + STAGES - 1);

    const int chunk = q % p.n_chunks;
    const int n = min(p.cc, cg - chunk * p.cc);
    const T* sl = smem + (q % STAGES) * p.stage + w0l;
    const T* sr = smem + (q % STAGES) * p.stage + static_cast<size_t>(p.cc) * tw + p.pad +
                  w0l - d0 - CW;
    // bf16: a run of channels; f32: the chunk's channels c = part mod 4 (cs is 4)
    const int c_first = f32 ? (part - chunk * p.cc % F32_LANES + F32_LANES) % F32_LANES
                            : part * run;
    const int c_end = f32 ? n : min(n, (part + 1) * run), c_step = f32 ? F32_LANES : 1;
    for (int c = c_first; c < c_end; c += c_step) {
      Vec8<T> l, ra, rb;
      l.load(sl + c * tw);
      ra.load(sr + c * rw);
      rb.load(sr + c * rw + CW);
      step(acc, l, ra, rb);
    }
    if (chunk + 1 < p.n_chunks) continue;

    // the tile's last chunk: the lanes of an item meet, and the item is stored
    if constexpr (f32) {
      // in lane order, ((s0 + s1) + s2) + s3, the same value in each lane
      const int base = (threadIdx.x & 31) & ~(F32_LANES - 1);
#pragma unroll
      for (int k = 0; k < DPT; ++k)
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          float v = __shfl_sync(0xffffffffu, acc[k][j], base);
#pragma unroll
          for (int m = 1; m < F32_LANES; ++m)
            v = __fadd_rn(v, __shfl_sync(0xffffffffu, acc[k][j], base + m));
          acc[k][j] = v;
        }
    } else {
      for (int m = 1; m < p.cs; m <<= 1)
#pragma unroll
        for (int k = 0; k < DPT; ++k)
#pragma unroll
          for (int j = 0; j < CW; ++j) acc[k][j] += __shfl_xor_sync(0xffffffffu, acc[k][j], m);
    }
    const Tile t = tile_at(blockIdx.x + (q / p.n_chunks) * gridDim.x, p, C, H, W, D, G);
    const int w0 = t.w_s + w0l;
    if (has_item && w0 < W) {
      const bool pow2 = (div & (div - 1)) == 0;
      const float divf = static_cast<float>(div), inv = 1.f / divf;
      T* orow = out + t.out + static_cast<size_t>(d0) * plane;
#pragma unroll
      for (int k = 0; k < DPT; ++k) {
        if (k % p.cs != part || d0 + k >= D) continue;
        float v[CW];
#pragma unroll
        for (int j = 0; j < CW; ++j) {
          // f32: acc * (1/div), as PyTorch's mean scales; bf16: the rounded f32
          // quotient acc / div, as JAX's mean divides: acc * (1/div), exact for
          // a power of two (the sum's div 1 among them), else refined by one FMA
          // step (Markstein)
          const float q0 = __fmul_rn(acc[k][j], inv);
          v[j] = f32 || pow2 ? q0 : fmaf(fmaf(-q0, divf, acc[k][j]), inv, q0);
        }
        store8(orow + k * plane, v, w0, W, vec);
      }
    }
#pragma unroll
    for (int k = 0; k < DPT; ++k)
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[k][j] = 0.f;
  }
  mma::cp_wait<0>();
}

// The tiling for this card: `cs` lanes per item while the items alone would
// fill under a quarter of the card's resident threads (f32: always 4, so D is
// at most 8 * NT_MAX / 4 = 384 there); tiles of at most NT_MAX threads, halved
// while there are fewer than 4 per SM; channel chunks of at most CC_MAX that
// fit the shared memory a block may use.
template <typename T>
cudaError_t make_plan(Plan* p, int B, int C, int H, int W, int D, int G, int* grid) {
  int dev = 0, sms = 0, smem_max = 0, threads_sm = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&threads_sm, cudaDevAttrMaxThreadsPerMultiProcessor, dev);
  if (err != cudaSuccess) return err;
  const int cg = C / G;
  p->n_dc = (D + DPT - 1) / DPT;
  p->n_wc = (W + CW - 1) / CW;
  p->pad = DPT * p->n_dc;
  if (p->n_dc > NT_MAX) return cudaErrorInvalidValue;
  const long long rows = static_cast<long long>(B) * G * H;
  const long long items = rows * p->n_dc * p->n_wc;
  const long long resident = static_cast<long long>(sms) * threads_sm;
  p->cs = 1;
  if (std::is_same<T, float>::value) {
    p->cs = F32_LANES;
    if (p->n_dc * p->cs > NT_MAX) return cudaErrorInvalidValue;
  }
  while (!std::is_same<T, float>::value && p->cs < 8 && 2 * p->cs <= cg &&
         p->n_dc * 2 * p->cs <= NT_MAX && items * 2 * p->cs <= resident / 4)
    p->cs *= 2;
  p->twc = p->n_wc;
  while (p->twc > 1 && p->n_dc * p->twc * p->cs > NT_MAX) p->twc = (p->twc + 1) / 2;
  while (p->twc > 1 && rows * ((p->n_wc + p->twc - 1) / p->twc) < 4LL * sms)
    p->twc = (p->twc + 1) / 2;
  p->cc = cg < CC_MAX ? cg : CC_MAX;
  auto bytes = [&]() {
    return static_cast<size_t>(p->cc) * (2 * p->twc * CW + p->pad) * sizeof(T) * STAGES;
  };
  while (bytes() > static_cast<size_t>(smem_max) && (p->twc > 1 || p->cc > 1))
    if (p->twc > 1) p->twc = (p->twc + 1) / 2;
    else p->cc = (p->cc + 1) / 2;
  if (bytes() > static_cast<size_t>(smem_max)) return cudaErrorInvalidValue;
  p->n_wt = (p->n_wc + p->twc - 1) / p->twc;
  p->n_chunks = (cg + p->cc - 1) / p->cc;
  p->nt = (p->n_dc * p->twc * p->cs + 31) / 32 * 32;
  p->stage = static_cast<size_t>(p->cc) * (2 * p->twc * CW + p->pad);
  if (rows * p->n_wt >= (1LL << 31)) return cudaErrorInvalidValue;
  p->tiles = static_cast<int>(rows * p->n_wt);
  const size_t smem = bytes();
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(cv_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, cv_kernel<T>, p->nt, smem);
  if (err != cudaSuccess) return err;
  const long long blocks = static_cast<long long>(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = static_cast<int>(p->tiles < blocks ? p->tiles : blocks);
  return cudaSuccess;
}

template <typename T>
cudaError_t launch(const void* left, const void* right, void* out, int B, int C, int H, int W,
                   int D, int G, int div, cudaStream_t stream) {
  Plan p;
  int grid = 0;
  cudaError_t err = make_plan<T>(&p, B, C, H, W, D, G, &grid);
  if (err != cudaSuccess) return err;
  // 16-byte copies and stores need every row start (a multiple of W elements)
  // 16-byte aligned
  const bool vec = (static_cast<size_t>(W) * sizeof(T)) % 16 == 0 &&
                   (reinterpret_cast<uintptr_t>(left) | reinterpret_cast<uintptr_t>(right) |
                    reinterpret_cast<uintptr_t>(out)) % 16 == 0;
  cv_kernel<T><<<grid, p.nt, p.stage * sizeof(T) * STAGES, stream>>>(
      static_cast<const T*>(left), static_cast<const T*>(right), static_cast<T*>(out), C, H, W,
      D, G, div, p, vec);
  return cudaGetLastError();
}

cudaError_t dispatch(const void* left, const void* right, void* out, int B, int C, int H, int W,
                     int D, int G, int div, int dtype, void* stream) {
  if (B <= 0 || C <= 0 || H <= 0 || W <= 0 || D <= 0 || G <= 0 || C % G != 0 || div <= 0)
    return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch<float>(left, right, out, B, C, H, W, D, G, div, s);
  if (dtype == 1) return launch<__nv_bfloat16>(left, right, out, B, C, H, W, D, G, div, s);
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. left/right are contiguous [B,C,H,W] on the
// device; out is a contiguous [B,D,H,W] (corr) or [B,G,D,H,W] (gwc, G dividing C).
// gwc's `div` divides each sum: C/G for the group-wise mean, 1 for the sum.
extern "C" cudaError_t corr_volume_launch(const void* left, const void* right, void* out, int B,
                                          int C, int H, int W, int D, int dtype, void* stream) {
  return dispatch(left, right, out, B, C, H, W, D, 1, C, dtype, stream);
}

extern "C" cudaError_t gwc_volume_launch(const void* left, const void* right, void* out, int B,
                                         int C, int H, int W, int D, int G, int div, int dtype,
                                         void* stream) {
  return dispatch(left, right, out, B, C, H, W, D, G, div, dtype, stream);
}
