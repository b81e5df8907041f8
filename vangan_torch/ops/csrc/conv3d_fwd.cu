// Direct 3-D convolution forward for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/conv3d.py::_conv_fwd
// (bodies _fwd_kernel / _fwd_kernel_b). That kernel exists because XLA pads
// small channel counts to 128 TPU lanes; its z-select matmuls, lane padding
// and slab DMA are TPU workarounds and are not carried over.
//
// What bounds it on the card: the generator's small-channel convs
// (max(Ci, Co) < 128) do 27 * Ci FMAs per output voxel and channel, which at
// 128^3 is 10-90 GFLOP per patch, so the kernel is compute-bound once input
// reads hit L1/L2. This first version runs on the CUDA cores in f32 (no
// tensor cores): each thread owns one output voxel and CO_T output channels,
// so one input load feeds CO_T FMAs; the weights of a Ci-tile are staged in
// shared memory (the full 96*27*32 f32 slab would not fit in 227 KB) and read
// as warp-wide broadcasts. Threads of a block walk neighbouring z voxels, so
// input loads coalesce. Padding (zero or reflect, numpy semantics for any
// width) is an index mapping, so no padded copy of the input is made.
// An implicit-GEMM wgmma/TMA version is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int CO_T = 16;      // output channels per thread
constexpr int THREADS = 128;  // output voxels per block
constexpr int SMEM_FLOATS = 12288;  // 48 KB of staged weights
constexpr int KMAX = 8;       // largest kernel extent per axis

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// Coordinate i of the padded axis -> index into [0, n), or -1 for a zero pad.
// Reflect follows numpy/jnp.pad 'reflect' for any pad width (period 2(n-1)).
__device__ __forceinline__ int map_index(int i, int n, int reflect) {
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

// acc[j] += v * w[j] for the CO_T weights of one tap (shared-memory broadcasts).
__device__ __forceinline__ void accumulate(float* acc, float v, const float4* wt) {
#pragma unroll
  for (int j = 0; j < CO_T / 4; ++j) {
    const float4 wv = wt[j];
    acc[4 * j + 0] = fmaf(v, wv.x, acc[4 * j + 0]);
    acc[4 * j + 1] = fmaf(v, wv.y, acc[4 * j + 1]);
    acc[4 * j + 2] = fmaf(v, wv.z, acc[4 * j + 2]);
    acc[4 * j + 3] = fmaf(v, wv.w, acc[4 * j + 3]);
  }
}

// K > 0: a cubic K^3 kernel known at compile time; K == 0: any kx, ky, kz <= KMAX.
template <typename T, int K>
__global__ void __launch_bounds__(THREADS)
conv3d_fwd_kernel(const T* __restrict__ x, const T* __restrict__ w,
                  const T* __restrict__ bias, T* __restrict__ y,
                  int Ci, int Co, int X, int Y, int Z, int Xo, int Yo, int Zo,
                  int kx, int ky, int kz, int sx, int sy, int sz,
                  int px, int py, int pz, int reflect, int ci_tile) {
  extern __shared__ float4 w_s4[];  // [ci_tile][taps][CO_T] floats
  float* w_s = reinterpret_cast<float*>(w_s4);
  if (K > 0) { kx = K; ky = K; kz = K; }
  const int taps = kx * ky * kz;
  const int co0 = blockIdx.y * CO_T;
  const int b = blockIdx.z;
  const long long nout = (long long)Xo * Yo * Zo;
  const long long o = (long long)blockIdx.x * THREADS + threadIdx.x;
  const bool active = o < nout;

  int ox = 0, oy = 0, oz = 0;
  if (active) {
    oz = (int)(o % Zo);
    const long long t = o / Zo;
    oy = (int)(t % Yo);
    ox = (int)(t / Yo);
  }
  constexpr int KA = K > 0 ? K : KMAX;
  int xoff[KA], yoff[KA], zoff[KA];  // element offsets per tap, -1 = zero pad
#pragma unroll
  for (int d = 0; d < KA; ++d) {
    const int ix = d < kx ? map_index(ox * sx + d - px, X, reflect) : -1;
    const int iy = d < ky ? map_index(oy * sy + d - py, Y, reflect) : -1;
    const int iz = d < kz ? map_index(oz * sz + d - pz, Z, reflect) : -1;
    xoff[d] = ix < 0 ? -1 : ix * Y * Z;
    yoff[d] = iy < 0 ? -1 : iy * Z;
    zoff[d] = iz;
  }

  float acc[CO_T];
#pragma unroll
  for (int j = 0; j < CO_T; ++j) acc[j] = 0.f;

  const long long plane = (long long)X * Y * Z;
  const T* xb = x + (long long)b * Ci * plane;
  for (int c0 = 0; c0 < Ci; c0 += ci_tile) {
    const int cn = min(ci_tile, Ci - c0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * taps * CO_T; i += THREADS) {
      const int col = i % CO_T;
      const int r = i / CO_T;
      const int tap = r % taps;
      const int cil = r / taps;
      const int co = co0 + col;
      w_s[i] = co < Co ? to_f(w[((long long)co * Ci + c0 + cil) * taps + tap]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int cil = 0; cil < cn; ++cil) {
      const T* xc = xb + (long long)(c0 + cil) * plane;
      const float4* ws = w_s4 + cil * taps * (CO_T / 4);
      if constexpr (K > 0) {
#pragma unroll
        for (int dx = 0; dx < K; ++dx) {
          if (xoff[dx] < 0) continue;
#pragma unroll
          for (int dy = 0; dy < K; ++dy) {
            if (yoff[dy] < 0) continue;
            const T* row = xc + xoff[dx] + yoff[dy];
#pragma unroll
            for (int dz = 0; dz < K; ++dz) {
              if (zoff[dz] < 0) continue;
              accumulate(acc, to_f(row[zoff[dz]]), ws + ((dx * K + dy) * K + dz) * (CO_T / 4));
            }
          }
        }
      } else {  // any kx, ky, kz: one rolled loop over the taps
        for (int t = 0; t < taps; ++t) {
          const int dz = t % kz, dy = (t / kz) % ky, dx = t / (ky * kz);
          if (xoff[dx] < 0 || yoff[dy] < 0 || zoff[dz] < 0) continue;
          accumulate(acc, to_f(xc[xoff[dx] + yoff[dy] + zoff[dz]]), ws + t * (CO_T / 4));
        }
      }
    }
  }
  if (!active) return;
#pragma unroll
  for (int j = 0; j < CO_T; ++j) {
    const int co = co0 + j;
    if (co < Co) {
      const float bv = bias != nullptr ? to_f(bias[co]) : 0.f;
      y[((long long)b * Co + co) * nout + o] = from_f<T>(acc[j] + bv);
    }
  }
}

template <typename T, int K>
void launch(const void* x, const void* w, const void* bias, void* y, int B, int Ci,
            int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
            int kz, int sx, int sy, int sz, int px, int py, int pz, int reflect,
            cudaStream_t stream) {
  const int taps = kx * ky * kz;
  int ci_tile = SMEM_FLOATS / (taps * CO_T);
  if (ci_tile > Ci) ci_tile = Ci;
  const size_t smem = (size_t)ci_tile * taps * CO_T * sizeof(float);
  const long long nout = (long long)Xo * Yo * Zo;
  dim3 grid((unsigned)((nout + THREADS - 1) / THREADS), (Co + CO_T - 1) / CO_T, B);
  conv3d_fwd_kernel<T, K><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<const T*>(bias),
      static_cast<T*>(y), Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, sz, px, py,
      pz, reflect, ci_tile);
}

template <typename T>
void dispatch(const void* x, const void* w, const void* bias, void* y, int B, int Ci,
              int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
              int kz, int sx, int sy, int sz, int px, int py, int pz, int reflect,
              cudaStream_t s) {
  const bool cubic = kx == ky && ky == kz;
#define VG_LAUNCH(KK)                                                                \
  launch<T, KK>(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, \
                sz, px, py, pz, reflect, s)
  if (cubic && kx == 1) VG_LAUNCH(1);
  else if (cubic && kx == 3) VG_LAUNCH(3);
  else if (cubic && kx == 4) VG_LAUNCH(4);
  else VG_LAUNCH(0);
#undef VG_LAUNCH
}

}  // namespace

// C entry point, bound with ctypes. x (B,Ci,X,Y,Z), w (Co,Ci,kx,ky,kz),
// bias (Co,) or NULL, y (B,Co,Xo,Yo,Zo), all contiguous in one dtype
// (0 = float32, 1 = bfloat16). Returns cudaGetLastError() after the launch;
// 1000 for an argument the kernel does not take.
extern "C" int vg_conv3d_fwd(const void* x, const void* w, const void* bias, void* y,
                             int dtype, int B, int Ci, int Co, int X, int Y, int Z,
                             int Xo, int Yo, int Zo, int kx, int ky, int kz, int sx,
                             int sy, int sz, int px, int py, int pz, int reflect,
                             void* stream) {
  if (kx < 1 || ky < 1 || kz < 1 || kx > KMAX || ky > KMAX || kz > KMAX) return 1000;
  if (B < 1 || Ci < 1 || Co < 1 || Xo < 1 || Yo < 1 || Zo < 1) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy,
                    sz, px, py, pz, reflect, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz,
                            sx, sy, sz, px, py, pz, reflect, s);
  else
    return 1000;
  return (int)cudaGetLastError();
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* vg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
