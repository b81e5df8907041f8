// Fused InstanceNorm + activation backward for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernels vangan_tpu/ops/pallas/instnorm.py::bwd_reduce_sums
// (body _bwd_reduce_kernel) and ::bwd_dx (body _bwd_dx_kernel). For
// y = act((x - mean)*a + beta), a = gamma*inv, xhat = (x - mean)*inv:
//
//   g'  = g * act'(pre), pre recomputed from x exactly as instnorm_fwd.cu
//         computes it (so act' sees the forward's values)
//   dx  = a * (g' - sum(g')/n - xhat * sum(xhat*g')/n)
//
// and the caller sums the per-(b, c) sums over b for dbeta = sum(g') and
// dgamma = sum(xhat*g'). The elementwise body is f32 and dx is rounded to
// x's dtype once: a bf16 body rounds the broadcast centring constants
// coherently over a whole plane and biases the sums that consume dx (the TPU
// kernel's note, instnorm.py:240-245).
//
// What bounds it on the card: memory bandwidth. x and g are read twice
// (reduce, then dx) and dx written once, with a few flops per element. As in
// the forward, the reduction is split over `nsplit` blocks per (b, c) plane
// that write partial sums, a tiny pass adds them in a fixed order, and the dx
// pass streams 16-byte vectors.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T v[V];
};

__device__ __forceinline__ void chunk_range(long long N, int nsplit, int V, int s,
                                            long long& lo, long long& hi) {
  long long chunk = (N + nsplit - 1) / nsplit;
  chunk = (chunk + V - 1) / V * V;
  lo = s * chunk;
  hi = lo + chunk < N ? lo + chunk : N;
}

// act'(pre): 0 none, 1 relu (0 at pre = 0), 2 leaky relu (1 at pre = 0), as
// the autograd of the plain version.
__device__ __forceinline__ float act_grad(float pre, int act, float alpha) {
  if (act == 1) return pre > 0.f ? 1.f : 0.f;
  if (act == 2) return pre >= 0.f ? 1.f : alpha;
  return 1.f;
}

// Pass 1 (K5a): grid (B*C, nsplit). partial[(bc*nsplit + s)*2 + {0,1}] =
// sum(g'), sum(xhat*g') over the block's chunk.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g,
                     const float* __restrict__ ab, float* __restrict__ partial, long long N,
                     int nsplit, int act, float alpha) {
  const int s = blockIdx.y;
  const long long bc = blockIdx.x;
  long long lo, hi;
  chunk_range(N, nsplit, V, s, lo, hi);
  const float m = ab[4 * bc], a = ab[4 * bc + 1], b = ab[4 * bc + 2], inv = ab[4 * bc + 3];
  const T* px = x + bc * N;
  const T* pg = g + bc * N;
  float sg = 0.f, sxg = 0.f;
  for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += (long long)THREADS * V) {
    const Vec<T, V> vx = *reinterpret_cast<const Vec<T, V>*>(px + i);
    const Vec<T, V> vg = *reinterpret_cast<const Vec<T, V>*>(pg + i);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xc = to_f(vx.v[k]) - m;
      const float gp = to_f(vg.v[k]) * act_grad(fmaf(xc, a, b), act, alpha);
      sg += gp;
      sxg = fmaf(xc * inv, gp, sxg);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    sg += __shfl_down_sync(0xffffffffu, sg, off);
    sxg += __shfl_down_sync(0xffffffffu, sxg, off);
  }
  __shared__ float sh[2][THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = sg;
    sh[1][warp] = sxg;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < THREADS / 32; ++k) {
      sg += sh[0][k];
      sxg += sh[1][k];
    }
    float* out = partial + (bc * nsplit + s) * 2;
    out[0] = sg;
    out[1] = sxg;
  }
}

// Pass 2: one thread per (b, c) plane. sums[bc*2 + {0,1}] = sum(g'), sum(xhat*g').
__global__ void in_bwd_sums_kernel(const float* __restrict__ partial, float* __restrict__ sums,
                                   int BC, int nsplit) {
  const int bc = blockIdx.x * blockDim.x + threadIdx.x;
  if (bc >= BC) return;
  float sg = 0.f, sxg = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    sg += partial[((long long)bc * nsplit + s) * 2];
    sxg += partial[((long long)bc * nsplit + s) * 2 + 1];
  }
  sums[2 * bc] = sg;
  sums[2 * bc + 1] = sxg;
}

// Pass 3 (K5b): grid (B*C, nsplit). dx = a*(g' - c1 - xhat*c2), c1 = sum(g')/n,
// c2 = sum(xhat*g')/n.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ ab,
                 const float* __restrict__ sums, T* __restrict__ dx, long long N, int nsplit,
                 int act, float alpha) {
  const int s = blockIdx.y;
  const long long bc = blockIdx.x;
  long long lo, hi;
  chunk_range(N, nsplit, V, s, lo, hi);
  const float m = ab[4 * bc], a = ab[4 * bc + 1], b = ab[4 * bc + 2], inv = ab[4 * bc + 3];
  const float c1 = sums[2 * bc] / (float)N, c2 = sums[2 * bc + 1] / (float)N;
  const T* px = x + bc * N;
  const T* pg = g + bc * N;
  T* pd = dx + bc * N;
  for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += (long long)THREADS * V) {
    const Vec<T, V> vx = *reinterpret_cast<const Vec<T, V>*>(px + i);
    const Vec<T, V> vg = *reinterpret_cast<const Vec<T, V>*>(pg + i);
    Vec<T, V> vout;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xc = to_f(vx.v[k]) - m;
      const float gp = to_f(vg.v[k]) * act_grad(fmaf(xc, a, b), act, alpha);
      vout.v[k] = from_f<T>(a * (gp - c1 - xc * inv * c2));
    }
    *reinterpret_cast<Vec<T, V>*>(pd + i) = vout;
  }
}

template <typename T, int V>
void run(const void* x, const void* g, const float* ab, float* partial, float* sums, void* dx,
         int BC, long long N, int nsplit, int act, float alpha, cudaStream_t s) {
  const dim3 grid(BC, nsplit);
  in_bwd_reduce_kernel<T, V><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ab, partial, N, nsplit, act, alpha);
  in_bwd_sums_kernel<<<(BC + 127) / 128, 128, 0, s>>>(partial, sums, BC, nsplit);
  in_bwd_dx_kernel<T, V><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x),
                                                  static_cast<const T*>(g), ab, sums,
                                                  static_cast<T*>(dx), N, nsplit, act, alpha);
}

}  // namespace

// C entry point, bound with ctypes. x, g, dx (B, C, X, Y, Z) contiguous in one
// dtype (0 = float32, 1 = bfloat16), N = X*Y*Z; ab (B*C*4,) f32 from the
// forward (mean, a, beta, inv); partial (B*C*nsplit*2,) f32 scratch; sums
// (B*C*2,) f32 out (sum(g'), sum(xhat*g') per plane). vec = 1 when N is a
// multiple of 16 bytes of elements and x, g, dx are 16-byte aligned.
// Returns cudaGetLastError() after the launches; 1000 for a bad argument.
extern "C" int vg_instnorm_bwd(const void* x, const void* g, const float* ab, float* partial,
                               float* sums, void* dx, int dtype, int BC, long long N,
                               int nsplit, int act, float alpha, int vec, void* stream) {
  if (BC < 1 || N < 1 || nsplit < 1 || nsplit > 65535) return 1000;
  if (act < 0 || act > 2) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec) run<float, 4>(x, g, ab, partial, sums, dx, BC, N, nsplit, act, alpha, s);
    else run<float, 1>(x, g, ab, partial, sums, dx, BC, N, nsplit, act, alpha, s);
  } else if (dtype == 1) {
    if (vec) run<__nv_bfloat16, 8>(x, g, ab, partial, sums, dx, BC, N, nsplit, act, alpha, s);
    else run<__nv_bfloat16, 1>(x, g, ab, partial, sums, dx, BC, N, nsplit, act, alpha, s);
  } else {
    return 1000;
  }
  return (int)cudaGetLastError();
}
