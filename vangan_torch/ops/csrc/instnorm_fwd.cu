// Fused InstanceNorm + activation forward for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernels vangan_tpu/ops/pallas/instnorm.py::_stats
// (body _stats_kernel) and ::_fwd_impl (body _apply_kernel).
//
// What bounds it on the card: memory bandwidth. The op reads x twice (stats,
// then apply) and writes y once, with a handful of flops per element. In the
// NCXYZ layout every (b, c) plane is one contiguous run of X*Y*Z elements, so
// both passes stream 16-byte vectors. The TPU kernel carried running
// (mean, M2) across its sequential grid; Hopper blocks run in no order, so
// pass 1 splits each plane over `nsplit` blocks that each write a partial
// (n, mean, M2), a tiny pass merges the partials per plane (Chan's parallel
// Welford merge, immune to the E[x^2]-mean^2 cancellation when mean >> std)
// into (mean, a = gamma*inv, beta, inv = rsqrt(var+eps)), and pass 3 writes
// act((x - mean)*a + beta) in the input dtype. Centring before scaling keeps
// f32 precision when mean >> std. Statistics and the affine are f32. The
// four per-plane values stay with the caller for the backward
// (instnorm_bwd.cu), which needs inv itself: a = gamma*inv cannot give it
// back where gamma = 0.

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

// V elements of T in one 16-byte load (V == 1: scalar).
template <typename T, int V>
struct alignas(V * sizeof(T)) Vec {
  T v[V];
};

// Chan's merge of (nb, mb, m2b) into (n, mean, m2).
__device__ __forceinline__ void chan_merge(float& n, float& mean, float& m2, float nb,
                                           float mb, float m2b) {
  if (nb == 0.f) return;
  if (n == 0.f) {
    n = nb;
    mean = mb;
    m2 = m2b;
    return;
  }
  const float nt = n + nb;
  const float d = mb - mean;
  const float f = nb / nt;
  mean += d * f;
  m2 += m2b + d * d * n * f;
  n = nt;
}

__device__ __forceinline__ void chunk_range(long long N, int nsplit, int V, int s,
                                            long long& lo, long long& hi) {
  long long chunk = (N + nsplit - 1) / nsplit;
  chunk = (chunk + V - 1) / V * V;
  lo = s * chunk;
  hi = lo + chunk < N ? lo + chunk : N;
}

// Pass 1: grid (B*C, nsplit). partial[(bc*nsplit + s)*3 + {0,1,2}] = n, mean, M2.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_stats_kernel(const T* __restrict__ x, float* __restrict__ partial, long long N,
                int nsplit) {
  const int s = blockIdx.y;
  const long long bc = blockIdx.x;
  long long lo, hi;
  chunk_range(N, nsplit, V, s, lo, hi);
  const T* p = x + bc * N;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += (long long)THREADS * V) {
    const Vec<T, V> vec = *reinterpret_cast<const Vec<T, V>*>(p + i);
    float f[V];
    float vm = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      f[k] = to_f(vec.v[k]);
      vm += f[k];
    }
    vm *= 1.f / V;
    float vm2 = 0.f;
#pragma unroll
    for (int k = 0; k < V; ++k) vm2 += (f[k] - vm) * (f[k] - vm);
    chan_merge(n, mean, m2, (float)V, vm, vm2);
  }
  // warp, then block merge
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
  __shared__ float sh[3][THREADS / 32];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = n;
    sh[1][warp] = mean;
    sh[2][warp] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int k = 1; k < THREADS / 32; ++k) chan_merge(n, mean, m2, sh[0][k], sh[1][k], sh[2][k]);
    float* out = partial + (bc * nsplit + s) * 3;
    out[0] = n;
    out[1] = mean;
    out[2] = m2;
  }
}

// Pass 2: one thread per (b, c) plane. ab[bc*4 + {0,1,2,3}] = mean, a, beta, inv.
__global__ void in_affine_kernel(const float* __restrict__ partial,
                                 const float* __restrict__ gamma,
                                 const float* __restrict__ beta, float* __restrict__ ab,
                                 int BC, int C, int nsplit, float eps) {
  const int bc = blockIdx.x * blockDim.x + threadIdx.x;
  if (bc >= BC) return;
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const float* q = partial + ((long long)bc * nsplit + s) * 3;
    chan_merge(n, mean, m2, q[0], q[1], q[2]);
  }
  const float var = fmaxf(m2 / n, 0.f);
  const float inv = rsqrtf(var + eps);
  ab[4 * bc] = mean;
  ab[4 * bc + 1] = gamma[bc % C] * inv;
  ab[4 * bc + 2] = beta[bc % C];
  ab[4 * bc + 3] = inv;
}

// Pass 3: grid (B*C, nsplit). y = act((x - mean)*a + beta); act 0 none,
// 1 relu, 2 leaky relu with slope alpha.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_apply_kernel(const T* __restrict__ x, const float* __restrict__ ab, T* __restrict__ y,
                long long N, int nsplit, int act, float alpha) {
  const int s = blockIdx.y;
  const long long bc = blockIdx.x;
  long long lo, hi;
  chunk_range(N, nsplit, V, s, lo, hi);
  const float m = ab[4 * bc], a = ab[4 * bc + 1], b = ab[4 * bc + 2];
  const T* p = x + bc * N;
  T* q = y + bc * N;
  for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += (long long)THREADS * V) {
    const Vec<T, V> vin = *reinterpret_cast<const Vec<T, V>*>(p + i);
    Vec<T, V> vout;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float t = fmaf(to_f(vin.v[k]) - m, a, b);
      if (act == 1) t = fmaxf(t, 0.f);
      else if (act == 2) t = t >= 0.f ? t : alpha * t;
      vout.v[k] = from_f<T>(t);
    }
    *reinterpret_cast<Vec<T, V>*>(q + i) = vout;
  }
}

template <typename T, int V>
void run(const void* x, const float* gamma, const float* beta, void* y, float* partial,
         float* ab, int BC, int C, long long N, int nsplit, float eps, int act,
         float alpha, cudaStream_t s) {
  const dim3 grid(BC, nsplit);
  in_stats_kernel<T, V><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), partial, N,
                                                nsplit);
  in_affine_kernel<<<(BC + 127) / 128, 128, 0, s>>>(partial, gamma, beta, ab, BC, C,
                                                    nsplit, eps);
  in_apply_kernel<T, V><<<grid, THREADS, 0, s>>>(static_cast<const T*>(x), ab,
                                                static_cast<T*>(y), N, nsplit, act, alpha);
}

}  // namespace

// C entry point, bound with ctypes. x and y (B, C, X, Y, Z) contiguous in one
// dtype (0 = float32, 1 = bfloat16), N = X*Y*Z; gamma, beta (C,) f32;
// partial (B*C*nsplit*3,) f32 scratch and ab (B*C*4,) f32 out (mean, a, beta,
// inv per plane, for the backward). vec = 1 when N is a
// multiple of 16 bytes of elements and x, y are 16-byte aligned, else 0.
// Returns cudaGetLastError() after the launches; 1000 for a bad argument.
extern "C" int vg_instnorm_fwd(const void* x, const float* gamma, const float* beta,
                               void* y, float* partial, float* ab, int dtype, int BC,
                               int C, long long N, int nsplit, float eps, int act,
                               float alpha, int vec, void* stream) {
  if (BC < 1 || C < 1 || N < 1 || nsplit < 1 || nsplit > 65535) return 1000;
  if (act < 0 || act > 2) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (vec) run<float, 4>(x, gamma, beta, y, partial, ab, BC, C, N, nsplit, eps, act, alpha, s);
    else run<float, 1>(x, gamma, beta, y, partial, ab, BC, C, N, nsplit, eps, act, alpha, s);
  } else if (dtype == 1) {
    if (vec)
      run<__nv_bfloat16, 8>(x, gamma, beta, y, partial, ab, BC, C, N, nsplit, eps, act, alpha, s);
    else
      run<__nv_bfloat16, 1>(x, gamma, beta, y, partial, ab, BC, C, N, nsplit, eps, act, alpha, s);
  } else {
    return 1000;
  }
  return (int)cudaGetLastError();
}
