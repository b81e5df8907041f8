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
// What bounds it on the card: memory bandwidth. The least traffic reads x and
// g once and writes dx once (6 bytes an element in bf16), but dx needs the
// plane's sums, so each element is used twice. ops/instnorm.py::bwd_plan
// picks the route:
//
// route 0, small planes (up to 4 16-byte vectors per thread and tensor: the
// 16^3 and 8^3 levels and the discriminator's deep norms): one block per
// (b, c) plane holds x and g in registers between the reduction and dx. One
// launch, one read.
//
// route 1, large planes: a reduce launch (nsplit blocks per plane write
// partial sums) and a dx launch whose blocks re-read x and g and add their
// plane's nsplit partials themselves, in a fixed order (the sums are the same
// bits in every run, and no launch of one thread per plane is left). Both
// grids are 1-D, every plane's blocks in turn, so any B*C takes one pair.
// Planes in groups whose x and g fit in a share of the 50 MB L2 (so the dx
// launch re-reads them from L2) measured slower on the H100 than this
// (PERF.md), so there are none.
//
// Each thread issues U 16-byte loads of x and of g before it uses any, so
// enough bytes are in flight; planes that are not 16-byte aligned take the
// same bodies one element at a time.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int U = 4;           // vectors of each tensor in flight per thread
constexpr int MAX_SPLIT = THREADS;  // a dx block adds its plane's partials one per thread

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

struct Plane {
  float m, a, b, inv;
};

__device__ __forceinline__ Plane plane_of(const float* __restrict__ ab, long long bc) {
  return {ab[4 * bc], ab[4 * bc + 1], ab[4 * bc + 2], ab[4 * bc + 3]};
}

template <typename T, int V>
__device__ __forceinline__ void add_sums(const Vec<T, V>& vx, const Vec<T, V>& vg, const Plane& p,
                                         int act, float alpha, float& sg, float& sxg) {
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float xc = to_f(vx.v[k]) - p.m;
    const float gp = to_f(vg.v[k]) * act_grad(fmaf(xc, p.a, p.b), act, alpha);
    sg += gp;
    sxg = fmaf(xc * p.inv, gp, sxg);
  }
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> dx_of(const Vec<T, V>& vx, const Vec<T, V>& vg,
                                           const Plane& p, float c1, float c2, int act,
                                           float alpha) {
  Vec<T, V> out;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float xc = to_f(vx.v[k]) - p.m;
    const float gp = to_f(vg.v[k]) * act_grad(fmaf(xc, p.a, p.b), act, alpha);
    out.v[k] = from_f<T>(p.a * (gp - c1 - xc * p.inv * c2));
  }
  return out;
}

// Block-wide sums of (u, v), the same bits in every thread and every run: a
// butterfly within each warp, then the warps' sums in warp order.
__device__ __forceinline__ void block_sum2(float& u, float& v) {
  __shared__ float sh[2][THREADS / 32];
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    u += __shfl_xor_sync(0xffffffffu, u, off);
    v += __shfl_xor_sync(0xffffffffu, v, off);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    sh[0][warp] = u;
    sh[1][warp] = v;
  }
  __syncthreads();
  u = sh[0][0];
  v = sh[1][0];
#pragma unroll
  for (int k = 1; k < THREADS / 32; ++k) {
    u += sh[0][k];
    v += sh[1][k];
  }
}

// Route 0: grid (B*C,). The plane's vectors t, t + THREADS, ... stay in this
// thread's registers from the reduction to dx.
template <typename T, int V, int VPT>
__global__ void __launch_bounds__(THREADS)
in_bwd_plane_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ ab,
                    float* __restrict__ sums, T* __restrict__ dx, long long N, int act,
                    float alpha) {
  const long long bc = blockIdx.x;
  const Plane p = plane_of(ab, bc);
  const T* px = x + bc * N;
  const T* pg = g + bc * N;
  Vec<T, V> vx[VPT], vg[VPT];
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
    const long long i = ((long long)threadIdx.x + u * THREADS) * V;
    if (i < N) {
      vx[u] = *reinterpret_cast<const Vec<T, V>*>(px + i);
      vg[u] = *reinterpret_cast<const Vec<T, V>*>(pg + i);
    }
  }
  float sg = 0.f, sxg = 0.f;
#pragma unroll
  for (int u = 0; u < VPT; ++u)
    if (((long long)threadIdx.x + u * THREADS) * V < N)
      add_sums(vx[u], vg[u], p, act, alpha, sg, sxg);
  block_sum2(sg, sxg);
  if (threadIdx.x == 0) {
    sums[2 * bc] = sg;
    sums[2 * bc + 1] = sxg;
  }
  const float c1 = sg / (float)N, c2 = sxg / (float)N;
  T* pd = dx + bc * N;
#pragma unroll
  for (int u = 0; u < VPT; ++u) {
    const long long i = ((long long)threadIdx.x + u * THREADS) * V;
    if (i < N)
      *reinterpret_cast<Vec<T, V>*>(pd + i) = dx_of(vx[u], vg[u], p, c1, c2, act, alpha);
  }
}

// Route 1, reduce: grid (B*C*nsplit,), block bc*nsplit + s.
// partial[(bc*nsplit + s)*2 + {0,1}] = sum(g'), sum(xhat*g') over the block's
// chunk.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_bwd_reduce_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ ab,
                     float* __restrict__ partial, long long N, int nsplit, int act, float alpha) {
  const int s = (int)(blockIdx.x % nsplit);
  const long long bc = blockIdx.x / nsplit;
  long long lo, hi;
  chunk_range(N, nsplit, V, s, lo, hi);
  const Plane p = plane_of(ab, bc);
  const T* px = x + bc * N;
  const T* pg = g + bc * N;
  float sg = 0.f, sxg = 0.f;
  constexpr long long STEP = (long long)THREADS * V;
  for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += STEP * U) {
    Vec<T, V> vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * STEP < hi) {
        vx[u] = *reinterpret_cast<const Vec<T, V>*>(px + i + u * STEP);
        vg[u] = *reinterpret_cast<const Vec<T, V>*>(pg + i + u * STEP);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * STEP < hi) add_sums(vx[u], vg[u], p, act, alpha, sg, sxg);
  }
  block_sum2(sg, sxg);
  if (threadIdx.x == 0) {
    float* out = partial + (bc * nsplit + s) * 2;
    out[0] = sg;
    out[1] = sxg;
  }
}

// Route 1, dx: the reduce's grid. Each block adds its plane's nsplit
// partials (one per thread, then block_sum2: a fixed order), block 0 of the
// plane writes the sums, and every block writes dx over its chunk, reading x
// and g again.
template <typename T, int V>
__global__ void __launch_bounds__(THREADS)
in_bwd_dx_kernel(const T* __restrict__ x, const T* __restrict__ g, const float* __restrict__ ab,
                 const float* __restrict__ partial, float* __restrict__ sums, T* __restrict__ dx,
                 long long N, int nsplit, int act, float alpha) {
  const int s = (int)(blockIdx.x % nsplit);
  const long long bc = blockIdx.x / nsplit;
  float sg = 0.f, sxg = 0.f;
  if (threadIdx.x < nsplit) {
    sg = partial[(bc * nsplit + threadIdx.x) * 2];
    sxg = partial[(bc * nsplit + threadIdx.x) * 2 + 1];
  }
  block_sum2(sg, sxg);
  if (s == 0 && threadIdx.x == 0) {
    sums[2 * bc] = sg;
    sums[2 * bc + 1] = sxg;
  }
  const float c1 = sg / (float)N, c2 = sxg / (float)N;
  long long lo, hi;
  chunk_range(N, nsplit, V, s, lo, hi);
  const Plane p = plane_of(ab, bc);
  const T* px = x + bc * N;
  const T* pg = g + bc * N;
  T* pd = dx + bc * N;
  constexpr long long STEP = (long long)THREADS * V;
  for (long long i = lo + (long long)threadIdx.x * V; i < hi; i += STEP * U) {
    Vec<T, V> vx[U], vg[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * STEP < hi) {
        vx[u] = *reinterpret_cast<const Vec<T, V>*>(px + i + u * STEP);
        vg[u] = *reinterpret_cast<const Vec<T, V>*>(pg + i + u * STEP);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * STEP < hi)
        *reinterpret_cast<Vec<T, V>*>(pd + i + u * STEP) =
            dx_of(vx[u], vg[u], p, c1, c2, act, alpha);
  }
}

template <typename T, int V>
cudaError_t run_small(const void* x, const void* g, const float* ab, float* sums, void* dx, int BC,
                      long long N, int vpt, int act, float alpha, cudaStream_t s) {
#define VG_PLANE(VP)                                                                         \
  in_bwd_plane_kernel<T, V, VP><<<BC, THREADS, 0, s>>>(                                      \
      static_cast<const T*>(x), static_cast<const T*>(g), ab, sums, static_cast<T*>(dx), N, \
      act, alpha)
  if (vpt == 1) VG_PLANE(1);
  else if (vpt == 2) VG_PLANE(2);
  else VG_PLANE(4);
#undef VG_PLANE
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run_split(const void* x, const void* g, const float* ab, float* partial, float* sums,
                      void* dx, int BC, long long N, int nsplit, int act, float alpha,
                      cudaStream_t s) {
  const unsigned blocks = (unsigned)((long long)BC * nsplit);
  in_bwd_reduce_kernel<T, V><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ab, partial, N, nsplit, act, alpha);
  in_bwd_dx_kernel<T, V><<<blocks, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ab, partial, sums,
      static_cast<T*>(dx), N, nsplit, act, alpha);
  return cudaGetLastError();
}

template <typename T, int V>
cudaError_t run(const void* x, const void* g, const float* ab, float* partial, float* sums,
                void* dx, int BC, long long N, int route, int vpt, int nsplit, int act,
                float alpha, cudaStream_t s) {
  if (route == 0) return run_small<T, V>(x, g, ab, sums, dx, BC, N, vpt, act, alpha, s);
  return run_split<T, V>(x, g, ab, partial, sums, dx, BC, N, nsplit, act, alpha, s);
}

}  // namespace

// C entry point, bound with ctypes. x, g, dx (B, C, X, Y, Z) contiguous in one
// dtype (0 = float32, 1 = bfloat16), N = X*Y*Z; ab (B*C*4,) f32 from the
// forward (mean, a, beta, inv); sums (B*C*2,) f32 out (sum(g'), sum(xhat*g')
// per plane). vec = 1 when N is a multiple of 16 bytes of elements and x, g,
// dx are 16-byte aligned (16-byte vectors), else 0 (one element at a time).
// route 0 (one block per plane): vpt 1, 2 or 4 vectors per thread with
// N <= vpt * 256 * vector; partial and nsplit ignored. route 1 (two passes):
// nsplit blocks per plane (at most 256), partial (B*C*nsplit*2,) f32 scratch.
// ops/instnorm.py::bwd_plan picks these. Returns cudaGetLastError() after the
// launches; 1000 for a bad argument.
extern "C" int vg_instnorm_bwd(const void* x, const void* g, const float* ab, float* partial,
                               float* sums, void* dx, int dtype, int BC, long long N, int route,
                               int vec, int vpt, int nsplit, int act, float alpha, void* stream) {
  if (BC < 1 || N < 1 || act < 0 || act > 2 || (dtype != 0 && dtype != 1)) return 1000;
  const int V = vec ? (dtype == 0 ? 4 : 8) : 1;
  if (route == 0) {
    if (vpt != 1 && vpt != 2 && vpt != 4) return 1000;
    if (N > (long long)vpt * THREADS * V) return 1000;
  } else if (route == 1) {
    if (nsplit < 1 || nsplit > MAX_SPLIT || partial == nullptr) return 1000;
    if ((long long)BC * nsplit >= (1LL << 31)) return 1000;
  } else {
    return 1000;
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 0)
    e = vec ? run<float, 4>(x, g, ab, partial, sums, dx, BC, N, route, vpt, nsplit, act, alpha, s)
            : run<float, 1>(x, g, ab, partial, sums, dx, BC, N, route, vpt, nsplit, act, alpha, s);
  else
    e = vec ? run<__nv_bfloat16, 8>(x, g, ab, partial, sums, dx, BC, N, route, vpt, nsplit, act,
                                    alpha, s)
            : run<__nv_bfloat16, 1>(x, g, ab, partial, sums, dx, BC, N, route, vpt, nsplit, act,
                                    alpha, s);
  return (int)e;
}
