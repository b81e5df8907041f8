// Fused InstanceNorm + activation forward for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernels vangan_tpu/ops/pallas/instnorm.py::_stats
// (body _stats_kernel) and ::_fwd_impl (body _apply_kernel), in one launch.
//
// Per (b, c) plane: mean and variance in f32 (Chan's merge of centred
// partials, immune to the E[x^2] - mean^2 cancellation when mean >> std),
// then y = act((x - mean)*a + beta) with a = gamma*rsqrt(var + eps), rounded
// once to x's dtype; act 0 none, 1 relu, 2 leaky relu with slope alpha. The
// plane's (mean, a, beta, inv) go to `ab` for the backward (instnorm_bwd.cu),
// which needs inv itself: a = gamma*inv cannot give it back where gamma = 0.
//
// What bounds it on the card: memory bandwidth. The least traffic reads x
// once and writes y once, but y needs the whole plane's statistics. The TPU
// kernel carried running (mean, M2) across its sequential grid; here the
// blocks of one plane hold it on chip together, so x is read from device
// memory once (the stream route excepted). ops/instnorm.py::fwd_plan picks
// the route and its sizes; the C entry refuses a plan it does not hold.
//
// Block `rank` of a plane takes the rank-th run of `vpb` 16-byte vectors of
// the plane: the first `smem_vecs` of them come into dynamic shared memory by
// 1-D TMA bulk copies (cp.async.bulk onto an mbarrier), up to NT*RPT more
// into registers, and the rest (the tail) is read twice, the second time
// right after the cluster barrier, while it is warm in L2. Each block merges
// its own Chan partial (n, mean, M2) in a fixed order; after a cluster
// barrier every block reads all ranks' partials through distributed shared
// memory in rank order, so all compute the same bits in every run; rank 0
// writes `ab`. Each block then applies from what it holds, and waits on a
// second cluster barrier before it exits (its partial must outlive the other
// ranks' reads). The routes:
//
// - small (planes of up to 1024 vectors: 16^3, 14^3, 8^3 in bf16): one
//   block of 256 threads per plane, in registers.
// - cluster: a thread-block cluster of `cs` blocks (up to 16, the
//   non-portable size) per plane, scheduled together on neighbouring SMs,
//   each run in shared memory (64 KiB, three blocks an SM).
// - stream: planes no cluster's shared memory holds at that occupancy
//   (128^3): 16 blocks of 512 threads, two an SM, each keeping up to
//   112 KiB in shared memory and 16 KiB in registers and reading the rest of
//   its run twice. On the H100 they beat a cluster of 16 that holds the
//   whole 128^3 plane one block an SM (PERF.md): the second block's loads
//   overlap the first's barrier and stores.
//
// Vectors are 16 bytes of the flat tensor (x and y 16-byte aligned): a plane
// that does not start or end on a 16-byte boundary (31^3 in bf16) shares its
// first and last vector with its neighbours. Those two are loaded whole and
// masked: their statistics take only the plane's elements and their stores
// are element by element. Every other vector is loaded and stored whole, so
// the vector width is decided per vector, not per tensor.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <mutex>

namespace cg = cooperative_groups;

namespace {

// The plan's constants (ops/instnorm.py holds the same, FWD_*): the only
// plans the entry takes. Sizes in 16-byte vectors.
constexpr int SMALL_THREADS = 256;   // small route: one block a plane
constexpr int SMALL_RPT_MAX = 4;     // registers a thread: 1, 2 or 4
constexpr int CLUSTER_THREADS = 256; // cluster route: a block's run in shared memory
constexpr int CLUSTER_VECS = 4096;   // (64 KiB, three blocks an SM)
constexpr int STREAM_THREADS = 512;  // stream route
constexpr int STREAM_SMEM = 7168;    // shared memory a block keeps (112 KiB, two blocks an SM)
constexpr int STREAM_RPT = 2;        // and registers a thread
constexpr int MAX_CLUSTER = 16;      // the non-portable size
constexpr int BULK_BYTES = 32768;    // bytes per bulk copy
constexpr int U = 4;                 // tail vectors in flight per thread
constexpr int UNSCHEDULABLE = 1001;  // status: no cluster of this shape fits on the card
static_assert(CLUSTER_THREADS == SMALL_THREADS, "the cluster route runs a small-route body");

// ---- element access -----------------------------------------------------

template <typename T> struct Lanes;
template <> struct Lanes<float> { static constexpr int V = 4; };
template <> struct Lanes<__nv_bfloat16> { static constexpr int V = 8; };

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[4]) {
  f[0] = __uint_as_float(u.x);
  f[1] = __uint_as_float(u.y);
  f[2] = __uint_as_float(u.z);
  f[3] = __uint_as_float(u.w);
}

__device__ __forceinline__ void unpack(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack(const float (&f)[4]) {
  return make_uint4(__float_as_uint(f[0]), __float_as_uint(f[1]), __float_as_uint(f[2]),
                    __float_as_uint(f[3]));
}

__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<const unsigned*>(&h);
}

__device__ __forceinline__ uint4 pack(const float (&f)[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]), pack2(f[4], f[5]), pack2(f[6], f[7]));
}

__device__ __forceinline__ void store1(float* p, float v) { *p = v; }
__device__ __forceinline__ void store1(__nv_bfloat16* p, float v) { *p = __float2bfloat16(v); }

// ---- PTX: mbarrier, bulk copy, cluster barrier ----------------------------

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_addr(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred P1;\n\t"
      "LAB_WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n\t"
      "@P1 bra DONE;\n\t"
      "bra LAB_WAIT;\n\t"
      "DONE:\n\t}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// ---- statistics -----------------------------------------------------------

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

// The plane's vectors [vfirst, vend) of the flat tensor; elements of vector
// vi that lie in the plane are [klo, khi).
struct Plane {
  long long vfirst, vend;
  int head, tail;  // valid elements start at `head` in vfirst and end at `tail` in vend - 1
  __device__ __forceinline__ void range(long long vi, int V, int& klo, int& khi) const {
    klo = vi == vfirst ? head : 0;
    khi = vi == vend - 1 ? tail : V;
  }
};

// Merge vector vi's valid elements into this thread's (n, mean, m2).
template <int V>
__device__ __forceinline__ void accumulate(const float (&f)[V], int klo, int khi, float& n,
                                           float& mean, float& m2) {
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) s += (k >= klo && k < khi) ? f[k] : 0.f;
  const float cnt = (float)(khi - klo);
  const float vm = s / cnt;
  float vm2 = 0.f;
#pragma unroll
  for (int k = 0; k < V; ++k) {
    const float d = (k >= klo && k < khi) ? f[k] - vm : 0.f;
    vm2 += d * d;
  }
  chan_merge(n, mean, m2, cnt, vm, vm2);
}

template <typename T>
__device__ __forceinline__ void accumulate_vec(const uint4& u, long long vi, const Plane& p,
                                               float& n, float& mean, float& m2) {
  constexpr int V = Lanes<T>::V;
  float f[V];
  unpack(u, f);
  int klo, khi;
  p.range(vi, V, klo, khi);
  accumulate<V>(f, klo, khi, n, mean, m2);
}

// y at vector vi from x's vector u: whole, or element by element where the
// vector is shared with a neighbouring plane.
template <typename T>
__device__ __forceinline__ void apply_vec(const uint4& u, long long vi, const Plane& p, float m,
                                          float a, float b, int act, float alpha, T* y) {
  constexpr int V = Lanes<T>::V;
  float f[V];
  unpack(u, f);
#pragma unroll
  for (int k = 0; k < V; ++k) {
    float t = fmaf(f[k] - m, a, b);
    if (act == 1) t = fmaxf(t, 0.f);
    else if (act == 2) t = t >= 0.f ? t : alpha * t;
    f[k] = t;
  }
  int klo, khi;
  p.range(vi, V, klo, khi);
  if (klo == 0 && khi == V) {
    reinterpret_cast<uint4*>(y)[vi] = pack(f);
  } else {
#pragma unroll
    for (int k = 0; k < V; ++k)
      if (k >= klo && k < khi) store1(y + vi * V + k, f[k]);
  }
}

// grid (B*C*cs,), cluster (cs,): block rank r of plane p is block p*cs + r.
// Its run of the plane's vectors: [lo, lo + nsm) in shared memory, the next
// nreg in registers (vector lo + nsm + t + k*NT in thread t's slot k), the
// rest (the tail) streamed.
template <typename T, int NT, int RPT>
__global__ void __launch_bounds__(NT)
in_fwd_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
              const float* __restrict__ beta, T* __restrict__ y, float* __restrict__ ab, int C,
              long long N, int cs, int vpb, int smem_vecs, float eps, int act, float alpha) {
  constexpr int V = Lanes<T>::V;
  extern __shared__ __align__(128) uint4 s_vec[];
  __shared__ float s_warp[3][NT / 32];
  __shared__ float s_part[3];   // this block's (n, mean, M2), read by its cluster
  __shared__ float s_plane[3];  // the plane's mean, a, beta
  __shared__ __align__(8) uint64_t s_bar;

  const long long plane = blockIdx.x / cs;
  const int rank = (int)(blockIdx.x % cs);
  const long long e0 = plane * N, e1 = e0 + N;
  Plane p;
  p.vfirst = e0 / V;
  p.vend = (e1 + V - 1) / V;
  p.head = (int)(e0 - p.vfirst * V);
  p.tail = (int)(e1 - (p.vend - 1) * V);
  long long lo = p.vfirst + (long long)rank * vpb;
  if (lo > p.vend) lo = p.vend;
  const long long cnt = (lo + vpb < p.vend ? lo + vpb : p.vend) - lo;
  const int nsm = (int)(cnt < smem_vecs ? cnt : smem_vecs);
  const int nreg = (int)(cnt - nsm < NT * RPT ? cnt - nsm : NT * RPT);
  const long long ntail = cnt - nsm - nreg;
  const long long reg0 = lo + nsm, tail0 = reg0 + nreg;
  const uint4* __restrict__ xv = reinterpret_cast<const uint4*>(x);

  // 1. loads: the shared-memory run by bulk copies, then the registers
  if (nsm > 0) {
    if (threadIdx.x == 0) mbar_init(&s_bar);
    __syncthreads();
    if (threadIdx.x == 0) {
      const uint32_t bytes = (uint32_t)nsm * 16u;
      mbar_expect_tx(&s_bar, bytes);
      for (uint32_t off = 0; off < bytes; off += BULK_BYTES)
        bulk_load(reinterpret_cast<char*>(s_vec) + off,
                  reinterpret_cast<const char*>(xv + lo) + off,
                  bytes - off < (uint32_t)BULK_BYTES ? bytes - off : (uint32_t)BULK_BYTES,
                  &s_bar);
    }
  }
  uint4 r[RPT];
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = threadIdx.x + k * NT;
    if (i < nreg) r[k] = __ldg(xv + reg0 + i);
  }

  // 2. this thread's Chan partial: tail, registers, shared memory (a fixed order)
  float n = 0.f, mean = 0.f, m2 = 0.f;
  for (long long i = threadIdx.x; i < ntail; i += (long long)NT * U) {
    uint4 t[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * NT < ntail) t[u] = __ldg(xv + tail0 + i + u * NT);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * NT < ntail) accumulate_vec<T>(t[u], tail0 + i + u * NT, p, n, mean, m2);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = threadIdx.x + k * NT;
    if (i < nreg) accumulate_vec<T>(r[k], reg0 + i, p, n, mean, m2);
  }
  if (nsm > 0) {
    mbar_wait(&s_bar, 0);
    for (int i = threadIdx.x; i < nsm; i += NT)
      accumulate_vec<T>(s_vec[i], lo + i, p, n, mean, m2);
  }

  // 3. the block's partial: a tree within each warp, then the warps in order
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float nb = __shfl_down_sync(0xffffffffu, n, off);
    const float mb = __shfl_down_sync(0xffffffffu, mean, off);
    const float m2b = __shfl_down_sync(0xffffffffu, m2, off);
    chan_merge(n, mean, m2, nb, mb, m2b);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) {
    s_warp[0][warp] = n;
    s_warp[1][warp] = mean;
    s_warp[2][warp] = m2;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < NT / 32; ++w)
      chan_merge(n, mean, m2, s_warp[0][w], s_warp[1][w], s_warp[2][w]);
    s_part[0] = n;
    s_part[1] = mean;
    s_part[2] = m2;
  }

  // 4. the plane's statistics: every block merges all ranks' partials in rank order
  if (cs > 1) {
    cluster_arrive();
    cluster_wait();
  } else {
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    float pn = 0.f, pm = 0.f, pm2 = 0.f;
    if (cs > 1) {
      cg::cluster_group cluster = cg::this_cluster();
      for (int q = 0; q < cs; ++q) {
        const float* part = cluster.map_shared_rank(s_part, q);
        chan_merge(pn, pm, pm2, part[0], part[1], part[2]);
      }
    } else {
      chan_merge(pn, pm, pm2, s_part[0], s_part[1], s_part[2]);
    }
    const float var = fmaxf(pm2 / pn, 0.f);
    const float inv = rsqrtf(var + eps);
    const int c = (int)(plane % C);
    s_plane[0] = pm;
    s_plane[1] = gamma[c] * inv;
    s_plane[2] = beta[c];
    if (rank == 0) {
      ab[4 * plane] = pm;
      ab[4 * plane + 1] = s_plane[1];
      ab[4 * plane + 2] = s_plane[2];
      ab[4 * plane + 3] = inv;
    }
  }
  __syncthreads();
  if (cs > 1) cluster_arrive();  // this block has read the other ranks' partials
  const float m = s_plane[0], a = s_plane[1], b = s_plane[2];

  // 5. apply: the tail first (re-read while warm in L2), registers, shared memory
  for (long long i = threadIdx.x; i < ntail; i += (long long)NT * U) {
    uint4 t[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * NT < ntail) t[u] = __ldg(xv + tail0 + i + u * NT);
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (i + u * NT < ntail) apply_vec<T>(t[u], tail0 + i + u * NT, p, m, a, b, act, alpha, y);
  }
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int i = threadIdx.x + k * NT;
    if (i < nreg) apply_vec<T>(r[k], reg0 + i, p, m, a, b, act, alpha, y);
  }
  for (int i = threadIdx.x; i < nsm; i += NT)
    apply_vec<T>(s_vec[i], lo + i, p, m, a, b, act, alpha, y);
  if (cs > 1) cluster_wait();  // no rank exits while another may still read its partial
}

struct Args {
  const void* x;
  const float* gamma;
  const float* beta;
  void* y;
  float* ab;
  int BC, C;
  long long N;
  int cs, vpb, smem_vecs, act;
  float eps, alpha;
  cudaStream_t stream;
  int* launched;
};

// Whether a cluster of cs blocks of `kern` with `smem` dynamic bytes can be
// resident on the current device, from cudaOccupancyMaxActiveClusters; the
// answers are kept per (device, kernel, cs, smem).
struct Fit {
  int dev;
  const void* kern;
  int cs, smem, active;
};

cudaError_t active_clusters(int dev, const void* kern, const cudaLaunchConfig_t& cfg, int cs,
                            int smem, int& active) {
  static std::mutex mu;
  static Fit seen[64];
  static int nseen = 0;
  std::lock_guard<std::mutex> lock(mu);
  cudaError_t e;
  for (int i = 0; i < nseen; ++i)
    if (seen[i].dev == dev && seen[i].kern == kern && seen[i].cs == cs && seen[i].smem == smem) {
      active = seen[i].active;
      return cudaSuccess;
    }
  e = cudaOccupancyMaxActiveClusters(&active, kern, &cfg);
  if (e != cudaSuccess) return e;
  if (nseen < 64) seen[nseen++] = {dev, kern, cs, smem, active};
  return cudaSuccess;
}

template <typename T, int NT, int RPT>
int launch(const Args& a) {
  auto kern = in_fwd_kernel<T, NT, RPT>;
  constexpr int max_smem = (NT == STREAM_THREADS ? STREAM_SMEM : CLUSTER_VECS) * 16;
  const int smem = a.smem_vecs * 16;
  static unsigned configured = 0;  // devices whose attributes are set, one bit each
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 32) return 1000;
  if (!(configured & (1u << dev))) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    configured |= 1u << dev;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(a.BC * a.cs));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = (size_t)smem;
  cfg.stream = a.stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)a.cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = a.cs > 1 ? 1 : 0;
  if (a.cs > 1) {
    int active = 0;
    e = active_clusters(dev, reinterpret_cast<const void*>(kern), cfg, a.cs, smem, active);
    if (e != cudaSuccess) return (int)e;
    if (active < 1) return UNSCHEDULABLE;
  }
  e = cudaLaunchKernelEx(&cfg, kern, static_cast<const T*>(a.x), a.gamma, a.beta,
                         static_cast<T*>(a.y), a.ab, a.C, a.N, a.cs, a.vpb, a.smem_vecs, a.eps,
                         a.act, a.alpha);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e == cudaSuccess) ++*a.launched;
  return (int)e;
}

// The four bodies fwd_plan runs: small (256 threads, 1, 2 or 4 vectors a
// thread in registers), cluster (256 threads, shared memory) and stream
// (512 threads, shared memory and 2 vectors a thread).
template <typename T>
int dispatch(const Args& a, int route, int rpt) {
  if (route == 2) return launch<T, STREAM_THREADS, STREAM_RPT>(a);
  if (rpt == 1) return launch<T, SMALL_THREADS, 1>(a);  // also CLUSTER_THREADS, 1
  if (rpt == 2) return launch<T, SMALL_THREADS, 2>(a);
  return launch<T, SMALL_THREADS, SMALL_RPT_MAX>(a);
}

}  // namespace

// C entry point, bound with ctypes. x and y (B, C, X, Y, Z) contiguous in one
// dtype (0 = float32, 1 = bfloat16), 16-byte aligned, N = X*Y*Z; gamma, beta
// (C,) f32; ab (B*C*4,) f32 out (mean, a, beta, inv per plane, for the
// backward). The plan (ops/instnorm.py::fwd_plan): route 0 small, 1 cluster,
// 2 stream; cs blocks per plane (a cluster when cs > 1); threads per block;
// rpt 16-byte vectors per thread in registers; vpb vectors per block, of
// which smem_vecs in shared memory. The entry takes only the plans fwd_plan
// makes (the constants above) and checks that the plan covers every plane
// and that a cluster of cs blocks is schedulable. Adds the kernel launches it
// made to *launched. Returns 0 or a CUDA error after the launch; 1000 for a
// refused argument or plan; 1001 when no cluster of this shape fits on the
// card.
extern "C" int vg_instnorm_fwd(const void* x, const float* gamma, const float* beta, void* y,
                               float* ab, int dtype, int BC, int C, long long N, int route,
                               int cs, int threads, int rpt, int vpb, int smem_vecs, float eps,
                               int act, float alpha, void* stream, int* launched) {
  if (BC < 1 || C < 1 || N < 1 || act < 0 || act > 2 || (dtype != 0 && dtype != 1)) return 1000;
  if ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y)) % 16) return 1000;
  if (launched == nullptr) return 1000;
  const int V = dtype == 0 ? 4 : 8;
  // the most vectors a plane spans: one more where planes do not start on a vector
  const long long vecs = (N + (N % V ? V - 1 : 0) + V - 1) / V;
  if (cs < 1 || cs > MAX_CLUSTER || (cs & (cs - 1)) || vpb < 1) return 1000;
  if ((long long)cs * vpb < vecs || (long long)(cs - 1) * vpb >= vecs) return 1000;
  if ((long long)BC * cs >= (1LL << 31)) return 1000;
  if (route == 0) {  // small: one block, registers only
    const bool rpt_ok = rpt == 1 || rpt == 2 || rpt == SMALL_RPT_MAX;
    if (threads != SMALL_THREADS || !rpt_ok || cs != 1 || smem_vecs != 0 ||
        vpb > SMALL_THREADS * rpt)
      return 1000;
  } else if (route == 1) {  // cluster: the run in shared memory
    if (threads != CLUSTER_THREADS || rpt != 1 || smem_vecs != vpb || vpb > CLUSTER_VECS)
      return 1000;
  } else if (route == 2) {  // stream: what the block cannot hold read twice
    const int smem = vpb < STREAM_SMEM ? vpb : STREAM_SMEM;
    if (threads != STREAM_THREADS || rpt != STREAM_RPT || cs != MAX_CLUSTER ||
        smem_vecs != smem || vpb <= CLUSTER_VECS)
      return 1000;
  } else {
    return 1000;
  }
  const Args a = {x, gamma, beta, y, ab, BC, C, N, cs, vpb, smem_vecs, act, eps, alpha,
                  static_cast<cudaStream_t>(stream), launched};
  return dtype == 0 ? dispatch<float>(a, route, rpt) : dispatch<__nv_bfloat16>(a, route, rpt);
}
