// Soft-skeleton backward round for Hopper (sm_90a), (B, X, Y, Z) float32.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/skeleton.py::_round_bwd
// (body _bwd_kernel). One launch runs the backward of one uniform round of
// skeleton_fwd.cu,
//
//   e = erode(img);  opened = dilate(e);  delta = max(img - opened, 0);
//   skel = skel_prev + max(delta - skel_prev * delta, 0)   (round 0: delta)
//
// taking (img, e, skel_prev, d_e_next, d_skel) to (d_img, d_skel_prev), where
// e is the round's eroded image (the next round's input, which the forward
// keeps) and d_e_next the cotangent of that next image (none after the last
// round). The TPU kernel replayed jax.vjp of the round on a slab with a halo
// of 4; here the round is differentiated by hand as a gather, so no voxel is
// written by two blocks and no atomics are needed. A block owns a TX x TY x
// TZ tile and keeps every intermediate in shared memory; d_e and d_v never
// leave it (their halos are recomputed by the neighbouring blocks):
//
//   A. For every voxel r of the tile and a halo of 2: the dilation's argmax
//      over the 3^3 window of e (staged with a halo of 3), delta, and
//      d_v = dL/d(img - opened) at r (d_skel and skel_prev read at r). It
//      writes d_skel_prev (elementwise) for the tile.
//   B. For every voxel q of the tile and a halo of 1:
//      d_e[q] = d_e_next[q] - (the sum of d_v[r] over the r whose argmax is
//      q), and the erosion's argmin over the 19-voxel window of img (staged
//      with a halo of 2).
//   C. For each tile voxel p:
//      d_img[p] = d_v[p] + sum of d_e[q] over the q whose argmin is p.
//
// A block reads d_e_next around its tile, so d_img must not alias it.
//
// Boundary semantics are the forward's: +inf outside the volume for the min,
// -inf for e outside the volume in the max. Ties (equal values in a window)
// go to the first extremum in the scan order; plain torch routes a max-pool
// tie to its own first index and splits a torch.minimum tie, and JAX splits
// every tie. All are valid subgradients, and on data with distinct values
// they give the same input gradient: every path through erode/dilate carries
// a gradient to a voxel of the same value, so each path ends at the one input
// voxel that holds it. The rounded ops (__fsub_rn, __fmul_rn) repeat the
// forward's exactly, so every relu'/comparison sees the forward's values.
// ops/skeleton.py::round_bwd_plain is this arithmetic, in the same order, in
// torch.
//
// What bounds it on the card: instruction issue (27 compares a voxel of the
// halo-2 box, 27 + 19 of the halo-1 box, 19 of the tile, and the staging),
// not bytes: from device memory each input is read once and each output
// written once, the halos come from L2. Fusing the two passes of the
// two-launch version saves the 4 volumes of d_e and d_v traffic a round but
// recomputes phase A on the halo-2 box (1.95x the tile at 16^3, where the
// two-launch version's phase A ran on 1.66x of an 8 x 8 x 32 tile). The
// 16^3 tile takes 114.6 KB of shared memory, two blocks of 1024 threads an
// SM: on the H100 it ran faster than 8 x 8 x 32 tiles (256 or 1024 threads)
// and 16 x 16 x 32 tiles (one block an SM) (PERF.md).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int imax(int a, int b) { return a > b ? a : b; }
constexpr int up16(int bytes) { return (bytes + 15) / 16 * 16; }

// A box of the tile's neighbourhood in tile-relative coordinates: it starts
// at (X0, Y0, Z0) and spans NX x NY x NZ voxels, z fastest.
template <int X0, int Y0, int Z0, int NX, int NY, int NZ>
struct Box {
  static constexpr int N = NX * NY * NZ;
  static __device__ __forceinline__ int at(int x, int y, int z) {
    return ((x - X0) * NY + (y - Y0)) * NZ + (z - Z0);
  }
  static __device__ __forceinline__ void coords(int i, int& x, int& y, int& z) {
    const unsigned u = (unsigned)i;
    z = (int)(u % NZ) + Z0;
    y = (int)(u / NZ % NY) + Y0;
    x = (int)(u / (NZ * NY)) + X0;
  }
};

template <int TX_, int TY_, int TZ_, int NT_>
struct Tile {
  static constexpr int TX = TX_, TY = TY_, TZ = TZ_, NT = NT_;
  using E = Box<-3, -3, -3, TX + 6, TY + 6, TZ + 6>;  // e
  using A = Box<-2, -2, -2, TX + 4, TY + 4, TZ + 4>;  // phase A: img, d_v, argmax
  using B = Box<-1, -1, -1, TX + 2, TY + 2, TZ + 2>;  // phase B: d_e, argmin
  using T = Box<0, 0, 0, TX, TY, TZ>;
  // shared memory: e, then (over it, once phase A is done) d_e and the argmin
  // bytes; img and d_v; the argmax bytes
  static constexpr int S0 = up16(imax(4 * E::N, 5 * B::N));
  static constexpr int SMEM = S0 + 8 * A::N + up16(A::N);
};

__device__ __forceinline__ bool inside(int x, int y, int z, int X, int Y, int Z) {
  return x >= 0 && x < X && y >= 0 && y < Y && z >= 0 && z < Z;
}

// Stage box Bx of the volume v (`fill` outside it) into s, for the tile at
// (x0, y0, z0) of the volume at `base`.
template <typename Bx, int NT>
__device__ __forceinline__ void stage(float* __restrict__ s, const float* __restrict__ v,
                                      float fill, int x0, int y0, int z0, int X, int Y, int Z,
                                      long long base) {
  for (int i = threadIdx.x; i < Bx::N; i += NT) {
    int x, y, z;
    Bx::coords(i, x, y, z);
    const int gx = x0 + x, gy = y0 + y, gz = z0 + z;
    s[i] = inside(gx, gy, gz, X, Y, Z) ? v[base + ((long long)gx * Y + gy) * Z + gz] : fill;
  }
}

// grid (ceil(Z/TZ), ceil(Y/TY), B*ceil(X/TX)).
template <typename G>
__global__ void __launch_bounds__(G::NT, 2048 / G::NT)  // a full SM of threads: 32 registers
skel_bwd_kernel(const float* __restrict__ img, const float* __restrict__ e,
                const float* __restrict__ skel_prev, const float* __restrict__ d_e_next,
                const float* __restrict__ d_skel, float* __restrict__ d_img,
                float* __restrict__ d_skel_prev, int X, int Y, int Z, int tiles_x, int first) {
  using E = typename G::E;
  using A = typename G::A;
  using B = typename G::B;
  using T = typename G::T;
  constexpr int NT = G::NT;
  extern __shared__ __align__(16) unsigned char smem[];
  float* s_e = reinterpret_cast<float*>(smem);
  float* s_de = reinterpret_cast<float*>(smem);
  unsigned char* s_amin = smem + 4 * B::N;
  float* s_img = reinterpret_cast<float*>(smem + G::S0);
  float* s_dv = s_img + A::N;
  unsigned char* s_amax = reinterpret_cast<unsigned char*>(s_dv + A::N);

  const int b = blockIdx.z / tiles_x;
  const int x0 = (blockIdx.z % tiles_x) * G::TX, y0 = blockIdx.y * G::TY, z0 = blockIdx.x * G::TZ;
  const long long base = (long long)b * X * Y * Z;
  auto in = [&](int x, int y, int z) { return inside(x0 + x, y0 + y, z0 + z, X, Y, Z); };
  auto at = [&](int x, int y, int z) {
    return base + ((long long)(x0 + x) * Y + (y0 + y)) * Z + (z0 + z);
  };
  stage<E, NT>(s_e, e, -INFINITY, x0, y0, z0, X, Y, Z, base);
  stage<A, NT>(s_img, img, INFINITY, x0, y0, z0, X, Y, Z, base);
  __syncthreads();
  for (int i = threadIdx.x; i < A::N; i += NT) {
    int x, y, z;
    A::coords(i, x, y, z);
    float dv = 0.f;
    int best = 0;
    if (in(x, y, z)) {
      float opened = -INFINITY;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const float v = s_e[E::at(x + dx - 1, y + dy - 1, z + dz - 1)];
            if (v > opened) {
              opened = v;
              best = (dx * 3 + dy) * 3 + dz;
            }
          }
      const long long idx = at(x, y, z);
      const float diff = __fsub_rn(s_img[i], opened);
      const float delta = fmaxf(diff, 0.f);
      const float gs = d_skel[idx];
      float d_delta = gs;
      if (!first) {
        const float s = skel_prev[idx];
        const bool up = __fsub_rn(delta, __fmul_rn(s, delta)) > 0.f;
        d_delta = up ? gs * (1.f - s) : 0.f;
        const bool own = x >= 0 && x < G::TX && y >= 0 && y < G::TY && z >= 0 && z < G::TZ;
        if (own) d_skel_prev[idx] = up ? gs * (1.f - delta) : gs;
      }
      dv = diff > 0.f ? d_delta : 0.f;
    }
    s_dv[i] = dv;
    s_amax[i] = (unsigned char)best;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < B::N; i += NT) {
    int x, y, z;
    B::coords(i, x, y, z);
    float de = 0.f;
    int best = 255;
    if (in(x, y, z)) {
      float acc = 0.f;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const int r = A::at(x + 1 - dx, y + 1 - dy, z + 1 - dz);
            if (s_amax[r] == (dx * 3 + dy) * 3 + dz) acc += s_dv[r];
          }
      de = (d_e_next != nullptr ? d_e_next[at(x, y, z)] : 0.f) - acc;
      float m = INFINITY;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            if (dx != 1 && dy != 1 && dz != 1) continue;
            const float v = s_img[A::at(x + dx - 1, y + dy - 1, z + dz - 1)];
            if (v < m) {
              m = v;
              best = (dx * 3 + dy) * 3 + dz;
            }
          }
    }
    s_de[i] = de;
    s_amin[i] = (unsigned char)best;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < T::N; i += NT) {
    int x, y, z;
    T::coords(i, x, y, z);
    if (!in(x, y, z)) continue;
    float acc = s_dv[A::at(x, y, z)];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          if (dx != 1 && dy != 1 && dz != 1) continue;
          const int q = B::at(x + 1 - dx, y + 1 - dy, z + 1 - dz);
          if (s_amin[q] == (dx * 3 + dy) * 3 + dz) acc += s_de[q];
        }
    d_img[at(x, y, z)] = acc;
  }
}

template <typename G>
int launch(const float* img, const float* e, const float* skel_prev, const float* d_e_next,
           const float* d_skel, float* d_img, float* d_skel_prev, int B, int X, int Y, int Z,
           int first, cudaStream_t s, int* launched) {
  static unsigned configured = 0;  // devices whose shared-memory limit is set, one bit each
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= 32) return 1000;
  auto kern = skel_bwd_kernel<G>;
  const int smem = G::SMEM;
  if (!(configured & (1u << dev))) {
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    configured |= 1u << dev;
  }
  const int tiles_x = (X + G::TX - 1) / G::TX, tiles_y = (Y + G::TY - 1) / G::TY;
  const int tiles_z = (Z + G::TZ - 1) / G::TZ;
  if ((long long)B * tiles_x > 65535 || tiles_y > 65535) return 1000;
  const dim3 grid(tiles_z, tiles_y, B * tiles_x);
  kern<<<grid, G::NT, smem, s>>>(img, e, skel_prev, d_e_next, d_skel, d_img, d_skel_prev, X, Y,
                                 Z, tiles_x, first);
  err = cudaGetLastError();
  if (err == cudaSuccess) ++*launched;
  return (int)err;
}

}  // namespace

// C entry point, bound with ctypes: the backward of one round, one launch.
// All pointers are (B, X, Y, Z) float32, contiguous. img is the round's
// input, e its eroded image, skel_prev the skel before the round (null when
// first = 1, round 0), d_e_next the cotangent of e as the next round's input
// (null after the last round), d_skel the cotangent of the round's skel.
// Writes d_img (must not alias d_e_next, which blocks read around their
// tiles) and, unless first, d_skel_prev (must not alias d_skel). Tiles are
// 16^3 voxels, 1024 threads (ops/skeleton.py::BWD_TILE). Adds the kernel
// launches it made to *launched. Returns cudaGetLastError() after the
// launch; 1000 for a bad argument.
extern "C" int vg_skeleton_round_bwd(const float* img, const float* e, const float* skel_prev,
                                     const float* d_e_next, const float* d_skel, float* d_img,
                                     float* d_skel_prev, int B, int X, int Y, int Z, int first,
                                     void* stream, int* launched) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || launched == nullptr) return 1000;
  if (!first && (skel_prev == nullptr || d_skel_prev == nullptr || d_skel_prev == d_skel))
    return 1000;
  if (d_img == d_e_next || d_img == d_skel) return 1000;
  return launch<Tile<16, 16, 16, 1024>>(img, e, skel_prev, d_e_next, d_skel, d_img, d_skel_prev,
                                        B, X, Y, Z, first, static_cast<cudaStream_t>(stream),
                                        launched);
}
