// Soft-skeleton backward round for Hopper (sm_90a), (B, X, Y, Z) float32.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/skeleton.py::_round_bwd
// (body _bwd_kernel). One call runs the backward of one uniform round of
// skeleton_fwd.cu,
//
//   e = erode(img);  opened = dilate(e);  delta = max(img - opened, 0);
//   skel = skel_prev + max(delta - skel_prev * delta, 0)   (round 0: delta)
//
// taking (img, e, skel_prev, d_e_next, d_skel) to (d_img, d_skel_prev), where
// e is the round's eroded image (the next round's input, which the forward
// keeps) and d_e_next the cotangent of that next image (none after the last
// round). The TPU kernel replayed jax.vjp of the round on a slab with a halo
// of 4; here the round is differentiated by hand in two launches, each a
// gather, so no voxel is written by two blocks and no atomics are needed:
//
//   A. For every voxel r of the tile and a halo of 1: the dilation's argmax
//      over the 3^3 window of e (+ its value, `opened`), delta, and
//      d_v = dL/d(img - opened) at r. Then for each tile voxel q:
//      d_e[q] = d_e_next[q] - sum of d_v[r] over the r whose argmax is q.
//      It also writes d_v and d_skel_prev (elementwise) for the tile.
//   B. For every voxel q of the tile and a halo of 1: the erosion's argmin
//      over the 19-voxel window of img. Then for each tile voxel p:
//      d_img[p] = d_v[p] + sum of d_e[q] over the q whose argmin is p.
//
// A voxel's gradient thus depends on voxels up to 4 away (two windows of
// radius 1 in each launch), as the TPU kernel's halo of 4 says.
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
//
// What bounds it on the card: memory bandwidth. Launch A reads e (halo 2),
// img, skel_prev, d_skel (halo 1) and d_e_next, and writes d_e, d_v and
// d_skel_prev; launch B reads img (halo 2), d_e (halo 1) and d_v and writes
// d_img: about 11 volumes of f32 traffic per round, with halo re-reads from
// L2. Tiles are 8x8x32, as in the forward.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 8, TY = 8, TZ = 32;                // output tile
constexpr int HX = TX + 2, HY = TY + 2, HZ = TZ + 2;  // halo 1
constexpr int EX = TX + 4, EY = TY + 4, EZ = TZ + 4;  // halo 2
constexpr int THREADS = 256;

__device__ __forceinline__ bool inside(int x, int y, int z, int X, int Y, int Z) {
  return x >= 0 && x < X && y >= 0 && y < Y && z >= 0 && z < Z;
}

// Stage v (B, X, Y, Z) with a halo of 2 around the tile; `fill` outside the volume.
__device__ __forceinline__ void stage_halo2(float (*s)[EY][EZ], const float* __restrict__ v,
                                            long long base, int x0, int y0, int z0, int X,
                                            int Y, int Z, float fill) {
  for (int i = threadIdx.x; i < EX * EY * EZ; i += THREADS) {
    const int lz = i % EZ, ly = (i / EZ) % EY, lx = i / (EZ * EY);
    const int gx = x0 - 2 + lx, gy = y0 - 2 + ly, gz = z0 - 2 + lz;
    s[lx][ly][lz] = inside(gx, gy, gz, X, Y, Z) ? v[base + ((long long)gx * Y + gy) * Z + gz]
                                                : fill;
  }
}

// grid (ceil(Z/TZ), ceil(Y/TY), B*ceil(X/TX)).
__global__ void __launch_bounds__(THREADS)
skel_bwd_open_kernel(const float* __restrict__ img, const float* __restrict__ e,
                     const float* __restrict__ skel_prev, const float* __restrict__ d_e_next,
                     const float* __restrict__ d_skel, float* __restrict__ d_skel_prev,
                     float* __restrict__ d_e, float* __restrict__ d_v, int X, int Y, int Z,
                     int tiles_x, int first) {
  __shared__ float s_e[EX][EY][EZ];
  __shared__ float s_dv[HX][HY][HZ];
  __shared__ unsigned char s_arg[HX][HY][HZ];
  const int b = blockIdx.z / tiles_x;
  const int x0 = (blockIdx.z % tiles_x) * TX, y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  const long long base = (long long)b * X * Y * Z;

  stage_halo2(s_e, e, base, x0, y0, z0, X, Y, Z, -INFINITY);
  __syncthreads();

  for (int i = threadIdx.x; i < HX * HY * HZ; i += THREADS) {
    const int lz = i % HZ, ly = (i / HZ) % HY, lx = i / (HZ * HY);
    const int gx = x0 - 1 + lx, gy = y0 - 1 + ly, gz = z0 - 1 + lz;
    float dv = 0.f;
    int best = 0;
    if (inside(gx, gy, gz, X, Y, Z)) {
      float opened = -INFINITY;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            const float v = s_e[lx + dx][ly + dy][lz + dz];
            if (v > opened) {
              opened = v;
              best = (dx * 3 + dy) * 3 + dz;
            }
          }
      const long long idx = base + ((long long)gx * Y + gy) * Z + gz;
      const bool own = lx >= 1 && lx <= TX && ly >= 1 && ly <= TY && lz >= 1 && lz <= TZ;
      const float diff = __fsub_rn(img[idx], opened);
      const float delta = fmaxf(diff, 0.f);
      const float gs = d_skel[idx];
      float d_delta = gs;  // round 0: skel = delta
      if (!first) {
        const float s = skel_prev[idx];
        const bool up = __fsub_rn(delta, __fmul_rn(s, delta)) > 0.f;
        d_delta = up ? gs * (1.f - s) : 0.f;
        if (own) d_skel_prev[idx] = up ? gs * (1.f - delta) : gs;
      }
      dv = diff > 0.f ? d_delta : 0.f;
      if (own) d_v[idx] = dv;
    }
    s_dv[lx][ly][lz] = dv;
    s_arg[lx][ly][lz] = (unsigned char)best;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TX * TY * TZ; i += THREADS) {
    const int lz = i % TZ, ly = (i / TZ) % TY, lx = i / (TZ * TY);
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (!inside(gx, gy, gz, X, Y, Z)) continue;
    const long long idx = base + ((long long)gx * Y + gy) * Z + gz;
    float acc = d_e_next != nullptr ? d_e_next[idx] : 0.f;
    // r = q - (dx - 1, dy - 1, dz - 1) sits at halo-1 index (l + 2 - d); q is
    // tap (dx, dy, dz) of r's window
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          const int rx = lx + 2 - dx, ry = ly + 2 - dy, rz = lz + 2 - dz;
          if (s_arg[rx][ry][rz] == (dx * 3 + dy) * 3 + dz) acc -= s_dv[rx][ry][rz];
        }
    d_e[idx] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
skel_bwd_erode_kernel(const float* __restrict__ img, const float* __restrict__ d_e,
                      const float* __restrict__ d_v, float* __restrict__ d_img, int X, int Y,
                      int Z, int tiles_x) {
  __shared__ float s_img[EX][EY][EZ];
  __shared__ float s_de[HX][HY][HZ];
  __shared__ unsigned char s_arg[HX][HY][HZ];
  const int b = blockIdx.z / tiles_x;
  const int x0 = (blockIdx.z % tiles_x) * TX, y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  const long long base = (long long)b * X * Y * Z;

  stage_halo2(s_img, img, base, x0, y0, z0, X, Y, Z, INFINITY);
  __syncthreads();

  for (int i = threadIdx.x; i < HX * HY * HZ; i += THREADS) {
    const int lz = i % HZ, ly = (i / HZ) % HY, lx = i / (HZ * HY);
    const int gx = x0 - 1 + lx, gy = y0 - 1 + ly, gz = z0 - 1 + lz;
    float de = 0.f;
    int best = 255;
    if (inside(gx, gy, gz, X, Y, Z)) {
      float m = INFINITY;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz) {
            if (dx != 1 && dy != 1 && dz != 1) continue;  // the 19-voxel erosion window
            const float v = s_img[lx + dx][ly + dy][lz + dz];
            if (v < m) {
              m = v;
              best = (dx * 3 + dy) * 3 + dz;
            }
          }
      de = d_e[base + ((long long)gx * Y + gy) * Z + gz];
    }
    s_de[lx][ly][lz] = de;
    s_arg[lx][ly][lz] = (unsigned char)best;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TX * TY * TZ; i += THREADS) {
    const int lz = i % TZ, ly = (i / TZ) % TY, lx = i / (TZ * TY);
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (!inside(gx, gy, gz, X, Y, Z)) continue;
    const long long idx = base + ((long long)gx * Y + gy) * Z + gz;
    float acc = d_v[idx];
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) {
          if (dx != 1 && dy != 1 && dz != 1) continue;
          const int qx = lx + 2 - dx, qy = ly + 2 - dy, qz = lz + 2 - dz;
          if (s_arg[qx][qy][qz] == (dx * 3 + dy) * 3 + dz) acc += s_de[qx][qy][qz];
        }
    d_img[idx] = acc;
  }
}

}  // namespace

// C entry point, bound with ctypes: the backward of one round. All pointers
// are (B, X, Y, Z) float32, contiguous. img is the round's input, e its eroded
// image, skel_prev the skel before the round (null when first = 1, round 0),
// d_e_next the cotangent of e as the next round's input (null after the last
// round), d_skel the cotangent of the round's skel. Writes d_img (may alias
// d_e_next) and, unless first, d_skel_prev (must not alias d_skel); d_e and
// d_v are scratch. Returns cudaGetLastError() after the launches; 1000 for a
// bad argument.
extern "C" int vg_skeleton_round_bwd(const float* img, const float* e, const float* skel_prev,
                                     const float* d_e_next, const float* d_skel, float* d_img,
                                     float* d_skel_prev, float* d_e, float* d_v, int B, int X,
                                     int Y, int Z, int first, void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1) return 1000;
  if (!first && (skel_prev == nullptr || d_skel_prev == nullptr || d_skel_prev == d_skel))
    return 1000;
  if (d_img == d_e || d_img == d_v || d_e == d_v) return 1000;
  const int tiles_x = (X + TX - 1) / TX, tiles_y = (Y + TY - 1) / TY;
  const int tiles_z = (Z + TZ - 1) / TZ;
  if ((long long)B * tiles_x > 65535 || tiles_y > 65535) return 1000;
  const dim3 grid(tiles_z, tiles_y, B * tiles_x);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  skel_bwd_open_kernel<<<grid, THREADS, 0, s>>>(img, e, skel_prev, d_e_next, d_skel,
                                                d_skel_prev, d_e, d_v, X, Y, Z, tiles_x, first);
  skel_bwd_erode_kernel<<<grid, THREADS, 0, s>>>(img, d_e, d_v, d_img, X, Y, Z, tiles_x);
  return (int)cudaGetLastError();
}
