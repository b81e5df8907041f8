// Soft-skeleton forward round for Hopper (sm_90a), (B, X, Y, Z) float32.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/skeleton.py::_round_fwd
// (body _fwd_kernel). One launch runs one uniform round of the clDice
// skeleton (see vangan_torch/ops/morphology.py):
//
//   e = erode(img);  delta = max(img - dilate(e), 0);
//   skel += max(delta - skel * delta, 0)   (round 0: skel = delta);  img' = e
//
// erode is the min over the 19 voxels of the 3^3 cube that have at least one
// offset 0 (the union of the reference's (3,3,1), (3,1,3), (1,3,3) windows),
// dilate the max over the 3^3 cube, both TF SAME: out-of-volume voxels never
// count. The TPU kernel's X-slab DMA, its Z%128 / Y%16 shape limits and its
// multi-round fusion are not carried over: this kernel takes any B, X, Y, Z.
//
// What bounds it on the card: memory bandwidth. A round reads img and skel
// and writes skel and e, a few min/max per voxel. Each block stages an
// 8x8x32 output tile of img with a halo of 2 in shared memory (+inf outside
// the volume, so it never wins a min), erodes the tile with a halo of 1 into
// a second shared array (-inf outside the volume, so the dilation ignores
// it), then takes the 3^3 max and updates skel in place. e goes to a second
// buffer (the caller ping-pongs two), because neighbouring blocks still read
// img. Halo reads come from L2. Fusing rounds is later work.
//
// Exactness: min and max are exact and each arithmetic op is rounded on its
// own (__fsub_rn / __fmul_rn / __fadd_rn keep nvcc from contracting the
// update into an FMA), so the result is bit-identical to the plain torch
// version, which rounds every op.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TX = 8, TY = 8, TZ = 32;                // output tile
constexpr int IX = TX + 4, IY = TY + 4, IZ = TZ + 4;  // img tile, halo 2
constexpr int EX = TX + 2, EY = TY + 2, EZ = TZ + 2;  // eroded tile, halo 1
constexpr int THREADS = 256;

__device__ __forceinline__ bool inside(int x, int y, int z, int X, int Y, int Z) {
  return x >= 0 && x < X && y >= 0 && y < Y && z >= 0 && z < Z;
}

// grid (ceil(Z/TZ), ceil(Y/TY), B*ceil(X/TX)).
__global__ void __launch_bounds__(THREADS)
skel_round_kernel(const float* __restrict__ img, float* __restrict__ skel,
                  float* __restrict__ img_next, int X, int Y, int Z, int tiles_x, int first) {
  __shared__ float s_img[IX][IY][IZ];
  __shared__ float s_ero[EX][EY][EZ];
  const int b = blockIdx.z / tiles_x;
  const int x0 = (blockIdx.z % tiles_x) * TX, y0 = blockIdx.y * TY, z0 = blockIdx.x * TZ;
  const long long base = (long long)b * X * Y * Z;

  for (int i = threadIdx.x; i < IX * IY * IZ; i += THREADS) {
    const int lz = i % IZ, ly = (i / IZ) % IY, lx = i / (IZ * IY);
    const int gx = x0 - 2 + lx, gy = y0 - 2 + ly, gz = z0 - 2 + lz;
    s_img[lx][ly][lz] = inside(gx, gy, gz, X, Y, Z)
                            ? img[base + ((long long)gx * Y + gy) * Z + gz]
                            : INFINITY;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < EX * EY * EZ; i += THREADS) {
    const int lz = i % EZ, ly = (i / EZ) % EY, lx = i / (EZ * EY);
    float e = -INFINITY;
    if (inside(x0 - 1 + lx, y0 - 1 + ly, z0 - 1 + lz, X, Y, Z)) {
      e = INFINITY;
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
          for (int dz = 0; dz < 3; ++dz)
            if (dx == 1 || dy == 1 || dz == 1) e = fminf(e, s_img[lx + dx][ly + dy][lz + dz]);
    }
    s_ero[lx][ly][lz] = e;
  }
  __syncthreads();

  for (int i = threadIdx.x; i < TX * TY * TZ; i += THREADS) {
    const int lz = i % TZ, ly = (i / TZ) % TY, lx = i / (TZ * TY);
    const int gx = x0 + lx, gy = y0 + ly, gz = z0 + lz;
    if (!inside(gx, gy, gz, X, Y, Z)) continue;
    float opened = -INFINITY;
#pragma unroll
    for (int dx = 0; dx < 3; ++dx)
#pragma unroll
      for (int dy = 0; dy < 3; ++dy)
#pragma unroll
        for (int dz = 0; dz < 3; ++dz) opened = fmaxf(opened, s_ero[lx + dx][ly + dy][lz + dz]);
    const float delta = fmaxf(__fsub_rn(s_img[lx + 2][ly + 2][lz + 2], opened), 0.f);
    const long long idx = base + ((long long)gx * Y + gy) * Z + gz;
    float s = delta;
    if (!first) {
      s = skel[idx];
      s = __fadd_rn(s, fmaxf(__fsub_rn(delta, __fmul_rn(s, delta)), 0.f));
    }
    skel[idx] = s;
    if (img_next != nullptr) img_next[idx] = s_ero[lx + 1][ly + 1][lz + 1];
  }
}

}  // namespace

// C entry point, bound with ctypes: one round. img, skel, img_next are
// (B, X, Y, Z) float32, contiguous; img_next may be null (the last round) and
// must not alias img. first = 1 writes skel = delta without reading skel.
// Returns cudaGetLastError() after the launch; 1000 for a bad argument.
extern "C" int vg_skeleton_round_fwd(const float* img, float* skel, float* img_next, int B,
                                     int X, int Y, int Z, int first, void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || img == img_next) return 1000;
  const int tiles_x = (X + TX - 1) / TX, tiles_y = (Y + TY - 1) / TY;
  const int tiles_z = (Z + TZ - 1) / TZ;
  if ((long long)B * tiles_x > 65535 || tiles_y > 65535) return 1000;
  const dim3 grid(tiles_z, tiles_y, B * tiles_x);
  skel_round_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      img, skel, img_next, X, Y, Z, tiles_x, first);
  return (int)cudaGetLastError();
}
