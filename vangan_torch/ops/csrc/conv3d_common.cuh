// Device helpers shared by the conv3d kernels (conv3d_fwd.cu, conv3d_dgrad.cu,
// conv3d_wgrad.cu, and the bodies above 64 taps in conv3d_taps.cuh):
// the padding index map, the tensor-core route's tile constants (and those of
// its body in tap chunks), its swizzled shared-memory layout and halo
// staging, and inline-PTX wrappers for ldmatrix, mma.sync (bf16 -> f32) and
// cp.async.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace vg {

constexpr int KMAX = 8;  // largest kernel extent per axis

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

// ---- the tensor-core (mma) route ------------------------------------------
//
// A block owns a brick of BRICK_X x BRICK_Y x BRICK_Z output voxels (z
// fastest, as NCXYZ). The input it needs, the brick's halo, is staged in
// shared memory voxel-major, 16 channels (one MMA k-step, 32 bytes) per voxel:
// each tap of the kernel is then a shifted view of the same halo, and
// ldmatrix takes any 16-byte-aligned row address, so a tap costs no gather.
// Along an axis with kernel extent 1 and stride s the halo keeps only every
// s-th input position (a strided 1^3 conv stages no voxel it does not read).
constexpr int MMA_THREADS = 256;  // 8 warps
constexpr int BRICK_X = 4, BRICK_Y = 8, BRICK_Z = 8;
constexpr int BRICK = BRICK_X * BRICK_Y * BRICK_Z;  // 256 voxels = 16 MMA row tiles
constexpr int CI_CHUNK = 16;                        // input channels per k-step

struct Halo {
  int hx, hy, hz;  // extent per axis
  int ex, ey, ez;  // halo step between neighbouring output voxels
  int qx, qy, qz;  // input step between neighbouring halo positions
};

__host__ __device__ inline Halo make_halo(int kx, int ky, int kz, int sx, int sy, int sz) {
  Halo h;
  h.ex = kx == 1 ? 1 : sx; h.qx = kx == 1 ? sx : 1; h.hx = (BRICK_X - 1) * h.ex + kx;
  h.ey = ky == 1 ? 1 : sy; h.qy = ky == 1 ? sy : 1; h.hy = (BRICK_Y - 1) * h.ey + ky;
  h.ez = kz == 1 ? 1 : sz; h.qz = kz == 1 ? sz : 1; h.hz = (BRICK_Z - 1) * h.ez + kz;
  return h;
}

// The tensor-core body in tap chunks, for more than 64 taps at stride 1
// (ops/conv3d.py conv_plan, fields tap_chunk / tap_chunks). A block owns
// FOLD_BX x FOLD_BY columns of FOLD_ROWS consecutive z positions, and the
// kernel's kz taps go on the GEMM's N (column co * kz + dz, FOLD_N wide): a
// column's 16 z positions are one MMA row tile (forward) or k-step (weight
// gradient), and each (dx, dy) pair of taps is one shifted view of the halo,
// (FOLD_BX + kx - 1) x (FOLD_BY + ky - 1) x FOLD_ROWS voxels, staged once per
// 16-channel chunk by stage_halo. A column gives FOLD_ROWS - kz + 1 output z
// positions. The forward's body for one input channel (route 3) owns the
// same columns, each of FOLD_ROWS output z positions.
constexpr int FOLD_BX = 4, FOLD_BY = 8;
constexpr int FOLD_ROWS = 16;
constexpr int FOLD_N = 8;
// g values the weight gradient stages per column and output channel: output
// z positions -(KMAX - 1) .. FOLD_ROWS of the column
constexpr int FOLD_G_ROW = FOLD_ROWS + KMAX;

__host__ __device__ inline Halo make_fold_halo(int kx, int ky) {
  Halo h;
  h.ex = h.ey = h.ez = 1;
  h.qx = h.qy = h.qz = 1;
  h.hx = FOLD_BX + kx - 1;
  h.hy = FOLD_BY + ky - 1;
  h.hz = FOLD_ROWS;
  return h;
}

// 16-byte unit that holds half `half` (8 bf16) of row `row` of a [row][16]
// bf16 tile. The halves swap on every other group of four rows, so the eight
// rows of one ldmatrix 8x8 read (consecutive voxels or channels) fall in
// eight different bank groups.
__device__ __forceinline__ int swz(int row, int half) {
  return row * 2 + (half ^ ((row >> 2) & 1));
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void ldsm_x4(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t addr, uint32_t (&r)[4]) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

__device__ __forceinline__ void ldsm_x2(uint32_t addr, uint32_t& r0, uint32_t& r1) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1) : "r"(addr));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(uint32_t saddr, const void* gptr) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(saddr), "l"(gptr));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
// Wait for all but the most recently committed group.
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage the halo of one brick for channels [c0, c0 + 16) into `halo`
// ([voxel][16] bf16, swizzled). xb is the sample's input (Ci, X, Y, Z); halo
// position (hx, hy, hz) reads input position (o0 + h * q) per axis through the
// index map; channels >= Ci and zero-pad positions are 0. The transpose from
// NCXYZ to voxel-major happens here, in registers (cp.async cannot do it):
// each thread gathers the 16 channels of a voxel and writes two 16-byte units.
__device__ __forceinline__ void stage_halo(uint4* halo, const __nv_bfloat16* xb, int c0, int Ci,
                                           int X, int Y, int Z, const Halo& h, int x0, int y0,
                                           int z0, int reflect) {
  const long long plane = (long long)X * Y * Z;
  const int n = h.hx * h.hy * h.hz;
  const int cn = min(CI_CHUNK, Ci - c0);
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb) + c0 * plane;
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    const int vz = v % h.hz, t = v / h.hz, vy = t % h.hy, vx = t / h.hy;
    const int ix = map_index(x0 + vx * h.qx, X, reflect);
    const int iy = map_index(y0 + vy * h.qy, Y, reflect);
    const int iz = map_index(z0 + vz * h.qz, Z, reflect);
    uint32_t p[8];
    if (ix >= 0 && iy >= 0 && iz >= 0) {
      const unsigned short* src = xs + ((long long)ix * Y + iy) * Z + iz;
      unsigned short e[CI_CHUNK];
#pragma unroll
      for (int j = 0; j < CI_CHUNK; ++j) e[j] = j < cn ? __ldg(src + j * plane) : 0;
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = (uint32_t)e[2 * j] | ((uint32_t)e[2 * j + 1] << 16);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) p[j] = 0;
    }
    halo[swz(v, 0)] = make_uint4(p[0], p[1], p[2], p[3]);
    halo[swz(v, 1)] = make_uint4(p[4], p[5], p[6], p[7]);
  }
}

// Halo index of brick voxel m (0..BRICK-1) before the tap's offset.
__device__ __forceinline__ int brick_halo_index(int m, const Halo& h) {
  const int i = m / (BRICK_Y * BRICK_Z), j = (m / BRICK_Z) % BRICK_Y, l = m % BRICK_Z;
  return (i * h.ex * h.hy + j * h.ey) * h.hz + l * h.ez;
}

// Set a kernel's dynamic shared memory ceiling when it needs more than 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       (int)bytes);
  if (e != cudaSuccess) return e;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

}  // namespace vg
