// Direct 3-D convolution forward for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/conv3d.py::_conv_fwd
// (bodies _fwd_kernel / _fwd_kernel_b). That kernel exists because XLA pads
// small channel counts to 128 TPU lanes; its z-select matmuls, lane padding
// and slab DMA are TPU workarounds and are not carried over. The input
// gradient (_conv_dgrad) runs this kernel once per stride parity
// (ops/conv3d.py).
//
//   y[b, co, o] = sum over ci, d of x_pad[b, ci, s*o + d] * w[co, ci, d] (+ bias)
//
// Padding (zero or reflect, numpy semantics for any width) is an index map,
// so no padded copy of the input is made. Two bodies; ops/conv3d.py::conv_plan
// picks one per shape and passes it in `route`:
//
// route 1, tensor cores (bfloat16; the main path): an implicit GEMM with
// M = output voxels, N = Co, K = Ci x taps, on mma.sync m16n8k16 (bf16 in,
// f32 accumulate). The generator's small-channel convs (max(Ci, Co) < 128)
// do 27 Ci FMAs per output voxel and channel at up to 128^3 voxels, near the
// card's bf16 ridge (dec0.block1 48 -> 16: ~324 FLOP per byte against ~295),
// so the FMAs must run on the tensor cores, and the input must not be
// re-read per tap or per Co tile. A block owns a brick of 4 x 8 x 8 output
// voxels and a Co tile of up to 64 (every Co of the path in one or two
// tiles) and walks Ci in chunks of 16: per chunk it copies the chunk's
// weights (pre-arranged by the wrapper as [chunk][co tile][tap][co][16],
// with cp.async) and the brick's input halo (through the index map,
// transposed to voxel-major in registers; see conv3d_common.cuh) into shared
// memory, and every tap is then an MMA over a shifted view of that halo,
// fed by ldmatrix: the input is read once per chunk, not once per tap or Co
// tile. Each warp owns two 16-voxel row tiles and the whole Co tile. The
// halo staging is not double-buffered (its transpose goes through
// registers); two blocks per SM overlap one's staging with the other's
// MMAs. mma.sync and not wgmma: wgmma wants 64-row tiles of A in swizzled
// shared memory described by a descriptor, which the halo's shifted
// per-tap views are not, and mma.sync's rate (hundreds of TFLOP/s) is not
// what bounds these shapes, the halo staging is.
//
// route 2, tensor cores in tap chunks (bfloat16, more than 64 taps at unit
// stride with Co * kz <= 8: the ResNet generator's 7^3 head, 32 -> 1). What
// bounds it: 343 taps of 32 channels per output voxel are 21,952 FMAs on
// one output channel, so an N = Co tile of 8 would issue 8x the useful MMA
// work, and the brick's halo is 7.7x the voxels it outputs (10 x 14 x 14 for
// 4 x 8 x 8), which must not be re-read per tap from device memory. The
// design: the kz taps go on N. For each (dx, dy) pair of taps,
//
//   P[v, co * kz + dz] = sum over ci of x_pad[ci, v + (dx, dy, 0)] * w[co, ci, dx, dy, dz]
//
// is one m16n8k16 MMA per 16 voxels v and 16-channel chunk, summed over the
// pairs, and y[o, co] = sum over dz of P[o + dz e_z, co * kz + dz] (+ bias)
// in the epilogue through shared memory. M runs over columns of 16
// consecutive z positions (an output brick extended by kz - 1 along z), so
// a column gives 16 - kz + 1 outputs and 7 of the 8 N columns are useful at
// Co = 1 (conv_plan's pad_share 0.46 at 128^3). A block owns 4 x 8 such
// columns; per 16-channel chunk it stages their halo (10 x 14 x 16 voxels
// for 7^3, 70 KB) once, with the chunk's weights ([dx][dy][8][16], 12.5 KB)
// double-buffered by cp.async (the next chunk's copy runs under this
// chunk's MMAs), and walks the kernel in tap chunks, one y slice (kx, 1,
// kz) at a time: warp w owns the columns (bx, w), loads the halo row (hx, w
// + dy) of each hx < 4 + kx - 1 once per slice (ldmatrix), and feeds it to
// the MMAs of every (bx, dx) with bx + dx = hx, so a halo fragment serves up
// to kx MMAs, not one.
//
// route 0, CUDA cores (float32, and bfloat16 shapes the tensor-core routes
// do not take: Ci <= 3, where a 16-channel k-step would be mostly padding,
// or more than 64 taps outside route 2 (the ResNet's 7^3 stem, 1 -> 32)):
// each thread owns one output voxel and CO_T output
// channels, so one input load feeds CO_T f32 FMAs; the weights of a Ci-tile
// are staged in shared memory and read as warp-wide broadcasts. The float32
// route stays on exact f32 arithmetic (no TF32).

#include "conv3d_common.cuh"

namespace {

using vg::KMAX;
using vg::map_index;
using vg::to_f;
using vg::from_f;

constexpr int CO_T = 16;      // output channels per thread
constexpr int THREADS = 128;  // output voxels per block
constexpr int SMEM_FLOATS = 12288;  // 48 KB of staged weights
constexpr int MMA_MAX_CO_TILE = 64;
constexpr size_t MAX_SMEM = 227 * 1024;

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

// Route 0. K > 0: a cubic K^3 kernel known at compile time; K == 0: any
// kx, ky, kz <= KMAX.
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
cudaError_t launch(const void* x, const void* w, const void* bias, void* y, int B, int Ci,
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
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* w, const void* bias, void* y, int B, int Ci,
                     int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
                     int kz, int sx, int sy, int sz, int px, int py, int pz, int reflect,
                     cudaStream_t s) {
  const bool cubic = kx == ky && ky == kz;
#define VG_LAUNCH(KK)                                                                \
  return launch<T, KK>(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, \
                       sz, px, py, pz, reflect, s)
  if (cubic && kx == 1) VG_LAUNCH(1);
  if (cubic && kx == 2) VG_LAUNCH(2);  // the parity sub-kernels of conv3d_dgrad
  if (cubic && kx == 3) VG_LAUNCH(3);
  if (cubic && kx == 4) VG_LAUNCH(4);
  VG_LAUNCH(0);
#undef VG_LAUNCH
}

// Route 1: bf16 implicit GEMM on the tensor cores (see the note at the top).
// wt: the weights as 16-byte units [Ci/16][gridDim.y][taps][NT * 8][2],
// zero-padded in Ci and Co; y: (B, Co, Xo, Yo, Zo).
template <int NT>
__global__ void __launch_bounds__(vg::MMA_THREADS, 2)
conv3d_fwd_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wt,
                      const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                      int Ci, int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx,
                      int ky, int kz, int sx, int sy, int sz, int px, int py, int pz,
                      int reflect) {
  using namespace vg;
  constexpr int CO_TILE = NT * 8;
  extern __shared__ uint4 smem[];
  const int taps = kx * ky * kz;
  const Halo h = make_halo(kx, ky, kz, sx, sy, sz);
  const int w_units = taps * CO_TILE * 2;
  uint4* w_s = smem;
  uint4* halo = smem + w_units;

  const int nbz = (Zo + BRICK_Z - 1) / BRICK_Z, nby = (Yo + BRICK_Y - 1) / BRICK_Y;
  int q = blockIdx.x;
  const int oz0 = (q % nbz) * BRICK_Z;
  q /= nbz;
  const int oy0 = (q % nby) * BRICK_Y, ox0 = (q / nby) * BRICK_X;
  const int ct = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, r = lane & 7;

  // ldmatrix rows of this lane: A (voxel, channel half) of the warp's two
  // row tiles; B (co row, channel half) of a pair of n tiles
  int a_hv[2];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
    a_hv[mt] = brick_halo_index((2 * warp + mt) * 16 + r + 8 * (mi & 1), h);
  const int a_half = mi >> 1;
  const int b_row = (mi >> 1) * 8 + r, b_half = mi & 1;

  float acc[2][NT][4];
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  const uint32_t halo_u = smem_u32(halo), w_u = smem_u32(w_s);
  const long long plane = (long long)X * Y * Z;
  const __nv_bfloat16* xb = x + (long long)b * Ci * plane;
  const int n_chunks = (Ci + CI_CHUNK - 1) / CI_CHUNK;
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk is consumed
    const uint4* wsrc = wt + ((long long)c * gridDim.y + ct) * w_units;
    for (int u = tid; u < w_units; u += MMA_THREADS)
      cp_async16(w_u + swz(u >> 1, u & 1) * 16, wsrc + u);
    cp_async_commit();
    stage_halo(halo, xb, c * CI_CHUNK, Ci, X, Y, Z, h, ox0 * sx - px, oy0 * sy - py,
               oz0 * sz - pz, reflect);
    cp_async_wait_all();
    __syncthreads();
    int t = 0;
    for (int dx = 0; dx < kx; ++dx)
      for (int dy = 0; dy < ky; ++dy)
        for (int dz = 0; dz < kz; ++dz, ++t) {
          const int toff = (dx * h.hy + dy) * h.hz + dz;
          uint32_t a[2][4];
#pragma unroll
          for (int mt = 0; mt < 2; ++mt)
            ldsm_x4(halo_u + swz(a_hv[mt] + toff, a_half) * 16, a[mt]);
          const int wrow = t * CO_TILE;
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            uint32_t bb[4];
            ldsm_x4(w_u + swz(wrow + p * 16 + b_row, b_half) * 16, bb);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) {
              mma_bf16(acc[mt][2 * p], a[mt], bb[0], bb[1]);
              mma_bf16(acc[mt][2 * p + 1], a[mt], bb[2], bb[3]);
            }
          }
          if constexpr (NT & 1) {
            uint32_t b0, b1;
            ldsm_x2(w_u + swz(wrow + (NT - 1) * 8 + r, b_half) * 16, b0, b1);
#pragma unroll
            for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], a[mt], b0, b1);
          }
        }
  }

  // epilogue: C[m = voxel][n = co]; lane holds rows g, g + 8, columns 2q, 2q + 1
  const long long nout = (long long)Xo * Yo * Zo;
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int m = (2 * warp + mt) * 16 + g + 8 * hr;
      const int ox = ox0 + m / (BRICK_Y * BRICK_Z), oy = oy0 + (m / BRICK_Z) % BRICK_Y,
                oz = oz0 + m % BRICK_Z;
      if (ox >= Xo || oy >= Yo || oz >= Zo) continue;
      const long long o = ((long long)ox * Yo + oy) * Zo + oz;
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int co = ct * CO_TILE + nt * 8 + 2 * tq + e;
          if (co >= Co) continue;
          const float bv = bias != nullptr ? __bfloat162float(bias[co]) : 0.f;
          y[((long long)b * Co + co) * nout + o] = __float2bfloat16(acc[mt][nt][2 * hr + e] + bv);
        }
    }
}

// Shared memory of the tensor-core route: the chunk's weights and the halo.
size_t mma_smem(int kx, int ky, int kz, int sx, int sy, int sz, int co_tile) {
  const vg::Halo h = vg::make_halo(kx, ky, kz, sx, sy, sz);
  return ((size_t)kx * ky * kz * co_tile + (size_t)h.hx * h.hy * h.hz) * 32;
}

template <int NT>
cudaError_t launch_mma(const void* x, const void* w, const void* bias, void* y, int B, int Ci,
                       int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
                       int kz, int sx, int sy, int sz, int px, int py, int pz, int reflect,
                       cudaStream_t s) {
  using namespace vg;
  const size_t smem = mma_smem(kx, ky, kz, sx, sy, sz, NT * 8);
  cudaError_t e = allow_smem(conv3d_fwd_mma_kernel<NT>, smem);
  if (e != cudaSuccess) return e;
  const long long bricks = (long long)((Xo + BRICK_X - 1) / BRICK_X) *
                           ((Yo + BRICK_Y - 1) / BRICK_Y) * ((Zo + BRICK_Z - 1) / BRICK_Z);
  const dim3 grid((unsigned)bricks, (Co + NT * 8 - 1) / (NT * 8), B);
  conv3d_fwd_mma_kernel<NT><<<grid, MMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), Ci, Co, X, Y,
      Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, sz, px, py, pz, reflect);
  return cudaGetLastError();
}


// Route 2: bf16 implicit GEMM in tap chunks, the kz taps on N (see the note
// at the top). wt: the weights as 16-byte units [Ci/16][kx][ky][FOLD_N][2],
// column co * kz + dz, zero-padded in Ci and N; y: (B, Co, Xo, Yo, Zo).
__global__ void __launch_bounds__(vg::MMA_THREADS, 2)
conv3d_fwd_fold_kernel(const __nv_bfloat16* __restrict__ x, const uint4* __restrict__ wt,
                       const __nv_bfloat16* __restrict__ bias, __nv_bfloat16* __restrict__ y,
                       int Ci, int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx,
                       int ky, int kz, int px, int py, int pz, int reflect) {
  using namespace vg;
  constexpr int COLS = FOLD_BX * FOLD_BY;
  extern __shared__ uint4 smem[];
  const Halo h = make_fold_halo(kx, ky);
  const int bz = FOLD_ROWS - kz + 1;  // output z positions of a column
  const int w_units = kx * ky * FOLD_N * 2;
  uint4* halo = smem;
  uint4* w_s = smem + h.hx * h.hy * h.hz * 2;  // two buffers of w_units

  const int nbz = (Zo + bz - 1) / bz, nby = (Yo + FOLD_BY - 1) / FOLD_BY;
  int q = blockIdx.x;
  const int oz0 = (q % nbz) * bz;
  q /= nbz;
  const int oy0 = (q % nby) * FOLD_BY, ox0 = (q / nby) * FOLD_BX;
  const int b = blockIdx.z;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, r = lane & 7;
  // ldmatrix rows of this lane: A (z position, channel half) of a column;
  // B (n row, channel half)
  const int a_z = r + 8 * (mi & 1), a_half = mi >> 1;
  const int b_half = mi & 1;

  float acc[FOLD_BX][4];
#pragma unroll
  for (int bx = 0; bx < FOLD_BX; ++bx)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[bx][e] = 0.f;

  const uint32_t halo_u = smem_u32(halo), w_u = smem_u32(w_s);
  const long long plane = (long long)X * Y * Z;
  const __nv_bfloat16* xb = x + (long long)b * Ci * plane;
  const int n_chunks = (Ci + CI_CHUNK - 1) / CI_CHUNK;
  auto copy_weights = [&](int c) {
    const uint4* src = wt + (long long)c * w_units;
    const uint32_t dst = w_u + (c & 1) * w_units * 16;
    for (int u = tid; u < w_units; u += MMA_THREADS)
      cp_async16(dst + swz(u >> 1, u & 1) * 16, src + u);
    cp_async_commit();
  };
  copy_weights(0);
  for (int c = 0; c < n_chunks; ++c) {
    __syncthreads();  // the previous chunk's halo and weights are consumed
    const bool next = c + 1 < n_chunks;
    if (next) copy_weights(c + 1);
    stage_halo(halo, xb, c * CI_CHUNK, Ci, X, Y, Z, h, ox0 - px, oy0 - py, oz0 - pz, reflect);
    if (next) cp_async_wait_all_but_last(); else cp_async_wait_all();
    __syncthreads();
    const uint32_t wc = w_u + (c & 1) * w_units * 16;
    for (int dy = 0; dy < ky; ++dy) {  // one tap chunk: the y slice (kx, 1, kz)
      uint32_t a[FOLD_BX + KMAX - 1][4];
#pragma unroll
      for (int hx = 0; hx < FOLD_BX + KMAX - 1; ++hx)
        if (hx < FOLD_BX + kx - 1)
          ldsm_x4(halo_u + swz((hx * h.hy + warp + dy) * h.hz + a_z, a_half) * 16, a[hx]);
#pragma unroll
      for (int dx = 0; dx < KMAX; ++dx) {
        if (dx >= kx) break;
        uint32_t b0, b1;
        ldsm_x2(wc + swz((dx * ky + dy) * FOLD_N + r, b_half) * 16, b0, b1);
#pragma unroll
        for (int bx = 0; bx < FOLD_BX; ++bx) mma_bf16(acc[bx], a[bx + dx], b0, b1);
      }
    }
  }

  // epilogue: P[column][z][n] through shared memory (in the halo's place);
  // lane holds rows (z) g, g + 8, columns 2q, 2q + 1 of each of its columns
  __syncthreads();
  float* p_s = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int bx = 0; bx < FOLD_BX; ++bx)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p_s[((bx * FOLD_BY + warp) * FOLD_ROWS + g + 8 * (e >> 1)) * FOLD_N + 2 * tq + (e & 1)] =
          acc[bx][e];
  __syncthreads();
  const long long nout = (long long)Xo * Yo * Zo;
  for (int i = tid; i < Co * COLS * bz; i += MMA_THREADS) {
    const int oz = i % bz, t = i / bz, col = t % COLS, co = t / COLS;
    const int ox = ox0 + col / FOLD_BY, oy = oy0 + col % FOLD_BY;
    if (ox >= Xo || oy >= Yo || oz0 + oz >= Zo) continue;
    const float* p = p_s + (col * FOLD_ROWS + oz) * FOLD_N + co * kz;
    float s = bias != nullptr ? __bfloat162float(bias[co]) : 0.f;
    for (int dz = 0; dz < kz; ++dz) s += p[dz * FOLD_N + dz];
    y[((long long)b * Co + co) * nout + ((long long)ox * Yo + oy) * Zo + oz0 + oz] =
        __float2bfloat16(s);
  }
}

// Shared memory of route 2: the halo and two chunks' weights (the epilogue's
// P, 16 KB, reuses the halo's space: at least 5 x 9 x 16 voxels, 23 KB).
size_t fold_smem(int kx, int ky) {
  const vg::Halo h = vg::make_fold_halo(kx, ky);
  return (size_t)h.hx * h.hy * h.hz * 32 + 2 * (size_t)kx * ky * vg::FOLD_N * 32;
}

cudaError_t launch_fold(const void* x, const void* w, const void* bias, void* y, int B, int Ci,
                        int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
                        int kz, int px, int py, int pz, int reflect, cudaStream_t s) {
  using namespace vg;
  const size_t smem = fold_smem(kx, ky);
  cudaError_t e = allow_smem(conv3d_fwd_fold_kernel, smem);
  if (e != cudaSuccess) return e;
  const int bz = FOLD_ROWS - kz + 1;
  const long long bricks = (long long)((Xo + FOLD_BX - 1) / FOLD_BX) *
                           ((Yo + FOLD_BY - 1) / FOLD_BY) * ((Zo + bz - 1) / bz);
  conv3d_fwd_fold_kernel<<<dim3((unsigned)bricks, 1, B), MMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint4*>(w),
      static_cast<const __nv_bfloat16*>(bias), static_cast<__nv_bfloat16*>(y), Ci, Co, X, Y, Z,
      Xo, Yo, Zo, kx, ky, kz, px, py, pz, reflect);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. x (B,Ci,X,Y,Z), bias (Co,) or NULL,
// y (B,Co,Xo,Yo,Zo), all contiguous in one dtype (0 = float32, 1 =
// bfloat16); lo pads px, py, pz, zero (reflect = 0) or reflect (1).
// route 0 (CUDA cores): w (Co,Ci,kx,ky,kz), co_tile ignored. route 1 (tensor
// cores, bfloat16 only): w pre-arranged as [ceil(Ci/16)][ceil(Co/co_tile)]
// [taps][co_tile][16] bf16, zero-padded; co_tile a multiple of 8 up to 64.
// route 2 (tensor cores in tap chunks, bfloat16 only): unit stride, Co * kz
// <= 8, co_tile 8; w pre-arranged as [ceil(Ci/16)][kx][ky][8][16] bf16 (row
// co * kz + dz), zero-padded.
// Returns cudaGetLastError() after the launch; 1000 for an argument the
// kernel does not take.
extern "C" int vg_conv3d_fwd(const void* x, const void* w, const void* bias, void* y,
                             int dtype, int B, int Ci, int Co, int X, int Y, int Z,
                             int Xo, int Yo, int Zo, int kx, int ky, int kz, int sx,
                             int sy, int sz, int px, int py, int pz, int reflect, int route,
                             int co_tile, void* stream) {
  if (kx < 1 || ky < 1 || kz < 1 || kx > KMAX || ky > KMAX || kz > KMAX) return 1000;
  if (B < 1 || Ci < 1 || Co < 1 || Xo < 1 || Yo < 1 || Zo < 1) return 1000;
  if (sx < 1 || sy < 1 || sz < 1) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if (dtype == 0)
      return (int)dispatch<float>(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz,
                                  sx, sy, sz, px, py, pz, reflect, s);
    if (dtype == 1)
      return (int)dispatch<__nv_bfloat16>(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx,
                                          ky, kz, sx, sy, sz, px, py, pz, reflect, s);
    return 1000;
  }
  if (route == 2) {
    if (dtype != 1 || co_tile != vg::FOLD_N || sx != 1 || sy != 1 || sz != 1) return 1000;
    if (Co * kz > vg::FOLD_N || fold_smem(kx, ky) > MAX_SMEM) return 1000;
    const int bz = vg::FOLD_ROWS - kz + 1;
    if ((long long)((Xo + 3) / 4) * ((Yo + 7) / 8) * ((Zo + bz - 1) / bz) >= (1LL << 31))
      return 1000;
    return (int)launch_fold(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, px, py,
                            pz, reflect, s);
  }
  if (route != 1 || dtype != 1) return 1000;
  if (co_tile < 8 || co_tile > MMA_MAX_CO_TILE || co_tile % 8 != 0) return 1000;
  if (mma_smem(kx, ky, kz, sx, sy, sz, co_tile) > MAX_SMEM) return 1000;
  if ((long long)((Xo + 3) / 4) * ((Yo + 7) / 8) * ((Zo + 7) / 8) >= (1LL << 31)) return 1000;
#define VG_MMA(NT)                                                                       \
  case NT:                                                                               \
    return (int)launch_mma<NT>(x, w, bias, y, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, \
                               sx, sy, sz, px, py, pz, reflect, s)
  switch (co_tile / 8) {
    VG_MMA(1); VG_MMA(2); VG_MMA(3); VG_MMA(4); VG_MMA(5); VG_MMA(6); VG_MMA(7); VG_MMA(8);
  }
#undef VG_MMA
  return 1000;
}

// The CUDA runtime's message for an error code returned above.
extern "C" const char* vg_error_string(int status) {
  return cudaGetErrorString(static_cast<cudaError_t>(status));
}
