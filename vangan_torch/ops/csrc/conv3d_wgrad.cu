// 3-D convolution weight gradient for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/conv3d.py::_conv_wgrad
// (body _wgrad_kernel):
//
//   dW[co, ci, d] = sum over b, o of x_pad[b, ci, s*o + d] * g[b, co, o]
//
// accumulated in float32 and returned in float32. x_pad is read through the
// same zero/reflect index map as conv3d_fwd.cu, so no padded copy is made.
// ops/conv3d.py::conv_plan picks the body per shape and passes it in `route`.
//
// What bounds it on the card: the same FMAs as the forward (Co * Ci * taps
// per output voxel) summed over up to B * 128^3 = 6.3 M voxels per weight;
// at the path's heavy convs that is near the bf16 ridge, so the FMAs must
// run on the tensor cores and x must not be gathered once per tap from
// device memory.
//
// route 1, tensor cores (bfloat16; the main path): a GEMM with M = Ci x taps
// (16 channels of one tap per MMA row tile), N = Co (a tile of up to 32) and
// K = the voxels, on mma.sync m16n8k16 (bf16 in, f32 accumulate). A block
// owns one 16-channel chunk of Ci, one Co tile and a group of up to 32 taps,
// and walks its share of the (sample, 4 x 8 x 8 brick) pairs: per brick it
// stages g (Co tile x 256 voxels) and the brick's x halo of its channels
// once in shared memory (conv3d_common.cuh), and forms each tap's operand
// from that halo by offset, with ldmatrix.trans. Warps split the taps (up
// to four each); where a tap group is narrower than eight warps (1^3
// shortcuts and head), the remaining warps split the voxels instead, so a
// 1^3 conv does not pay for a 27-tap tile. Split-K: each block (and each
// voxel-splitting warp) writes its f32 partial tile to its own slice of a
// workspace (slices, Co, Ci * taps) that the wrapper allocates; a second
// launch sums the slices in a fixed order. No atomics: dW is bit-identical
// from run to run. mma.sync and not wgmma: wgmma wants 64-row tiles of A in
// swizzled shared memory behind a descriptor, which the per-tap shifted
// halo views are not, and the tensor-core rate is not what bounds these
// shapes, the staging of g and the halo is.
//
// route 2, tensor cores in tap chunks (bfloat16, more than 64 taps at unit
// stride with Ci >= 16 and Co * kz <= 8: the ResNet generator's 7^3 head, 32
// -> 1). At Co = 1 an N = Co tile would be 7/8 padding, and a Ci x taps
// row tile per tap gathers x again for each of the 343 taps. For each (dx,
// dy) pair of taps, with v running over the brick's voxels extended by kz -
// 1 along z,
//
//   dW[co, ci, dx, dy, dz] = sum over v of x_pad[ci, v + (dx, dy, 0)] * g[co, v - dz e_z]
//
// is a GEMM with M = the 16 channels of a chunk, N = the kz shifts of g
// (column co * kz + dz; 7 of 8 useful at Co = 1) and K = the voxels: a
// block owns a 16-channel chunk and walks its share of the (sample, brick)
// pairs, bricks of 4 x 8 columns of 16 z positions (16 - kz + 1 outputs
// each). Per brick it stages the x halo of its channels (conv3d_common.cuh,
// as the forward's route 2) and g's z halo of each column once, and builds
// each shifted B fragment from the latter in registers; warp dy owns the
// tap chunk (kx, 1, kz) of its dy, loads the halo row (hx, by + dy) of each
// hx < 4 + kx - 1 once per brick row by (ldmatrix.trans), and feeds it to
// the MMAs of every (bx, dx) with bx + dx = hx. The same split-K contract:
// block slice s of the workspace (split, Co, Ci * taps) gets every element
// of its chunk, and the sum launch adds the slices in slice order, so dW is
// bit-identical from run to run.
//
// route 3, tensor cores for one input channel (bfloat16, Ci = 1, more than
// 64 taps at unit stride: the ResNet generator's 7^3 stem, 1 -> 32). With
// Ci = 1 there is no 16-channel M, and the CUDA-core body issues 343 FMAs
// per voxel and output channel (18.6 ms at 3 x 128^3 on an H100). It is
// route 3's forward GEMM transposed: for each dz,
//
//   dW[co, 0, dx, dy, dz] = sum over v of x_pad[v + (dx, dy, dz)] * g[co, v]
//
// is an MMA with M = the (dx, dy) pairs (49 padded to 64 at 7^3: four m
// tiles), N = a Co tile (four n tiles at Co = 32) and K = the 16 z positions
// of a column. A block owns route 3's brick (4 x 8 columns of 16 output z)
// and walks its share of the (sample, brick) pairs: per brick it stages the
// x halo exactly as the forward does (conv3d_taps.cuh stage_pair_halo: kz
// copies, copy dz shifted by dz along z), so that A's row for a pair, 16
// consecutive z of copy dz at halo row (bx + dx, by + dy), is one aligned
// ldmatrix row (the forward reads the same rows with ldmatrix.trans), and g
// as [column][co][16 z] (zero outside the output; the co rows of a column
// contiguous and swizzled, so the eight rows of an ldmatrix read fall in
// eight bank groups). Warp w < kz owns the tap plane dz = w and keeps the
// 64 x Co-tile f32 accumulator (64 registers a thread at Co = 32; all kz
// planes in one warp would need 448); per column it loads the Co tile's B
// fragments once and feeds each to its m tiles. The same split-K contract
// as routes 0 and 2: block slice s of the workspace (split, Co, taps) gets
// every element of the block's Co tile, and the sum launch adds the slices
// in slice order, so dW is bit-identical from run to run.
//
// route 0, CUDA cores (float32, and bfloat16 shapes the tensor-core routes
// do not take: more than 64 taps outside routes 2 and 3, such as Ci = 2):
// a GEMM with M = Co, N = Ci * taps (the "columns") and K = the voxels. A block owns an MT x NTILE tile of dW and
// walks its share of the voxels in chunks of NT: per chunk it stages g
// (MT x NT) and the gathered x columns (NT x NTILE) in shared memory, and
// each thread accumulates a 4 x 4 register tile in f32 (no TF32). The voxel
// range is split over gridDim.x blocks (the caller's `split`, from
// ops/conv3d.py::conv_plan); each block writes its partial tile to its own
// slice of the workspace (split, Co, Ci * taps) and the sum launch of route
// 1 adds the slices in slice order: no atomics, dW bit-identical from run to
// run here too. Three tile shapes (16 x 256, 32 x 128, 64 x 64); the host
// picks the one with least padding.

#include "conv3d_taps.cuh"

namespace {

using vg::KMAX;
using vg::map_index;
using vg::to_f;

constexpr int THREADS = 256;
constexpr int NT = 32;    // voxels per chunk
constexpr int MMA_MAX_CO_TILE = 32;
constexpr int TAPS_PER_WARP = 4;
constexpr int G_STRIDE = vg::BRICK + 8;  // g tile row: 256 voxels + 16 bytes against bank conflicts
constexpr size_t MAX_SMEM = 227 * 1024;

template <typename T, int MT, int NTILE>
__global__ void __launch_bounds__(THREADS)
conv3d_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ ws,
                    int B, int Ci, int Co, int X, int Y, int Z, int Xo, int Yo, int Zo,
                    int kx, int ky, int kz, int sx, int sy, int sz, int px, int py, int pz,
                    int reflect, long long n_chunks) {
  static_assert((MT / 4) * (NTILE / 4) == THREADS, "one 4x4 tile per thread");
  __shared__ float g_s[MT][NT + 1];
  __shared__ __align__(16) float x_s[NT][NTILE];
  __shared__ long long v_x[NT];  // b*Ci*plane of the voxel, -1 past the end
  __shared__ long long v_g[NT];  // b*Co*nout + o
  __shared__ int v_off[NT][3][KMAX];  // element offset per axis and tap, -1 = zero pad
  __shared__ int c_ci[NTILE];   // input channel of the column, -1 past the end
  __shared__ int c_tap[NTILE];  // dx | dy << 4 | dz << 8

  const int taps = kx * ky * kz;
  const int ncols = Ci * taps;
  const int co0 = blockIdx.y * MT;
  const int q0 = blockIdx.z * NTILE;
  const long long plane = (long long)X * Y * Z;
  const long long nout = (long long)Xo * Yo * Zo;
  const long long total = (long long)B * nout;
  const int tid = threadIdx.x;
  const int tn = tid % (NTILE / 4), tm = tid / (NTILE / 4);

  for (int q = tid; q < NTILE; q += THREADS) {
    const int qq = q0 + q;
    int ci = -1, tp = 0;
    if (qq < ncols) {
      ci = qq / taps;
      const int t = qq % taps;
      tp = (t / (ky * kz)) | (((t / kz) % ky) << 4) | ((t % kz) << 8);
    }
    c_ci[q] = ci;
    c_tap[q] = tp;
  }

  float acc[4][4];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int k = 0; k < 4; ++k) acc[j][k] = 0.f;

  for (long long chunk = blockIdx.x; chunk < n_chunks; chunk += gridDim.x) {
    const long long v0 = chunk * NT;
    __syncthreads();  // the previous chunk's tiles are consumed
    // one thread per voxel decodes it (32-bit: the caller keeps B*nout < 2^31)
    for (int n = tid; n < NT; n += THREADS) {
      const long long v = v0 + n;
      if (v < total) {
        const int vi = (int)v, no = (int)nout;
        const int bb = vi / no, o = vi - bb * no;
        const int oz = o % Zo, t = o / Zo, oy = t % Yo, ox = t / Yo;
        v_x[n] = (long long)bb * Ci * plane;
        v_g[n] = (long long)bb * Co * nout + o;
#pragma unroll
        for (int d = 0; d < KMAX; ++d) {
          const int ix = d < kx ? map_index(ox * sx + d - px, X, reflect) : -1;
          const int iy = d < ky ? map_index(oy * sy + d - py, Y, reflect) : -1;
          v_off[n][0][d] = ix < 0 ? -1 : ix * Y * Z;
          v_off[n][1][d] = iy < 0 ? -1 : iy * Z;
          v_off[n][2][d] = d < kz ? map_index(oz * sz + d - pz, Z, reflect) : -1;
        }
      } else {
        v_x[n] = -1;
        v_g[n] = -1;
      }
    }
    __syncthreads();
    for (int i = tid; i < MT * NT; i += THREADS) {
      const int n = i % NT, m = i / NT;
      const long long vg = v_g[n];
      g_s[m][n] = (vg >= 0 && co0 + m < Co) ? to_f(g[vg + (long long)(co0 + m) * nout]) : 0.f;
    }
    for (int i = tid; i < NT * NTILE; i += THREADS) {
      const int q = i % NTILE, n = i / NTILE;
      const int ci = c_ci[q];
      const long long vx = v_x[n];
      float val = 0.f;
      if (ci >= 0 && vx >= 0) {
        const int tp = c_tap[q];
        const int ox = v_off[n][0][tp & 15], oy = v_off[n][1][(tp >> 4) & 15],
                  oz = v_off[n][2][tp >> 8];
        if (ox >= 0 && oy >= 0 && oz >= 0) val = to_f(x[vx + ci * plane + ox + oy + oz]);
      }
      x_s[n][q] = val;
    }
    __syncthreads();
#pragma unroll 4
    for (int n = 0; n < NT; ++n) {
      const float4 xv = reinterpret_cast<const float4*>(x_s[n])[tn];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float gv = g_s[tm * 4 + j][n];
        acc[j][0] = fmaf(gv, xv.x, acc[j][0]);
        acc[j][1] = fmaf(gv, xv.y, acc[j][1]);
        acc[j][2] = fmaf(gv, xv.z, acc[j][2]);
        acc[j][3] = fmaf(gv, xv.w, acc[j][3]);
      }
    }
  }
  float* out = ws + (long long)blockIdx.x * Co * ncols;  // this block's slice
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tm * 4 + j;
    if (co >= Co) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + tn * 4 + k;
      if (q < ncols) out[(long long)co * ncols + q] = acc[j][k];
    }
  }
}

// dw[i] = sum over the slices of ws[slice][i], in slice order.
__global__ void conv3d_wgrad_sum_kernel(const float* __restrict__ ws, float* __restrict__ dw,
                                        int slices, long long n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int k = 0; k < slices; ++k) s += ws[k * n + i];
  dw[i] = s;
}

cudaError_t sum_slices(const float* ws, float* dw, int slices, long long n, cudaStream_t s) {
  conv3d_wgrad_sum_kernel<<<(unsigned)((n + 255) / 256), 256, 0, s>>>(ws, dw, slices, n);
  return cudaGetLastError();
}

template <typename T, int MT, int NTILE>
cudaError_t launch(const void* x, const void* g, float* dw, float* ws, int B, int Ci, int Co,
                   int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky, int kz, int sx,
                   int sy, int sz, int px, int py, int pz, int reflect, int split,
                   cudaStream_t s) {
  const long long total = (long long)B * Xo * Yo * Zo;
  const long long n_chunks = (total + NT - 1) / NT;
  const int ncols = Ci * kx * ky * kz;
  const dim3 grid((unsigned)split, (Co + MT - 1) / MT, (ncols + NTILE - 1) / NTILE);
  conv3d_wgrad_kernel<T, MT, NTILE><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), ws, B, Ci, Co, X, Y, Z, Xo, Yo, Zo,
      kx, ky, kz, sx, sy, sz, px, py, pz, reflect, n_chunks);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_slices(ws, dw, split, (long long)Co * ncols, s);
}

// Padded work of an MT x NTILE tiling of the Co x ncols product.
long long padded(int Co, int ncols, int mt, int nt) {
  return (long long)((Co + mt - 1) / mt * mt) * ((ncols + nt - 1) / nt * nt);
}

template <typename T>
cudaError_t dispatch(const void* x, const void* g, float* dw, float* ws, int B, int Ci, int Co,
                     int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky, int kz,
                     int sx, int sy, int sz, int px, int py, int pz, int reflect, int split,
                     cudaStream_t s) {
  const int ncols = Ci * kx * ky * kz;
  const long long a = padded(Co, ncols, 16, 256), b = padded(Co, ncols, 32, 128),
                  c = padded(Co, ncols, 64, 64);
#define VG_LAUNCH(MT, NTL)                                                                 \
  return launch<T, MT, NTL>(x, g, dw, ws, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, \
                            sy, sz, px, py, pz, reflect, split, s)
  if (a <= b && a <= c) VG_LAUNCH(16, 256);
  if (b <= c) VG_LAUNCH(32, 128);
  VG_LAUNCH(64, 64);
#undef VG_LAUNCH
}

// Route 1: bf16 implicit GEMM on the tensor cores (see the note at the top).
// Grid: x = the split over (sample, brick) pairs, y = (tap group, Ci chunk,
// Co tile) with the Co tile fastest. Block slice s of the workspace, or
// s * (8 / tap_warps) + k for the k-th voxel-splitting warp, gets this
// block's partial dW tile (every element of it, zeros included).
template <int NTL>
__global__ void __launch_bounds__(vg::MMA_THREADS, 2)
conv3d_wgrad_mma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                        float* __restrict__ ws, int B, int Ci, int Co, int X, int Y, int Z,
                        int Xo, int Yo, int Zo, int kx, int ky, int kz, int sx, int sy, int sz,
                        int px, int py, int pz, int reflect, int tap_warps) {
  using namespace vg;
  constexpr int CO_TILE = NTL * 8;
  extern __shared__ uint4 smem[];
  const int taps = kx * ky * kz;
  const Halo h = make_halo(kx, ky, kz, sx, sy, sz);
  uint4* halo = smem;
  unsigned short* g_s = reinterpret_cast<unsigned short*>(smem + 2 * h.hx * h.hy * h.hz);

  const int co_tiles = (Co + CO_TILE - 1) / CO_TILE, n_chunks = (Ci + CI_CHUNK - 1) / CI_CHUNK;
  int wtile = blockIdx.y;
  const int ct = wtile % co_tiles;
  wtile /= co_tiles;
  const int chunk = wtile % n_chunks, tg = wtile / n_chunks;
  const int co0 = ct * CO_TILE, c0 = chunk * CI_CHUNK;
  const int t0 = tg * tap_warps * TAPS_PER_WARP;
  const int t_end = min(taps, t0 + tap_warps * TAPS_PER_WARP);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, r = lane & 7;
  const int kslices = (MMA_THREADS / 32) / tap_warps;
  const int ts = warp % tap_warps, ks = warp / tap_warps;
  // this warp's taps and their offsets in the halo
  int toff[TAPS_PER_WARP];
#pragma unroll
  for (int j = 0; j < TAPS_PER_WARP; ++j) {
    const int t = t0 + ts + j * tap_warps;
    const int dz = t % kz, dy = (t / kz) % ky, dx = t / (ky * kz);
    toff[j] = t < t_end ? (dx * h.hy + dy) * h.hz + dz : -1;
  }
  // ldmatrix rows of this lane: A (.trans) voxel row rr of a k-step and
  // channel half; B (co row, voxel half) of a pair of n tiles
  const int rr = r + 8 * (mi >> 1), a_half = mi & 1;
  const int b_row = (mi >> 1) * 8 + r, b_half = mi & 1;

  float acc[TAPS_PER_WARP][NTL][4];
#pragma unroll
  for (int j = 0; j < TAPS_PER_WARP; ++j)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][nt][e] = 0.f;

  const uint32_t halo_u = smem_u32(halo), g_u = smem_u32(g_s);
  const long long plane = (long long)X * Y * Z, nout = (long long)Xo * Yo * Zo;
  const int nbz = (Zo + BRICK_Z - 1) / BRICK_Z, nby = (Yo + BRICK_Y - 1) / BRICK_Y;
  const int nbx = (Xo + BRICK_X - 1) / BRICK_X;
  const long long n_bricks = (long long)nbx * nby * nbz;
  const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);
  // the g voxel of this thread in every brick
  const int gi = tid / (BRICK_Y * BRICK_Z), gj = (tid / BRICK_Z) % BRICK_Y, gl = tid % BRICK_Z;

  for (long long q = blockIdx.x; q < B * n_bricks; q += gridDim.x) {
    const int bb = (int)(q / n_bricks);
    int bq = (int)(q % n_bricks);
    const int oz0 = (bq % nbz) * BRICK_Z;
    bq /= nbz;
    const int oy0 = (bq % nby) * BRICK_Y, ox0 = (bq / nby) * BRICK_X;
    __syncthreads();  // the previous brick is consumed
    stage_halo(halo, x + (long long)bb * Ci * plane, c0, Ci, X, Y, Z, h, ox0 * sx - px,
               oy0 * sy - py, oz0 * sz - pz, reflect);
    {
      const int ox = ox0 + gi, oy = oy0 + gj, oz = oz0 + gl;
      const bool in = ox < Xo && oy < Yo && oz < Zo;
      const unsigned short* src =
          gs + ((long long)bb * Co + co0) * nout + ((long long)ox * Yo + oy) * Zo + oz;
#pragma unroll 4
      for (int n = 0; n < CO_TILE; ++n)
        g_s[n * G_STRIDE + tid] = in && co0 + n < Co ? __ldg(src + n * nout) : 0;
    }
    __syncthreads();
    for (int kk = ks; kk < BRICK / 16; kk += kslices) {
      uint32_t bf[NTL][2];
#pragma unroll
      for (int p = 0; p < NTL / 2; ++p) {
        uint32_t b4[4];
        ldsm_x4(g_u + ((p * 16 + b_row) * G_STRIDE + kk * 16 + b_half * 8) * 2, b4);
        bf[2 * p][0] = b4[0];
        bf[2 * p][1] = b4[1];
        bf[2 * p + 1][0] = b4[2];
        bf[2 * p + 1][1] = b4[3];
      }
      if constexpr (NTL & 1)
        ldsm_x2(g_u + (((NTL - 1) * 8 + r) * G_STRIDE + kk * 16 + b_half * 8) * 2,
                bf[NTL - 1][0], bf[NTL - 1][1]);
      const int hv = brick_halo_index(kk * 16 + rr, h);
#pragma unroll
      for (int j = 0; j < TAPS_PER_WARP; ++j) {
        if (toff[j] < 0) continue;
        uint32_t a[4];
        ldsm_x4_trans(halo_u + swz(hv + toff[j], a_half) * 16, a);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) mma_bf16(acc[j][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // C[m = channel of the chunk][n = co]: rows g, g + 8, columns 2q, 2q + 1
  const long long nw = (long long)Co * Ci * taps;
  float* out = ws + ((long long)blockIdx.x * kslices + ks) * nw;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int j = 0; j < TAPS_PER_WARP; ++j) {
    if (toff[j] < 0) continue;
    const int t = t0 + ts + j * tap_warps;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int ci = c0 + gr + 8 * (e >> 1), co = co0 + nt * 8 + 2 * tq + (e & 1);
        if (ci < Ci && co < Co) out[((long long)co * Ci + ci) * taps + t] = acc[j][nt][e];
      }
  }
}

size_t mma_smem(int kx, int ky, int kz, int sx, int sy, int sz, int co_tile) {
  const vg::Halo h = vg::make_halo(kx, ky, kz, sx, sy, sz);
  return (size_t)h.hx * h.hy * h.hz * 32 + (size_t)co_tile * G_STRIDE * 2;
}

template <int NTL>
cudaError_t launch_mma(const void* x, const void* g, float* dw, float* ws, int B, int Ci,
                       int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
                       int kz, int sx, int sy, int sz, int px, int py, int pz, int reflect,
                       int tap_warps, int split, cudaStream_t s) {
  using namespace vg;
  const size_t smem = mma_smem(kx, ky, kz, sx, sy, sz, NTL * 8);
  cudaError_t e = allow_smem(conv3d_wgrad_mma_kernel<NTL>, smem);
  if (e != cudaSuccess) return e;
  const int taps = kx * ky * kz;
  const int tap_groups = (taps + tap_warps * TAPS_PER_WARP - 1) / (tap_warps * TAPS_PER_WARP);
  const int tiles = tap_groups * ((Ci + CI_CHUNK - 1) / CI_CHUNK) * ((Co + NTL * 8 - 1) / (NTL * 8));
  conv3d_wgrad_mma_kernel<NTL><<<dim3(split, tiles), MMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), ws, B, Ci,
      Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, sz, px, py, pz, reflect, tap_warps);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_slices(ws, dw, split * ((MMA_THREADS / 32) / tap_warps), (long long)Co * Ci * taps,
                    s);
}

// Route 2: bf16 GEMM in tap chunks, the kz shifts of g on N (see the note at
// the top). Grid: x = the split over (sample, brick) pairs, y = the Ci
// chunk; 32 * ky threads, warp dy owning the taps (dx, dy, dz).
__global__ void __launch_bounds__(vg::MMA_THREADS, 2)
conv3d_wgrad_fold_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         float* __restrict__ ws, int B, int Ci, int Co, int X, int Y, int Z,
                         int Xo, int Yo, int Zo, int kx, int ky, int kz, int px, int py, int pz,
                         int reflect) {
  using namespace vg;
  constexpr int COLS = FOLD_BX * FOLD_BY;
  extern __shared__ uint4 smem[];
  const Halo h = make_fold_halo(kx, ky);
  const int bz = FOLD_ROWS - kz + 1;  // output z positions of a column
  uint4* halo = smem;
  // g_s[co][column][j]: g at output z position oz0 + j - (KMAX - 1) of the
  // column, 0 outside the column's outputs and the volume
  unsigned short* g_s = reinterpret_cast<unsigned short*>(smem + 2 * h.hx * h.hy * h.hz);

  const int c0 = blockIdx.y * CI_CHUNK;
  const int tid = threadIdx.x, dy = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, r = lane & 7;
  // ldmatrix.trans rows of this lane: A (z position, channel half)
  const int a_z = r + 8 * (mi >> 1), a_half = mi & 1;
  // B (16 z positions x FOLD_N): this lane's column n = (co, dz), rows 2q,
  // 2q + 1 (b0) and 2q + 8, 2q + 9 (b1), read from g_s at z - dz
  const int gn = lane >> 2, tq = lane & 3;
  const bool n_live = gn < Co * kz;
  const int g_off = n_live ? (gn / kz) * COLS * FOLD_G_ROW + (KMAX - 1) - gn % kz : 0;

  float acc[KMAX][4];
#pragma unroll
  for (int dx = 0; dx < KMAX; ++dx)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[dx][e] = 0.f;

  const uint32_t halo_u = smem_u32(halo);
  const long long plane = (long long)X * Y * Z, nout = (long long)Xo * Yo * Zo;
  const int nbz = (Zo + bz - 1) / bz, nby = (Yo + FOLD_BY - 1) / FOLD_BY;
  const int nbx = (Xo + FOLD_BX - 1) / FOLD_BX;
  const long long n_bricks = (long long)nbx * nby * nbz;
  const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);

  for (long long q = blockIdx.x; q < B * n_bricks; q += gridDim.x) {
    const int bb = (int)(q / n_bricks);
    int bq = (int)(q % n_bricks);
    const int oz0 = (bq % nbz) * bz;
    bq /= nbz;
    const int oy0 = (bq % nby) * FOLD_BY, ox0 = (bq / nby) * FOLD_BX;
    __syncthreads();  // the previous brick is consumed
    stage_halo(halo, x + (long long)bb * Ci * plane, c0, Ci, X, Y, Z, h, ox0 - px, oy0 - py,
               oz0 - pz, reflect);
    for (int i = tid; i < Co * COLS * FOLD_G_ROW; i += blockDim.x) {
      const int j = i % FOLD_G_ROW, t = i / FOLD_G_ROW, col = t % COLS, co = t / COLS;
      const int oz = j - (KMAX - 1), ox = ox0 + col / FOLD_BY, oy = oy0 + col % FOLD_BY;
      const bool in = oz >= 0 && oz < bz && oz0 + oz < Zo && ox < Xo && oy < Yo;
      g_s[i] = in ? __ldg(gs + ((long long)bb * Co + co) * nout +
                          ((long long)ox * Yo + oy) * Zo + oz0 + oz)
                  : (unsigned short)0;
    }
    __syncthreads();
    for (int by = 0; by < FOLD_BY; ++by) {
      uint32_t a[FOLD_BX + KMAX - 1][4];
#pragma unroll
      for (int hx = 0; hx < FOLD_BX + KMAX - 1; ++hx)
        if (hx < FOLD_BX + kx - 1)
          ldsm_x4_trans(halo_u + swz((hx * h.hy + by + dy) * h.hz + a_z, a_half) * 16, a[hx]);
      uint32_t bf[FOLD_BX][2];
#pragma unroll
      for (int bx = 0; bx < FOLD_BX; ++bx) {
        const unsigned short* gc = g_s + g_off + (bx * FOLD_BY + by) * FOLD_G_ROW + 2 * tq;
        bf[bx][0] = n_live ? (uint32_t)gc[0] | ((uint32_t)gc[1] << 16) : 0u;
        bf[bx][1] = n_live ? (uint32_t)gc[8] | ((uint32_t)gc[9] << 16) : 0u;
      }
#pragma unroll
      for (int dx = 0; dx < KMAX; ++dx) {
        if (dx >= kx) break;
#pragma unroll
        for (int bx = 0; bx < FOLD_BX; ++bx) mma_bf16(acc[dx], a[bx + dx], bf[bx][0], bf[bx][1]);
      }
    }
  }

  // C[m = channel of the chunk][n = (co, dz)]: rows gr, gr + 8, columns 2q, 2q + 1
  const int taps = kx * ky * kz;
  float* out = ws + (long long)blockIdx.x * Co * Ci * taps;
  const int gr = lane >> 2;
#pragma unroll
  for (int dx = 0; dx < KMAX; ++dx) {
    if (dx >= kx) break;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int ci = c0 + gr + 8 * (e >> 1), n = 2 * tq + (e & 1);
      if (ci < Ci && n < Co * kz)
        out[(((long long)(n / kz) * Ci + ci) * kx + dx) * ky * kz + dy * kz + n % kz] =
            acc[dx][e];
    }
  }
}

size_t fold_smem(int kx, int ky, int Co) {
  const vg::Halo h = vg::make_fold_halo(kx, ky);
  return (size_t)h.hx * h.hy * h.hz * 32 +
         (size_t)Co * vg::FOLD_BX * vg::FOLD_BY * vg::FOLD_G_ROW * 2;
}

cudaError_t launch_fold(const void* x, const void* g, float* dw, float* ws, int B, int Ci,
                        int Co, int X, int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
                        int kz, int px, int py, int pz, int reflect, int split, cudaStream_t s) {
  using namespace vg;
  const size_t smem = fold_smem(kx, ky, Co);
  cudaError_t e = allow_smem(conv3d_wgrad_fold_kernel, smem);
  if (e != cudaSuccess) return e;
  conv3d_wgrad_fold_kernel<<<dim3(split, (Ci + CI_CHUNK - 1) / CI_CHUNK), 32 * ky, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), ws, B, Ci,
      Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, px, py, pz, reflect);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_slices(ws, dw, split, (long long)Co * Ci * kx * ky * kz, s);
}

// Route 3: bf16 GEMM for one input channel, the (dx, dy) pairs on M (see
// the note at the top). Grid: x = the split over (sample, brick) pairs, y =
// the Co tile; MMA_THREADS threads, warp dz < kz owning the taps (dx, dy,
// dz), the others only staging. vec: g's 16-byte units (8 z positions) are
// aligned (Zo % 8 == 0 and g 16-byte aligned).
template <int NTL>
__global__ void __launch_bounds__(vg::MMA_THREADS, 2)
conv3d_wgrad_pair_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ g,
                         float* __restrict__ ws, int B, int Co, int X, int Y, int Z, int Xo,
                         int Yo, int Zo, int kx, int ky, int kz, int px, int py, int pz,
                         int reflect, int vec) {
  using namespace vg;
  constexpr int CO_TILE = NTL * 8;
  extern __shared__ uint4 smem[];
  const int hy = FOLD_BY + ky - 1, rows = (FOLD_BX + kx - 1) * hy;
  uint4* halo = smem;                 // [dz][row][2]
  uint4* g_s = smem + kz * rows * 2;  // [column][co][2]
  const uint32_t halo_u = smem_u32(halo), g_u = smem_u32(g_s);
  const int co0 = blockIdx.y * CO_TILE;
  const int tid = threadIdx.x, dz = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, r = lane & 7;
  const int pairs = kx * ky, steps = pair_steps(kx, ky);

  // this lane's ldmatrix row of A per m tile, one byte each (at most
  // (KMAX - 1) * (FOLD_BY + KMAX - 1) + KMAX - 1 = 112): the halo row of
  // pair 16 m + r + 8 (mi & 1), z half mi >> 1; a padding pair (k >= kx *
  // ky) reads pair 0's row, and its result is dropped
  uint32_t roff = 0;
#pragma unroll
  for (int m = 0; m < PAIR_MAX_STEPS; ++m) {
    const int k = 16 * m + r + 8 * (mi & 1);
    roff |= (uint32_t)(k < pairs ? (k / ky) * hy + k % ky : 0) << (8 * m);
  }
  const int a_half = mi >> 1;
  // this lane's ldmatrix row of B in a column's [co][2] units: co row (mi >>
  // 1) * 8 + r of each pair of n tiles, z half mi & 1 (the swizzle of a row
  // offset by a multiple of 8 is the row's own)
  const uint32_t b_lane = g_u + swz((mi >> 1) * 8 + r, mi & 1) * 16;
  float acc[PAIR_MAX_STEPS][NTL][4];
#pragma unroll
  for (int m = 0; m < PAIR_MAX_STEPS; ++m)
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[m][nt][e] = 0.f;

  const long long plane = (long long)X * Y * Z, nout = (long long)Xo * Yo * Zo;
  // 32-bit: the C entry keeps B * n_bricks < 2^31
  const int n_bricks = ((Xo + FOLD_BX - 1) / FOLD_BX) * ((Yo + FOLD_BY - 1) / FOLD_BY) *
                       ((Zo + FOLD_ROWS - 1) / FOLD_ROWS);
  const unsigned short* gs = reinterpret_cast<const unsigned short*>(g);

  for (int q = blockIdx.x; q < B * n_bricks; q += gridDim.x) {
    const int bb = q / n_bricks;
    int ox0, oy0, oz0;
    brick_origin(q % n_bricks, Yo, Zo, FOLD_BX, FOLD_BY, FOLD_ROWS, ox0, oy0, oz0);
    __syncthreads();  // the previous brick is consumed
    stage_pair_halo(halo, x + bb * plane, X, Y, Z, kx, ky, kz, px, py, pz, reflect, ox0, oy0,
                    oz0);
    // g_s unit (column, co, half): g at output z oz0 + 8 half .. + 7 of the
    // column, 0 outside the output; a warp stores 16 consecutive co rows
    for (int u = tid; u < PAIR_COLS * CO_TILE * 2; u += MMA_THREADS) {
      const int hh = u & 1, co = (u >> 1) % CO_TILE, col = (u >> 1) / CO_TILE;
      const int ox = ox0 + col / FOLD_BY, oy = oy0 + col % FOLD_BY, oz = oz0 + 8 * hh;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (ox < Xo && oy < Yo && oz < Zo && co0 + co < Co) {
        const unsigned short* src =
            gs + ((long long)bb * Co + co0 + co) * nout + ((long long)ox * Yo + oy) * Zo + oz;
        if (vec && oz + 8 <= Zo) {
          v = __ldg(reinterpret_cast<const uint4*>(src));
        } else {
          uint32_t p[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t lo = oz + 2 * j < Zo ? __ldg(src + 2 * j) : 0;
            const uint32_t hi = oz + 2 * j + 1 < Zo ? __ldg(src + 2 * j + 1) : 0;
            p[j] = lo | (hi << 16);
          }
          v = make_uint4(p[0], p[1], p[2], p[3]);
        }
      }
      g_s[swz(col * CO_TILE + co, hh)] = v;
    }
    __syncthreads();
    if (dz >= kz) continue;
    const uint32_t hc = halo_u + (uint32_t)(dz * rows * 32);
    for (int col = 0; col < PAIR_COLS; ++col) {
      const uint32_t g_col = b_lane + (uint32_t)(col * CO_TILE * 32);
      uint32_t bf[NTL][2];
#pragma unroll
      for (int p = 0; p < NTL / 2; ++p) {
        uint32_t t4[4];
        ldsm_x4(g_col + p * 16 * 32, t4);
        bf[2 * p][0] = t4[0];
        bf[2 * p][1] = t4[1];
        bf[2 * p + 1][0] = t4[2];
        bf[2 * p + 1][1] = t4[3];
      }
      // an odd last n tile: lanes 0-15 give ldmatrix.x2 rows r of z half
      // mi & 1, which b_lane holds for them
      if constexpr (NTL & 1) ldsm_x2(g_col + (NTL - 1) * 8 * 32, bf[NTL - 1][0], bf[NTL - 1][1]);
      const int hrow = (col / FOLD_BY) * hy + col % FOLD_BY;
#pragma unroll
      for (int m = 0; m < PAIR_MAX_STEPS; ++m) {
        if (m >= steps) break;
        uint32_t a[4];
        ldsm_x4(hc + swz(hrow + (int)((roff >> (8 * m)) & 255), a_half) * 16, a);
#pragma unroll
        for (int nt = 0; nt < NTL; ++nt) mma_bf16(acc[m][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // C[m = pair][n = co]: rows gr, gr + 8, columns 2q, 2q + 1 of each tile
  if (dz >= kz) return;
  const int taps = pairs * kz;
  float* out = ws + (long long)blockIdx.x * Co * taps;
  const int gr = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int m = 0; m < PAIR_MAX_STEPS; ++m) {
    if (m >= steps) break;
#pragma unroll
    for (int nt = 0; nt < NTL; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int p = 16 * m + gr + 8 * (e >> 1), co = co0 + nt * 8 + 2 * tq + (e & 1);
        if (p < pairs && co < Co) out[(long long)co * taps + p * kz + dz] = acc[m][nt][e];
      }
  }
}

// Shared memory of route 3: the kz halo copies and the Co tile's g columns.
size_t pair_wgrad_smem(int kx, int ky, int kz, int co_tile) {
  const size_t rows = (size_t)(vg::FOLD_BX + kx - 1) * (vg::FOLD_BY + ky - 1);
  return (kz * rows + (size_t)vg::PAIR_COLS * co_tile) * 32;
}

template <int NTL>
cudaError_t launch_pair(const void* x, const void* g, float* dw, float* ws, int B, int Co, int X,
                        int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky, int kz, int px,
                        int py, int pz, int reflect, int split, cudaStream_t s) {
  using namespace vg;
  const size_t smem = pair_wgrad_smem(kx, ky, kz, NTL * 8);
  cudaError_t e = allow_smem(conv3d_wgrad_pair_kernel<NTL>, smem);
  if (e != cudaSuccess) return e;
  const int vec = Zo % 8 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const dim3 grid((unsigned)split, (Co + NTL * 8 - 1) / (NTL * 8));
  conv3d_wgrad_pair_kernel<NTL><<<grid, MMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const __nv_bfloat16*>(g), ws, B, Co, X,
      Y, Z, Xo, Yo, Zo, kx, ky, kz, px, py, pz, reflect, vec);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return sum_slices(ws, dw, split, (long long)Co * kx * ky * kz, s);
}

}  // namespace

// C entry point, bound with ctypes. x (B,Ci,X,Y,Z) and g (B,Co,Xo,Yo,Zo)
// contiguous in one dtype (0 = float32, 1 = bfloat16); dw (Co,Ci,kx,ky,kz)
// float32, contiguous; lo pads px, py, pz, zero (reflect = 0) or reflect (1);
// split the blocks along the voxels (1 to 65535), ws a float32 workspace.
// route 0 (CUDA cores): ws_bytes >= split * Co * Ci * taps * 4; co_tile and
// tap_warps are ignored. route 1 (tensor cores, bfloat16 only): co_tile a
// multiple of 8 up to 32, tap_warps 1, 2, 4 or 8, ws_bytes >= split *
// (8 / tap_warps) * Co * Ci * taps * 4. route 2 (tensor cores in tap chunks,
// bfloat16 only): unit stride, Co * kz <= 8, co_tile 8, tap_warps ignored,
// ws_bytes >= split * Co * Ci * taps * 4. route 3 (tensor cores for one
// input channel, bfloat16 only): Ci = 1, unit stride, co_tile a multiple of
// 8 up to 32, tap_warps ignored, ws_bytes >= split * Co * taps * 4. Every
// element of dw is written.
// Returns cudaGetLastError() after the launches; 1000 for an argument the
// kernel does not take.
extern "C" int vg_conv3d_wgrad(const void* x, const void* g, float* dw, float* ws, int dtype,
                               int B, int Ci, int Co, int X, int Y, int Z, int Xo, int Yo,
                               int Zo, int kx, int ky, int kz, int sx, int sy, int sz, int px,
                               int py, int pz, int reflect, int route, int co_tile,
                               int tap_warps, int split, long long ws_bytes, void* stream) {
  if (kx < 1 || ky < 1 || kz < 1 || kx > KMAX || ky > KMAX || kz > KMAX) return 1000;
  if (B < 1 || Ci < 1 || Co < 1 || Xo < 1 || Yo < 1 || Zo < 1) return 1000;
  if (sx < 1 || sy < 1 || sz < 1) return 1000;
  if (split < 1 || split > 65535 || ws == nullptr) return 1000;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (route == 0) {
    if ((long long)(Co + 15) / 16 > 65535 || (long long)Ci * kx * ky * kz / 64 + 1 > 65535)
      return 1000;
    if ((long long)B * Xo * Yo * Zo >= (1LL << 31)) return 1000;  // 32-bit voxel decode
    if ((long long)split * Co * Ci * kx * ky * kz * 4 > ws_bytes) return 1000;
    if (dtype == 0)
      return (int)dispatch<float>(x, g, dw, ws, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx,
                                  sy, sz, px, py, pz, reflect, split, s);
    if (dtype == 1)
      return (int)dispatch<__nv_bfloat16>(x, g, dw, ws, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky,
                                          kz, sx, sy, sz, px, py, pz, reflect, split, s);
    return 1000;
  }
  if (route == 2) {
    if (dtype != 1 || co_tile != vg::FOLD_N || sx != 1 || sy != 1 || sz != 1) return 1000;
    if (Co * kz > vg::FOLD_N || (Ci + 15) / 16 > 65535 || fold_smem(kx, ky, Co) > MAX_SMEM)
      return 1000;
    if ((long long)split * Co * Ci * kx * ky * kz * 4 > ws_bytes) return 1000;
    const int bz = vg::FOLD_ROWS - kz + 1;
    if ((long long)B * ((Xo + 3) / 4) * ((Yo + 7) / 8) * ((Zo + bz - 1) / bz) >= (1LL << 31))
      return 1000;
    return (int)launch_fold(x, g, dw, ws, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, px, py, pz,
                            reflect, split, s);
  }
  if (route == 3) {
    if (dtype != 1 || Ci != 1 || sx != 1 || sy != 1 || sz != 1) return 1000;
    if (co_tile < 8 || co_tile > vg::PAIR_MAX_CO_TILE || co_tile % 8 != 0) return 1000;
    if (pair_wgrad_smem(kx, ky, kz, co_tile) > MAX_SMEM || (Co + co_tile - 1) / co_tile > 65535)
      return 1000;
    if ((long long)split * Co * kx * ky * kz * 4 > ws_bytes) return 1000;
    if ((long long)B * ((Xo + 3) / 4) * ((Yo + 7) / 8) * ((Zo + 15) / 16) >= (1LL << 31))
      return 1000;
#define VG_PAIR(NTL)                                                                        \
  case NTL:                                                                                 \
    return (int)launch_pair<NTL>(x, g, dw, ws, B, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, px, \
                                 py, pz, reflect, split, s)
    switch (co_tile / 8) {
      VG_PAIR(1); VG_PAIR(2); VG_PAIR(3); VG_PAIR(4);
    }
#undef VG_PAIR
    return 1000;
  }
  if (route != 1 || dtype != 1) return 1000;
  if (co_tile < 8 || co_tile > MMA_MAX_CO_TILE || co_tile % 8 != 0) return 1000;
  if (tap_warps != 1 && tap_warps != 2 && tap_warps != 4 && tap_warps != 8) return 1000;
  if (mma_smem(kx, ky, kz, sx, sy, sz, co_tile) > MAX_SMEM) return 1000;
  const long long taps = (long long)kx * ky * kz;
  const long long tiles = (taps + tap_warps * TAPS_PER_WARP - 1) / (tap_warps * TAPS_PER_WARP) *
                          ((Ci + 15) / 16) * ((Co + co_tile - 1) / co_tile);
  if (tiles > 65535) return 1000;
  if ((long long)split * (8 / tap_warps) * Co * Ci * taps * 4 > ws_bytes) return 1000;
#define VG_MMA(NTL)                                                                         \
  case NTL:                                                                                 \
    return (int)launch_mma<NTL>(x, g, dw, ws, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, \
                                sy, sz, px, py, pz, reflect, tap_warps, split, s)
  switch (co_tile / 8) {
    VG_MMA(1); VG_MMA(2); VG_MMA(3); VG_MMA(4);
  }
#undef VG_MMA
  return 1000;
}
