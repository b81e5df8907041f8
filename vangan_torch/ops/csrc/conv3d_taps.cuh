// The tensor-core bodies for kernels of more than 64 taps at unit stride,
// shared by the forward (conv3d_fwd.cu, routes 2 and 3) and the input
// gradient (conv3d_dgrad.cu, which runs them on g, zero-padded by k - 1, with
// the flipped kernel and Ci and Co swapped, as the TPU kernel's _conv_dgrad
// runs _conv_fwd). A body computes one block's brick of the unit-stride conv
//
//   v[co, o] = init(co) + sum over ci, d of x_pad[ci, o + d] * w[co, ci, d]
//
// and hands each v inside the output to the caller's epilogue:
// `epi.begin(ox0, oy0, oz0)`, called once by every thread before a barrier
// that precedes the stores, then `epi.store(co, ox, oy, oz, v)` with absolute
// output coordinates; `epi.init(co)` is the bias (0 for the input gradient).
// The forward's epilogue writes y; the input gradient's writes dx, or the
// reflect fold's f32 buffer, through its destination map. The weight
// gradient's route 3 (conv3d_wgrad.cu) stages route 3's halo with
// stage_pair_halo and reads it as A untransposed.
#pragma once

#include "conv3d_common.cuh"

namespace vg {

// The block of output voxels (ox0, oy0, oz0) of grid index q, z fastest, for
// bricks of bx x by x bz.
__device__ __forceinline__ void brick_origin(int q, int Yo, int Zo, int bx, int by, int bz,
                                             int& ox0, int& oy0, int& oz0) {
  const int nbz = (Zo + bz - 1) / bz, nby = (Yo + by - 1) / by;
  oz0 = (q % nbz) * bz;
  q /= nbz;
  oy0 = (q % nby) * by;
  ox0 = (q / nby) * bx;
}

// ---- route 2: tap chunks, the kz taps on N ---------------------------------
// For each (dx, dy) pair of taps,
//
//   P[v, co * kz + dz] = sum over ci of x_pad[ci, v + (dx, dy, 0)] * w[co, ci, dx, dy, dz]
//
// is one m16n8k16 MMA per 16 voxels v and 16-channel chunk, summed over the
// pairs, and v[o, co] = sum over dz of P[o + dz e_z, co * kz + dz] in the
// epilogue through shared memory. M runs over columns of FOLD_ROWS
// consecutive z positions, so a column gives FOLD_ROWS - kz + 1 outputs. A
// block owns FOLD_BX x FOLD_BY columns; per 16-channel chunk it stages their
// halo once, with the chunk's weights ([dx][dy][FOLD_N][16], the wrapper's
// fold_weights) double-buffered by cp.async, and walks the kernel one y
// slice (kx, 1, kz) at a time: warp w owns the columns (bx, w), loads the
// halo row (hx, w + dy) of each hx < FOLD_BX + kx - 1 once per slice
// (ldmatrix) and feeds it to the MMAs of every (bx, dx) with bx + dx = hx.

// Shared memory of route 2: the halo and two chunks' weights (the epilogue's
// P, 16 KB, reuses the halo's space: at least 5 x 9 x 16 voxels, 23 KB).
__host__ __device__ inline size_t fold_smem(int kx, int ky) {
  const Halo h = make_fold_halo(kx, ky);
  return (size_t)h.hx * h.hy * h.hz * 32 + 2 * (size_t)kx * ky * FOLD_N * 32;
}

// xb: the sample's input (Ci, X, Y, Z); wt: fold_weights' 16-byte units
// [Ci/16][kx][ky][FOLD_N][2]; Co * kz <= FOLD_N output channels; (px, py, pz)
// the lo pads; (ox0, oy0, oz0) the brick's first output voxel.
template <class Epi>
__device__ __forceinline__ void tap_chunk_body(const __nv_bfloat16* __restrict__ xb,
                                               const uint4* __restrict__ wt, int Ci, int Co,
                                               int X, int Y, int Z, int Xo, int Yo, int Zo,
                                               int kx, int ky, int kz, int px, int py, int pz,
                                               int reflect, int ox0, int oy0, int oz0, Epi& epi) {
  constexpr int COLS = FOLD_BX * FOLD_BY;
  extern __shared__ uint4 smem[];
  const Halo h = make_fold_halo(kx, ky);
  const int bz = FOLD_ROWS - kz + 1;  // output z positions of a column
  const int w_units = kx * ky * FOLD_N * 2;
  uint4* halo = smem;
  uint4* w_s = smem + h.hx * h.hy * h.hz * 2;  // two buffers of w_units
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
  epi.begin(ox0, oy0, oz0);
  __syncthreads();
  for (int i = tid; i < Co * COLS * bz; i += MMA_THREADS) {
    const int oz = i % bz, t = i / bz, col = t % COLS, co = t / COLS;
    const int ox = ox0 + col / FOLD_BY, oy = oy0 + col % FOLD_BY;
    if (ox >= Xo || oy >= Yo || oz0 + oz >= Zo) continue;
    const float* p = p_s + (col * FOLD_ROWS + oz) * FOLD_N + co * kz;
    float s = epi.init(co);
    for (int dz = 0; dz < kz; ++dz) s += p[dz * FOLD_N + dz];
    epi.store(co, ox, oy, oz0 + oz, s);
  }
}

// ---- route 3: one input channel, the (dx, dy) pairs on K --------------------
// With Ci = 1 there is no channel to put on the GEMM's K, so the taps go
// there: for each dz,
//
//   v[o, co] += sum over pairs (dx, dy) of x_pad[o + (dx, dy, dz)] * w[co, 0, dx, dy, dz]
//
// is an MMA with M = a column of FOLD_ROWS consecutive z outputs, N = a Co
// tile (n tiles of 8, no padding at Co = 32) and K = the kx * ky pairs padded
// to a multiple of 16 (49 -> 64 at 7^3: 1.31x the useful work with the dz
// loop outside). For one pair, the 16 rows of a column read 16 consecutive
// z positions of the halo, so A's transpose has contiguous rows and
// ldmatrix.trans feeds it; an ldmatrix row must be 16-byte aligned, so the
// halo is staged kz times, copy dz shifted by dz positions along z (each
// (hx, hy) row read once from device memory into registers and written kz
// times), and every dz reads aligned rows of its copy. All the weights
// ([dz][k-step][co][16 pairs], the wrapper's pair_weights) come in once per
// block with cp.async: no chunk loop. A block owns route 2's FOLD_BX x
// FOLD_BY columns, warp w the columns (bx, w); per (dz, k-step) it loads the
// Co tile's B fragments once and feeds them to its FOLD_BX columns. The
// epilogue stages
// the f32 sums through shared memory ([co][column][z], rows offset by 4
// floats against bank conflicts), so that consecutive threads store
// consecutive z of one channel.
constexpr int PAIR_COLS = FOLD_BX * FOLD_BY;
constexpr int PAIR_MAX_CO_TILE = 32;
constexpr int PAIR_MAX_STEPS = KMAX * KMAX / 16;           // k-steps of 16 pairs
constexpr int PAIR_P_STRIDE = PAIR_COLS * FOLD_ROWS + 4;  // floats per staged co row
static_assert(FOLD_BY * 32 == MMA_THREADS, "a warp per column of y");

__host__ __device__ inline int pair_steps(int kx, int ky) { return (kx * ky + 15) / 16; }

// 16-byte units of one Co tile's weights: [kz][steps][co_tile][2]
__host__ __device__ inline int pair_w_units(int kx, int ky, int kz, int co_tile) {
  return kz * pair_steps(kx, ky) * co_tile * 2;
}

// Shared memory of route 3: the kz halo copies and the weights, or the staged
// outputs, whichever is larger.
__host__ __device__ inline size_t pair_smem(int kx, int ky, int kz, int co_tile) {
  const size_t rows = (size_t)(FOLD_BX + kx - 1) * (FOLD_BY + ky - 1);
  const size_t main = (kz * rows * 2 + (size_t)pair_w_units(kx, ky, kz, co_tile)) * 16;
  const size_t out = (size_t)co_tile * PAIR_P_STRIDE * 4;
  return main > out ? main : out;
}

// Stage route 3's halo for the brick at output (ox0, oy0, oz0): the
// (FOLD_BX + kx - 1) x (FOLD_BY + ky - 1) (x, y) rows, kz times ([dz][row][2]
// 16-byte units, swizzled), copy dz holding the row's FOLD_ROWS padded z
// positions oz0 + dz .. oz0 + dz + FOLD_ROWS - 1, read through the index map
// (zero outside a zero pad). Each row is read once from device memory into
// registers and written kz times. xb: the sample's one channel (X, Y, Z).
__device__ __forceinline__ void stage_pair_halo(uint4* halo, const __nv_bfloat16* __restrict__ xb,
                                                int X, int Y, int Z, int kx, int ky, int kz,
                                                int px, int py, int pz, int reflect, int ox0,
                                                int oy0, int oz0) {
  const int hy = FOLD_BY + ky - 1, rows = (FOLD_BX + kx - 1) * hy;
  const unsigned short* xs = reinterpret_cast<const unsigned short*>(xb);
  for (int row = threadIdx.x; row < rows; row += blockDim.x) {
    const int ix = map_index(ox0 - px + row / hy, X, reflect);
    const int iy = map_index(oy0 - py + row % hy, Y, reflect);
    const bool in = ix >= 0 && iy >= 0;
    const unsigned short* src = xs + ((long long)(in ? ix : 0) * Y + (in ? iy : 0)) * Z;
    unsigned short e[FOLD_ROWS + KMAX - 1];
#pragma unroll
    for (int j = 0; j < FOLD_ROWS + KMAX - 1; ++j) {
      const int iz = j < FOLD_ROWS + kz - 1 ? map_index(oz0 - pz + j, Z, reflect) : -1;
      e[j] = in && iz >= 0 ? __ldg(src + iz) : 0;
    }
#pragma unroll
    for (int c = 0; c < KMAX; ++c) {
      if (c >= kz) break;
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        uint32_t p[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          p[j] = (uint32_t)e[c + 8 * hh + 2 * j] | ((uint32_t)e[c + 8 * hh + 2 * j + 1] << 16);
        halo[c * rows * 2 + swz(row, hh)] = make_uint4(p[0], p[1], p[2], p[3]);
      }
    }
  }
}

// xb: the sample's one input channel (X, Y, Z); wt: this Co tile's weights
// (pair_w_units 16-byte units); its channels co0 .. co0 + NT * 8 - 1 of Co.
template <int NT, class Epi>
__device__ __forceinline__ void pair_body(const __nv_bfloat16* __restrict__ xb,
                                          const uint4* __restrict__ wt, int Co, int co0, int X,
                                          int Y, int Z, int Xo, int Yo, int Zo, int kx, int ky,
                                          int kz, int px, int py, int pz, int reflect, int ox0,
                                          int oy0, int oz0, Epi& epi) {
  constexpr int CO_TILE = NT * 8;
  extern __shared__ uint4 smem[];
  const int hy = FOLD_BY + ky - 1, rows = (FOLD_BX + kx - 1) * hy;
  const int pairs = kx * ky, steps = pair_steps(kx, ky);
  const int w_units = pair_w_units(kx, ky, kz, CO_TILE);
  uint4* halo = smem;                    // [dz][row][2]
  uint4* w_s = smem + kz * rows * 2;     // [dz][step][co][2]
  const uint32_t halo_u = smem_u32(halo), w_u = smem_u32(w_s);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, r = lane & 7;

  for (int u = tid; u < w_units; u += MMA_THREADS)
    cp_async16(w_u + swz(u >> 1, u & 1) * 16, wt + u);
  cp_async_commit();
  stage_pair_halo(halo, xb, X, Y, Z, kx, ky, kz, px, py, pz, reflect, ox0, oy0, oz0);
  cp_async_wait_all();
  __syncthreads();

  // this lane's ldmatrix.trans row of A per k-step: pair k = 16 s + r +
  // 8 (mi >> 1) (row k of A's transpose), z half mi & 1; the padding pairs
  // (k >= kx * ky, zero weights) read pair 0's row
  int roff[PAIR_MAX_STEPS];
#pragma unroll
  for (int s = 0; s < PAIR_MAX_STEPS; ++s) {
    const int k = 16 * s + r + 8 * (mi >> 1);
    roff[s] = k < pairs ? (k / ky) * hy + k % ky : 0;
  }
  const int a_half = mi & 1;
  const int b_row = (mi >> 1) * 8 + r, b_half = mi & 1;
  float acc[FOLD_BX][NT][4];
#pragma unroll
  for (int bx = 0; bx < FOLD_BX; ++bx)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[bx][nt][e] = 0.f;

  for (int dz = 0; dz < kz; ++dz) {
    const uint32_t hc = halo_u + (uint32_t)(dz * rows * 32);
#pragma unroll
    for (int s = 0; s < PAIR_MAX_STEPS; ++s) {
      if (s >= steps) break;
      const int wrow = (dz * steps + s) * CO_TILE;
      uint32_t bf[NT][2];
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        uint32_t t4[4];
        ldsm_x4(w_u + swz(wrow + p * 16 + b_row, b_half) * 16, t4);
        bf[2 * p][0] = t4[0];
        bf[2 * p][1] = t4[1];
        bf[2 * p + 1][0] = t4[2];
        bf[2 * p + 1][1] = t4[3];
      }
      if constexpr (NT & 1)
        ldsm_x2(w_u + swz(wrow + (NT - 1) * 8 + r, b_half) * 16, bf[NT - 1][0], bf[NT - 1][1]);
#pragma unroll
      for (int bx = 0; bx < FOLD_BX; ++bx) {
        uint32_t a[4];
        ldsm_x4_trans(hc + swz(bx * hy + warp + roff[s], a_half) * 16, a);
#pragma unroll
        for (int nt = 0; nt < NT; ++nt) mma_bf16(acc[bx][nt], a, bf[nt][0], bf[nt][1]);
      }
    }
  }

  // epilogue: C[m = z][n = co]; lane holds rows g, g + 8, columns 2q, 2q + 1
  __syncthreads();  // every warp is done with the halo and the weights
  float* p_s = reinterpret_cast<float*>(smem);
  const int g = lane >> 2, tq = lane & 3;
#pragma unroll
  for (int bx = 0; bx < FOLD_BX; ++bx)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p_s[(nt * 8 + 2 * tq + (e & 1)) * PAIR_P_STRIDE + (bx * FOLD_BY + warp) * FOLD_ROWS + g +
            8 * (e >> 1)] = acc[bx][nt][e];
  epi.begin(ox0, oy0, oz0);
  __syncthreads();
  for (int i = tid; i < CO_TILE * PAIR_COLS * FOLD_ROWS; i += MMA_THREADS) {
    const int z = i % FOLD_ROWS, col = (i / FOLD_ROWS) % PAIR_COLS;
    const int co = i / (FOLD_ROWS * PAIR_COLS);
    const int ox = ox0 + col / FOLD_BY, oy = oy0 + col % FOLD_BY, oz = oz0 + z;
    if (co0 + co >= Co || ox >= Xo || oy >= Yo || oz >= Zo) continue;
    epi.store(co0 + co, ox, oy, oz,
              epi.init(co0 + co) + p_s[co * PAIR_P_STRIDE + col * FOLD_ROWS + z]);
  }
}

}  // namespace vg
