// 3-D convolution input gradient for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/conv3d.py::_conv_dgrad, the
// parity-decomposed transposed conv. For the conv y = conv(pad(x), w, s):
//
//   dxp[b, ci, s*q + p] = sum over co, e of g[b, co, q - e] * w[co, ci, s*e + p]
//
// per stride parity p (per axis, the taps d = s*e + p), then the pad folded
// back onto dx: dropped for a zero pad, added into the voxels it copies for a
// reflect pad. f32 accumulation, dx written in g's dtype, rounded once.
//
// What bounds it on the card: the same FMAs as the forward (Ci * Co * taps
// per input voxel), near the bf16 ridge on the heavy convs, and, on the
// stride-2 convs, the many small sub-kernels (1 to 8 taps) that each parity
// runs over the same g. So all the parities of a conv run in ONE launch, and
// each runs the implicit GEMM of its parity's stride-1 sub-conv over g (M =
// positions of that parity, N = a tile of x's channels, K = g's channels x
// the sub-kernel's taps). The epilogue writes dx in place at the strided
// positions s*q + p - lo: no zero fill, no per-parity pieces, no interleave
// copy, no full-volume f32 intermediate. A parity with no taps (the odd
// positions of a 1^3 stride-2 conv) writes zeros. Positions in a zero pad are
// not stored. A reflect pad's fold needs f32 sums across parities: the
// positions it reads (the pad positions and the interior positions they fold
// onto, a few planes per axis) go to a small f32 buffer instead of dx, and
// one fold launch sums them in ops/pad.py::pad3d_grad's order (per axis: the
// lo slab's, then the interior, then the hi slab's; x, then y, then z) and
// rounds each voxel once.
//
// route 1, tensor cores (bfloat16; the main path): the forward's machinery
// (conv3d_common.cuh). A block owns a brick of 4 x 8 x 8 positions of the
// parity grid, a sample and a Ci tile of up to 64, and runs every parity of
// that brick in turn. The brick's g halo (voxel-major, 16 channels per
// voxel) is staged in shared memory once for all the parities when it fits:
// each parity's sub-kernel reads its view of parity 0's halo at an offset,
// so a stride-2 3^3 conv stages g once where eight launches staged it eight
// times. Per parity and 16-channel chunk of g, the chunk's weights of that
// parity (arranged once per call by ops/conv3d.py::dgrad_weights: every
// parity's flipped sub-kernel, Ci and Co swapped, as [Co chunk][Ci tile][tap]
// [ci][16], one after another) come in with cp.async, and each tap is an MMA
// over a shifted view of the halo (ldmatrix, mma.sync m16n8k16, bf16 in, f32
// accumulate).
//
// route 0, CUDA cores (float32, and bfloat16 shapes the tensor-core route does
// not take: a sub-kernel of more than 64 taps, or Co <= 3): the grid covers
// (parity, positions, Ci tile, sample), parities with the most taps first so
// the longest blocks start first; each thread owns one position of a parity
// and 16 input channels; the weights of a Co tile are staged in shared memory
// as f32 and read as broadcasts. Exact f32 FMAs (no TF32).

#include "conv3d_common.cuh"

namespace {

using vg::KMAX;
using vg::from_f;
using vg::map_index;
using vg::to_f;

constexpr int MAXPAR = 64;            // stride parities sx * sy * sz
constexpr int MAXFOLDPAD = KMAX - 1;  // widest reflect pad per side
constexpr int MAXSP = 4 * MAXFOLDPAD + 4;  // fold positions per axis
constexpr int MAXT = 2 * MAXFOLDPAD + 2;   // fold targets per axis
constexpr int MMA_MAX_CI_TILE = 64;
constexpr int THREADS = 128;          // route 0: positions per block
constexpr int CI_T = 16;              // route 0: input channels per thread
constexpr int FOLD_THREADS = 256;
constexpr size_t MAX_SMEM = 227 * 1024;

// The input's geometry and the fold's tables. Kernels copy it to shared
// memory before their epilogues: lookups with a per-thread index into the
// launch's parameters go through the constant cache one address at a time.
// Its size is ops/conv3d.py::DGRAD_STATIC_SMEM, which the plan counts.
struct Geo {
  int n[3];   // x's extents
  int lo[3];  // lo pads
  int xp[3];  // padded extents
  int fold;   // 1: a reflect pad whose fold goes through buf
  int simple; // 1: every axis is simple (conv3d_dgrad_fold_simple_kernel)
  int ns[3], nt[3];
  int sp[3][MAXSP];  // fold positions per axis (padded coordinates, sorted)
  int tg[3][MAXT];   // fold targets per axis (x coordinates, sorted)
  long long slab;    // fold-buffer floats per (b, ci)
};
static_assert(sizeof(Geo) == 656, "ops/conv3d.py::DGRAD_STATIC_SMEM");

// route 0: staged weights, in floats. A launch that does not opt in to more
// takes 48 KB of shared memory, static included: the kernel's Geo, too.
constexpr int SMEM_FLOATS = (48 * 1024 - (int)sizeof(Geo)) / (int)sizeof(float);

// Everything a launch needs, passed by value (__grid_constant__).
struct Args {
  int B, Ci, Co;
  int no[3];  // g's extents
  int k[3], s[3];  // kernel, stride
  Geo geo;
  int npar;
  int taps_max;     // the largest sub-kernel's taps
  int shared_halo;  // route 1: the g halo staged once for all parities
  int order[MAXPAR];             // product index of the j-th parity to run (the plan's order)
  long long start[MAXPAR + 1];   // route 0: first block of the j-th parity
  long long woff[MAXPAR];        // route 1: weights of parity (product index), 16-byte units
};

// Copy the geometry to shared memory (the caller synchronises before use).
__device__ __forceinline__ void load_geo(Geo& dst, const Geo& src) {
  static_assert(sizeof(Geo) % 4 == 0, "Geo is copied as ints");
  int* d = reinterpret_cast<int*>(&dst);
  const int* s = reinterpret_cast<const int*>(&src);
  for (int i = threadIdx.x; i < (int)(sizeof(Geo) / 4); i += blockDim.x) d[i] = s[i];
}

struct Parity {
  int p[3], e[3], nq[3];  // parity, sub-kernel extents, positions of that parity
};

__host__ __device__ inline Parity parity_of(const Args& a, int pid) {
  Parity q;
  q.p[2] = pid % a.s[2];
  q.p[1] = (pid / a.s[2]) % a.s[1];
  q.p[0] = pid / (a.s[2] * a.s[1]);
  for (int d = 0; d < 3; ++d) {
    q.e[d] = q.p[d] < a.k[d] ? (a.k[d] - q.p[d] + a.s[d] - 1) / a.s[d] : 0;
    q.nq[d] = a.geo.xp[d] > q.p[d] ? (a.geo.xp[d] - q.p[d] + a.s[d] - 1) / a.s[d] : 0;
  }
  return q;
}

// The grid's j-th parity for a block.
__device__ __forceinline__ int parity_slot(const Args& a, long long blk) {
  int j = 0;
  while (blk >= a.start[j + 1]) ++j;
  return j;
}

__device__ __forceinline__ int fold_slot(const Geo& a, int d, int P) {
  for (int j = 0; j < a.ns[d]; ++j) {
    const int q = a.sp[d][j];
    if (q == P) return j;
    if (q > P) break;
  }
  return -1;
}

// Offset in a (b, ci) slab of the fold buffer of padded position P, which is
// a fold position along at least one axis: the x family (fold position along
// x: ns_x * Yp * Zp), then the y family (Xp * ns_y * Zp), then z.
__device__ __forceinline__ long long buf_offset(const Geo& a, const int (&P)[3],
                                                const int (&sp)[3]) {
  const long long X = a.xp[0], Y = a.xp[1], Z = a.xp[2];
  if (sp[0] >= 0) return ((long long)sp[0] * Y + P[1]) * Z + P[2];
  long long base = (long long)a.ns[0] * Y * Z;
  if (sp[1] >= 0) return base + ((long long)P[0] * a.ns[1] + sp[1]) * Z + P[2];
  base += X * a.ns[1] * Z;
  return base + ((long long)P[0] * Y + P[1]) * a.ns[2] + sp[2];
}

// Where the value at padded position P goes: kind 0 nowhere (a zero pad),
// 1 dx at spatial offset off, 2 the fold buffer at slab offset off.
struct Dest {
  int kind;
  long long off;
};

__device__ __forceinline__ Dest dest_of(const Geo& a, const int (&P)[3]) {
  int i[3], sp[3];
  bool pad = false, folds = false;
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    i[d] = P[d] - a.lo[d];
    pad |= i[d] < 0 || i[d] >= a.n[d];
  }
  if (a.fold) {
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      sp[d] = fold_slot(a, d, P[d]);
      folds |= sp[d] >= 0;
    }
    if (folds) return {2, buf_offset(a, P, sp)};  // every pad position is a fold position
  }
  if (pad) return {0, 0};
  return {1, ((long long)i[0] * a.n[1] + i[1]) * a.n[2] + i[2]};
}

// ---- route 1: tensor cores --------------------------------------------------
// Grid x: (sample, brick, Ci tile), the Ci tile fastest; the bricks tile the
// positions of parity 0 (the most of any parity). A block runs every parity
// of its brick in turn (a.order). With a.shared_halo the g halo of every Co
// chunk is staged once, for parity 0's sub-kernel (the largest on every
// axis), and each parity reads its view of it at an offset: a stride-2 3^3
// conv stages g once instead of once per parity. Without it (one parity with
// taps, or a halo too large to keep) the halo is staged per parity and chunk.
// wt: dgrad_weights' buffer as 16-byte units. MULTI: more than one parity
// (a unit-stride conv compiles to the single-parity body).
template <int NT, bool MULTI>
__global__ void __launch_bounds__(vg::MMA_THREADS, 2)
conv3d_dgrad_mma_kernel(const __nv_bfloat16* __restrict__ g, const uint4* __restrict__ wt,
                        __nv_bfloat16* __restrict__ dx, float* __restrict__ buf,
                        const __grid_constant__ Args a) {
  using namespace vg;
  constexpr int N_TILE = NT * 8;
  extern __shared__ uint4 smem[];
  __shared__ Geo G;
  load_geo(G, a.geo);
  __syncthreads();
  const Parity p0 = parity_of(a, 0);
  const int ci_tiles = (a.Ci + N_TILE - 1) / N_TILE;
  const int nbz = (p0.nq[2] + BRICK_Z - 1) / BRICK_Z, nby = (p0.nq[1] + BRICK_Y - 1) / BRICK_Y;
  const int nbx = (p0.nq[0] + BRICK_X - 1) / BRICK_X;
  long long q = blockIdx.x;
  const int ct = (int)(q % ci_tiles);
  q /= ci_tiles;
  const long long bricks = (long long)nbx * nby * nbz;
  const int b = (int)(q / bricks);
  int bq = (int)(q % bricks);
  const int qz0 = (bq % nbz) * BRICK_Z;
  bq /= nbz;
  const int qy0 = (bq % nby) * BRICK_Y, qx0 = (bq / nby) * BRICK_X;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int mi = lane >> 3, r = lane & 7;
  const int a_half = mi >> 1;
  const int b_row = (mi >> 1) * 8 + r, b_half = mi & 1;
  uint4* w_s = smem;  // one parity's weights of one chunk
  uint4* halo = smem + a.taps_max * N_TILE * 2;
  const uint32_t halo_u = smem_u32(halo), w_u = smem_u32(w_s);
  const long long plane_o = (long long)a.no[0] * a.no[1] * a.no[2];
  const __nv_bfloat16* gb = g + (long long)b * a.Co * plane_o;
  const int n_chunks = (a.Co + CI_CHUNK - 1) / CI_CHUNK;
  const Halo h0 = make_halo(p0.e[0], p0.e[1], p0.e[2], 1, 1, 1);
  const int hvox0 = h0.hx * h0.hy * h0.hz;
  const bool shared = MULTI && a.shared_halo;
  if (shared)  // every chunk once; the first barrier below publishes it
    for (int c = 0; c < n_chunks; ++c)
      stage_halo(halo + (long long)c * 2 * hvox0, gb, c * CI_CHUNK, a.Co, a.no[0], a.no[1],
                 a.no[2], h0, qx0 - (p0.e[0] - 1), qy0 - (p0.e[1] - 1), qz0 - (p0.e[2] - 1), 0);
  const long long plane = (long long)G.n[0] * G.n[1] * G.n[2];
  const int gr = lane >> 2, tq = lane & 3;

  for (int jj = 0; jj < (MULTI ? a.npar : 1); ++jj) {
    const int pid = MULTI ? a.order[jj] : 0;
    const Parity par = MULTI ? parity_of(a, pid) : p0;
    const int ex = par.e[0], ey = par.e[1], ez = par.e[2];
    const int taps = ex * ey * ez;
    float acc[2][NT][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

    if (taps > 0) {
      // the stride-1 sub-conv of g, lo pad e - 1, flipped sub-kernel; in the
      // shared halo its view starts e0 - e further along each axis
      const Halo h = shared ? h0 : make_halo(ex, ey, ez, 1, 1, 1);
      const int view = shared ? ((p0.e[0] - ex) * h.hy + (p0.e[1] - ey)) * h.hz +
                                    (p0.e[2] - ez) : 0;
      int a_hv[2];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        a_hv[mt] = brick_halo_index((2 * warp + mt) * 16 + r + 8 * (mi & 1), h) + view;
      const int w_units = taps * N_TILE * 2;
      for (int c = 0; c < n_chunks; ++c) {
        __syncthreads();  // the previous chunk (or parity) is consumed
        const uint4* wsrc = wt + a.woff[pid] + ((long long)c * ci_tiles + ct) * w_units;
        for (int u = tid; u < w_units; u += MMA_THREADS)
          cp_async16(w_u + swz(u >> 1, u & 1) * 16, wsrc + u);
        cp_async_commit();
        if (!shared)
          stage_halo(halo, gb, c * CI_CHUNK, a.Co, a.no[0], a.no[1], a.no[2], h, qx0 - (ex - 1),
                     qy0 - (ey - 1), qz0 - (ez - 1), 0);
        cp_async_wait_all();
        __syncthreads();
        const uint32_t hc = halo_u + (shared ? (uint32_t)(c * 2 * hvox0 * 16) : 0u);
        int t = 0;
        for (int dx_ = 0; dx_ < ex; ++dx_)
          for (int dy = 0; dy < ey; ++dy)
            for (int dz = 0; dz < ez; ++dz, ++t) {
              const int toff = (dx_ * h.hy + dy) * h.hz + dz;
              uint32_t af[2][4];
#pragma unroll
              for (int mt = 0; mt < 2; ++mt)
                ldsm_x4(hc + swz(a_hv[mt] + toff, a_half) * 16, af[mt]);
              const int wrow = t * N_TILE;
#pragma unroll
              for (int p = 0; p < NT / 2; ++p) {
                uint32_t bb[4];
                ldsm_x4(w_u + swz(wrow + p * 16 + b_row, b_half) * 16, bb);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) {
                  mma_bf16(acc[mt][2 * p], af[mt], bb[0], bb[1]);
                  mma_bf16(acc[mt][2 * p + 1], af[mt], bb[2], bb[3]);
                }
              }
              if constexpr (NT & 1) {
                uint32_t b0, b1;
                ldsm_x2(w_u + swz(wrow + (NT - 1) * 8 + r, b_half) * 16, b0, b1);
#pragma unroll
                for (int mt = 0; mt < 2; ++mt) mma_bf16(acc[mt][NT - 1], af[mt], b0, b1);
              }
            }
      }
    }

    // epilogue: C[m = position][n = ci]; lane holds rows g, g + 8, columns 2q, 2q + 1
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int hr = 0; hr < 2; ++hr) {
        const int m = (2 * warp + mt) * 16 + gr + 8 * hr;
        const int qq[3] = {qx0 + m / (BRICK_Y * BRICK_Z), qy0 + (m / BRICK_Z) % BRICK_Y,
                           qz0 + m % BRICK_Z};
        if (qq[0] >= par.nq[0] || qq[1] >= par.nq[1] || qq[2] >= par.nq[2]) continue;
        const int P[3] = {a.s[0] * qq[0] + par.p[0], a.s[1] * qq[1] + par.p[1],
                          a.s[2] * qq[2] + par.p[2]};
        const Dest d = dest_of(G, P);
        if (d.kind == 0) continue;
#pragma unroll
        for (int nt = 0; nt < NT; ++nt)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int ci = ct * N_TILE + nt * 8 + 2 * tq + e;
            if (ci >= a.Ci) continue;
            const float v = acc[mt][nt][2 * hr + e];
            const long long bc = (long long)b * a.Ci + ci;
            if (d.kind == 1) dx[bc * plane + d.off] = __float2bfloat16(v);
            else buf[bc * G.slab + d.off] = v;
          }
      }
  }
}

// ---- route 0: CUDA cores ----------------------------------------------------
// Grid x: per parity in launch order, its positions in blocks of THREADS; y:
// Ci tiles of CI_T; z: samples. w: (Co, Ci, kx, ky, kz) in g's dtype.
template <typename T>
__global__ void __launch_bounds__(THREADS)
conv3d_dgrad_kernel(const T* __restrict__ g, const T* __restrict__ w, T* __restrict__ dx,
                    float* __restrict__ buf, const __grid_constant__ Args a, int co_tile) {
  extern __shared__ float w_s[];  // [co_tile][taps][CI_T]
  __shared__ Geo G;
  load_geo(G, a.geo);  // published by the barrier before the epilogue
  const long long blk = blockIdx.x;
  const int j = parity_slot(a, blk);
  const Parity par = parity_of(a, a.order[j]);
  const long long npos = (long long)par.nq[0] * par.nq[1] * par.nq[2];
  const long long q = (blk - a.start[j]) * THREADS + threadIdx.x;
  const bool active = q < npos;
  const int ci0 = blockIdx.y * CI_T, b = blockIdx.z;
  const int ex = par.e[0], ey = par.e[1], ez = par.e[2];
  const int taps = ex * ey * ez;
  int qx = 0, qy = 0, qz = 0;
  if (active) {
    qz = (int)(q % par.nq[2]);
    qy = (int)((q / par.nq[2]) % par.nq[1]);
    qx = (int)(q / ((long long)par.nq[2] * par.nq[1]));
  }
  float acc[CI_T];
#pragma unroll
  for (int c = 0; c < CI_T; ++c) acc[c] = 0.f;

  const long long plane_o = (long long)a.no[0] * a.no[1] * a.no[2];
  const int taps_w = a.k[0] * a.k[1] * a.k[2];
  for (int co0 = 0; co0 < a.Co && taps > 0; co0 += co_tile) {
    const int cn = min(co_tile, a.Co - co0);
    __syncthreads();
    for (int i = threadIdx.x; i < cn * taps * CI_T; i += THREADS) {
      const int col = i % CI_T, rr = i / CI_T, t = rr % taps, cl = rr / taps;
      const int tz = t % ez, ty = (t / ez) % ey, tx = t / (ez * ey);
      const int d = ((a.s[0] * tx + par.p[0]) * a.k[1] + a.s[1] * ty + par.p[1]) * a.k[2] +
                    a.s[2] * tz + par.p[2];
      const int ci = ci0 + col;
      w_s[i] = ci < a.Ci ? to_f(w[((long long)(co0 + cl) * a.Ci + ci) * taps_w + d]) : 0.f;
    }
    __syncthreads();
    if (!active) continue;
    for (int cl = 0; cl < cn; ++cl) {
      const T* gc = g + ((long long)b * a.Co + co0 + cl) * plane_o;
      const float4* wc = reinterpret_cast<const float4*>(w_s + cl * taps * CI_T);
      int t = 0;
      for (int tx = 0; tx < ex; ++tx) {
        const int ox = qx - tx;
        for (int ty = 0; ty < ey; ++ty) {
          const int oy = qy - ty;
          for (int tz = 0; tz < ez; ++tz, ++t) {
            const int oz = qz - tz;
            if (ox < 0 || ox >= a.no[0] || oy < 0 || oy >= a.no[1] || oz < 0 || oz >= a.no[2])
              continue;
            const float v = to_f(gc[((long long)ox * a.no[1] + oy) * a.no[2] + oz]);
#pragma unroll
            for (int c4 = 0; c4 < CI_T / 4; ++c4) {
              const float4 wv = wc[t * (CI_T / 4) + c4];
              acc[4 * c4 + 0] = fmaf(v, wv.x, acc[4 * c4 + 0]);
              acc[4 * c4 + 1] = fmaf(v, wv.y, acc[4 * c4 + 1]);
              acc[4 * c4 + 2] = fmaf(v, wv.z, acc[4 * c4 + 2]);
              acc[4 * c4 + 3] = fmaf(v, wv.w, acc[4 * c4 + 3]);
            }
          }
        }
      }
    }
  }
  __syncthreads();
  if (!active) return;
  const int P[3] = {a.s[0] * qx + par.p[0], a.s[1] * qy + par.p[1], a.s[2] * qz + par.p[2]};
  const Dest d = dest_of(G, P);
  if (d.kind == 0) return;
  const long long plane = (long long)G.n[0] * G.n[1] * G.n[2];
#pragma unroll
  for (int c = 0; c < CI_T; ++c) {
    const int ci = ci0 + c;
    if (ci >= a.Ci) continue;
    const long long bc = (long long)b * a.Ci + ci;
    if (d.kind == 1) dx[bc * plane + d.off] = from_f<T>(acc[c]);
    else buf[bc * G.slab + d.off] = acc[c];
  }
}

// ---- the reflect fold ---------------------------------------------------------

__device__ __forceinline__ bool is_target(const Geo& a, int d, int i) {
  for (int j = 0; j < a.nt[d]; ++j)
    if (a.tg[d][j] == i) return true;
  return false;
}

// The idx-th position of axis d that is not a fold target.
__device__ __forceinline__ int non_target(const Geo& a, int d, int idx) {
  int pos = idx;
  for (int j = 0; j < a.nt[d]; ++j) {
    if (a.tg[d][j] > pos) break;
    ++pos;
  }
  return pos;
}

// The fold along axis d for x position i: value(P) of the padded positions
// that pad3d_grad adds into i, in its order: the lo slab's (summed in
// position order), plus the interior one, then each of the hi slab's. A
// position no pad folds onto keeps its interior value. No arrays: the
// positions are found again by the index map (a few pad positions per axis).
template <int D, typename F>
__device__ __forceinline__ float fold_axis(const Geo& a, int i, F value) {
  const int n = a.n[D], lo = a.lo[D], hi = a.xp[D] - n - lo;
  if (!is_target(a, D, i)) return value(i + lo);
  float acc = 0.f;
  bool any = false;
  for (int P = 0; P < lo; ++P)
    if (map_index(P - lo, n, 1) == i) {
      const float v = value(P);
      acc = any ? acc + v : v;
      any = true;
    }
  acc = any ? acc + value(i + lo) : value(i + lo);
  for (int P = lo + n; P < lo + n + hi; ++P)
    if (map_index(P - lo, n, 1) == i) acc += value(P);
  return acc;
}

// One thread per x voxel that a fold target lies on along some axis: the x
// family (target along x), then the y family (not along x), then z.
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
conv3d_dgrad_fold_kernel(const float* __restrict__ buf, T* __restrict__ dx,
                         const __grid_constant__ Args args, int per_bc) {
  __shared__ Geo a;
  load_geo(a, args.geo);
  __syncthreads();
  const int t = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (t >= per_bc) return;
  const int X = a.n[0], Y = a.n[1], Z = a.n[2];
  const int fam_x = a.nt[0] * Y * Z;
  const int fam_y = (X - a.nt[0]) * a.nt[1] * Z;
  int i[3];
  if (t < fam_x) {
    i[0] = a.tg[0][t / (Y * Z)];
    i[1] = (t / Z) % Y;
    i[2] = t % Z;
  } else if (t < fam_x + fam_y) {
    const int u = t - fam_x;
    i[2] = u % Z;
    i[1] = a.tg[1][(u / Z) % a.nt[1]];
    i[0] = non_target(a, 0, u / (Z * a.nt[1]));
  } else {
    const int u = t - fam_x - fam_y;
    i[2] = a.tg[2][u % a.nt[2]];
    const int r = u / a.nt[2];
    i[1] = non_target(a, 1, r % (Y - a.nt[1]));
    i[0] = non_target(a, 0, r / (Y - a.nt[1]));
  }
  const long long plane = (long long)X * Y * Z;
  const long long off = ((long long)i[0] * Y + i[1]) * Z + i[2];
  for (long long bc = blockIdx.y; bc < (long long)args.B * args.Ci; bc += gridDim.y) {
    const float* slab = buf + bc * a.slab;
    const float v = fold_axis<2>(a, i[2], [&](int Pz) {
      return fold_axis<1>(a, i[1], [&](int Py) {
        return fold_axis<0>(a, i[0], [&](int Px) {
          const int P[3] = {Px, Py, Pz};
          const int sp[3] = {fold_slot(a, 0, Px), fold_slot(a, 1, Py), fold_slot(a, 2, Pz)};
          return slab[buf_offset(a, P, sp)];
        });
      });
    });
    dx[bc * plane + off] = from_f<T>(v);
  }
}

// The fold when every axis is simple: lo + hi <= n - 2, so a lo pad position
// P folds onto i = lo - P (1..lo) and a hi one onto i = 2(n - 1) - (P - lo)
// (n - 1 - hi .. n - 2), each target has one source besides itself, and a
// fold position's slot is arithmetic. Every reflect conv of the path pads 1.
__device__ __forceinline__ int simple_slot(const Geo& a, int d, int P) {
  const int lo = a.lo[d], n = a.n[d], hi = a.xp[d] - n - lo;
  if (P < lo) return P;
  if (P <= 2 * lo) return P == lo ? -1 : P - 1;
  if (P < lo + n - 1 - hi) return -1;
  if (P <= lo + n - 2) return 2 * lo + P - (lo + n - 1 - hi);
  if (P < lo + n) return -1;
  return 2 * lo + hi + P - lo - n;
}

// One thread per x voxel that a fold target lies on (the families of
// conv3d_dgrad_fold_kernel) and a stride of (b, ci) planes: its (at most 8)
// buffer offsets are found once, then each plane is 1 to 8 loads added in
// pad3d_grad's order (per axis: lo source + interior, or interior + hi
// source; x innermost, then y, then z).
template <typename T>
__global__ void __launch_bounds__(FOLD_THREADS)
conv3d_dgrad_fold_simple_kernel(const float* __restrict__ buf, T* __restrict__ dx,
                                const __grid_constant__ Args args, int per_bc) {
  __shared__ Geo a;
  load_geo(a, args.geo);
  __syncthreads();
  const int t = blockIdx.x * FOLD_THREADS + threadIdx.x;
  if (t >= per_bc) return;
  const int X = a.n[0], Y = a.n[1], Z = a.n[2];
  const int fam_x = a.nt[0] * Y * Z;
  const int fam_y = (X - a.nt[0]) * a.nt[1] * Z;
  int i[3];
  if (t < fam_x) {
    i[0] = a.tg[0][t / (Y * Z)];
    i[1] = (t / Z) % Y;
    i[2] = t % Z;
  } else if (t < fam_x + fam_y) {
    const int u = t - fam_x;
    i[2] = u % Z;
    i[1] = a.tg[1][(u / Z) % a.nt[1]];
    i[0] = non_target(a, 0, u / (Z * a.nt[1]));
  } else {
    const int u = t - fam_x - fam_y;
    i[2] = a.tg[2][u % a.nt[2]];
    const int r = u / a.nt[2];
    i[1] = non_target(a, 1, r % (Y - a.nt[1]));
    i[0] = non_target(a, 0, r / (Y - a.nt[1]));
  }
  int src[3][2], cnt[3];  // per axis the positions summed, left to right
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const int lo = a.lo[d], n = a.n[d], hi = a.xp[d] - n - lo;
    src[d][0] = src[d][1] = i[d] + lo;
    cnt[d] = 1;
    if (i[d] >= 1 && i[d] <= lo) {
      src[d][0] = lo - i[d];
      cnt[d] = 2;
    } else if (i[d] >= n - 1 - hi && i[d] <= n - 2) {
      src[d][1] = lo + 2 * (n - 1) - i[d];
      cnt[d] = 2;
    }
  }
  long long off[2][2][2];
#pragma unroll
  for (int x = 0; x < 2; ++x)
#pragma unroll
    for (int y = 0; y < 2; ++y)
#pragma unroll
      for (int z = 0; z < 2; ++z) {
        const int P[3] = {src[0][x], src[1][y], src[2][z]};
        const int sp[3] = {simple_slot(a, 0, P[0]), simple_slot(a, 1, P[1]),
                           simple_slot(a, 2, P[2])};
        off[x][y][z] = buf_offset(a, P, sp);
      }
  const long long plane = (long long)X * Y * Z;
  const long long doff = ((long long)i[0] * Y + i[1]) * Z + i[2];
  for (long long bc = blockIdx.y; bc < (long long)args.B * args.Ci; bc += gridDim.y) {
    const float* slab = buf + bc * a.slab;
    float vz = 0.f;
#pragma unroll
    for (int z = 0; z < 2; ++z) {
      if (z >= cnt[2]) break;
      float vy = 0.f;
#pragma unroll
      for (int y = 0; y < 2; ++y) {
        if (y >= cnt[1]) break;
        float vx = slab[off[0][y][z]];
        if (cnt[0] == 2) vx = vx + slab[off[1][y][z]];
        vy = y == 0 ? vx : vy + vx;
      }
      vz = z == 0 ? vy : vz + vy;
    }
    dx[bc * plane + doff] = from_f<T>(vz);
  }
}

// ---- host side -----------------------------------------------------------------

// The fold's tables from the plan (ops/conv3d.py::dgrad_tables): per axis
// the number of fold positions, then the positions of x, y and z (padded
// coordinates, sorted); the targets are the interior ones among them.
// Refuses a table that is not sorted, leaves the axis, misses a pad position,
// or does not have the layout simple_slot assumes on a simple axis.
bool load_fold(Args& a, const int* hi, const int* fold) {
  Geo& G = a.geo;
  const int* pos = fold + 3;
  long long ns_total = 0;
  G.simple = 1;
  for (int d = 0; d < 3; ++d) {
    const int n = G.n[d], lo = G.lo[d], ns = fold[d];
    if (ns < 0 || ns > MAXSP) return false;
    G.ns[d] = ns;
    G.nt[d] = 0;
    int pads = 0;
    for (int j = 0; j < ns; ++j) {
      const int P = pos[j];
      if (P < 0 || P >= G.xp[d] || (j > 0 && P <= pos[j - 1])) return false;
      G.sp[d][j] = P;
      if (P < lo || P >= lo + n) {
        ++pads;
      } else {
        if (G.nt[d] == MAXT) return false;
        G.tg[d][G.nt[d]++] = P - lo;
      }
    }
    if (pads != lo + hi[d]) return false;
    if (lo + hi[d] > 0 && lo + hi[d] > n - 2) G.simple = 0;
    pos += ns;
    ns_total += ns;
  }
  for (int d = 0; d < 3; ++d)  // simple: the pads and one target each, so slots < ns
    if (G.simple && G.ns[d] != 2 * (G.lo[d] + hi[d])) return false;
  G.fold = ns_total > 0;
  G.slab = (long long)G.ns[0] * G.xp[1] * G.xp[2] + (long long)G.xp[0] * G.ns[1] * G.xp[2] +
           (long long)G.xp[0] * G.xp[1] * G.ns[2];
  return true;
}

template <typename T>
cudaError_t launch_fold(const float* buf, void* dx, const Args& a, cudaStream_t s) {
  const Geo& G = a.geo;
  const int X = G.n[0], Y = G.n[1], Z = G.n[2];
  const long long per_bc = (long long)G.nt[0] * Y * Z + (long long)(X - G.nt[0]) * G.nt[1] * Z +
                           (long long)(X - G.nt[0]) * (Y - G.nt[1]) * G.nt[2];
  if (per_bc == 0) return cudaSuccess;
  if (per_bc >= (1LL << 31) - FOLD_THREADS) return cudaErrorInvalidValue;
  const long long bc = (long long)a.B * a.Ci;
  if (G.simple) {  // a thread takes several planes: about 2^20 threads in all
    long long ny = ((1LL << 20) + per_bc - 1) / per_bc;
    ny = ny < bc ? ny : bc;
    const dim3 grid((unsigned)((per_bc + FOLD_THREADS - 1) / FOLD_THREADS),
                    (unsigned)(ny < 65535 ? ny : 65535));
    conv3d_dgrad_fold_simple_kernel<T><<<grid, FOLD_THREADS, 0, s>>>(
        buf, static_cast<T*>(dx), a, (int)per_bc);
    return cudaGetLastError();
  }
  const dim3 grid((unsigned)((per_bc + FOLD_THREADS - 1) / FOLD_THREADS),
                  (unsigned)(bc < 65535 ? bc : 65535));
  conv3d_dgrad_fold_kernel<T><<<grid, FOLD_THREADS, 0, s>>>(buf, static_cast<T*>(dx), a,
                                                             (int)per_bc);
  return cudaGetLastError();
}

template <int NT, bool MULTI>
cudaError_t launch_mma_body(const void* g, const void* w, void* dx, float* buf, const Args& a,
                            long long blocks, size_t smem, cudaStream_t s) {
  cudaError_t e = vg::allow_smem(conv3d_dgrad_mma_kernel<NT, MULTI>, smem);
  if (e != cudaSuccess) return e;
  conv3d_dgrad_mma_kernel<NT, MULTI><<<(unsigned)blocks, vg::MMA_THREADS, smem, s>>>(
      static_cast<const __nv_bfloat16*>(g), static_cast<const uint4*>(w),
      static_cast<__nv_bfloat16*>(dx), buf, a);
  return cudaGetLastError();
}

template <int NT>
cudaError_t launch_mma(const void* g, const void* w, void* dx, float* buf, const Args& a,
                       long long blocks, size_t smem, cudaStream_t s) {
  return a.npar > 1 ? launch_mma_body<NT, true>(g, w, dx, buf, a, blocks, smem, s)
                    : launch_mma_body<NT, false>(g, w, dx, buf, a, blocks, smem, s);
}

template <typename T>
cudaError_t launch_cuda_cores(const void* g, const void* w, void* dx, float* buf, const Args& a,
                              int co_tile, int taps_max, cudaStream_t s) {
  const size_t smem = (size_t)co_tile * taps_max * CI_T * sizeof(float);
  cudaError_t e = vg::allow_smem(conv3d_dgrad_kernel<T>, smem);
  if (e != cudaSuccess) return e;
  const dim3 grid((unsigned)a.start[a.npar], (a.Ci + CI_T - 1) / CI_T, a.B);
  conv3d_dgrad_kernel<T><<<grid, THREADS, smem, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(w), static_cast<T*>(dx), buf, a, co_tile);
  return cudaGetLastError();
}

}  // namespace

// C entry point, bound with ctypes. g (B,Co,Xo,Yo,Zo) and dx (B,Ci,X,Y,Z),
// contiguous in one dtype (0 = float32, 1 = bfloat16); pads lx..lz (lo) and
// hx..hz (hi), zero (reflect = 0) or reflect (1, at most 7 per side).
// route 0 (CUDA cores): w (Co,Ci,kx,ky,kz) in g's dtype; ci_tile ignored.
// order, fold: the plan's parity order and fold table (ops/conv3d.py::
// dgrad_tables; the fold table is read for a reflect pad only).
// route 1 (tensor cores, bfloat16 only): w is ops/conv3d.py::dgrad_weights(w,
// stride, ci_tile), ci_tile a multiple of 8 up to 64; shared_halo 1 stages g's
// halo once per block for all the parities; smem_bytes the plan's dynamic
// shared memory, which must be this launch's. buf: for a reflect pad, an f32
// scratch of buf_bytes >= B * Ci * slab * 4 (the plan's fold_bytes), else
// ignored. Makes one launch, and one fold launch for a reflect pad. Returns
// cudaGetLastError() after the launches; 1000 for an argument the kernel does
// not take.
extern "C" int vg_conv3d_dgrad(const void* g, const void* w, void* dx, float* buf, int dtype,
                               int B, int Ci, int Co, int X, int Y, int Z, int Xo, int Yo, int Zo,
                               int kx, int ky, int kz, int sx, int sy, int sz, int lx, int ly,
                               int lz, int hx, int hy, int hz, int reflect, const int* order,
                               const int* fold, int route, int ci_tile, int shared_halo,
                               int smem_bytes, long long buf_bytes, void* stream) {
  Args a;
  const int k[3] = {kx, ky, kz}, st[3] = {sx, sy, sz}, lo[3] = {lx, ly, lz}, hi[3] = {hx, hy, hz};
  const int n[3] = {X, Y, Z}, no[3] = {Xo, Yo, Zo};
  if (B < 1 || Ci < 1 || Co < 1 || B > 65535) return 1000;
  a.B = B;
  a.Ci = Ci;
  a.Co = Co;
  long long npar = 1;
  for (int d = 0; d < 3; ++d) {
    if (k[d] < 1 || k[d] > KMAX || st[d] < 1 || n[d] < 1 || no[d] < 1) return 1000;
    if (lo[d] < 0 || hi[d] < 0) return 1000;
    if (reflect && (lo[d] > MAXFOLDPAD || hi[d] > MAXFOLDPAD)) return 1000;
    a.geo.n[d] = n[d];
    a.no[d] = no[d];
    a.k[d] = k[d];
    a.s[d] = st[d];
    a.geo.lo[d] = lo[d];
    a.geo.xp[d] = n[d] + lo[d] + hi[d];
    if (a.geo.xp[d] < k[d] || (a.geo.xp[d] - k[d]) / st[d] + 1 != no[d]) return 1000;
    npar *= st[d];
  }
  if (npar > MAXPAR || order == nullptr) return 1000;
  a.npar = (int)npar;
  if (reflect) {
    if (fold == nullptr || !load_fold(a, hi, fold)) return 1000;
  } else {
    a.geo.fold = 0;
    a.geo.simple = 0;
    a.geo.slab = 0;
    for (int d = 0; d < 3; ++d) a.geo.ns[d] = a.geo.nt[d] = 0;
  }
  if (a.geo.fold && (buf == nullptr || buf_bytes < (long long)B * Ci * a.geo.slab * 4))
    return 1000;

  // the plan's launch order: every parity once
  unsigned long long seen = 0;
  for (int j = 0; j < a.npar; ++j) {
    const int pid = order[j];
    if (pid < 0 || pid >= a.npar || (seen >> pid & 1)) return 1000;
    seen |= 1ULL << pid;
    a.order[j] = pid;
  }
  int taps[MAXPAR];
  int taps_max = 0;
  for (int pid = 0; pid < a.npar; ++pid) {
    const Parity p = parity_of(a, pid);
    taps[pid] = p.e[0] * p.e[1] * p.e[2];
    if (taps[pid] > taps_max) taps_max = taps[pid];
  }

  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (route == 1) {
    if (dtype != 1 || ci_tile < 8 || ci_tile > MMA_MAX_CI_TILE || ci_tile % 8 != 0) return 1000;
    if (taps_max > 64) return 1000;
    const int ci_tiles = (Ci + ci_tile - 1) / ci_tile, chunks = (Co + 15) / 16;
    long long woff = 0;
    for (int pid = 0; pid < a.npar; ++pid) {
      a.woff[pid] = woff;
      woff += (long long)chunks * ci_tiles * taps[pid] * ci_tile * 2;
    }
    a.taps_max = taps_max;
    a.shared_halo = shared_halo ? 1 : 0;
    // shared memory: one parity's weights of a chunk, and g's halo for parity
    // 0 (the largest sub-kernel on every axis): every chunk's when shared,
    // else one chunk's
    const Parity p0 = parity_of(a, 0);
    const vg::Halo h0 = vg::make_halo(p0.e[0], p0.e[1], p0.e[2], 1, 1, 1);
    const size_t smem =
        ((size_t)taps_max * ci_tile + (size_t)h0.hx * h0.hy * h0.hz * (shared_halo ? chunks : 1)) *
        32;
    if (smem != (size_t)smem_bytes || smem + sizeof(Geo) > MAX_SMEM) return 1000;
    const long long blocks = (long long)((p0.nq[0] + vg::BRICK_X - 1) / vg::BRICK_X) *
                             ((p0.nq[1] + vg::BRICK_Y - 1) / vg::BRICK_Y) *
                             ((p0.nq[2] + vg::BRICK_Z - 1) / vg::BRICK_Z) * B * ci_tiles;
    if (blocks >= (1LL << 31) || blocks < 1) return 1000;
    switch (ci_tile / 8) {
      case 1: e = launch_mma<1>(g, w, dx, buf, a, blocks, smem, s); break;
      case 2: e = launch_mma<2>(g, w, dx, buf, a, blocks, smem, s); break;
      case 3: e = launch_mma<3>(g, w, dx, buf, a, blocks, smem, s); break;
      case 4: e = launch_mma<4>(g, w, dx, buf, a, blocks, smem, s); break;
      case 5: e = launch_mma<5>(g, w, dx, buf, a, blocks, smem, s); break;
      case 6: e = launch_mma<6>(g, w, dx, buf, a, blocks, smem, s); break;
      case 7: e = launch_mma<7>(g, w, dx, buf, a, blocks, smem, s); break;
      default: e = launch_mma<8>(g, w, dx, buf, a, blocks, smem, s); break;
    }
  } else if (route == 0) {
    if (dtype != 0 && dtype != 1) return 1000;
    if ((Ci + CI_T - 1) / CI_T > 65535) return 1000;
    a.taps_max = taps_max;
    a.shared_halo = 0;
    int co_tile = SMEM_FLOATS / (taps_max * CI_T);
    if (co_tile > Co) co_tile = Co;
    if (co_tile < 1) return 1000;
    a.start[0] = 0;
    for (int j = 0; j < a.npar; ++j) {
      const Parity p = parity_of(a, a.order[j]);
      const long long npos = (long long)p.nq[0] * p.nq[1] * p.nq[2];
      a.start[j + 1] = a.start[j] + (npos + THREADS - 1) / THREADS;
    }
    if (a.start[a.npar] >= (1LL << 31) || a.start[a.npar] < 1) return 1000;
    e = dtype == 0 ? launch_cuda_cores<float>(g, w, dx, buf, a, co_tile, taps_max, s)
                   : launch_cuda_cores<__nv_bfloat16>(g, w, dx, buf, a, co_tile, taps_max, s);
  } else {
    return 1000;
  }
  if (e != cudaSuccess || !a.geo.fold) return (int)e;
  e = dtype == 0 ? launch_fold<float>(buf, dx, a, s) : launch_fold<__nv_bfloat16>(buf, dx, a, s);
  return (int)e;
}
