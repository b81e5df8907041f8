// 3-D convolution weight gradient for Hopper (sm_90a), NCXYZ layout.
//
// Replaces the TPU kernel vangan_tpu/ops/pallas/conv3d.py::_conv_wgrad
// (body _wgrad_kernel):
//
//   dW[co, ci, d] = sum over b, o of x_pad[b, ci, s*o + d] * g[b, co, o]
//
// accumulated in float32 and returned in float32. x_pad is read through the
// same zero/reflect index map as conv3d_fwd.cu, so no padded copy is made.
//
// What bounds it on the card: the same FMAs as the forward (Co * Ci * taps
// per output voxel), over a reduction of up to B * 128^3 = 6.3 M voxels per
// weight, so it is compute-bound; this first version runs on the CUDA cores
// in f32. It is a GEMM with M = Co, N = Ci * taps (the "columns") and K = the
// voxels. A block owns an MT x NTILE tile of dW and walks its share of the
// voxels in chunks of NT: per chunk it stages g (MT x NT) and the gathered
// x columns (NT x NTILE) in shared memory, and each thread accumulates a
// 4 x 4 register tile (one float4 of x and four broadcast g values per 16
// FMAs). The voxel range is split over gridDim.x blocks and the partial
// tiles are added into dW with f32 atomics (dW is zeroed by the caller), so
// the sum order, and the last bits of dW, vary from run to run. Three tile
// shapes (16 x 256, 32 x 128, 64 x 64) fit the layer widths of the path;
// the host picks the one with least padding. wgmma/TMA is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;
constexpr int NT = 32;    // voxels per chunk
constexpr int KMAX = 8;   // largest kernel extent per axis
constexpr int TARGET_BLOCKS = 132 * 10;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

// Coordinate i of the padded axis -> index into [0, n), or -1 for a zero pad
// (numpy 'reflect' for any width, as conv3d_fwd.cu).
__device__ __forceinline__ int map_index(int i, int n, int reflect) {
  if (i >= 0 && i < n) return i;
  if (!reflect) return -1;
  if (n == 1) return 0;
  const int period = 2 * (n - 1);
  i %= period;
  if (i < 0) i += period;
  return i < n ? i : period - i;
}

template <typename T, int MT, int NTILE>
__global__ void __launch_bounds__(THREADS)
conv3d_wgrad_kernel(const T* __restrict__ x, const T* __restrict__ g, float* __restrict__ dw,
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
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int co = co0 + tm * 4 + j;
    if (co >= Co) continue;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int q = q0 + tn * 4 + k;
      if (q < ncols) atomicAdd(dw + (long long)co * ncols + q, acc[j][k]);
    }
  }
}

template <typename T, int MT, int NTILE>
void launch(const void* x, const void* g, float* dw, int B, int Ci, int Co, int X, int Y,
            int Z, int Xo, int Yo, int Zo, int kx, int ky, int kz, int sx, int sy, int sz,
            int px, int py, int pz, int reflect, cudaStream_t s) {
  const long long total = (long long)B * Xo * Yo * Zo;
  const long long n_chunks = (total + NT - 1) / NT;
  const int tiles_m = (Co + MT - 1) / MT, tiles_n = (Ci * kx * ky * kz + NTILE - 1) / NTILE;
  long long split = (TARGET_BLOCKS + (long long)tiles_m * tiles_n - 1) / ((long long)tiles_m * tiles_n);
  if (split > n_chunks) split = n_chunks;
  if (split > 65535) split = 65535;
  const dim3 grid((unsigned)split, tiles_m, tiles_n);
  conv3d_wgrad_kernel<T, MT, NTILE><<<grid, THREADS, 0, s>>>(
      static_cast<const T*>(x), static_cast<const T*>(g), dw, B, Ci, Co, X, Y, Z, Xo, Yo, Zo,
      kx, ky, kz, sx, sy, sz, px, py, pz, reflect, n_chunks);
}

// Padded work of an MT x NTILE tiling of the Co x ncols product.
long long padded(int Co, int ncols, int mt, int nt) {
  return (long long)((Co + mt - 1) / mt * mt) * ((ncols + nt - 1) / nt * nt);
}

template <typename T>
void dispatch(const void* x, const void* g, float* dw, int B, int Ci, int Co, int X, int Y,
              int Z, int Xo, int Yo, int Zo, int kx, int ky, int kz, int sx, int sy, int sz,
              int px, int py, int pz, int reflect, cudaStream_t s) {
  const int ncols = Ci * kx * ky * kz;
  const long long a = padded(Co, ncols, 16, 256), b = padded(Co, ncols, 32, 128),
                  c = padded(Co, ncols, 64, 64);
#define VG_LAUNCH(MT, NTL)                                                                    \
  launch<T, MT, NTL>(x, g, dw, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, sz, px, py, \
                     pz, reflect, s)
  if (a <= b && a <= c) VG_LAUNCH(16, 256);
  else if (b <= c) VG_LAUNCH(32, 128);
  else VG_LAUNCH(64, 64);
#undef VG_LAUNCH
}

}  // namespace

// C entry point, bound with ctypes. x (B,Ci,X,Y,Z) and g (B,Co,Xo,Yo,Zo)
// contiguous in one dtype (0 = float32, 1 = bfloat16); dw (Co,Ci,kx,ky,kz)
// float32, contiguous and zeroed by the caller; lo pads px, py, pz, zero
// (reflect = 0) or reflect (1). Returns cudaGetLastError() after the launch;
// 1000 for an argument the kernel does not take.
extern "C" int vg_conv3d_wgrad(const void* x, const void* g, float* dw, int dtype, int B,
                               int Ci, int Co, int X, int Y, int Z, int Xo, int Yo, int Zo,
                               int kx, int ky, int kz, int sx, int sy, int sz, int px, int py,
                               int pz, int reflect, void* stream) {
  if (kx < 1 || ky < 1 || kz < 1 || kx > KMAX || ky > KMAX || kz > KMAX) return 1000;
  if (B < 1 || Ci < 1 || Co < 1 || Xo < 1 || Yo < 1 || Zo < 1) return 1000;
  if ((long long)(Co + 15) / 16 > 65535 || (long long)Ci * kx * ky * kz / 64 + 1 > 65535)
    return 1000;
  if ((long long)B * Xo * Yo * Zo >= (1LL << 31)) return 1000;  // 32-bit voxel decode
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    dispatch<float>(x, g, dw, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, sz, px, py,
                    pz, reflect, s);
  else if (dtype == 1)
    dispatch<__nv_bfloat16>(x, g, dw, B, Ci, Co, X, Y, Z, Xo, Yo, Zo, kx, ky, kz, sx, sy, sz,
                            px, py, pz, reflect, s);
  else
    return 1000;
  return (int)cudaGetLastError();
}
