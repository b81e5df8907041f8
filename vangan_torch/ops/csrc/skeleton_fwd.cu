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
// count. The kernel takes any B, X, Y, Z.
//
// What bounds it on the card: memory. A round reads img and skel and writes
// skel and e, 16 bytes a voxel; its min/max work is small once the windows
// are separable, so the design keeps that work in registers and reads img
// from device memory about once:
//
//   - The separable passes. With mx, my, mz the 3-window mins along one axis
//     (+inf outside the volume), erode = min(my(mx v), mz(min(mx v, my v)))
//     (the union of the three windows; min(mz f, mz g) = mz(min(f, g)));
//     with Mx, My, Mz the 3-window maxes, dilate = Mx(My(Mz e)) (e masked to
//     -inf outside the volume). 18 min/max per voxel instead of 46 (about
//     27 with the halos a warp recomputes) and about 6 shuffles.
//   - The tile. A warp owns 32 consecutive z (one a lane, so every load and
//     store is one coalesced row) and TY rows of y, held in registers, and
//     marches along a chunk of CHUNK_X planes of x. The z pass (mz, Mz) takes
//     a lane's two neighbours by warp shuffles; the y pass (my, My) runs
//     inside each lane's registers; the x pass (mx, Mx) is elementwise over
//     the rolling planes: three img planes, two planes of My(Mz e). No
//     shared memory and no barrier.
//   - The halos. e is needed on a halo of 1 around the output, img on a halo
//     of 2. So lanes 2..29 own output z (28 a warp), a warp's rows span
//     TY + 4 of img, and the march starts two planes before its chunk and
//     ends two after: the x halo is paid once per chunk, not once per tile.
//     Neighbouring warps read the halo rows again, mostly from L2.
//   - The loads in flight. Each step of the march issues the next step's
//     loads first (the next img plane, the next output plane's skel_prev),
//     so a warp keeps TY + 4 + TY rows in flight under its work. With 8
//     rows and 16 planes a warp, 3 x 128^3 makes 1920 warps at 128
//     registers, one wave on 132 SMs.
//
// skel_prev and skel_out may be one buffer (each voxel is read, then
// written, by one lane): the forward-only path updates skel in place; the
// differentiated path writes each round's skel to a new buffer, since the
// backward (skeleton_bwd.cu) reads every round's input skel. e goes to
// another buffer (the forward-only caller ping-pongs two), because
// neighbouring warps still read img. Rounds are not fused: the
// differentiated path writes every round's e and skel anyway, for the
// backward, so fusing saves traffic only without a gradient, and R fused
// rounds need a halo of R + 1 on all three axes of a tile.
//
// Exactness: min and max are exact and order-free, so the separable passes
// give the same values as the 19 and 27 taps, and each arithmetic op is
// rounded on its own (__fsub_rn / __fmul_rn / __fadd_rn keep nvcc from
// contracting the update into an FMA). The result is bit-identical to the
// plain torch version, which rounds every op.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int LANES = 32;            // z a warp spans (one a lane)
constexpr int OUT_Z = LANES - 4;     // z a warp writes: lanes 2..29
constexpr int TY = 8;                // output rows of y a warp owns
constexpr int CHUNK_X = 16;          // output planes of x a warp marches over
constexpr int WARPS = 4;             // warps a block (each on its own tile)
constexpr int VY = TY + 4, EY = TY + 2;  // rows of img (halo 2) and of e (halo 1)
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float zmin3(float v) {
  return fminf(fminf(v, __shfl_up_sync(FULL, v, 1)), __shfl_down_sync(FULL, v, 1));
}

__device__ __forceinline__ float zmax3(float v) {
  return fmaxf(fmaxf(v, __shfl_up_sync(FULL, v, 1)), __shfl_down_sync(FULL, v, 1));
}

// Rows y0 - 2 .. y0 + TY + 1 of plane x at the lane's z; +inf outside the
// volume.
__device__ __forceinline__ void load_plane(float (&v)[VY], const float* __restrict__ img,
                                           long long col, int x, int X, int Z, long long YZ,
                                           bool zin, unsigned rows) {
  const bool in = zin && x >= 0 && x < X;
  const float* src = img + (col + x * YZ);
#pragma unroll
  for (int j = 0; j < VY; ++j) v[j] = in && (rows >> j & 1u) ? __ldg(src + j * Z) : INFINITY;
}

// One warp a (z tile, y tile, x chunk, sample), z tile fastest, so that
// neighbouring warps share their halo rows in L2.
__global__ void __launch_bounds__(WARPS * LANES)
skel_round_kernel(const float* __restrict__ img, const float* skel_prev, float* skel_out,
                  float* __restrict__ img_next, int X, int Y, int Z, int tiles_z, int tiles_y,
                  int chunks_x, long long warps, int first) {
  const long long w = (long long)blockIdx.x * WARPS + threadIdx.x / LANES;
  if (w >= warps) return;  // the whole warp
  const int lane = threadIdx.x % LANES;
  const int tz = (int)(w % tiles_z);
  const long long r = w / tiles_z;
  const int ty = (int)(r % tiles_y);
  const long long r2 = r / tiles_y;
  const int cx = (int)(r2 % chunks_x);
  const long long b = r2 / chunks_x;

  const int z = tz * OUT_Z - 2 + lane, y0 = ty * TY;
  const int xa = cx * CHUNK_X, xb = min(xa + CHUNK_X, X);
  const bool zin = z >= 0 && z < Z;
  const bool owner = zin && lane >= 2 && lane < 2 + OUT_Z;
  unsigned rows = 0;  // bit j: img row j (y = y0 - 2 + j) lies in the volume
#pragma unroll
  for (int j = 0; j < VY; ++j) rows |= (unsigned)(y0 - 2 + j >= 0 && y0 - 2 + j < Y) << j;
  const long long YZ = (long long)Y * Z;
  // offset of (x, y0 - 2, z) in the volume; rows add j * Z
  const long long col = b * X * YZ + (long long)(y0 - 2) * Z + z;

  float v2[VY], v1[VY], vn[VY];  // img planes p - 2, p - 1, p
  float p1[TY], p2[TY];          // My(Mz e) of planes p - 2, p - 3 (output rows)
  float sp[TY];                  // skel_prev of plane p - 2 (output rows)
#pragma unroll
  for (int k = 0; k < TY; ++k) p1[k] = sp[k] = 0.f;
  load_plane(v2, img, col, xa - 2, X, Z, YZ, zin, rows);
  load_plane(v1, img, col, xa - 1, X, Z, YZ, zin, rows);
  load_plane(vn, img, col, xa, X, Z, YZ, zin, rows);

  // Plane p - 1 is eroded once plane p is loaded, and plane p - 2 is output
  // once plane p - 1 is eroded: the march runs p over xa .. xb + 1. Each step
  // first issues the loads the next one needs (img plane p + 1, skel_prev of
  // plane p - 1), so that their latency passes under this step's work; a
  // lane's skel_prev loads would otherwise wait on its stores of the step
  // before, since skel_out may alias skel_prev.
#pragma unroll 1
  for (int p = xa; p <= xb + 1; ++p) {
    float vf[VY], sf[TY];
    load_plane(vf, img, col, p <= xb ? p + 1 : -1, X, Z, YZ, zin, rows);
    const bool s_in = !first && owner && p - 1 >= xa && p - 1 < xb;
    const float* s_src = skel_prev + (col + (p - 1) * YZ);
#pragma unroll
    for (int k = 0; k < TY; ++k) sf[k] = s_in && (rows >> (k + 2) & 1u) ? s_src[(k + 2) * Z] : 0.f;
    const int xe = p - 1;
    const bool e_in = zin && xe >= 0 && xe < X;
    float a[VY];  // mx(img) on plane p - 1
#pragma unroll
    for (int j = 0; j < VY; ++j) a[j] = fminf(fminf(v2[j], v1[j]), vn[j]);
    float u[EY];  // e on plane p - 1, then Mz e
#pragma unroll
    for (int i = 0; i < EY; ++i) {
      const float t1 = fminf(fminf(a[i], a[i + 1]), a[i + 2]);  // my(mx v)
      // mz(mx v) and mz(my v) in one z pass: min(mz f, mz g) = mz(min(f, g))
      const float t2 = zmin3(fminf(a[i + 1], fminf(fminf(v1[i], v1[i + 1]), v1[i + 2])));
      u[i] = e_in && (rows >> (i + 1) & 1u) ? fminf(t1, t2) : -INFINITY;
    }
    if (img_next != nullptr && owner && xe >= xa && xe < xb) {
      float* dst = img_next + (col + xe * YZ);
#pragma unroll
      for (int i = 1; i <= TY; ++i)
        if (rows >> (i + 1) & 1u) dst[(i + 1) * Z] = u[i];
    }
#pragma unroll
    for (int i = 0; i < EY; ++i) u[i] = zmax3(u[i]);
    float pn[TY];  // My(Mz e) on plane p - 1
#pragma unroll
    for (int k = 0; k < TY; ++k) pn[k] = fmaxf(fmaxf(u[k], u[k + 1]), u[k + 2]);

    if (p >= xa + 2 && owner) {  // output plane p - 2
      float* dst = skel_out + (col + (p - 2) * YZ);
#pragma unroll
      for (int k = 0; k < TY; ++k) {
        if (!(rows >> (k + 2) & 1u)) continue;
        const float opened = fmaxf(fmaxf(p2[k], p1[k]), pn[k]);
        const float delta = fmaxf(__fsub_rn(v2[k + 2], opened), 0.f);
        dst[(k + 2) * Z] = first ? delta
                                 : __fadd_rn(sp[k], fmaxf(__fsub_rn(delta, __fmul_rn(sp[k], delta)),
                                                          0.f));
      }
    }
#pragma unroll
    for (int j = 0; j < VY; ++j) {
      v2[j] = v1[j];
      v1[j] = vn[j];
      vn[j] = vf[j];
    }
#pragma unroll
    for (int k = 0; k < TY; ++k) {
      p2[k] = p1[k];
      p1[k] = pn[k];
      sp[k] = sf[k];
    }
  }
}

}  // namespace

// C entry point, bound with ctypes: one round. img, skel_prev, skel_out,
// img_next are (B, X, Y, Z) float32, contiguous; skel_out may alias
// skel_prev; img_next may be null (not wanted) and must not alias img.
// first = 1 writes skel_out = delta without reading skel_prev (which may then
// be null). Returns cudaGetLastError() after the launch; 1000 for a bad
// argument.
extern "C" int vg_skeleton_round_fwd(const float* img, const float* skel_prev, float* skel_out,
                                     float* img_next, int B, int X, int Y, int Z, int first,
                                     void* stream) {
  if (B < 1 || X < 1 || Y < 1 || Z < 1 || img == img_next || skel_out == nullptr) return 1000;
  if (!first && skel_prev == nullptr) return 1000;
  const int tiles_z = (Z + OUT_Z - 1) / OUT_Z, tiles_y = (Y + TY - 1) / TY;
  const int chunks_x = (X + CHUNK_X - 1) / CHUNK_X;
  const long long warps = (long long)B * chunks_x * tiles_y * tiles_z;
  const long long blocks = (warps + WARPS - 1) / WARPS;
  if (blocks > 0x7fffffffLL) return 1000;
  skel_round_kernel<<<(unsigned)blocks, WARPS * LANES, 0, static_cast<cudaStream_t>(stream)>>>(
      img, skel_prev, skel_out, img_next, X, Y, Z, tiles_z, tiles_y, chunks_x, warps, first);
  return (int)cudaGetLastError();
}
