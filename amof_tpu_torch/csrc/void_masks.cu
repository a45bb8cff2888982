// Probe/channel void masks and Monte Carlo point fits of the batched pore
// step, for Hopper.
//
// Replaces the Pallas TPU kernel amof_tpu/pore/surface_kernel.py
// void_masks_points_pallas (kernel #5). For every xy tile (one xy column
// of voxels over the full z extent) the candidates are the rows of three
// runs of the column-sorted atom table (the 3x3 column neighbourhood, y
// edges duplicated). A voxel is in the probe mask iff
// d2 >= (R_j + probe)^2 for every candidate j (likewise the channel mask),
// with d2 the factorized quadratic of the reference:
//   q  = dfx * a + dfy * b,  QQ = |q|^2,  QZ2 = 2 q.c,  A = |c|^2,
//   u  = dz - rint(dz)  (z minimum image),  d2 = (QQ + A u^2) + u QZ2.
// MC sample points of the tile test d2 >= (R_j + probe)^2 against the same
// candidates, unwrapped to Cartesian positions.
//
// One block per tile. The block stages the tile's candidate rows (at most
// 3 x window, CAP at a time) in shared memory, already unwrapped to the
// tile frame with their squared thresholds. Each thread owns items of
// (sub-column, ZG consecutive z voxels): QQ and QZ2 are computed once per
// candidate and reused over the item's ZG voxels, and the ZG results are
// bits in a register. Masks are written straight into [gx, gy, gz] order.
// When a tile has more than CAP candidate rows, later passes read back and
// AND into what the item's own thread wrote (same thread, same item).
//
// What bounds it on the card: f32 operations, about 12 per
// (sub-column, candidate) and 7 per (voxel, candidate), against 36 KB of
// shared candidates per pass; the output is one byte per voxel. Rows past
// a run's end are never read, so the TPU kernel's dead pad rows and their
// negative-threshold guard have no counterpart.
//
// Bit-exactness: the reference's expression order, rintf (round half to
// even, as jnp.round), IEEE division, built with --fmad=false, so masks
// equal the plain PyTorch version (grid_kernel.void_masks_tiles_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CAP = 1024;  // candidate rows staged per pass
constexpr int ZG = 8;      // z voxels per thread item

__global__ void __launch_bounds__(THREADS) void_masks_kernel(
    const float* __restrict__ payload, int m_rows,
    const int* __restrict__ start, const int* __restrict__ count,
    const float* __restrict__ cell, int gx, int gy, int gz, int nbx,
    int nby, float thr_hi, float thr_lo, float thr_fit, int two_masks,
    const float* __restrict__ pts, int n_pts, uint8_t* __restrict__ m_hi,
    uint8_t* __restrict__ m_lo, uint8_t* __restrict__ fit) {
  __shared__ float s_fx[CAP], s_fy[CAP], s_fz[CAP], s_hi[CAP], s_lo[CAP];
  __shared__ float s_wx[CAP], s_wy[CAP], s_wz[CAP], s_tf[CAP];

  const int t = blockIdx.x;
  const int ti = t / nby, tj = t % nby;
  const int tvx = gx / nbx, tvy = gy / nby;
  float c[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) c[i] = cell[i];
  const float azz = c[6] * c[6] + c[7] * c[7] + c[8] * c[8];
  const float cx = ((float)ti + 0.5f) / (float)nbx;
  const float cy = ((float)tj + 0.5f) / (float)nby;
  const int st0 = start[3 * t], st1 = start[3 * t + 1],
            st2 = start[3 * t + 2];
  const int n0 = count[3 * t], n1 = count[3 * t + 1],
            n2 = count[3 * t + 2];
  const int total = n0 + n1 + n2;
  const int n_zg = (gz + ZG - 1) / ZG;
  const int items = tvx * tvy * n_zg;
  const bool with_pts = pts != nullptr && n_pts > 0;

  for (int base = 0;; base += CAP) {
    const int rows = min(CAP, total - base);
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      int q = base + j;
      int row;
      if (q < n0) {
        row = st0 + q;
      } else if (q < n0 + n1) {
        row = st1 + (q - n0);
      } else {
        row = st2 + (q - n0 - n1);
      }
      const float fx = payload[row];
      const float fy = payload[m_rows + row];
      const float fz = payload[2 * m_rows + row];
      const float r = payload[3 * m_rows + row];
      const float fxc = fx - rintf(fx - cx);
      const float fyc = fy - rintf(fy - cy);
      s_fx[j] = fxc;
      s_fy[j] = fyc;
      s_fz[j] = fz;
      const float th = r + thr_hi;
      s_hi[j] = th * th;
      const float tl = r + thr_lo;
      s_lo[j] = tl * tl;
      if (with_pts) {
        s_wx[j] = fxc * c[0] + fyc * c[3] + fz * c[6];
        s_wy[j] = fxc * c[1] + fyc * c[4] + fz * c[7];
        s_wz[j] = fxc * c[2] + fyc * c[5] + fz * c[8];
        const float tf = r + thr_fit;
        s_tf[j] = tf * tf;
      }
    }
    __syncthreads();

    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int sub = it / n_zg, zg = it % n_zg;
      const int lx = sub / tvy, ly = sub % tvy;
      const float sfx = ((float)(ti * tvx) + (float)lx + 0.5f) / (float)gx;
      const float sfy = ((float)(tj * tvy) + (float)ly + 0.5f) / (float)gy;
      const int z0 = zg * ZG;
      const int nz = min(ZG, gz - z0);
      float vz[ZG];
#pragma unroll
      for (int k = 0; k < ZG; ++k) vz[k] = ((float)(z0 + k) + 0.5f) / (float)gz;
      const long long vox0 =
          ((long long)(ti * tvx + lx) * gy + (tj * tvy + ly)) * gz + z0;
      unsigned hb = 0, lb = 0;
      if (base == 0) {
        hb = lb = (1u << nz) - 1u;
      } else {
        for (int k = 0; k < nz; ++k) {
          hb |= (unsigned)(m_hi[vox0 + k] != 0) << k;
          if (two_masks) lb |= (unsigned)(m_lo[vox0 + k] != 0) << k;
        }
      }
      for (int j = 0; j < rows; ++j) {
        const float dfx = sfx - s_fx[j];
        const float dfy = sfy - s_fy[j];
        const float qx = dfx * c[0] + dfy * c[3];
        const float qy = dfx * c[1] + dfy * c[4];
        const float qz = dfx * c[2] + dfy * c[5];
        const float qq = qx * qx + qy * qy + qz * qz;
        const float qdz = (qx * c[6] + qy * c[7] + qz * c[8]) * 2.0f;
        const float fz = s_fz[j], th = s_hi[j], tl = s_lo[j];
#pragma unroll
        for (int k = 0; k < ZG; ++k) {
          const float dz = vz[k] - fz;
          const float u = dz - rintf(dz);
          const float uu = azz * (u * u);
          const float d2 = (qq + uu) + u * qdz;
          if (!(d2 >= th)) hb &= ~(1u << k);
          if (!(d2 >= tl)) lb &= ~(1u << k);
        }
      }
      for (int k = 0; k < nz; ++k) {
        m_hi[vox0 + k] = (uint8_t)((hb >> k) & 1u);
        if (two_masks) m_lo[vox0 + k] = (uint8_t)((lb >> k) & 1u);
      }
    }

    if (with_pts) {
      for (int p = threadIdx.x; p < n_pts; p += blockDim.x) {
        const long long o = (long long)t * n_pts + p;
        const float vx = pts[3 * o], vy = pts[3 * o + 1], vzp = pts[3 * o + 2];
        const float px = vx * c[0] + vy * c[3] + vzp * c[6];
        const float py = vx * c[1] + vy * c[4] + vzp * c[7];
        const float pz = vx * c[2] + vy * c[5] + vzp * c[8];
        bool ok = base == 0 ? true : fit[o] != 0;
        for (int j = 0; j < rows; ++j) {
          const float s = rintf(vzp - s_fz[j]);
          const float dx = px - s_wx[j] - s * c[6];
          const float dy = py - s_wy[j] - s * c[7];
          const float dz = pz - s_wz[j] - s * c[8];
          const float d2 = dx * dx + dy * dy + dz * dz;
          ok = ok && (d2 >= s_tf[j]);
        }
        fit[o] = (uint8_t)ok;
      }
    }
    if (base + CAP >= total) break;
    __syncthreads();  // staged rows are rewritten by the next pass
  }
}

}  // namespace

extern "C" int void_masks_launch(const void* payload, int m_rows,
                                 const void* start, const void* count,
                                 const void* cell, int gx, int gy, int gz,
                                 int nbx, int nby, float thr_hi, float thr_lo,
                                 float thr_fit, int two_masks, const void* pts,
                                 int n_pts, void* m_hi, void* m_lo, void* fit,
                                 void* stream) {
  const int n_tiles = nbx * nby;
  if (n_tiles <= 0 || gz <= 0) return 0;
  if (gx % nbx || gy % nby) return (int)cudaErrorInvalidValue;
  void_masks_kernel<<<n_tiles, THREADS, 0, (cudaStream_t)stream>>>(
      (const float*)payload, m_rows, (const int*)start, (const int*)count,
      (const float*)cell, gx, gy, gz, nbx, nby, thr_hi, thr_lo, thr_fit,
      two_masks, (const float*)pts, n_pts, (uint8_t*)m_hi, (uint8_t*)m_lo,
      (uint8_t*)fit);
  return (int)cudaGetLastError();
}
