// Surface-point blocker test of the batched pore step (-sa), for Hopper.
//
// Replaces the Pallas TPU kernel amof_tpu/pore/surface_kernel.py
// surface_valid_columns_pallas (kernel #6). Atoms are sorted by coarse xy
// column (width >= the blocker reach R_i + R_j + 2 probe), candidate atoms
// first within each column; a slot is `chunk` consecutive centers of one
// column. For every center i of a slot that holds a candidate and every
// direction k: the point p = c_i + (R_i + probe) dir_k, the linear voxel
// index of p and of its outward nudge, and valid = d2(p, j) >
// (R_j + probe - 1e-4)^2 for every blocker j of the column's three runs
// except i itself (self-exclusion by original atom index). Blockers are
// unwrapped to the slot's column frame in x/y; z is minimum-imaged per
// pair from the point's fractional z.
//
// One block per (column, z-slot); slots past a column's end or after its
// candidate prefix return at once (the Pallas kernel's `has` test and the
// XLA path's lax.cond). Each thread owns (center, direction) items; the
// block stages the blocker rows, unwrapped to Cartesian with their squared
// thresholds, CAP at a time in shared memory; with more than CAP rows a
// later pass ANDs into what the item's own thread wrote.
//
// What bounds it on the card: f32 operations, about 16 per
// (point, blocker) test over the staged rows (24 B per row from shared
// memory); outputs are 9 B per point. Only the candidate slots do work.
//
// Bit-exactness: the reference's expression order (the XLA column path
// grid_kernel.surface_valid_columns), rintf, built with --fmad=false, so
// validity and indices equal the plain PyTorch version
// (grid_kernel.surface_valid_tiles_plain).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int CAP = 1024;  // blocker rows staged per pass

__device__ __forceinline__ int axis_idx(float f, int g) {
  f = f - floorf(f);
  return min((int)(f * (float)g), g - 1);
}

__device__ __forceinline__ int lin_idx(float fx, float fy, float fz, int gx,
                                       int gy, int gz) {
  return (axis_idx(fx, gx) * gy + axis_idx(fy, gy)) * gz + axis_idx(fz, gz);
}

__global__ void __launch_bounds__(THREADS) surface_columns_kernel(
    const float* __restrict__ centers, int n,
    const int* __restrict__ c_bounds, const int* __restrict__ cand_end,
    int n_cols, int chunk, const float* __restrict__ blockers, int m_rows,
    const int* __restrict__ b_start, const int* __restrict__ b_count,
    int nbx, int nby, const float* __restrict__ cell,
    const float* __restrict__ inv, const float* __restrict__ dirs,
    const float* __restrict__ nudge, int k_dirs, float rp, float peps,
    int gx, int gy, int gz, uint8_t* __restrict__ valid,
    int* __restrict__ ipt, int* __restrict__ inu) {
  __shared__ float s_wx[CAP], s_wy[CAP], s_wz[CAP], s_fz[CAP], s_th[CAP],
      s_g[CAP];

  const int col = blockIdx.x % n_cols;
  const int zs = blockIdx.x / n_cols;
  const int lo = c_bounds[col] + zs * chunk;
  const int hi = min(lo + chunk, c_bounds[col + 1]);
  if (lo >= hi || lo >= cand_end[col]) return;

  float c[9], ic[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) {
    c[i] = cell[i];
    ic[i] = inv[i];
  }
  const float ucx = ((float)(col / nby) + 0.5f) / (float)nbx;
  const float ucy = ((float)(col % nby) + 0.5f) / (float)nby;
  const int st0 = b_start[3 * col], st1 = b_start[3 * col + 1],
            st2 = b_start[3 * col + 2];
  const int n0 = b_count[3 * col], n1 = b_count[3 * col + 1],
            n2 = b_count[3 * col + 2];
  const int total = n0 + n1 + n2;
  const int items = (hi - lo) * k_dirs;

  for (int base = 0;; base += CAP) {
    const int rows = min(CAP, total - base);
    for (int j = threadIdx.x; j < rows; j += blockDim.x) {
      const int q = base + j;
      int row;
      if (q < n0) {
        row = st0 + q;
      } else if (q < n0 + n1) {
        row = st1 + (q - n0);
      } else {
        row = st2 + (q - n0 - n1);
      }
      const float bx = blockers[row];
      const float by = blockers[m_rows + row];
      const float bz = blockers[2 * m_rows + row];
      const float br = blockers[3 * m_rows + row];
      const float wx = bx - rintf(bx - ucx);
      const float wy = by - rintf(by - ucy);
      s_wx[j] = wx * c[0] + wy * c[3] + bz * c[6];
      s_wy[j] = wx * c[1] + wy * c[4] + bz * c[7];
      s_wz[j] = wx * c[2] + wy * c[5] + bz * c[8];
      s_fz[j] = bz;
      const float t = br + peps;
      s_th[j] = t * t;
      s_g[j] = blockers[4 * m_rows + row];
    }
    __syncthreads();

    for (int it = threadIdx.x; it < items; it += blockDim.x) {
      const int a = lo + it / k_dirs;
      const int k = it % k_dirs;
      const float fx = centers[a], fy = centers[n + a];
      const float fz = centers[2 * n + a], ra = centers[3 * n + a];
      const float cg = centers[4 * n + a];
      const float fxu = fx - rintf(fx - ucx);
      const float fyu = fy - rintf(fy - ucy);
      const float ccx = fxu * c[0] + fyu * c[3] + fz * c[6];
      const float ccy = fxu * c[1] + fyu * c[4] + fz * c[7];
      const float ccz = fxu * c[2] + fyu * c[5] + fz * c[8];
      const float rx = ra + rp;
      const float px = ccx + rx * dirs[3 * k];
      const float py = ccy + rx * dirs[3 * k + 1];
      const float pz = ccz + rx * dirs[3 * k + 2];
      const float fpx = px * ic[0] + py * ic[3] + pz * ic[6];
      const float fpy = px * ic[1] + py * ic[4] + pz * ic[7];
      const float fpz = px * ic[2] + py * ic[5] + pz * ic[8];
      const long long o = (long long)a * k_dirs + k;
      bool ok = true;
      if (base == 0) {
        ipt[o] = lin_idx(fpx, fpy, fpz, gx, gy, gz);
        inu[o] = lin_idx(fpx + nudge[3 * k], fpy + nudge[3 * k + 1],
                         fpz + nudge[3 * k + 2], gx, gy, gz);
      } else {
        ok = valid[o] != 0;
      }
      for (int j = 0; j < rows; ++j) {
        const float zsh = rintf(fpz - s_fz[j]);
        const float dx = px - s_wx[j] - zsh * c[6];
        const float dy = py - s_wy[j] - zsh * c[7];
        const float dz = pz - s_wz[j] - zsh * c[8];
        const float d2 = dx * dx + dy * dy + dz * dz;
        const float te = s_g[j] == cg ? -1.0f : s_th[j];
        ok = ok && (d2 > te);
      }
      valid[o] = (uint8_t)ok;
    }
    if (base + CAP >= total) break;
    __syncthreads();  // staged rows are rewritten by the next pass
  }
}

}  // namespace

extern "C" int surface_columns_launch(
    const void* centers, int n, const void* c_bounds, const void* cand_end,
    int n_cols, int n_z, int chunk, const void* blockers, int m_rows,
    const void* b_start, const void* b_count, int nbx, int nby,
    const void* cell, const void* inv, const void* dirs, const void* nudge,
    int k_dirs, float rp, float peps, int gx, int gy, int gz, void* valid,
    void* ipt, void* inu, void* stream) {
  const long long blocks = (long long)n_cols * n_z;
  if (blocks <= 0 || n <= 0 || k_dirs <= 0) return 0;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidConfiguration;
  surface_columns_kernel<<<(unsigned)blocks, THREADS, 0,
                           (cudaStream_t)stream>>>(
      (const float*)centers, n, (const int*)c_bounds, (const int*)cand_end,
      n_cols, chunk, (const float*)blockers, m_rows, (const int*)b_start,
      (const int*)b_count, nbx, nby, (const float*)cell, (const float*)inv,
      (const float*)dirs, (const float*)nudge, k_dirs, rp, peps, gx, gy, gz,
      (uint8_t*)valid, (int*)ipt, (int*)inu);
  return (int)cudaGetLastError();
}
