// Flood-fill fixpoint of the pore connectivity chain, for Hopper.
//
// Replaces the Pallas TPU kernels amof_tpu/pore/grid_kernel.py
// _pallas_sweep_round_skip (kernel #7: block-skip rounds of masked
// 6-neighbour max sweeps) and _pallas_sweep_round (kernel #8: the same
// rounds without the skip), together with the while_loop that iterates
// them in _propagate_fixpoint. What they iterate to is the fixpoint of
// masked max propagation: every voxel with init >= 0 ends with the
// maximum init over its 6-connected component (open or periodic
// boundaries), every other voxel with -1. This source computes that
// fixpoint directly by union-find connected-component labelling (the
// lock-free union of Playne & Hawick, 2018): five launches, no host round
// trip and no per-round change flag, whatever the components' diameters.
//
//   1. init:     parent[i] = i on the mask, -1 on walls; out[i] = -1;
//   2. merge:    every masked voxel unites with its masked +x, +y, +z
//                neighbours (wrapped when periodic); roots are linked
//                smaller-index-wins with atomicMin;
//   3. compress: parent[i] = root of i;
//   4. root max: atomicMax(out[root], init[i]);
//   5. gather:   out[i] = out[root of i].
//
// The TPU kernels' slab blocking, halo depth, block-skip schedule and the
// VMEM limits that split #7 from #8 have no counterpart: one kernel serves
// every grid.
//
// What bounds it on the card: memory traffic, about 4 int32 arrays read
// and written a few times over (init, parent, out), plus the atomics of
// the merge and root-max passes; the finds walk short trees on typical
// masks.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ int find_root(const int* parent, int x) {
  int p = __ldcg(parent + x);
  while (p != x) {
    x = p;
    p = __ldcg(parent + x);
  }
  return x;
}

__device__ void unite(int* parent, int a, int b) {
  while (true) {
    a = find_root(parent, a);
    b = find_root(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    // link the larger root under the smaller one; if b stopped being a
    // root meanwhile, continue with what it points to now
    const int old = atomicMin(parent + b, a);
    if (old == b) return;
    b = old;
  }
}

__global__ void uf_init(const int* __restrict__ init, long long n,
                        int* __restrict__ parent, int* __restrict__ out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  parent[i] = init[i] >= 0 ? (int)i : -1;
  out[i] = -1;
}

__global__ void uf_merge(const int* __restrict__ init, int gx, int gy,
                         int gz, int periodic, int* parent) {
  const long long n = (long long)gx * gy * gz;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || init[i] < 0) return;
  const int z = (int)(i % gz);
  const int y = (int)((i / gz) % gy);
  const int x = (int)(i / ((long long)gy * gz));
  const int dims[3] = {gx, gy, gz};
  const int pos[3] = {x, y, z};
  const long long strides[3] = {(long long)gy * gz, gz, 1};
#pragma unroll
  for (int ax = 0; ax < 3; ++ax) {
    long long j;
    if (pos[ax] + 1 < dims[ax]) {
      j = i + strides[ax];
    } else if (periodic && dims[ax] > 1) {
      j = i - (long long)(dims[ax] - 1) * strides[ax];
    } else {
      continue;
    }
    if (init[j] >= 0) unite(parent, (int)i, (int)j);
  }
}

__global__ void uf_compress(const int* __restrict__ init, long long n,
                            int* parent) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || init[i] < 0) return;
  parent[i] = find_root(parent, (int)i);
}

__global__ void uf_root_max(const int* __restrict__ init, long long n,
                            const int* __restrict__ parent, int* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || init[i] < 0) return;
  atomicMax(out + parent[i], init[i]);
}

// a root's slot already holds its final value, and only roots are read,
// so writing every non-root slot in place is race-free
__global__ void uf_gather(const int* __restrict__ init, long long n,
                          const int* __restrict__ parent, int* out) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n || init[i] < 0) return;
  out[i] = out[parent[i]];
}

}  // namespace

extern "C" int flood_fill_launch(const void* init, int gx, int gy, int gz,
                                 int periodic, void* parent, void* out,
                                 void* stream) {
  const long long n = (long long)gx * gy * gz;
  if (n <= 0) return 0;
  if (n >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((n + THREADS - 1) / THREADS);
  cudaStream_t s = (cudaStream_t)stream;
  const int* lab = (const int*)init;
  int* par = (int*)parent;
  int* res = (int*)out;
  uf_init<<<blocks, THREADS, 0, s>>>(lab, n, par, res);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  uf_merge<<<blocks, THREADS, 0, s>>>(lab, gx, gy, gz, periodic, par);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  uf_compress<<<blocks, THREADS, 0, s>>>(lab, n, par);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  uf_root_max<<<blocks, THREADS, 0, s>>>(lab, n, par, res);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  uf_gather<<<blocks, THREADS, 0, s>>>(lab, n, par, res);
  return (int)cudaGetLastError();
}
