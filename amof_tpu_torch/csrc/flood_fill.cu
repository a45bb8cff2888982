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
// fixpoint directly, by tiled union-find connected-component labelling,
// in three launches with no host round trip, whatever the components'
// diameters. The TPU kernels' slab blocking, halo depth, block-skip
// schedule and the VMEM limits that split #7 from #8 have no counterpart:
// one kernel serves every grid.
//
// Tiles are TX x TY x TZ = 8 x 8 x 16 voxels, z (the contiguous axis)
// along the warp: a half-warp holds one 64-byte z row of the tile, whole
// sectors. A 1-D grid of one block per tile; the block splits its index
// into tile coordinates with two 32-bit divisions (a 3-D grid would cap
// the y and z tile counts at 65535), and no voxel pays a division. 16
// divides the bench grid's 112 (a 32-wide z tile would leave 1/8 of its
// lanes idle there), and 256 threads of four voxels each fill the tile
// with 8 KB of shared memory, 8 blocks an SM.
//
//   1. tiles:  read init once; out = -1 on walls. A tile without a masked
//              voxel (__syncthreads_or) records flag 0 and exits.
//              Otherwise label it in shared memory: each z run of masked
//              voxels (one ballot a row) starts as a star on its first
//              voxel, then union-find over the +y and +x links, one link
//              per overlapping pair of runs, finds halving their paths.
//              Each local root keeps the tile maximum of init. Writes
//              parent[v] = global index of v's local root, out[v] = that
//              maximum at local roots and -1 at other masked voxels (so
//              out >= 0 marks the local roots), flag 1.
//   2. faces:  occupied tiles unite across their +x, +y, +z faces with
//              occupied neighbours, in device memory (the last tile of a
//              periodic axis of length > 1 wraps onto the first), one
//              link per overlapping pair of z runs on the x and y faces.
//              Only local roots take part: finds start at parent[v] and
//              halve their paths. Whoever hangs root b under a folds
//              out[b] into a's root (atomicMax), so when the step ends
//              every global root holds its component's maximum.
//   3. gather: in each occupied tile, local roots first point straight
//              at their global root; then every masked voxel takes
//              out[parent[parent[v]]].
//
// The maximum is folded during the links, not in a launch of its own:
// a link writes parent[b], fences, then reads out[b]; a fold writes
// out[r] (atomicMax), fences, then reads parent[r] and, if r stopped
// being a root, goes on up. With sequentially consistent fences
// (__threadfence) at least one of two such threads sees the other's
// write, so no value is left behind at a root that has been linked
// (Dekker's argument), and every value climbs to its component's final
// root. Step 3 depends on every block of step 2, so it is a launch of
// its own: a grid-wide barrier in one launch would need every block
// resident at once (a cooperative launch), which can fail to fit and has
// no fallback here.
//
// Why the output is the same fixpoint whatever the link order: every
// link joins two masked voxels that are 6-neighbours, or two whose z runs
// are already joined to such a pair (a run is one tree from the start),
// and every 6-neighbour pair is covered, so the forest's trees are
// exactly the 6-connected components, whatever order the atomics land
// in. Links always hang the larger root under the smaller one
// (atomicMin; a path-halving store only moves a node to an ancestor), so
// parent[v] <= v, no cycle forms, and a link that lands on a node which
// stopped being a root is carried on from where it landed (Playne &
// Hawick 2018). A maximum does not depend on the order it is folded in.
// The output equals propagate_fixpoint_plain bit for bit, and repeated
// calls give equal outputs.
//
// What bounds each step on the card. Step 1 moves the bytes of the bound
// (init read once, out written once: 8 bytes a voxel) plus parent for
// masked voxels. Its shared-memory labelling is kept short by the runs,
// which replace the z links, and by halving finds: with one union per
// voxel link and no compression, a dense tile's chains grew with its
// voxels, and step 1 alone took 0.043 ms on a bench frame on an H100
// (0.004 ms on an all-wall grid). Steps 2 and 3
// touch occupied tiles only (745 of 1372 on bench frame 0), reading what
// step 1 left in L2; they are bounded by the launch and the dependent
// reads of the finds. The scratch (parent, then one flag a tile) comes
// from the wrapper's torch.empty: step 1 writes every flag, and parent is
// read only where step 1 wrote it, so nothing is cleared.

#include <cuda_runtime.h>

namespace {

constexpr int TX = 8, TY = 8, TZ = 16;      // tile, voxels
constexpr int LZ = 4, LYZ = 7;               // log2(TZ), log2(TY * TZ)
constexpr int TV = TX * TY * TZ;             // voxels a tile
constexpr int THREADS = 256;
constexpr int PER = TV / THREADS;            // voxels a thread
constexpr int XSTEP = THREADS / (TY * TZ);   // x layers between them
constexpr int FACE_PAIRS = TY * TZ + TX * TZ + TX * TY;
constexpr unsigned FULL = 0xffffffffu;
constexpr int KERNELS = 3;

static_assert(TZ == 1 << LZ && TY * TZ == 1 << LYZ, "tile shifts");
static_assert(TZ == 16, "a z row of the tile is a half-warp");
static_assert(PER * XSTEP == TX, "threads cover the tile");

struct Grid {
  int gx, gy, gz;     // voxels
  int ntx, nty, ntz;  // tiles
  int periodic;
};

struct Tile {
  int x0, y0, z0;     // its first voxel
  int base;           // that voxel's index
};

__device__ __forceinline__ Tile tile_of(const Grid& g, int b) {
  Tile t;
  const int r = b / g.ntz;
  t.x0 = r / g.nty * TX;
  t.y0 = r % g.nty * TY;
  t.z0 = b % g.ntz * TZ;
  t.base = (t.x0 * g.gy + t.y0) * g.gz + t.z0;
  return t;
}

// the thread's voxels: local index tid + k * THREADS, at local (lx0 + k *
// XSTEP, ly, lz); ``yz`` the offset of (0, ly, lz) in the grid, valid
// only where ``ok_yz``
struct Lanes {
  int lx0, ly, lz, yz;
  bool ok_yz;
};

__device__ __forceinline__ Lanes lanes_of(const Grid& g, const Tile& t) {
  Lanes l;
  const int tid = threadIdx.x;
  l.lz = tid & (TZ - 1);
  l.ly = (tid >> LZ) & (TY - 1);
  l.lx0 = tid >> LYZ;
  l.ok_yz = t.z0 + l.lz < g.gz && t.y0 + l.ly < g.gy;
  l.yz = l.ok_yz ? l.ly * g.gz + l.lz : 0;
  return l;
}

// ---- union-find in shared memory (step 1) --------------------------------

// root of x, reading only
__device__ __forceinline__ int root_s(const volatile int* lab, int x) {
  int p = lab[x];
  while (p != x) {
    x = p;
    p = lab[x];
  }
  return x;
}

// root of x with path halving: each visited node moves to its grandparent
// (an ancestor, so lab[x] <= x still holds)
__device__ __forceinline__ int find_s(volatile int* lab, int x) {
  while (true) {
    const int p = lab[x];
    if (p == x) return x;
    const int gp = lab[p];
    if (gp == p) return p;
    lab[x] = gp;
    x = gp;
  }
}

__device__ void unite_s(int* lab, int a, int b) {
  while (true) {
    a = find_s(lab, a);
    b = find_s(lab, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(lab + b, a);
    if (old == b) return;
    b = old;  // b stopped being a root meanwhile: go on from where it points
  }
}

// ---- union-find in device memory (step 2) --------------------------------

__device__ __forceinline__ int ld_relaxed(const int* p) {
  int v;
  asm volatile("ld.relaxed.gpu.global.b32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ int find_g(int* parent, int x) {
  while (true) {
    const int p = __ldcg(parent + x);
    if (p == x) return x;
    const int gp = __ldcg(parent + p);
    if (gp == p) return p;
    __stcg(parent + x, gp);
    x = gp;
  }
}

// fold m into the maximum of r's component: at r, and on up from r while
// r is found linked after the write
__device__ void fold_max(const int* parent, int* out, int r, int m) {
  while (true) {
    atomicMax(out + r, m);
    __threadfence();
    const int p = ld_relaxed(parent + r);
    if (p == r) return;
    r = p;
  }
}

__device__ void unite_g(int* parent, int* out, int a, int b) {
  while (true) {
    a = find_g(parent, a);
    b = find_g(parent, b);
    if (a == b) return;
    if (a > b) {
      const int t = a;
      a = b;
      b = t;
    }
    const int old = atomicMin(parent + b, a);
    if (old == b) {  // b hangs under a: carry b's maximum up
      __threadfence();
      fold_max(parent, out, a, ld_relaxed(out + b));
      return;
    }
    b = old;
  }
}

// ---- the three steps -----------------------------------------------------

__global__ void __launch_bounds__(THREADS)
    ff_tiles(const int* __restrict__ init, Grid g, int* __restrict__ parent,
             int* __restrict__ out, int* __restrict__ flags) {
  __shared__ int lab[TV];  // local parent (tile-local index)
  __shared__ int val[TV];  // init (-1 outside the grid); then the local max
  const Tile t = tile_of(g, blockIdx.x);
  const Lanes l = lanes_of(g, t);
  const int sxy = g.gy * g.gz;
  const int tid = threadIdx.x;
  int v[PER];
  bool any = false;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int lx = l.lx0 + k * XSTEP;
    const int i = tid + k * THREADS;
    const bool ok = l.ok_yz && t.x0 + lx < g.gx;
    const int gi = ok ? t.base + lx * sxy + l.yz : 0;
    v[k] = ok ? init[gi] : -1;
    if (ok && v[k] < 0) out[gi] = -1;
    val[i] = v[k];
    any |= v[k] >= 0;
  }
  if (!__syncthreads_or(any)) {
    if (tid == 0) flags[blockIdx.x] = 0;
    return;
  }
  // z runs: a masked voxel starts under the first voxel of its run
  const unsigned below = (1u << l.lz) - 1;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const unsigned row = __ballot_sync(FULL, v[k] >= 0) >> (tid & 16);
    const unsigned walls = ~row & below;
    lab[tid + k * THREADS] =
        tid + k * THREADS - l.lz + (walls ? 32 - __clz(walls) : 0);
  }
  __syncthreads();
  // +y and +x links, one per overlapping pair of runs: skip a link whose
  // -z neighbours are linked too (their runs are these runs)
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (v[k] < 0) continue;
    const int i = tid + k * THREADS;
    const bool prev = l.lz > 0 && val[i - 1] >= 0;
    if (l.ly + 1 < TY && val[i + TZ] >= 0 && !(prev && val[i + TZ - 1] >= 0))
      unite_s(lab, i, i + TZ);
    if (l.lx0 + k * XSTEP + 1 < TX && val[i + TY * TZ] >= 0 &&
        !(prev && val[i + TY * TZ - 1] >= 0))
      unite_s(lab, i, i + TY * TZ);
  }
  __syncthreads();
  // every node with children is a run start: run starts point straight
  // at their local root, then each voxel's root is lab[lab[i]]. These
  // finds only read: a halving store could put back an ancestor over a
  // run start that another thread has just pointed at its root.
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS;
    if (v[k] >= 0 && (l.lz == 0 || val[i - 1] < 0)) lab[i] = root_s(lab, i);
  }
  __syncthreads();
  int root[PER];
  const int lane = tid & 31;
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const int i = tid + k * THREADS;
    root[k] = v[k] >= 0 ? lab[lab[i]] : -1;
    // the tile maximum, one shared atomic per root a warp
    const bool up = v[k] >= 0 && root[k] != i;
    const unsigned want = __ballot_sync(FULL, up);
    if (up) {
      const unsigned same = __match_any_sync(want, root[k]);
      const int mx = __reduce_max_sync(same, v[k]);
      if (lane == __ffs(same) - 1) atomicMax(val + root[k], mx);
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    if (v[k] < 0) continue;
    const int i = tid + k * THREADS;
    const int r = root[k];
    const int gi = t.base + (l.lx0 + k * XSTEP) * sxy + l.yz;
    parent[gi] = t.base + (r >> LYZ) * sxy + ((r >> LZ) & (TY - 1)) * g.gz +
                 (r & (TZ - 1));
    out[gi] = r == i ? val[i] : -1;
  }
  if (tid == 0) flags[blockIdx.x] = 1;
}

__global__ void __launch_bounds__(THREADS)
    ff_faces(const int* __restrict__ init, Grid g, int* parent, int* out,
             const int* __restrict__ flags) {
  if (!flags[blockIdx.x]) return;
  const Tile t = tile_of(g, blockIdx.x);
  const int sxy = g.gy * g.gz;
  for (int p = threadIdx.x; p < FACE_PAIRS; p += THREADS) {
    // the face's axis: its length, the tile's last layer on it, the
    // layer across the face, the index step along it; then the pair
    int dim, last, step, x = t.x0, y = t.y0, z = t.z0;
    if (p < TY * TZ) {                                  // +x face
      dim = g.gx, last = min(t.x0 + TX, dim) - 1, step = sxy;
      x = last, y += p >> LZ, z += p & (TZ - 1);
    } else if (p < TY * TZ + TX * TZ) {                 // +y face
      const int q = p - TY * TZ;
      dim = g.gy, last = min(t.y0 + TY, dim) - 1, step = g.gz;
      x += q >> LZ, y = last, z += q & (TZ - 1);
    } else {                                            // +z face
      const int q = p - TY * TZ - TX * TZ;
      dim = g.gz, last = min(t.z0 + TZ, dim) - 1, step = 1;
      x += q / TY, y += q % TY, z = last;
    }
    if (x >= g.gx || y >= g.gy || z >= g.gz) continue;
    int next = last + 1;
    if (next == dim) {
      if (!g.periodic || dim == 1) continue;
      next = 0;
    }
    const int ia = (x * g.gy + y) * g.gz + z;
    const int ib = ia + (next - last) * step;
    // a masked voxel across the face makes its tile an occupied one
    if (init[ia] < 0 || init[ib] < 0) continue;
    // on an x or y face, the pair below in z joins the same two runs
    if (step != 1 && z > t.z0 && init[ia - 1] >= 0 && init[ib - 1] >= 0)
      continue;
    unite_g(parent, out, __ldcg(parent + ia), __ldcg(parent + ib));
  }
}

// a global root's slot already holds its final value and is only
// rewritten with it, so every masked voxel can take its value in place
__global__ void __launch_bounds__(THREADS)
    ff_gather(const int* __restrict__ init, Grid g, int* parent, int* out,
              const int* __restrict__ flags) {
  if (!flags[blockIdx.x]) return;
  const Tile t = tile_of(g, blockIdx.x);
  const Lanes l = lanes_of(g, t);
  const int sxy = g.gy * g.gz;
  int gi[PER];
  bool masked[PER];
#pragma unroll
  for (int k = 0; k < PER; ++k) {
    const bool ok = l.ok_yz && t.x0 + l.lx0 + k * XSTEP < g.gx;
    gi[k] = ok ? t.base + (l.lx0 + k * XSTEP) * sxy + l.yz : 0;
    masked[k] = ok && init[gi[k]] >= 0;
    // local roots hold a maximum (>= 0), other voxels -1
    if (masked[k] && out[gi[k]] >= 0) {
      int r = gi[k];
      for (int p = parent[r]; p != r; p = parent[r]) r = p;
      if (r != gi[k]) parent[gi[k]] = r;
    }
  }
  __syncthreads();
#pragma unroll
  for (int k = 0; k < PER; ++k)
    if (masked[k]) out[gi[k]] = out[parent[parent[gi[k]]]];
}

Grid grid_of(int gx, int gy, int gz, int periodic) {
  return Grid{gx, gy, gz, (gx + TX - 1) / TX, (gy + TY - 1) / TY,
              (gz + TZ - 1) / TZ, periodic};
}

}  // namespace

// parent: int32 scratch of gx * gy * gz + tiles (parent, then the flags)
extern "C" int flood_fill_launch(const void* init, int gx, int gy, int gz,
                                 int periodic, void* parent, void* out,
                                 void* stream) {
  const long long n = (long long)gx * gy * gz;
  if (n <= 0) return 0;
  if (n >= 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const Grid g = grid_of(gx, gy, gz, periodic);
  const unsigned tiles = (unsigned)g.ntx * g.nty * g.ntz;
  cudaStream_t s = (cudaStream_t)stream;
  const int* lab = (const int*)init;
  int* par = (int*)parent;
  int* flags = par + n;
  int* res = (int*)out;
  ff_tiles<<<tiles, THREADS, 0, s>>>(lab, g, par, res, flags);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  ff_faces<<<tiles, THREADS, 0, s>>>(lab, g, par, res, flags);
  if ((e = cudaGetLastError()) != cudaSuccess) return (int)e;
  ff_gather<<<tiles, THREADS, 0, s>>>(lab, g, par, res, flags);
  return (int)cudaGetLastError();
}

// per launch, in order (tiles, faces, gather), five ints: blocks,
// threads a block, static shared bytes, registers a thread, resident
// blocks per SM; then the tile (x, y, z) and the scratch ints
extern "C" int flood_fill_geometry(int gx, int gy, int gz, void* out) {
  int* o = (int*)out;
  const Grid g = grid_of(gx, gy, gz, 0);
  const void* fns[KERNELS] = {(const void*)ff_tiles, (const void*)ff_faces,
                              (const void*)ff_gather};
  for (int k = 0; k < KERNELS; ++k) {
    cudaFuncAttributes attr;
    cudaError_t e = cudaFuncGetAttributes(&attr, fns[k]);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&o[5 * k + 4], fns[k],
                                                        THREADS, 0);
    if (e != cudaSuccess) return (int)e;
    o[5 * k] = g.ntx * g.nty * g.ntz;
    o[5 * k + 1] = THREADS;
    o[5 * k + 2] = (int)attr.sharedSizeBytes;
    o[5 * k + 3] = attr.numRegs;
  }
  o[5 * KERNELS] = TX;
  o[5 * KERNELS + 1] = TY;
  o[5 * KERNELS + 2] = TZ;
  o[5 * KERNELS + 3] = gx * gy * gz + g.ntx * g.nty * g.ntz;
  return 0;
}
