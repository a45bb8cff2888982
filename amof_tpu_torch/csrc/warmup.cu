// Trivial copy kernel that pays the runtime's one-time costs early.
//
// Replaces the Pallas TPU kernel amof_tpu/warmup.py warmup_mosaic (the
// 8x128 float32 copy it dispatches without blocking, so the Mosaic
// runtime initialises while the host prepares its inputs). On the card
// the one-time costs are the nvcc build of csrc/, the dlopen of the
// library, CUDA context creation and the first module load; the wrapper
// (amof_tpu_torch/warmup.py) runs the build and this launch on a daemon
// thread and a side stream so they overlap the host's layout work.
//
// What bounds it on the card: nothing of the copy itself (2 x 4 KiB);
// one block of 256 threads, four float4 each, is all launch latency.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__global__ void warmup_copy_kernel(const float4* __restrict__ src,
                                   float4* __restrict__ dst, int n4) {
  for (int i = threadIdx.x; i < n4; i += THREADS) dst[i] = src[i];
}

}  // namespace

// dst[i] = src[i] for i < n (n a multiple of 4; both 16-byte aligned, as
// PyTorch's allocations are). Launches on ``stream``; returns cudaError_t.
extern "C" int warmup_copy_launch(const void* src, void* dst, int n,
                                  void* stream) {
  warmup_copy_kernel<<<1, THREADS, 0, (cudaStream_t)stream>>>(
      (const float4*)src, (float4*)dst, n / 4);
  return (int)cudaGetLastError();
}
