// Kernel B3: masked, clipped per-row sum and count for the WPS drill.
//
// Replaces gsky_tpu/ops/pallas_tpu.py::_stats_kernel (masked_stats_pallas).
// For data (B, N) f32 and valid (B, N) bytes (0 = invalid), each row's
//   sums[b]   = sum of data[b, n] over n with valid and lo <= x <= hi
//   counts[b] = number of such n
// (B, N >= 1, any size: the ragged chunk tail is masked here; the Pallas
// version pads B to 128 and N to 2048 instead).
//
// Bound on this card: bytes.  Every input byte is read once (5 bytes a
// pixel, about 1.34 GB at the 1000-step drill's (1024, 262144)); there is
// one compare-and-add per pixel, far below the f32 rate.
//
// Design: one block of 256 threads per row.  The Pallas grid walks a row
// in 2048-wide chunks, carrying a (rows, 2048) per-lane partial sum from
// one sequential grid step to the next; here the chunk loop runs inside
// the block, and thread t owns lanes t + 256 k (k < 8) of every chunk, so
// each lane's partial sum is accumulated in chunk order exactly as the
// Pallas kernel accumulates it (0 + x_0 + x_1 + ...; masked and tail
// lanes add 0.0).  The 2048 lane sums are then reduced by one fixed
// pairwise tree (stride 1024, 512, ..., 1): strides 1024..256 inside each
// thread's registers, 128..1 in shared memory.  `ops/stats.py::
// masked_stats_plain` runs the same order, so kernel and plain version
// agree to the bit.  Built with -fmad=false; there is no multiply anyway.
//
// K-block form (`launch_masked_stats_many`, the drill's wave lane): K
// drills' (B, N) blocks reduced by one launch, grid (B, K), each block
// read where it lies through a table of K base pointers passed by value
// in the launch's parameters (kMaxBlocks, the wave's largest size), so
// no (K, B, N) stack is copied first.  Each row runs the same body, so a
// row's result is bit-identical to the per-call launch's.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 2048;
constexpr int kThreads = 256;
constexpr int kLanes = kChunk / kThreads;  // 8 lanes per thread
constexpr int kMaxBlocks = 64;  // the K-block form's table (the wave cap)

struct BlockPtrs {
  const float* data[kMaxBlocks];
  const uint8_t* valid[kMaxBlocks];
};

// One row of n pixels: the whole block of kThreads threads reduces it
// into *sum and *count.
__device__ __forceinline__ void row_stats(const float* __restrict__ d,
                                          const uint8_t* __restrict__ v,
                                          float lo, float hi, int n,
                                          float* sum, int* count) {
  const int tid = threadIdx.x;

  float acc[kLanes];
#pragma unroll
  for (int k = 0; k < kLanes; ++k) acc[k] = 0.0f;
  int cnt = 0;

  for (int base = 0; base < n; base += kChunk) {
    float x[kLanes];
    bool in[kLanes];
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const int col = base + tid + k * kThreads;
      in[k] = false;
      x[k] = 0.0f;
      if (col < n) {
        in[k] = v[col] != 0;
        x[k] = d[col];
      }
    }
#pragma unroll
    for (int k = 0; k < kLanes; ++k) {
      const bool take = in[k] && x[k] >= lo && x[k] <= hi;
      acc[k] = __fadd_rn(acc[k], take ? x[k] : 0.0f);
      cnt += take ? 1 : 0;
    }
  }

  // the fixed lane tree: lane l += lane l + s for s = 1024, 512, 256
  // (lane l = tid + 256 k lives in acc[k] of thread tid) ...
#pragma unroll
  for (int k = 0; k < 4; ++k) acc[k] = __fadd_rn(acc[k], acc[k + 4]);
  acc[0] = __fadd_rn(acc[0], acc[2]);
  acc[1] = __fadd_rn(acc[1], acc[3]);
  acc[0] = __fadd_rn(acc[0], acc[1]);

  // ... then s = 128, ..., 1 across threads
  __shared__ float ssum[kThreads];
  __shared__ int scnt[kThreads];
  ssum[tid] = acc[0];
  scnt[tid] = cnt;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
      ssum[tid] = __fadd_rn(ssum[tid], ssum[tid + s]);
      scnt[tid] += scnt[tid + s];
    }
    __syncthreads();
  }
  if (tid == 0) {
    *sum = ssum[0];
    *count = scnt[0];
  }
}

__global__ void __launch_bounds__(kThreads)
masked_stats_kernel(const float* __restrict__ data,
                    const uint8_t* __restrict__ valid, float lo, float hi,
                    int n, float* __restrict__ sums,
                    int* __restrict__ counts) {
  const size_t row = blockIdx.x;
  row_stats(data + row * (size_t)n, valid + row * (size_t)n, lo, hi, n,
            sums + row, counts + row);
}

// grid (B, K): row blockIdx.x of block blockIdx.y; sums/counts (K, B).
__global__ void __launch_bounds__(kThreads)
masked_stats_many_kernel(const __grid_constant__ BlockPtrs ptrs, float lo,
                         float hi, int b, int n, float* __restrict__ sums,
                         int* __restrict__ counts) {
  const size_t row = blockIdx.x;
  const int k = blockIdx.y;
  const size_t out = (size_t)k * b + row;
  row_stats(ptrs.data[k] + row * (size_t)n, ptrs.valid[k] + row * (size_t)n,
            lo, hi, n, sums + out, counts + out);
}

}  // namespace

extern "C" int launch_masked_stats(const void* data, const void* valid,
                                   float lo, float hi, int b, int n,
                                   void* sums, void* counts, void* stream) {
  if (b < 1 || n < 1 || n > 0x7fffffff - kChunk) {
    return (int)cudaErrorInvalidValue;
  }
  masked_stats_kernel<<<b, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)data, (const uint8_t*)valid, lo, hi, n, (float*)sums,
      (int*)counts);
  return (int)cudaGetLastError();
}

// K blocks, each (b, n): data[k] f32 and valid[k] bytes, host arrays of K
// device pointers (copied into the launch's parameters); sums/counts (K,
// b).
extern "C" int launch_masked_stats_many(const void* const* data,
                                        const void* const* valid, float lo,
                                        float hi, int k, int b, int n,
                                        void* sums, void* counts,
                                        void* stream) {
  if (k < 1 || k > kMaxBlocks || b < 1 || n < 1 ||
      n > 0x7fffffff - kChunk) {
    return (int)cudaErrorInvalidValue;
  }
  BlockPtrs ptrs{};
  for (int i = 0; i < k; ++i) {
    ptrs.data[i] = (const float*)data[i];
    ptrs.valid[i] = (const uint8_t*)valid[i];
  }
  masked_stats_many_kernel<<<dim3(b, k), kThreads, 0, (cudaStream_t)stream>>>(
      ptrs, lo, hi, b, n, (float*)sums, (int*)counts);
  return (int)cudaGetLastError();
}
