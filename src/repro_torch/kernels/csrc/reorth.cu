// Lanczos full reorthogonalization for Hopper (sm_90a), float32: the two
// kernels of one classical Gram-Schmidt sweep over the stacked basis.
//
// Replaces the TPU kernels src/repro/kernels/reorth.py :: reorth_dots (the
// Pallas body _dots_kernel) and reorth_axpy (_axpy_kernel).  Same contract,
// on the flat (T, 128) parameter layout, with the basis one (M, T, 128)
// array and E = T * 128 elements per vector:
//
//   reorth_dots:  d_k = sum_e v_k[e] * w[e]          k = 0..M-1  (* mask_k)
//   reorth_axpy:  out[e] = w[e] - sum_k d_k * v_k[e]  (k in order 0..M-1)
//
// Design.  The Pallas dots kernel carried per-lane partial sums across a
// SEQUENTIAL row grid.  Here blocks run in no fixed order, so the sum is a
// deterministic two-stage reduction with no atomics: stage 1 gives each
// block a tile of 4,096 elements (256 threads x 4 float4); a thread keeps
// its 16 elements of w in registers and, for each k (a runtime loop, at
// most kMaxM, checked by the wrapper), streams its 16 elements of v_k, sums
// them, and the warp sums its 32 lanes by shuffles; the 8 warp sums of
// every k meet in shared memory and are added in warp order, one partial
// per (k, block) into a (M, n_blocks) buffer.  Stage 2 runs one block per
// k: each thread adds a strided run of that row in order, then a fixed
// shared-memory tree adds the 256 runs, and the mask multiplies the result.
// So the result is the same from run to run (it differs from a plain
// torch.sum in the last bits: another summation order).  w is read once and
// each v_k once; the partials are 4 bytes per 16 KB tile.
//
// The axpy is one pass: a thread owns 4 float4 of the output, loads w,
// then subtracts d_k * v_k for k = 0..M-1, every product and difference
// rounded on its own (__fmul_rn / __fsub_rn, so nvcc does not contract them
// into FMAs): given the same dots it equals kernels/ref.py::reorth_ref's
// acc = acc - d_k * v_k bitwise.  Each output element reads only its own w
// element, so `out` may be `w` itself: the Lanczos CGS2 writes its second
// sweep in place.  `out` must not overlap the basis (the wrapper checks).
//
// Ragged T.  E is a multiple of 128, so of 4 floats; the last tile of both
// kernels masks the float4s past E itself (the reference pads to its block
// instead).  The dead suffix of the basis (mask 0) is streamed like the
// live prefix, as the TPU kernels do; skipping it is later work.
//
// Bound.  Pure streaming, 2 flops per 8 bytes: bound by device memory.  At
// the transformer-100m probe (T = 1,056,920, M = 9) the dots read 10 x
// 541 MB (1.62 ms at 3.35 TB/s) and the axpy reads 10 and writes 1 vector
// (1.78 ms).  The design keeps one pass over each vector per kernel and
// enough 16-byte loads in flight (4 per thread per vector); TMA bulk copies
// and persistent blocks are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 4;                     // float4s per thread
constexpr int kTile = kThreads * kPerThread;      // float4s per block
constexpr int kMaxM = 64;

__global__ void __launch_bounds__(kThreads)
reorth_dots_partial(const float4* __restrict__ basis,
                    const float4* __restrict__ w, float* __restrict__ partial,
                    int M, long long vecs) {
  __shared__ float warp_sums[kMaxM * kWarps];
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  float4 wv[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long e = base + (long long)r * kThreads;
    wv[r] = e < vecs ? w[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int k = 0; k < M; ++k) {
    const float4* v = basis + (long long)k * vecs;
    float s = 0.f;
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const long long e = base + (long long)r * kThreads;
      if (e < vecs) {
        const float4 b = v[e];
        s += b.x * wv[r].x + b.y * wv[r].y + b.z * wv[r].z + b.w * wv[r].w;
      }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      s += __shfl_down_sync(0xffffffffu, s, off);
    }
    if (lane == 0) warp_sums[k * kWarps + warp] = s;
  }
  __syncthreads();
  for (int k = threadIdx.x; k < M; k += kThreads) {
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += warp_sums[k * kWarps + i];
    partial[(long long)k * gridDim.x + blockIdx.x] = s;
  }
}

__global__ void __launch_bounds__(kThreads)
reorth_dots_final(const float* __restrict__ partial, int n_blocks,
                  const float* __restrict__ mask, float* __restrict__ dots) {
  __shared__ float sums[kThreads];
  const int k = blockIdx.x;
  const float* row = partial + (long long)k * n_blocks;
  float s = 0.f;
  for (int i = threadIdx.x; i < n_blocks; i += kThreads) s += row[i];
  sums[threadIdx.x] = s;
  __syncthreads();
  for (int half = kThreads / 2; half > 0; half >>= 1) {
    if (threadIdx.x < half) sums[threadIdx.x] += sums[threadIdx.x + half];
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    dots[k] = sums[0] * mask[k];
  }
}

// No __restrict__ on w and out: out may be w (in place).
__global__ void __launch_bounds__(kThreads)
reorth_axpy_kernel(const float4* w, const float4* __restrict__ basis,
                   const float* __restrict__ dots, float4* out, int M,
                   long long vecs) {
  __shared__ float d[kMaxM];
  for (int k = threadIdx.x; k < M; k += kThreads) d[k] = dots[k];
  __syncthreads();
  const long long base = (long long)blockIdx.x * kTile + threadIdx.x;
  float4 acc[kPerThread];
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long e = base + (long long)r * kThreads;
    acc[r] = e < vecs ? w[e] : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int k = 0; k < M; ++k) {
    const float4* v = basis + (long long)k * vecs;
    const float dk = d[k];
#pragma unroll
    for (int r = 0; r < kPerThread; ++r) {
      const long long e = base + (long long)r * kThreads;
      if (e < vecs) {
        const float4 b = v[e];
        acc[r].x = __fsub_rn(acc[r].x, __fmul_rn(dk, b.x));
        acc[r].y = __fsub_rn(acc[r].y, __fmul_rn(dk, b.y));
        acc[r].z = __fsub_rn(acc[r].z, __fmul_rn(dk, b.z));
        acc[r].w = __fsub_rn(acc[r].w, __fmul_rn(dk, b.w));
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kPerThread; ++r) {
    const long long e = base + (long long)r * kThreads;
    if (e < vecs) out[e] = acc[r];
  }
}

}  // namespace

extern "C" {

// Blocks of stage 1 for `elems` floats per vector: the size of the (M,
// n_blocks) partial buffer the caller allocates.
long long reorth_dots_blocks(long long elems) {
  const long long vecs = elems / 4;
  return (vecs + kTile - 1) / kTile;
}

// Launches both stages on `stream` and returns cudaGetLastError().  The
// caller has checked devices, dtypes, contiguity, 16-byte alignment,
// shapes and 1 <= M <= kMaxM.
int reorth_dots_f32(const void* basis, const void* w, void* partial,
                    const void* mask, void* dots, int M, long long elems,
                    void* stream) {
  const long long vecs = elems / 4;
  const long long n_blocks = reorth_dots_blocks(elems);
  const cudaStream_t s = (cudaStream_t)stream;
  reorth_dots_partial<<<(unsigned)n_blocks, kThreads, 0, s>>>(
      (const float4*)basis, (const float4*)w, (float*)partial, M, vecs);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  reorth_dots_final<<<M, kThreads, 0, s>>>(
      (const float*)partial, (int)n_blocks, (const float*)mask,
      (float*)dots);
  return (int)cudaGetLastError();
}

// out = w - sum_k dots[k] * basis[k]; `out` may equal `w`, and must not
// overlap `basis` (checked by the caller).
int reorth_axpy_f32(const void* w, const void* basis, const void* dots,
                    void* out, int M, long long elems, void* stream) {
  const long long vecs = elems / 4;
  const unsigned grid = (unsigned)((vecs + kTile - 1) / kTile);
  reorth_axpy_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)w, (const float4*)basis, (const float*)dots,
      (float4*)out, M, vecs);
  return (int)cudaGetLastError();
}

const char* reorth_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
