// Batched fused gossip mix + momentum SGD for Hopper (sm_90a), float32,
// and its single-learner form (at the end of this file).
//
// Replaces the TPU kernel src/repro/kernels/gossip_mix.py ::
// gossip_mix_update_flat (the Pallas body _flat_kernel).  Same contract, on
// the persistent (n, T, 128) parameter store; for learner i, element by
// element, with the coefficient row c = coefs[i] =
// [self, nbr_0..nbr_{K-1}, lr scale, active(, nbr_fresh, publish)]:
//
//   mixed = c_self * w_i + sum_k c_k * nbr_k,  nbr_k = remote[partners[k, i]]
//           (publish mode: nbr_k = nbr_fresh ? remote[p] : buffer[p])
//   g     = g_i (+ wd * w_i when wd != 0)
//   lr_eff = lr * c[1 + K]
//   momentum:    mu' = beta * mu + g;  w' = active ? mixed - lr_eff * mu' : w_i
//                mu_out = active ? mu' : mu   (written in place)
//   no momentum: w' = active ? mixed - lr_eff * g : w_i
//   publish:     buf' = publish ? w' : buffer_i
//
// The selects are selects, never blends: an inactive learner's values are
// copied, so a NaN on the branch not taken cannot leak.  Each product and
// sum is rounded on its own (__fmul_rn / __fadd_rn / __fsub_rn, so nvcc
// does not contract them into FMAs) in the plain version's order: the
// kernel equals kernels/ref.py::gossip_mix_update_flat_ref bitwise.
//
// Design.  The TPU kernel ran a (learner, row block) grid with the partner
// ids in scalar-prefetch memory and let BlockSpec index maps fetch the
// neighbour rows.  Here a block owns (a 4,096-element tile, learner i):
// blockIdx.y is the learner, its first threads load the K partner ids and
// the coefficient row into shared memory, and each of the 256 threads
// then streams one float4 of every operand — neighbouring threads on
// neighbouring 16-byte addresses.  K is a runtime loop (at most 16, checked
// by the wrapper: enough for every make_schedule table up to n = 16), and
// lr, beta and wd are launch arguments, so one build serves every
// schedule; the lr scale and the selects come from the table, a tensor.
// w' and buf' must go to other buffers than the inputs (sync DPSGD passes
// w itself as `remote`, and another block may still read a row this block
// would overwrite); mu is updated in place, since learner i's momentum
// reads only its own elements.
//
// Bound.  Pure streaming, about 1 flop per byte: bound by device memory.
// At the training shape (n = 4, T = 1,056,920, K = 1, momentum, remote = w)
// the kernel must move w, g and mu in and w', mu out: 5 x 2.16 GB, about
// 3.2 ms at 3.35 TB/s.  An inactive learner only copies w (and buffer).
// TMA bulk copies and persistent blocks are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 16;

__device__ __forceinline__ float4 mul(float s, float4 v) {
  return make_float4(__fmul_rn(s, v.x), __fmul_rn(s, v.y), __fmul_rn(s, v.z),
                     __fmul_rn(s, v.w));
}

__device__ __forceinline__ float4 add(float4 a, float4 b) {
  return make_float4(__fadd_rn(a.x, b.x), __fadd_rn(a.y, b.y),
                     __fadd_rn(a.z, b.z), __fadd_rn(a.w, b.w));
}

__device__ __forceinline__ float4 sub(float4 a, float4 b) {
  return make_float4(__fsub_rn(a.x, b.x), __fsub_rn(a.y, b.y),
                     __fsub_rn(a.z, b.z), __fsub_rn(a.w, b.w));
}

template <bool kMomentum, bool kPublish>
__global__ void __launch_bounds__(kThreads)
gossip_mix_kernel(const float4* __restrict__ w,
                  const float4* __restrict__ remote,
                  const float4* __restrict__ grads, float4* mu,
                  const float4* __restrict__ buffer,
                  const int* __restrict__ partners,
                  const float* __restrict__ coefs,
                  float4* __restrict__ w_out, float4* __restrict__ buf_out,
                  int n, long long vecs, int K, float lr, float beta,
                  float wd) {
  __shared__ long long nbr_row[kMaxK];    // partner row starts, in float4s
  __shared__ float c[kMaxK + 5];
  const int i = blockIdx.y;
  const int ncoef = K + (kPublish ? 5 : 3);
  if (threadIdx.x < K) {
    nbr_row[threadIdx.x] = (long long)partners[threadIdx.x * n + i] * vecs;
  }
  if (threadIdx.x < ncoef) {
    c[threadIdx.x] = coefs[(long long)i * ncoef + threadIdx.x];
  }
  __syncthreads();
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= vecs) return;
  const long long self = (long long)i * vecs + e;
  const float4 wv = w[self];
  const bool active = c[2 + K] > 0.5f;

  float4 nw = wv;
  if (active) {
    float4 mixed = mul(c[0], wv);
    const bool fresh = !kPublish || c[3 + K] > 0.5f;
    for (int k = 0; k < K; ++k) {
      const float4 nb = fresh ? remote[nbr_row[k] + e] : buffer[nbr_row[k] + e];
      mixed = add(mixed, mul(c[1 + k], nb));
    }
    float4 gv = grads[self];
    if (wd != 0.f) gv = add(gv, mul(wd, wv));
    const float lr_eff = __fmul_rn(lr, c[1 + K]);
    if (kMomentum) {
      const float4 mn = add(mul(beta, mu[self]), gv);
      nw = sub(mixed, mul(lr_eff, mn));
      mu[self] = mn;
    } else {
      nw = sub(mixed, mul(lr_eff, gv));
    }
  }
  w_out[self] = nw;
  if (kPublish) {
    buf_out[self] = c[4 + K] > 0.5f ? nw : buffer[self];
  }
}

template <bool kMomentum, bool kPublish>
void launch(const void* w, const void* remote, const void* grads, void* mu,
            const void* buffer, const void* partners, const void* coefs,
            void* w_out, void* buf_out, int n, long long vecs, int K,
            float lr, float beta, float wd, cudaStream_t stream) {
  const dim3 grid((unsigned)((vecs + kThreads - 1) / kThreads), n);
  gossip_mix_kernel<kMomentum, kPublish><<<grid, kThreads, 0, stream>>>(
      (const float4*)w, (const float4*)remote, (const float4*)grads,
      (float4*)mu, (const float4*)buffer, (const int*)partners,
      (const float*)coefs, (float4*)w_out, (float4*)buf_out, n, vecs, K, lr,
      beta, wd);
}

// Single-learner fused mix + momentum + apply: replaces the TPU kernel
// src/repro/kernels/gossip_mix.py :: gossip_mix_update (the Pallas body
// _kernel), the reduced form of the batched kernel above that
// ops.dpsgd_fused_update reaches.  On one (T, 128) buffer with an explicit
// (K, T, 128) neighbour stack and coefs = [self, nbr_0..nbr_{K-1}]:
//
//   mixed = c_0 * w + sum_k c_{1+k} * nbr_k;  mu' = beta * mu + g;
//   w'    = mixed - lr * mu'
//
// into fresh outputs, every operation rounded on its own in the plain
// version's order (kernels/ref.py::gossip_mix_update_ref, bitwise).  One
// thread per float4, a block per 1,024 elements; coefs in shared memory.
// Bound: (3 + K) reads and 2 writes of the buffer; at transformer-100m's
// T = 1,056,920 and K = 2 that is 7 x 541.1 MB, 1.13 ms at 3.35 TB/s.
__global__ void __launch_bounds__(kThreads)
gossip_mix_single_kernel(const float4* __restrict__ w,
                         const float4* __restrict__ nbrs,
                         const float4* __restrict__ grads,
                         const float4* __restrict__ mu,
                         const float* __restrict__ coefs,
                         float4* __restrict__ w_out,
                         float4* __restrict__ mu_out, long long vecs, int K,
                         float lr, float beta) {
  __shared__ float c[kMaxK + 1];
  if (threadIdx.x <= K) c[threadIdx.x] = coefs[threadIdx.x];
  __syncthreads();
  const long long e = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (e >= vecs) return;
  float4 mixed = mul(c[0], w[e]);
  for (int k = 0; k < K; ++k) {
    mixed = add(mixed, mul(c[1 + k], nbrs[k * vecs + e]));
  }
  const float4 mn = add(mul(beta, mu[e]), grads[e]);
  w_out[e] = sub(mixed, mul(lr, mn));
  mu_out[e] = mn;
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `elems` is T * 128 (a multiple of 4); nbrs is (K, elems) with
// 1 <= K <= 16; coefs (1 + K,) float32 on the device.  The caller has
// checked devices, dtypes, contiguity, 16-byte alignment, shapes, and that
// the outputs overlap no input.
int gossip_mix_update_f32(const void* w, const void* nbrs, const void* grads,
                          const void* mu, const void* coefs, void* w_out,
                          void* mu_out, long long elems, int K, float lr,
                          float beta, void* stream) {
  const long long vecs = elems / 4;
  const unsigned blocks = (unsigned)((vecs + kThreads - 1) / kThreads);
  gossip_mix_single_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const float4*)w, (const float4*)nbrs, (const float4*)grads,
      (const float4*)mu, (const float*)coefs, (float4*)w_out, (float4*)mu_out,
      vecs, K, lr, beta);
  return (int)cudaGetLastError();
}

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// `mu` null selects the momentum-free update; `buffer` non-null selects
// publish mode (then `buf_out` is its output).  `elems` is T * 128, the
// float32 elements per learner (a multiple of 4).  The caller has checked
// devices, dtypes, contiguity, 16-byte alignment, shapes, 1 <= K <= 16,
// and that w_out / buf_out overlap no input.  The kernel trusts the
// partner table: every id must lie in [0, n).
int gossip_mix_update_flat_f32(const void* w, const void* remote,
                               const void* grads, void* mu,
                               const void* buffer, const void* partners,
                               const void* coefs, void* w_out, void* buf_out,
                               int n, long long elems, int K, float lr,
                               float beta, float wd, void* stream) {
  const long long vecs = elems / 4;
  const cudaStream_t s = (cudaStream_t)stream;
  if (mu != nullptr && buffer != nullptr) {
    launch<true, true>(w, remote, grads, mu, buffer, partners, coefs, w_out,
                       buf_out, n, vecs, K, lr, beta, wd, s);
  } else if (mu != nullptr) {
    launch<true, false>(w, remote, grads, mu, buffer, partners, coefs, w_out,
                        buf_out, n, vecs, K, lr, beta, wd, s);
  } else if (buffer != nullptr) {
    launch<false, true>(w, remote, grads, mu, buffer, partners, coefs, w_out,
                        buf_out, n, vecs, K, lr, beta, wd, s);
  } else {
    launch<false, false>(w, remote, grads, mu, buffer, partners, coefs,
                         w_out, buf_out, n, vecs, K, lr, beta, wd, s);
  }
  return (int)cudaGetLastError();
}

const char* gossip_mix_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
