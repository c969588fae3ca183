// Blocked flash attention backward for Hopper (sm_90a): causal / sliding
// window / logit softcap, GQA, float32 or bf16 in, float32 sums.
//
// Replaces no TPU kernel.  The TPU flash kernel
// (src/repro/kernels/flash_attention.py :: flash_attention_fwd) has no
// backward: the reference differentiates its jnp oracle
// (repro/kernels/ops.py :: _flash_bwd), and the port's route did the same
// on the card, recomputing the dense (B, H, S, S) float32 scores and
// differentiating them with autograd (1.6 GB a tensor at the 100m model's
// S = 4,096, ~64% of a training step there).  This kernel is added because
// the route's training needs a backward of its own.
//
// What it computes, for q (B, H, Sq, hd), k and v (B, KV, Sk, hd), head h
// reading kv head h / (H / KV), given the forward's output o and each
// row's log-sum-exp lse (stored by flash_attention.cu's kernels):
//
//   D    = rowsum(dO * o)                               (flash_bwd_prep)
//   r    = q . k;  x = r * scale;  x = cap * tanh(x / cap) when cap != 0
//   x    = live ? x : NEG_INF (keys past Sk: -inf), as the forward
//   P    = exp(x - lse);  dP = dO . v
//   dS   = P (dP - D) (1 - tanh^2 where the cap is on) * scale
//   dV  += P^T dO;  dK += dS^T q;  dQ += dS k
//
// A row with no live key at all (a window and Sq >= Sk + window) is the
// uniform average of V in the forward: there P = 1 / Sk over the keys
// and dS = 0, as the plain version's gradient gives.
//
// Design (flash_bwd_kernel).  One block owns 128 keys of one kv head and
// batch (heaviest causal key tiles first: they meet the most rows), and
// loops over the G query heads of the group and, for each, over the
// 32-row q tiles that the masks leave live for some of its keys: dK and
// dV of the kv head sum over its G heads in registers.  Eight warps of
// 16 keys each.  K and V are staged once; Q, dO and the rows' lse and D
// come through a two-stage ring of cp.async copies (rows past Sq or Sk
// zero-filled), so the next tile loads while this one computes.
// The products run key-major (M = the warp's 16 keys), so the m16n8
// layout of S^T and dP^T is the A fragment of dV = P^T dO and dK = dS^T Q
// unshuffled (the forward's trick: the k index t of an 8-row step stands
// for row 2 t, t + 4 for row 2 t + 1).  Per tile, each warp:
//   - S^T and dP^T in float32 FMAs, d in order.  S is the forward's
//     float32 kernel's scores bit for bit, so P is the forward's to
//     rounding (three TF32 terms sum in another order, which misses the
//     float32 tier where the softcap binds; tests/test_torch_flash_
//     attention.py emulates both).  dP sums as the preprocess sums D, so
//     where one key carries a row (P = 1) dP - D cancels as the plain
//     version's does: in three TF32 terms on the tensor cores, which
//     round their sums toward zero, dP missed the gradient tier there by
//     1.2x on the card (a causal row's first key, dq of size 10);
//   - the scale, softcap, masks (only on tiles partly masked for the
//     warp), P and dS in registers;
//   - dV and dK on the tensor cores (mma.sync m16n8k8, TF32), P, dS, dO
//     and Q each split as hi + lo in TF32 and summed lo.hi + hi.lo +
//     hi.hi (2^-22 of each product; bf16 operands are exact in TF32 and
//     drop their lo term), every 16 rows in fresh accumulators added to
//     float32 registers, so the sums' rounding toward zero stays short;
// and writes dS^T to shared memory.  Then the block computes dQ = dS K
// for the tile (each warp 16 rows x hd / 4 columns over the 128 keys,
// three TF32 terms, fresh accumulators every 16 keys) and adds it into a
// float32 dq with float2 atomics: several key blocks add to one row, so
// dq's sums run in an order that may change from run to run (a few
// float32 roundings; dK and dV are deterministic).  The tests hold it to
// the float32 gradient tier, not bitwise.
//
// Head dims 32, 64 and 128 (float32 and bf16; the wrapper zero-pads any
// other hd up to 128 to the next of them).  At hd 256 dK and dV alone
// would take 256 registers a thread: the wrapper keeps the plain
// version's recompute there, chosen statically from the padded hd.
//
// Bound.  10 hd flops per live (q, k) pair and head: q.k and dO.v in
// float32 FMAs (67 TFLOP/s) and three products (dV, dK, dQ) on the tensor
// cores in three TF32 terms each (495 / 3 TFLOP/s); at the 100m model's
// shape (B 2, H 12, S 4,096, hd 64, causal: 201 M live pairs) 0.77 ms of
// FMAs beside 0.47 ms of tensor cores, which can overlap; the bytes (q,
// k, v, o, dO read, dq, dk, dv written, dq's atomics) are ~0.1 ms.
// No kernel here has "flash_attention" in its name: the benchmark reads
// the forward's roofline from the kernels whose names hold it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMinusInf = -__builtin_huge_valf();

constexpr int kKeys = 128;        // keys per block: eight warps of 16
constexpr int kRows = 32;         // q rows per tile
constexpr int kWarps = kKeys / 16;
constexpr int kThreads = 32 * kWarps;
constexpr int kStages = 2;        // ring depth: tile i + 1 loads under i
constexpr int kLdS = kRows + 8;   // floats a row of dS^T in shared memory

// element strides (batch, head, row) of q, k, v, o, dO, dq, dk, dv
struct Strides {
  long long qb, qh, qs, kb, kh, ks, vb, vh, vs, ob, oh, os, gb, gh, gs, dqb,
      dqh, dqs, dkb, dkh, dks, dvb, dvh, dvs;
};

// four consecutive elements of T as float32 (exact for bf16)
template <typename T>
struct Load4;

template <>
struct Load4<float> {
  static __device__ __forceinline__ float4 load(const float* p) {
    return *reinterpret_cast<const float4*>(p);
  }
};

template <>
struct Load4<__nv_bfloat16> {
  static __device__ __forceinline__ float4 load(const __nv_bfloat16* p) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
    const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
    const float2 fa = __bfloat1622float2(a);
    const float2 fb = __bfloat1622float2(b);
    return make_float4(fa.x, fa.y, fb.x, fb.y);
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// dq[0..1] += (x, y): one 8-byte atomic where the toolkit has it (sm_90)
__device__ __forceinline__ void atomic_add2(float* p, float x, float y) {
#if defined(__CUDA_ARCH__) && __CUDA_ARCH__ >= 900 && \
    (__CUDACC_VER_MAJOR__ * 100 + __CUDACC_VER_MINOR__) >= 1203
  atomicAdd(reinterpret_cast<float2*>(p), make_float2(x, y));
#else
  atomicAdd(p, x);
  atomicAdd(p + 1, y);
#endif
}

// 16-byte copy global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4-byte copy global -> shared; src_bytes 0 writes a zero
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// rows [row0, row0 + R) of a (rows, HD) view with row stride `rs`
// elements into a shared tile of LD elements a row; rows at or past
// `n_rows` are zeros
template <typename T, int HD, int R, int LD>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long rs, int row0,
                                           int n_rows) {
  constexpr int kE = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  constexpr int kC = HD / kE;               // chunks a row
  for (int idx = threadIdx.x; idx < R * kC; idx += kThreads) {
    const int r = idx / kC, c = idx % kC;
    const bool in = row0 + r < n_rows;
    const T* p = in ? src + (long long)(row0 + r) * rs + c * kE : src;
    cp_async16(dst + r * LD + c * kE, p, in ? 16 : 0);
  }
}

// s += x . y over four elements, in order, as float32 FMAs
__device__ __forceinline__ void fma4(float& s, const float4& x,
                                     const float4& y) {
  s = fmaf(x.x, y.x, s);
  s = fmaf(x.y, y.y, s);
  s = fmaf(x.z, y.z, s);
  s = fmaf(x.w, y.w, s);
}

// x = hi + lo, both TF32 (10 mantissa bits): hi rounds x to nearest
// (ties away), lo rounds the exact remainder x - hi the same way, so
// hi + lo holds x to 2^-22 of its value
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = tf32_rna(x);
  lo = tf32_rna(x - __uint_as_float(hi));
}

// D (16 x 8, f32) += A (16 x 8, tf32, row) * B (8 x 8, tf32, col)
__device__ __forceinline__ void mma_tf32(float (&d)[4],
                                         const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// an A fragment (P or dS) as hi + lo TF32 terms
struct FragA {
  uint32_t hi[4], lo[4];
  __device__ __forceinline__ void set(float x0, float x1, float x2,
                                      float x3) {
    split_tf32(x0, hi[0], lo[0]);
    split_tf32(x1, hi[1], lo[1]);
    split_tf32(x2, hi[2], lo[2]);
    split_tf32(x3, hi[3], lo[3]);
  }
};

// d += A B in TF32 terms: lo.hi, hi.lo, then hi.hi (lo.lo, 2^-22 of the
// product, dropped); kExactB (B exact in TF32, as every bf16 is) leaves
// B's lo term out
template <bool kExactB>
__device__ __forceinline__ void mma3(float (&d)[4], const FragA& a, float b0,
                                     float b1) {
  if constexpr (kExactB) {
    const uint32_t h0 = __float_as_uint(b0), h1 = __float_as_uint(b1);
    mma_tf32(d, a.lo, h0, h1);
    mma_tf32(d, a.hi, h0, h1);
  } else {
    uint32_t h0, l0, h1, l1;
    split_tf32(b0, h0, l0);
    split_tf32(b1, h1, l1);
    mma_tf32(d, a.lo, h0, h1);
    mma_tf32(d, a.hi, l0, l1);
    mma_tf32(d, a.hi, h0, h1);
  }
}

// Shared memory: K (128 rows, padded by 32 bytes: the FMA scores' and
// dQ's fragment loads both fall on distinct banks), V (128 rows padded by
// 16 bytes), the ring's kStages x (Q, dO: 32 rows padded by 16 bytes;
// lse, D: 32 floats), dS^T (128 x 40 floats)
template <typename T, int HD>
struct Layout {
  static constexpr int kE = 16 / (int)sizeof(T);
  static constexpr int kLd = HD + kE;         // elements a V, Q, dO row
  static constexpr int kLdK = HD + 2 * kE;    // elements a K row
  static constexpr int kK = kKeys * kLdK * (int)sizeof(T);
  static constexpr int kV = kKeys * kLd * (int)sizeof(T);
  static constexpr int kTile = kRows * kLd * (int)sizeof(T);
  static constexpr int kStage = 2 * kTile + 2 * kRows * 4;
  static constexpr int kDs = kKeys * kLdS * 4;
  static constexpr int kBytes = kK + kV + kStages * kStage + kDs;
};

// D = rowsum(dO * o) in float32 FMAs, d in order (the order in which the
// main kernel sums dP = dO . v, so where a row's P is one key's, dP - D
// cancels as the plain version's does), a thread a row, and the float32
// dq accumulator zeroed; rows (b, s, h) in that order, so neighbouring
// threads read neighbouring rows of the model's (B, S, H, hd) layout
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_prep_kernel(const T* __restrict__ o, const T* __restrict__ dout,
                      float* __restrict__ dd, float* __restrict__ dq, int H,
                      int Sq, long long n_rows, Strides st) {
  const long long r = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (r >= n_rows) return;
  const int h = (int)(r % H);
  const int s = (int)((r / H) % Sq);
  const long long b = r / ((long long)H * Sq);
  const T* orow = o + b * st.ob + h * st.oh + s * st.os;
  const T* grow = dout + b * st.gb + h * st.gh + s * st.gs;
  float* qrow = dq + b * st.dqb + h * st.dqh + s * st.dqs;
  float sum = 0.f;
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    const float4 x = Load4<T>::load(orow + d);
    const float4 y = Load4<T>::load(grow + d);
    sum = fmaf(y.x, x.x, sum);
    sum = fmaf(y.y, x.y, sum);
    sum = fmaf(y.z, x.z, sum);
    sum = fmaf(y.w, x.w, sum);
    *reinterpret_cast<float4*>(qrow + d) = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  dd[(b * H + h) * Sq + s] = sum;
}

// One block per (kv head, batch, 128-key tile), the key tiles a causal
// mask meets most often first.  Warp w holds keys k0 + 16 w + g and + 8
// (lane = 4 g + t) of S^T, dP^T, dK and dV; of a 32-row q tile, rows
// 8 n + 2 t and 8 n + 2 t + 1 (n < NB): s[n][2 e + c] is (key g + 8 e,
// row 8 n + 2 t + c), the m16n8 accumulator of row block n.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, const T* __restrict__ dout,
                 const float* __restrict__ lse, const float* __restrict__ dd,
                 float* __restrict__ dq, T* __restrict__ dk,
                 T* __restrict__ dv, int H, int G, int Sq, int Sk,
                 Strides st, int causal, int window, float softcap,
                 float scale) {
  using L = Layout<T, HD>;
  constexpr int kLd = L::kLd, kLdK = L::kLdK;
  constexpr int NT = HD / 8;                  // 8-column tiles of hd
  constexpr int NB = kRows / 8;               // 8-row blocks of a q tile
  constexpr int MI = kRows / 16;              // dQ's m16 row tiles
  constexpr int NQ = HD * MI / 64;            // dQ's column tiles a warp
  constexpr bool kExact = sizeof(T) == 2;     // bf16 inputs: exact in TF32
  extern __shared__ float4 smem_bwd[];
  unsigned char* base = reinterpret_cast<unsigned char*>(smem_bwd);
  T* k_s = reinterpret_cast<T*>(base);
  T* v_s = reinterpret_cast<T*>(base + L::kK);
  unsigned char* ring = base + L::kK + L::kV;
  float* ds_s = reinterpret_cast<float*>(ring + kStages * L::kStage);

  const int tid = threadIdx.x;
  const int lane = tid & 31, w = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kKeys;
  const int kw0 = k0 + 16 * w;                // the warp's first key

  // the q tiles with a live key of this block for some row; rows with no
  // live key at all (a window and Sq >= Sk + window: the last rows) weigh
  // on every key, so they keep every tile to the end
  const int nq = (Sq + kRows - 1) / kRows;
  const int kmax = min(k0 + kKeys, Sk) - 1;
  const bool dead_rows = window > 0 && (Sq - 1) - (Sk - 1) >= window;
  int qt_lo = 0, qt_hi = nq;
  if (causal) qt_lo = min(nq, k0 / kRows);
  if (window > 0 && !dead_rows) {
    qt_hi = min(nq, (kmax + window - 1) / kRows + 1);
  }
  const int nqt = max(qt_hi - qt_lo, 0);
  const int n_it = G * nqt;

  // tile i: head kvh G + i / nqt, rows (qt_lo + i % nqt) kRows + [0, 32)
  auto slot_q = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::kStage);
  };
  auto slot_do = [&](int s) {
    return reinterpret_cast<T*>(ring + s * L::kStage + L::kTile);
  };
  auto slot_lse = [&](int s) {
    return reinterpret_cast<float*>(ring + s * L::kStage + 2 * L::kTile);
  };
  auto stage = [&](int i) {
    const int s = i % kStages;
    const int h = kvh * G + i / nqt;
    const int q0 = (qt_lo + i % nqt) * kRows;
    stage_rows<T, HD, kRows, kLd>(slot_q(s), q + b * st.qb + h * st.qh,
                                  st.qs, q0, Sq);
    stage_rows<T, HD, kRows, kLd>(slot_do(s), dout + b * st.gb + h * st.gh,
                                  st.gs, q0, Sq);
    if (tid < 2 * kRows) {
      // lse, then D, of the tile's rows (zeros past Sq)
      const int r = q0 + tid % kRows;
      const long long row = ((long long)b * H + h) * Sq + r;
      const float* src = (tid < kRows ? lse : dd) + (r < Sq ? row : 0);
      cp_async4(slot_lse(s) + tid, src, r < Sq ? 4 : 0);
    }
  };
  stage_rows<T, HD, kKeys, kLdK>(k_s, k + b * st.kb + kvh * st.kh, st.ks, k0,
                                 Sk);
  stage_rows<T, HD, kKeys, kLd>(v_s, v + b * st.vb + kvh * st.vh, st.vs, k0,
                                Sk);
  if (n_it > 0) stage(0);
  cp_async_commit();

  float dv_acc[NT][4], dk_acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
#pragma unroll
    for (int i = 0; i < 4; ++i) dv_acc[n][i] = dk_acc[n][i] = 0.f;
  const float inv_sk = 1.f / (float)Sk;
  const T* kw = k_s + (16 * w + g) * kLdK;         // K rows g, g + 8
  const T* vw = v_s + (16 * w + g) * kLd;          // V rows g, g + 8

  for (int it = 0; it < n_it; ++it) {
    if (it + 1 < n_it) stage(it + 1);       // loads under this tile
    cp_async_commit();
    cp_async_wait<1>();                     // this thread's tile-it copies
    __syncthreads();                        // everyone's
    const int s = it % kStages;
    const int h = kvh * G + it / nqt;
    const int q0 = (qt_lo + it % nqt) * kRows;
    const T* q_t = slot_q(s);
    const T* do_t = slot_do(s);
    const float* lse_t = slot_lse(s);
    const float* d_t = lse_t + kRows;

    // S^T = K Q^T and dP^T = V dO^T in float32 FMAs, d in order: S as
    // the forward's float32 kernel scores, dP as the preprocess sums D
    float sc[NB][4], dp[NB][4];
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int i = 0; i < 4; ++i) sc[n][i] = dp[n][i] = 0.f;
#pragma unroll 1
    for (int d = 0; d < HD; d += 4) {
      const float4 ka = Load4<T>::load(kw + d);
      const float4 kb = Load4<T>::load(kw + 8 * kLdK + d);
      const float4 va = Load4<T>::load(vw + d);
      const float4 vb = Load4<T>::load(vw + 8 * kLd + d);
#pragma unroll
      for (int n = 0; n < NB; ++n) {
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int r = 8 * n + 2 * t4 + c;
          const float4 x = Load4<T>::load(q_t + r * kLd + d);
          const float4 y = Load4<T>::load(do_t + r * kLd + d);
          fma4(sc[n][c], x, ka);
          fma4(sc[n][2 + c], x, kb);
          fma4(dp[n][c], y, va);
          fma4(dp[n][2 + c], y, vb);
        }
      }
    }

    // scale, softcap, masks (only where the tile is partly masked for
    // this warp), P into sc and dS into dp.  Rows past Sq hold zeros (q,
    // dO, lse, D): there P is finite and dS = 0, and P dO adds zeros
    const bool partial = kw0 + 15 >= Sk ||
                         (causal && q0 < kw0 + 15) ||
                         (window > 0 && q0 + kRows - 1 - kw0 >= window);
#pragma unroll
    for (int n = 0; n < NB; ++n) {
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int r = 8 * n + 2 * t4 + c;
        const int qpos = q0 + r;
        const float lse_r = lse_t[r], d_r = d_t[r];
        const bool dead = window > 0 && qpos - (Sk - 1) >= window;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kpos = kw0 + g + 8 * e;
          float x = sc[n][2 * e + c] * scale;
          float tc = 0.f;
          if (softcap != 0.f) {
            tc = tanhf(x / softcap);
            x = softcap * tc;
          }
          bool keep = true;
          if (partial) {
            const bool live = (!causal || qpos >= kpos) &&
                              (window <= 0 || qpos - kpos < window);
            x = kpos >= Sk ? kMinusInf : (live ? x : kNegInf);
            keep = !dead;
          }
          float p = expf(x - lse_r);
          float ds = p * (dp[n][2 * e + c] - d_r);
          if (softcap != 0.f) ds *= 1.f - tc * tc;
          ds *= scale;
          if (!keep) {                 // a row with no live key
            p = kpos < Sk ? inv_sk : 0.f;
            ds = 0.f;
          }
          sc[n][2 * e + c] = p;
          dp[n][2 * e + c] = ds;
        }
      }
    }

    // dS^T to shared memory for dQ
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        *reinterpret_cast<float2*>(ds_s + (16 * w + g + 8 * e) * kLdS +
                                   8 * n + 2 * t4) =
            make_float2(dp[n][2 * e], dp[n][2 * e + 1]);

    // dV += P^T dO and dK += dS^T Q: the accumulator of row block n is
    // the A fragment of k step n, {c0, c2, c1, c3}; B reads rows 8 n +
    // 2 t (k = t) and + 1 (k = t + 4)
    {
      FragA a[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) a[n].set(sc[n][0], sc[n][2], sc[n][1],
                                           sc[n][3]);
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
#pragma unroll
        for (int n0 = 0; n0 < NB; n0 += 2) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = n0; n < n0 + 2; ++n) {
            const T* bo = do_t + (8 * n + 2 * t4) * kLd + 8 * nd + g;
            mma3<kExact>(acc, a[n], to_float(bo[0]),
                                to_float(bo[kLd]));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) dv_acc[nd][i] += acc[i];
        }
      }
    }
    {
      FragA a[NB];
#pragma unroll
      for (int n = 0; n < NB; ++n) a[n].set(dp[n][0], dp[n][2], dp[n][1],
                                           dp[n][3]);
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
#pragma unroll
        for (int n0 = 0; n0 < NB; n0 += 2) {
          float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
          for (int n = n0; n < n0 + 2; ++n) {
            const T* bq = q_t + (8 * n + 2 * t4) * kLd + 8 * nd + g;
            mma3<kExact>(acc, a[n], to_float(bq[0]),
                                to_float(bq[kLd]));
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) dk_acc[nd][i] += acc[i];
        }
      }
    }
    __syncthreads();               // dS^T complete; the ring slot read

    // dQ = dS K for the tile: warp w takes rows 16 (w % MI) + [0, 16) and
    // column tiles (w / MI) NQ + [0, NQ), k over the 128 keys in fresh
    // accumulators every 16
    {
      const int mi = w % MI, nd0 = (w / MI) * NQ;
      float dqp[NQ][4];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
#pragma unroll
        for (int i = 0; i < 4; ++i) dqp[j][i] = 0.f;
#pragma unroll
      for (int kc = 0; kc < kKeys / 8; kc += 2) {
        float acc[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[j][i] = 0.f;
#pragma unroll
        for (int kk = kc; kk < kc + 2; ++kk) {
          const float* da = ds_s + (8 * kk + t4) * kLdS + 16 * mi + g;
          FragA a;
          a.set(da[0], da[8], da[4 * kLdS], da[4 * kLdS + 8]);
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            const T* kb = k_s + (8 * kk + t4) * kLdK + 8 * (nd0 + j) + g;
            mma3<kExact>(acc[j], a, to_float(kb[0]),
                                to_float(kb[4 * kLdK]));
          }
        }
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int i = 0; i < 4; ++i) dqp[j][i] += acc[j][i];
      }
      float* dqh = dq + b * st.dqb + h * st.dqh + 2 * t4;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = q0 + 16 * mi + g + 8 * half;
        if (row < Sq) {
#pragma unroll
          for (int j = 0; j < NQ; ++j) {
            atomic_add2(dqh + (long long)row * st.dqs + 8 * (nd0 + j),
                        dqp[j][2 * half], dqp[j][2 * half + 1]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();              // no copy outlives the block

  // dK and dV of the warp's keys, keys past Sk not written
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int key = kw0 + g + 8 * e;
    if (key < Sk) {
      T* dkr = dk + b * st.dkb + kvh * st.dkh + (long long)key * st.dks +
               2 * t4;
      T* dvr = dv + b * st.dvb + kvh * st.dvh + (long long)key * st.dvs +
               2 * t4;
#pragma unroll
      for (int nd = 0; nd < NT; ++nd) {
        store2(dkr + 8 * nd, dk_acc[nd][2 * e], dk_acc[nd][2 * e + 1]);
        store2(dvr + 8 * nd, dv_acc[nd][2 * e], dv_acc[nd][2 * e + 1]);
      }
    }
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dd, float* dq,
           void* dk, void* dv, int B, int H, int KV, int Sq, int Sk,
           const Strides& st, int causal, int window, float softcap,
           float scale, cudaStream_t stream) {
  const long long n_rows = (long long)B * H * Sq;
  flash_bwd_prep_kernel<T, HD>
      <<<(unsigned)((n_rows + kThreads - 1) / kThreads), kThreads, 0,
         stream>>>((const T*)o, (const T*)dout, dd, dq, H, Sq, n_rows, st);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  constexpr int bytes = Layout<T, HD>::kBytes;
  auto kern = flash_bwd_kernel<T, HD>;
  // above 48 KB only after the opt-in (set on the current device)
  e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(KV, B, (Sk + kKeys - 1) / kKeys);
  kern<<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (const T*)dout, lse, dd, dq,
      (T*)dk, (T*)dv, H, H / KV, Sq, Sk, st, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_hd(int hd, const void* q, const void* k, const void* v,
              const void* o, const void* dout, const float* lse, float* dd,
              float* dq, void* dk, void* dv, int B, int H, int KV, int Sq,
              int Sk, const Strides& st, int causal, int window,
              float softcap, float scale, cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, o, dout, lse, dd, dq, dk, dv, B, H, KV,
                           Sq, Sk, st, causal, window, softcap, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dout, lse, dd, dq, dk, dv, B, H, KV,
                           Sq, Sk, st, causal, window, softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dout, lse, dd, dq, dk, dv, B, H, KV,
                            Sq, Sk, st, causal, window, softcap, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The backward: flash_bwd_prep_kernel (D, dq zeroed) then
// flash_bwd_kernel, on `stream`; returns cudaGetLastError() (0 on
// success).  dtype 0 = float32, 1 = bf16, for q, k, v, o, dO, dk and dv
// alike; lse and D are float32 (B, H, Sq) contiguous, dq a float32
// accumulator (zeroed here).  hd 32, 64 or 128 (the wrapper zero-pads
// any other hd up to 128 and passes the true one's scale).  strides: 24
// element strides, (batch, head, row) for q, k, v, o, dO, dq, dk, dv in
// that order; the head dim contiguous.  Any Sq, Sk >= 1.  The caller has
// checked devices, dtypes, shapes (H % KV == 0) and 16-byte alignment of
// the pointers and of every stride.
int flash_bwd(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* dd, float* dq,
              void* dk, void* dv, int dtype, int B, int H, int KV, int Sq,
              int Sk, int hd, const long long* strides, int causal,
              int window, float softcap, float scale, void* stream) {
  Strides st;
  memcpy(&st, strides, sizeof(st));
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    return launch_hd<__nv_bfloat16>(hd, q, k, v, o, dout, lse, dd, dq, dk,
                                    dv, B, H, KV, Sq, Sk, st, causal, window,
                                    softcap, scale, s);
  }
  return launch_hd<float>(hd, q, k, v, o, dout, lse, dd, dq, dk, dv, B, H,
                          KV, Sq, Sk, st, causal, window, softcap, scale, s);
}

const char* flash_bwd_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
