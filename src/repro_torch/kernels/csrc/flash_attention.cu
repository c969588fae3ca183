// Blocked flash attention forward for Hopper (sm_90a): causal / sliding
// window / logit softcap, GQA, float32 or bf16 in, float32 sums.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py ::
// flash_attention_fwd (the Pallas body _attn_kernel).  Same contract:
// q (B, H, Sq, hd), k and v (B, KV, Sk, hd), head h reading kv head
// h / (H / KV); for each row, over the k tiles in order,
//
//   s    = (q . k) * hd^-0.5;  s = cap * tanh(s / cap) when cap != 0
//   s    = live ? s : NEG_INF,  live = (!causal || qpos >= kpos)
//                                   && (!window || qpos - kpos < window)
//   m'   = max(m, max_j s);  p = exp(s - m');  corr = exp(m - m')
//   l'   = l * corr + sum_j p;  acc' = acc * corr + p V
//   out  = acc / max(l, 1e-30), written in q's dtype
//
// with positions contiguous from 0 and NEG_INF = -1e30 (not -inf), so a
// row that a tile masks entirely takes p = 1 there until a live tile
// wipes it with corr = 0, as in the TPU kernel.
//
// Two kernels, chosen by the wrapper from (dtype, hd) alone:
// flash_attention_tc_kernel for bf16 q, k, v at hd 64 or 128 (every
// dense config of the registry), flash_attention_mma_kernel (FMA scores,
// P.V on the tensor cores in 3xTF32) for float32 inputs and for bf16 at
// hd 32 and 256.  Any other hd up to 256 reaches them zero-padded by the
// wrapper to the next instantiated one (32, 64, 128, 256), with the true
// hd's scale: the zero columns add exact zeros to every q . k, and the
// output columns they make are dropped.
//
// Design of the tensor-core kernel (flash_attention_tc_kernel).  The TPU
// kernel ran a sequential (B, KV, G, nq, nk) grid and carried m, l and
// acc in VMEM scratch across the nk axis.  Blocks here run in no order,
// so one block owns one (head, 128-row q tile, batch), the heaviest
// causal tiles launched first, and loops over the 64-key tiles that the
// masks leave live for some row.  It is warp-specialised: a producer
// warpgroup, one thread of which keeps TMA loads in flight (Q once, then
// K and V of each tile into a ring of four stages, each guarded by a
// `full` and an `empty` mbarrier; the model's strided (B, S, H, hd)
// views go straight into 4-d tensor maps), and two consumer warpgroups
// of 64 rows each, which take the producer's registers (setmaxnreg) and
// per tile run:
//   - S = Q K^T on `wgmma` (m64n64k16, bf16 operands from shared memory,
//     float32 accumulation): bf16 products are exact in float32, so only
//     the order of the sum differs from the plain version;
//   - the scale, the softcap (tanhf), the causal / window masks (only on
//     tiles that are partly masked for the warpgroup) and the online
//     softmax (expf, NEG_INF = -1e30) in registers on the accumulator
//     fragment, rows reduced across the four threads of a quad;
//   - O += P V on `wgmma` (m64nHDk16, bf16, P from registers, V read
//     MN-major: its rows as they lie in memory), with P in two bf16
//     terms, hi = rn(p) and lo = rn(p - hi): P V then carries 2^-18 of
//     p's relative error.  One term in bf16 (2^-9) or TF32 (2^-11)
//     misses the bf16 tier on causal rows with few keys, where the
//     rounding of each p weighs on an output near 0; two bf16 terms cost
//     the tensor cores what one TF32 term would.  The f32 accumulator
//     fragment of S is the bf16 A fragment of P V, so P needs no shuffle.
// S of tile t + 1 is started before the softmax of tile t, and P V of
// tile t runs under the softmax of tile t + 1, while the producer loads
// ahead: the tensor cores, the memory and the ALUs work at once, and the
// consumers meet only at the ring's barriers.  Shared tiles use wgmma's
// 128-byte-swizzle layout, which TMA writes (16-byte chunks XOR-ed by
// row: the tensor cores' reads hit distinct banks).  The ragged last q
// and k tiles: rows past Sq or Sk lie outside the tensor maps and load
// as zeros; q rows past Sq are not written, keys past Sk score -inf, so
// they weigh 0 even in a row that no key reaches.  Fully-masked tiles are
// skipped as in the float32 kernel below.  161 KB of shared memory at hd 128
// (one block of 384 threads per SM), 81 KB at hd 64.
//
// Design of the float32 kernel (flash_attention_mma_kernel).  One block
// owns one (head, batch, 64-row q tile), the heaviest causal tiles of the
// whole grid launched first, and loops over the 64-key tiles that the
// masks leave live for some row.  Its warps hold 16 MT rows each (MT m16
// tiles) in KG key groups: at hd 32 and 64, MT = 2 and KG = 4 over
// 32-key tiles (eight warps: two row halves, each in four groups that
// take every fourth tile, whose softmax states merge at the end); at hd
// 128, MT = 1 and KG = 1 over 64-key tiles (four warps of 16 rows), since
// O alone takes 64 registers a thread there; at hd 256, MT = 1 and KG = 1
// over 32-key tiles (O takes 128).  K and V come through a
// two-stage ring of 16-byte cp.async copies, KG tiles a round (rows past
// Sk zero-filled), so the next round loads while this one computes; Q is
// staged once.  Per tile, each thread:
//   - scores its 2 MT rows against a quarter of the keys in float32
//     FMAs, d in order,
//     the order in which the plain version's float32 product sums: three
//     TF32 terms on the tensor cores hold each product to 2^-22 but sum
//     it in another order, which at scores of tens (gemma2's heads with
//     q x 8, where the softcap binds) leaves 2.5 x the 1e-5 tier between
//     the two (tests/test_torch_flash_attention.py emulates both);
//   - runs the scale, the softcap (tanhf), the masks (only on tiles
//     partly masked for its warp) and the online softmax in registers,
//     rows reduced across the quad: no score tile in shared memory, no
//     barrier between S and P V;
//   - adds P V on the tensor cores (mma.sync m16n8k8, TF32), P and V each
//     split as hi + lo in TF32 and summed as lo.hi + hi.lo + hi.hi: 2^-22
//     of each product, within the tiers (bf16 V is exact in TF32
//     and drops its lo term).  The tensor cores round their sums toward
//     zero, so a tile's P V sums in fresh accumulators, added to O in
//     float32: one accumulator over a whole row of 4,608 keys drifted to
//     5.8 x the tier.  The scores' accumulator layout (keys 2 t,
//     2 t + 1 of each 8-key step) is P V's A fragment when the step's k
//     index t stands for key 2 t and t + 4 for key 2 t + 1: V's fragment
//     reads those rows, and P needs no shuffle.
// A fully-masked tile is skipped, which gives the same result for every
// row that has a live key (a skipped tile would have had p = 0 there, or
// p = 1 wiped later by corr = 0).  A row with no live key at all (only
// with a window and Sq >= Sk + window) gives the uniform average of V, as
// the TPU kernel and the plain version do: a block that holds such a row
// skips nothing.  The ragged last tiles: keys past Sk score -inf, q rows
// past Sq are not written, so every Sq, Sk >= 1 is taken.  Both kernels
// read q, k, v and write out through strides (head dim contiguous), so
// the model's (B, S, H, hd) layout needs no transpose.
//
// Bound.  Arithmetic: 4 hd flops per live (q, k) pair and head, half in
// q.k and half in P.V.  The tensor-core kernel runs q.k once and P.V
// twice (hi and lo), all at the bf16 rate (989 TFLOP/s): gemma2-27b's
// prefill at S = 8,192 (H = 32, hd = 128) is 550 GFLOP on a global layer,
// 0.834 ms, and 412 GFLOP on a local one, 0.625 ms; the bytes (q, k, v
// and out once) are ~0.1 ms.  The expf and tanhf over the ~1.07 G live
// (q, k, head) pairs of a global layer cost on the order of 1 ms of their
// own, so the softcapped layers do not reach the matmul bound.  The
// float32 kernel runs q.k at the float32 FMA rate (67 TFLOP/s) and P.V
// three times at the TF32 rate (495): at transformer-100m's training shape
// (B 2, H 12, S 512, hd 64, causal: 403 MFLOP a half) that is 6.0 us of
// FMAs and 2.4 us of tensor cores, which can overlap, against 3.8 us of
// bytes; the old float32-rate bound for both halves is 12.0 us.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kMinusInf = -__builtin_huge_valf();

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

// ---------------------------------------------------------------------------
// float32 q, k, v (hd 32, 64, 128, 256) and bf16 at hd 32 and 256: FMA
// scores, P.V on the tensor cores in three TF32 terms
// ---------------------------------------------------------------------------

namespace mma {

constexpr int kRows = 64;         // q rows per block
constexpr int kStages = 2;        // ring depth, in rounds of KG tiles:
                                  // round r + 1 loads under round r

// A block's warps: kRowWarps of 16 MT rows each (MT m16 tiles), times KG
// key groups.  Key group k takes tiles k, k + KG, ... of the block's live
// range, so KG tiles are in flight per round, and the groups' softmax
// states merge at the end.
template <int MT, int KG>
struct Warps {
  static constexpr int kRowWarps = kRows / (16 * MT);
  static constexpr int kThreads = 32 * kRowWarps * KG;
};

// Q, then kStages x KG K tiles of KK keys, then as many V tiles, each
// row padded by 16 bytes: the 16-byte cp.async rows stay aligned and the
// fragment loads below fall on distinct banks
template <typename T, int HD, int KG, int KK>
struct Layout {
  static constexpr int kLd = HD + 16 / (int)sizeof(T);   // elements a row
  static constexpr int kQ = kRows * kLd;
  static constexpr int kT = KK * kLd;
  static constexpr int kBytes =
      (int)sizeof(T) * (kQ + 2 * kStages * KG * kT);
};

// 16-byte copy global -> shared; src_bytes 0 fills the 16 bytes with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
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
// elements into a padded shared tile; rows at or past `n_rows` are zeros
template <typename T, int HD, int R, int kThreads>
__device__ __forceinline__ void stage_rows(T* dst, const T* src,
                                           long long rs, int row0,
                                           int n_rows) {
  constexpr int kE = 16 / (int)sizeof(T);   // elements a 16-byte chunk
  constexpr int kC = HD / kE;               // chunks a row
  constexpr int kLd = HD + kE;
  for (int idx = threadIdx.x; idx < R * kC; idx += kThreads) {
    const int r = idx / kC, c = idx % kC;
    const bool in = row0 + r < n_rows;
    const T* p = in ? src + (long long)(row0 + r) * rs + c * kE : src;
    cp_async16(dst + r * kLd + c * kE, p, in ? 16 : 0);
  }
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

// One block per (head, batch, 64-row q tile), the heaviest q tiles of a
// causal mask first over the whole grid.  Thread (row warp w, lane = 4 g
// + t) holds rows 16 (MT w + i) + g and that + 8 of S and O for each of
// its MT m16 tiles i.  Its scores are keys 8 j + 2 t + {0, 1} (j < KK /
// 8) of each KK-key tile: the m16n8 accumulator layout, which P.V takes as its
// A fragment unshuffled when the k index of each 8-key step runs over
// keys 2 t (k = t) and 2 t + 1 (k = t + 4), so V's B fragment reads rows
// 8 j + 2 t and 8 j + 2 t + 1.  Each K element loaded scores 2 MT rows;
// each V fragment loaded and split serves MT m16 tiles.
template <typename T, int HD, int MT, int KG, int KK>
__global__ void __launch_bounds__(Warps<MT, KG>::kThreads, 1)
flash_attention_mma_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int G, int Sq, int Sk, long long qb, long long qh,
                           long long qs, long long kb, long long kh,
                           long long ks, long long vb, long long vh,
                           long long vs, long long ob, long long oh,
                           long long os, int causal, int window,
                           float softcap, float scale) {
  using L = Layout<T, HD, KG, KK>;
  using W = Warps<MT, KG>;
  constexpr int kLd = L::kLd;
  constexpr int NT = HD / 8;                  // O's 8-column tiles
  constexpr int NR = 2 * MT;                  // rows a thread holds
  constexpr int NK = KK / 4;                  // keys a thread holds a tile
  // bf16 values are exact in TF32: V needs no lo term
  constexpr bool kExactV = sizeof(T) == 2;
  extern __shared__ float4 smem_mma[];
  T* q_s = reinterpret_cast<T*>(smem_mma);
  T* k_s = q_s + L::kQ;
  T* v_s = k_s + kStages * KG * L::kT;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int rw = warp % W::kRowWarps, kg = warp / W::kRowWarps;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;
  const T* qp = q + b * qb + h * qh;
  const T* kp = k + b * kb + (h / G) * kh;
  const T* vp = v + b * vb + (h / G) * vh;

  // the tiles with a live key for some row of the block: a row with no
  // live key at all (a window and Sq >= Sk + window) needs every tile
  const int nk = (Sk + KK - 1) / KK;
  const int qmax = min(q0 + kRows - 1, Sq - 1);
  const bool dead_rows = window > 0 && qmax - (Sk - 1) >= window;
  int t_lo = 0, t_hi = nk;
  if (!dead_rows) {
    if (causal) t_hi = min(nk, qmax / KK + 1);
    if (window > 0 && q0 - window - (KK - 1) >= 0) {
      t_lo = (q0 - window - (KK - 1)) / KK + 1;
    }
  }
  const int n_rounds = (t_hi - t_lo + KG - 1) / KG;
  // round r brings tiles t_lo + r KG + [0, KG) into ring slot r % kStages
  auto stage_round = [&](int r) {
#pragma unroll
    for (int k2 = 0; k2 < KG; ++k2) {
      const int t = t_lo + r * KG + k2;
      const int slot = (r % kStages) * KG + k2;
      if (t < t_hi) {
        stage_rows<T, HD, KK, W::kThreads>(k_s + slot * L::kT, kp, ks,
                                           t * KK, Sk);
        stage_rows<T, HD, KK, W::kThreads>(v_s + slot * L::kT, vp, vs,
                                           t * KK, Sk);
      }
    }
  };
  stage_rows<T, HD, kRows, W::kThreads>(q_s, qp, qs, q0, Sq);
  if (n_rounds > 0) stage_round(0);
  cp_async_commit();

  const int wr0 = 16 * MT * rw;               // the warp's first row
  const int wq0 = q0 + wr0;
  float o[MT][NT][4];
  float m[NR], l[NR];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int n = 0; n < NT; ++n) o[i][n][0] = o[i][n][1] = o[i][n][2] =
        o[i][n][3] = 0.f;
#pragma unroll
  for (int r = 0; r < NR; ++r) {
    m[r] = kNegInf;
    l[r] = 0.f;
  }

  for (int r = 0; r < n_rounds; ++r) {
    if (r + 1 < n_rounds) stage_round(r + 1);  // loads under this round
    cp_async_commit();
    cp_async_wait<1>();                       // this thread's round-r copies
    __syncthreads();                          // everyone's
    const int t = t_lo + r * KG + kg;
    if (t < t_hi) {
      const int slot = (r % kStages) * KG + kg;
      const T* kt = k_s + slot * L::kT;
      const T* vt = v_s + slot * L::kT;
      const int k0 = t * KK;

      // S = Q K^T in float32 FMAs, d in order as the plain version sums:
      // s[2 i + e] holds row 16 (MT w + i) + g + 8 e, entry 2 j + c key
      // 8 j + 2 t + c
      float s[NR][NK];
#pragma unroll
      for (int r2 = 0; r2 < NR; ++r2)
#pragma unroll
        for (int n = 0; n < NK; ++n) s[r2][n] = 0.f;
#pragma unroll 1
      for (int d = 0; d < HD; d += 4) {
        float4 a[NR];
#pragma unroll
        for (int r2 = 0; r2 < NR; ++r2) {
          a[r2] = Load4<T>::load(q_s + (wr0 + 8 * r2 + g) * kLd + d);
        }
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          const float4 kv = Load4<T>::load(
              kt + (8 * (n >> 1) + 2 * t4 + (n & 1)) * kLd + d);
#pragma unroll
          for (int r2 = 0; r2 < NR; ++r2) {
            s[r2][n] = fmaf(a[r2].x, kv.x, s[r2][n]);
            s[r2][n] = fmaf(a[r2].y, kv.y, s[r2][n]);
            s[r2][n] = fmaf(a[r2].z, kv.z, s[r2][n]);
            s[r2][n] = fmaf(a[r2].w, kv.w, s[r2][n]);
          }
        }
      }

      // scale, softcap, masks (only where the tile is partly masked for
      // this warp: keys past Sk score -inf, masked ones NEG_INF) and the
      // online softmax on the fragment, rows reduced across the quad
      const bool partial = k0 + KK > Sk ||
                           (causal && wq0 < k0 + KK - 1) ||
                           (window > 0 && wq0 + 16 * MT - 1 - k0 >= window);
#pragma unroll
      for (int r2 = 0; r2 < NR; ++r2) {
        const int qpos = wq0 + 8 * r2 + g;
        float mx = kNegInf;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          float x = s[r2][n] * scale;
          if (softcap != 0.f) x = softcap * tanhf(x / softcap);
          if (partial) {
            const int kpos = k0 + 8 * (n >> 1) + 2 * t4 + (n & 1);
            const bool live = (!causal || qpos >= kpos) &&
                              (window <= 0 || qpos - kpos < window);
            x = kpos >= Sk ? kMinusInf : (live ? x : kNegInf);
          }
          s[r2][n] = x;
          mx = fmaxf(mx, x);
        }
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float mn = fmaxf(m[r2], mx);
        const float c = expf(m[r2] - mn);
        m[r2] = mn;
        float sum = 0.f;
#pragma unroll
        for (int n = 0; n < NK; ++n) {
          s[r2][n] = expf(s[r2][n] - mn);
          sum += s[r2][n];
        }
        l[r2] = l[r2] * c + sum;   // this thread's columns; the quad's
                                   // are added at the end
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          o[r2 >> 1][n][2 * (r2 & 1)] *= c;
          o[r2 >> 1][n][2 * (r2 & 1) + 1] *= c;
        }
      }

      // O += P V on the tensor cores, P and V each as hi + lo in TF32:
      // lo.hi and hi.lo first, then hi.hi (lo.lo, 2^-22 of the product,
      // dropped).  The tensor cores round each sum toward zero, so one
      // accumulator fed every tile of a long row would drift by an ulp
      // of O a product (S 4,608: ~1,700 of them, 5.8 x the float32 tier):
      // each 8-column slice of the tile sums in a fresh accumulator of
      // KK / 8 x 3 products, added to O in float32
      uint32_t ph[KK / 8][MT][4], pl[KK / 8][MT][4];
#pragma unroll
      for (int j = 0; j < KK / 8; ++j) {
#pragma unroll
        for (int i = 0; i < MT; ++i) {
          split_tf32(s[2 * i][2 * j], ph[j][i][0], pl[j][i][0]);
          split_tf32(s[2 * i + 1][2 * j], ph[j][i][1], pl[j][i][1]);
          split_tf32(s[2 * i][2 * j + 1], ph[j][i][2], pl[j][i][2]);
          split_tf32(s[2 * i + 1][2 * j + 1], ph[j][i][3], pl[j][i][3]);
        }
      }
      const T* v0 = vt + 2 * t4 * kLd + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        float pv[MT][4];
#pragma unroll
        for (int i = 0; i < MT; ++i) pv[i][0] = pv[i][1] = pv[i][2] =
            pv[i][3] = 0.f;
#pragma unroll
        for (int j = 0; j < KK / 8; ++j) {
          const float x0 = to_float(v0[8 * j * kLd + 8 * n]);
          const float x1 = to_float(v0[(8 * j + 1) * kLd + 8 * n]);
          if constexpr (kExactV) {
            const uint32_t b0 = __float_as_uint(x0);
            const uint32_t b1 = __float_as_uint(x1);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_tf32(pv[i], pl[j][i], b0, b1);
              mma_tf32(pv[i], ph[j][i], b0, b1);
            }
          } else {
            uint32_t bh0, bl0, bh1, bl1;
            split_tf32(x0, bh0, bl0);
            split_tf32(x1, bh1, bl1);
#pragma unroll
            for (int i = 0; i < MT; ++i) {
              mma_tf32(pv[i], pl[j][i], bh0, bh1);
              mma_tf32(pv[i], ph[j][i], bl0, bl1);
              mma_tf32(pv[i], ph[j][i], bh0, bh1);
            }
          }
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int e = 0; e < 4; ++e) o[i][n][e] += pv[i][e];
      }
    }
    __syncthreads();               // the round's slots free for round r + 2
  }
  cp_async_wait<0>();              // no copy outlives the block
#pragma unroll
  for (int r2 = 0; r2 < NR; ++r2) {
    l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 1);
    l[r2] += __shfl_xor_sync(0xffffffffu, l[r2], 2);
  }

  if constexpr (KG > 1) {
    // key groups 1.. hand (m, l, O) to group 0 through shared memory (the
    // ring, free now), in order: m = max, each side rescaled by e^(m_k - m)
    constexpr int kState = 2 * NR + MT * NT * 4;
    float* x_s = reinterpret_cast<float*>(smem_mma) +
                 (size_t)(rw * 32 + lane) * kState;
    __syncthreads();               // every copy landed, every read done
    for (int k2 = 1; k2 < KG; ++k2) {
      if (kg == k2) {
#pragma unroll
        for (int r2 = 0; r2 < NR; ++r2) {
          x_s[2 * r2] = m[r2];
          x_s[2 * r2 + 1] = l[r2];
        }
#pragma unroll
        for (int i = 0; i < MT; ++i)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              x_s[2 * NR + (i * NT + n) * 4 + e] = o[i][n][e];
      }
      __syncthreads();
      if (kg == 0) {
#pragma unroll
        for (int r2 = 0; r2 < NR; ++r2) {
          const float mb = x_s[2 * r2];
          const float mn = fmaxf(m[r2], mb);
          const float ca = expf(m[r2] - mn), cb = expf(mb - mn);
          m[r2] = mn;
          l[r2] = l[r2] * ca + x_s[2 * r2 + 1] * cb;
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int idx = 2 * (r2 & 1) + e;
              o[r2 >> 1][n][idx] =
                  o[r2 >> 1][n][idx] * ca +
                  x_s[2 * NR + ((r2 >> 1) * NT + n) * 4 + idx] * cb;
            }
        }
      }
      __syncthreads();
    }
    if (kg != 0) return;
  }

  // out = O / max(l, 1e-30) (one reciprocal a row), rows past Sq not
  // written
  T* op = out + b * ob + h * oh + 2 * t4;
#pragma unroll
  for (int r2 = 0; r2 < NR; ++r2) {
    const int qpos = wq0 + 8 * r2 + g;
    if (qpos < Sq) {
      T* orow = op + (long long)qpos * os;
      const float inv = 1.f / fmaxf(l[r2], 1e-30f);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float x = o[r2 >> 1][n][2 * (r2 & 1)] * inv;
        const float y = o[r2 >> 1][n][2 * (r2 & 1) + 1] * inv;
        if constexpr (sizeof(T) == 4) {
          *reinterpret_cast<float2*>(orow + 8 * n) = make_float2(x, y);
        } else {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
              __floats2bfloat162_rn(x, y);
        }
      }
    }
  }
}

// hd 32 and 64: two m16 tiles a warp (each K element loaded scores four
// rows), four key groups of 32-key tiles (2 x 4 warps, two a scheduler;
// 157 KB of shared memory at hd 64); hd 128: one m16 tile, one key group
// of 64-key tiles (4 warps), since O alone is 64 registers a thread there;
// hd 256: one m16 tile, one key group of 32-key tiles (4 warps): O is 128
// registers a thread and the tile's scores and P splits 48 more, and Q
// plus the two-stage K/V ring take 195 KB of shared memory in float32
template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int Sq, int Sk, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  constexpr int MT = HD >= 128 ? 1 : 2;
  constexpr int KG = HD >= 128 ? 1 : 4;
  constexpr int KK = HD == 128 ? 64 : 32;
  constexpr int bytes = Layout<T, HD, KG, KK>::kBytes;
  auto kern = flash_attention_mma_kernel<T, HD, MT, KG, KK>;
  // above 48 KB only after the opt-in (set on the current device: cheap,
  // so every launch asks rather than caching per process)
  const cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(H, B, (Sq + kRows - 1) / kRows);
  kern<<<grid, Warps<MT, KG>::kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H / KV, Sq, Sk, st[0],
      st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9], st[10],
      st[11], causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace mma

// ---------------------------------------------------------------------------
// bf16 q, k, v at hd 64 / 128: the tensor-core kernel
// ---------------------------------------------------------------------------

namespace tc {

constexpr int kRows = 128;        // q rows per block: two warpgroups of 64
constexpr int kKeys = 64;         // keys per K/V tile
constexpr int kStages = 4;        // K/V ring depth
constexpr int kThreads = 384;     // a producer warpgroup + 2 consumers

template <int HD>
struct Layout {
  // Shared memory in wgmma's 128-byte-swizzle canonical layout, as TMA
  // writes it: a tile of R rows x HD bf16 is HD / 64 column blocks of R
  // rows x 128 bytes; the 16-byte chunk c of row r sits at chunk position
  // c ^ (r % 8) of its row, so 8 rows' reads of one chunk fall on 8
  // distinct bank groups.  Q is 128 rows; K and V, 64 keys each, kStages
  // of them: K-major for Q and K in S = Q K^T, MN-major for V in O = P V
  // (the rows of V as they lie in memory).  Every column block starts on
  // 1,024 bytes, as the swizzle needs; the ring's mbarriers follow.
  static constexpr int kQ = kRows * HD * 2;
  static constexpr int kT = kKeys * HD * 2;
  static constexpr int kBars = 8 * (2 * kStages + 1);
  static constexpr int kBytes = 1024 + kQ + 2 * kStages * kT + kBars;
};

// the wgmma shared-memory matrix descriptor, 128-byte swizzle: start
// address, leading and stride byte offsets (16-byte units), layout 1
__device__ __forceinline__ uint64_t make_desc(const void* p, uint32_t lbo,
                                              uint32_t sbo) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a >> 4) & 0x3FFF) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}
// K-major (Q, K): SBO between 8-row groups (8 x 128 bytes), LBO unused;
// a k16 step moves the start by 32 bytes within the 128-byte rows.
// MN-major (V): LBO between 64-column blocks, SBO between 8-key groups.
constexpr uint32_t kSbo = 1024, kVLbo = kKeys * 128;

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that owns it
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void bar_init(uint64_t* b, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(b)), "r"(count)
               : "memory");
}
// one arrival that also announces `bytes` of TMA traffic to wait for
__device__ __forceinline__ void bar_expect(uint64_t* b, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_addr(b)), "r"(bytes)
               : "memory");
}
__device__ __forceinline__ void bar_arrive(uint64_t* b) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(b))
               : "memory");
}
// wait until the phase of parity `parity` of the barrier has completed
__device__ __forceinline__ void bar_wait(uint64_t* b, int parity) {
  asm volatile(
      "{\n.reg .pred P1;\nLAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\nbra LAB_WAIT;\nDONE:\n}\n" ::"r"(smem_addr(b)),
      "r"(parity)
      : "memory");
}
// a TMA copy of one box of the 4-d tensor map (hd, rows, heads, batch)
// into shared memory, completing on barrier `bar`
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int col, int row,
                                         int head, int batch) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n"
      ::"r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(bar)), "r"(col), "r"(row), "r"(head), "r"(batch)
      : "memory");
}
// two floats as bf16x2 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// D (64 x 64, f32) = [D +] A (64 x 16, bf16, shared) * B (16 x 64, bf16,
// shared), both K-major; scale_d = 0 overwrites D
__device__ __forceinline__ void wgmma_m64n64k16_bf16(float (&d)[32],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// D (64 x 64, f32) += A (64 x 16, bf16, registers) * B (16 x 64, bf16,
// shared, MN-major: the rows of V as they lie in memory)
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

// D (64 x 128, f32) += A (64 x 16, bf16, registers) * B (16 x 128, bf16,
// shared, MN-major: the rows of V as they lie in memory)
__device__ __forceinline__ void wgmma_m64n128k16_bf16_rs(float (&d)[64],
                                                       const uint32_t (&a)[4],
                                                       uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      :
        "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&d)[HD / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (HD == 128) {
    wgmma_m64n128k16_bf16_rs(d, a, desc_b);
  } else {
    wgmma_m64n64k16_bf16_rs(d, a, desc_b);
  }
}

// One block per (head, 128-row q tile, batch), the heaviest q tiles of a
// causal mask first.  Warpgroup 0 is the producer: one thread starts the
// TMA loads of Q and of each K/V tile into a ring of kStages, each stage
// guarded by a `full` mbarrier (the TMA bytes landed) and an `empty` one
// (both consumers are done with it).  Warpgroups 1 and 2 each own 64 q
// rows: S = Q K^T (bf16 wgmma, f32 accumulation), the softcap, masks and
// online softmax on the accumulator fragment, O += P V (bf16 wgmma, P
// from registers in two bf16 terms).  Thread (warp wi of its consumer
// warpgroup w, lane = 4 g + t) holds rows r0 = 64 w + 16 wi + g and
// r0 + 8 of S and O, columns 8 j + 2 t + {0, 1}: the f32 accumulator
// fragment is the bf16 A fragment of the next product, so P needs no
// shuffle.  The producer hands its registers to the consumers
// (setmaxnreg).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
flash_attention_tc_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          __nv_bfloat16* __restrict__ out, int G, int Sq,
                          int Sk, long long ob, long long oh, long long os,
                          int causal, int window, float softcap,
                          float scale) {
  using L = Layout<HD>;
  constexpr int NO = HD / 2;                  // O accumulator per thread
  extern __shared__ __align__(128) unsigned char smem_tc[];
  // the swizzle repeats every 1,024 bytes: align the tiles to it
  unsigned char* q_s =
      smem_tc + ((1024 - static_cast<int>(smem_addr(smem_tc) & 1023)) & 1023);
  unsigned char* k_s = q_s + L::kQ;
  unsigned char* v_s = k_s + kStages * L::kT;
  uint64_t* full = reinterpret_cast<uint64_t*>(v_s + kStages * L::kT);
  uint64_t* empty = full + kStages;
  uint64_t* qbar = empty + kStages;

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int h = blockIdx.x, b = blockIdx.z;
  const int q0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int kvh = h / G;

  // the tiles with a live key for some row of the block: a row with no
  // live key at all (a window and Sq >= Sk + window) needs every tile
  const int nk = (Sk + kKeys - 1) / kKeys;
  const int qmax = min(q0 + kRows - 1, Sq - 1);
  const bool dead_rows = window > 0 && qmax - (Sk - 1) >= window;
  int t_lo = 0, t_hi = nk;
  if (!dead_rows) {
    if (causal) t_hi = min(nk, qmax / kKeys + 1);
    if (window > 0 && q0 - window - (kKeys - 1) >= 0) {
      t_lo = (q0 - window - (kKeys - 1)) / kKeys + 1;
    }
  }
  const int n_t = t_hi - t_lo;

  if (tid == 0) {
    for (int st = 0; st < kStages; ++st) {
      bar_init(&full[st], 1);
      bar_init(&empty[st], 2 * 128);        // every consumer thread
    }
    bar_init(qbar, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp < 4) {
    // the producer: Q once, then tile i into stage i % kStages as soon as
    // both consumers have released the tile kStages before it.  Rows past
    // Sq or Sk lie outside the tensor maps: TMA fills them with zeros
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 0) {
      bar_expect(qbar, L::kQ);
      for (int cb = 0; cb < HD / 64; ++cb) {
        tma_load(q_s + cb * kRows * 128, &qmap, qbar, cb * 64, q0, h, b);
      }
      for (int i = 0; i < n_t; ++i) {
        const int st = i % kStages;
        if (i >= kStages) bar_wait(&empty[st], (i / kStages - 1) & 1);
        bar_expect(&full[st], 2 * L::kT);
        const int key0 = (t_lo + i) * kKeys;
        for (int cb = 0; cb < HD / 64; ++cb) {
          tma_load(k_s + st * L::kT + cb * kKeys * 128, &kmap, &full[st],
                   cb * 64, key0, kvh, b);
          tma_load(v_s + st * L::kT + cb * kKeys * 128, &vmap, &full[st],
                   cb * 64, key0, kvh, b);
        }
      }
    }
    return;
  }
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = (warp >> 2) - 1, wi = warp & 3;
  const int g = lane >> 2, t4 = lane & 3;
  const int r0 = 64 * wg + 16 * wi + g;       // block-local rows r0, r0 + 8
  const int wq0 = q0 + 64 * wg;               // the warpgroup's first row
  const unsigned char* qw = q_s + 64 * wg * 128;  // this warpgroup's rows
  // S = Q K^T of the tile in ring stage `stage` into s, asynchronously
  auto start_qk = [&](float (&s)[32], int stage) {
    const unsigned char* kt = k_s + stage * L::kT;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int col = (kk & 3) * 32;     // bytes into the 128-byte rows
      wgmma_m64n64k16_bf16(
          s, make_desc(qw + (kk >> 2) * kRows * 128 + col, 0, kSbo),
          make_desc(kt + (kk >> 2) * kKeys * 128 + col, 0, kSbo), kk > 0);
    }
    wgmma_commit();
  };

  float o[NO];
#pragma unroll
  for (int i = 0; i < NO; ++i) o[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  float sa[32], sb[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sa[i] = sb[i] = 0.f;
  bar_wait(qbar, 0);
  bar_wait(&full[0], 0);
  start_qk(sa, 0);
  wgmma_wait_all();
  fence_regs(sa);
  const float cap_scale = softcap != 0.f ? scale / softcap : 0.f;
  uint32_t ph[16], pl[16];

  // Tile i: sc holds its raw S (retired) and P V of tile i - 1 may still
  // run, reading ph / pl.  S of tile i + 1 (into sn) is started first, so
  // the tensor cores work while the softmax of tile i runs in place in
  // sc; O is rescaled and ph / pl rewritten only once every wgmma in
  // flight has retired (touching a wgmma's registers before its wait
  // would serialize them), and P V of tile i then runs under the next
  // tile's softmax.  S of tile i + 1 is started even past the last tile
  // (on the last tile's stage, result unused): a wgmma under a condition
  // would serialize them too.
  auto step = [&](float (&sc)[32], float (&sn)[32], int i) {
    int nxt = i % kStages;
    if (i + 1 < n_t) {
      nxt = (i + 1) % kStages;
      bar_wait(&full[nxt], ((i + 1) / kStages) & 1);
    }
    start_qk(sn, nxt);

    // softcap, masks (only where the tile is partly masked for this
    // warpgroup) and the online softmax, rows r0 (e & 2 == 0) and r0 + 8
    const int k0 = (t_lo + i) * kKeys;
    const bool partial = k0 + kKeys > Sk ||
                         (causal && wq0 < k0 + kKeys - 1) ||
                         (window > 0 && wq0 + 63 - k0 >= window);
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      float x = softcap != 0.f ? softcap * tanhf(sc[e] * cap_scale)
                               : sc[e] * scale;
      if (partial) {
        const int kpos = k0 + 8 * (e >> 2) + 2 * t4 + (e & 1);
        const int qpos = q0 + r0 + ((e & 2) ? 8 : 0);
        const bool live = (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        // keys past Sk do not exist in the reference: -inf weighs 0
        // even in a row that no key reaches
        x = kpos >= Sk ? kMinusInf : (live ? x : kNegInf);
      }
      sc[e] = x;
      if (e & 2) {
        mx1 = fmaxf(mx1, x);
      } else {
        mx0 = fmaxf(mx0, x);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float c0 = expf(m0 - n0), c1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const float p = expf(sc[e] - ((e & 2) ? n1 : n0));
      if (e & 2) {
        sum1 += p;
      } else {
        sum0 += p;
      }
      sc[e] = p;
    }
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 1);
    sum0 += __shfl_xor_sync(0xffffffffu, sum0, 2);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 1);
    sum1 += __shfl_xor_sync(0xffffffffu, sum1, 2);
    l0 = l0 * c0 + sum0;
    l1 = l1 * c1 + sum1;

    wgmma_wait_all();        // P V of tile i - 1 and S of tile i + 1
    fence_regs(o);
    fence_regs(sn);
    if (i >= 1) bar_arrive(&empty[(i - 1) % kStages]);  // tile i - 1 done
#pragma unroll
    for (int e = 0; e < NO; ++e) o[e] *= (e & 2) ? c1 : c0;
    // p = hi + lo in bf16: hi = rn(p), lo = rn(p - hi) (p - hi is exact),
    // so P V carries 2^-18 of p's relative error; pairs of columns pack
    // into one register, the A fragment of a 16-key step
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const __nv_bfloat162 hv = __floats2bfloat162_rn(sc[e], sc[e + 1]);
      const float2 hf = __bfloat1622float2(hv);
      ph[e / 2] = *reinterpret_cast<const uint32_t*>(&hv);
      pl[e / 2] = pack_bf16(sc[e] - hf.x, sc[e + 1] - hf.y);
    }

    // O += P V, 16 keys a step: A = (P[r0, 2t..], P[r0 + 8, 2t..],
    // P[r0, 8 + 2t..], P[r0 + 8, 8 + 2t..]) of the step's 16 columns
    const unsigned char* vt = v_s + (i % kStages) * L::kT;
    wgmma_fence();
#pragma unroll
    for (int j = 0; j < kKeys / 16; ++j) {
      const uint64_t dv = make_desc(vt + j * 2 * kSbo, kVLbo, kSbo);
      const uint32_t ah[4] = {ph[4 * j], ph[4 * j + 1], ph[4 * j + 2],
                              ph[4 * j + 3]};
      wgmma_pv<HD>(o, ah, dv);
      const uint32_t al[4] = {pl[4 * j], pl[4 * j + 1], pl[4 * j + 2],
                              pl[4 * j + 3]};
      wgmma_pv<HD>(o, al, dv);
    }
    wgmma_commit();
  };
  for (int i = 0; i < n_t; i += 2) {
    step(sa, sb, i);
    if (i + 1 < n_t) step(sb, sa, i + 1);
  }
  wgmma_wait_all();
  fence_regs(o);

  // out = O / max(l, 1e-30) in bf16, rows past Sq not written
  const float inv0 = 1.f / fmaxf(l0, 1e-30f);
  const float inv1 = 1.f / fmaxf(l1, 1e-30f);
  __nv_bfloat16* op = out + b * ob + h * oh;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qpos = q0 + r0 + 8 * half;
    if (qpos < Sq) {
      __nv_bfloat16* orow = op + (long long)qpos * os + 2 * t4;
      const float inv = half ? inv1 : inv0;
#pragma unroll
      for (int j = 0; j < HD / 8; ++j) {
        *reinterpret_cast<__nv_bfloat162*>(orow + 8 * j) =
            __floats2bfloat162_rn(o[4 * j + 2 * half] * inv,
                                  o[4 * j + 2 * half + 1] * inv);
      }
    }
  }
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// The tensor map of a (B, heads, rows, hd) bf16 view with element strides
// (batch, head, row), head dim contiguous: boxes of 64 columns (128
// bytes, the swizzle's width) x box_rows rows, 128-byte swizzle, zeros
// outside.  cuTensorMapEncodeTiled is looked up through the CUDA runtime,
// so the library links nothing beyond it.
int make_map(CUtensorMap* map, const void* base, int hd, int rows,
             int heads, int batch, long long sb, long long sh, long long sr,
             int box_rows) {
  static EncodeTiled encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
    if (e != cudaSuccess) return (int)e;
    if (!fn) return (int)cudaErrorNotSupported;
    encode = (EncodeTiled)fn;
  }
  const cuuint64_t dims[4] = {(cuuint64_t)hd, (cuuint64_t)rows,
                              (cuuint64_t)heads, (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)sr * 2, (cuuint64_t)sh * 2,
                                 (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)box_rows, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base),
      dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int Sq, int Sk, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  CUtensorMap qm, km, vm;
  int e = make_map(&qm, q, HD, Sq, H, B, st[0], st[1], st[2], kRows);
  if (!e) e = make_map(&km, k, HD, Sk, KV, B, st[3], st[4], st[5], kKeys);
  if (!e) e = make_map(&vm, v, HD, Sk, KV, B, st[6], st[7], st[8], kKeys);
  if (e) return e;
  constexpr int bytes = Layout<HD>::kBytes;
  const cudaError_t ce = cudaFuncSetAttribute(
      flash_attention_tc_kernel<HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (ce != cudaSuccess) return (int)ce;
  const dim3 grid(H, (Sq + kRows - 1) / kRows, B);
  flash_attention_tc_kernel<HD><<<grid, kThreads, bytes, stream>>>(
      qm, km, vm, (__nv_bfloat16*)out, H / KV, Sq, Sk, st[9], st[10],
      st[11], causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace tc

}  // namespace

extern "C" {

// The float32 kernel (FMA scores, 3xTF32 P.V).  Launches on `stream` and
// returns cudaGetLastError() (0 on success).  dtype 0 = float32 (hd 32,
// 64, 128 or 256), 1 = bf16 (hd 32 or 256: the tensor-core kernel takes
// bf16 at 64 and 128); q, k, v and out alike.  The wrapper zero-pads any
// other head dim to the next of these and passes the true one's scale.
// strides: 12 element strides, (batch, head, row) for q, k, v and out in
// that order; the head dim is contiguous.  Any Sq, Sk >= 1.  The caller
// has checked devices, dtypes, shapes (H % KV == 0) and 16-byte alignment
// of the pointers and of every stride.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int dtype, int B, int H, int KV, int Sq,
                        int Sk, int hd, const long long* strides, int causal,
                        int window, float softcap, float scale,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 1) {
    switch (hd) {
      case 32:
        return mma::launch<__nv_bfloat16, 32>(q, k, v, out, B, H, KV, Sq, Sk,
                                              strides, causal, window,
                                              softcap, scale, s);
      case 256:
        return mma::launch<__nv_bfloat16, 256>(q, k, v, out, B, H, KV, Sq,
                                               Sk, strides, causal, window,
                                               softcap, scale, s);
      default:
        return (int)cudaErrorInvalidValue;
    }
  }
  switch (hd) {
    case 32:
      return mma::launch<float, 32>(q, k, v, out, B, H, KV, Sq, Sk, strides,
                                    causal, window, softcap, scale, s);
    case 64:
      return mma::launch<float, 64>(q, k, v, out, B, H, KV, Sq, Sk, strides,
                                    causal, window, softcap, scale, s);
    case 128:
      return mma::launch<float, 128>(q, k, v, out, B, H, KV, Sq, Sk,
                                     strides, causal, window, softcap, scale,
                                     s);
    case 256:
      return mma::launch<float, 256>(q, k, v, out, B, H, KV, Sq, Sk,
                                     strides, causal, window, softcap, scale,
                                     s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// The tensor-core kernel for bf16 q, k, v at hd 64 or 128; any Sq, Sk >= 1
// (the ragged last tiles are masked).  Arguments as flash_attention_fwd's
// without the dtype.
int flash_attention_fwd_tc(const void* q, const void* k, const void* v,
                           void* out, int B, int H, int KV, int Sq, int Sk,
                           int hd, const long long* strides, int causal,
                           int window, float softcap, float scale,
                           void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  switch (hd) {
    case 64:
      return tc::launch<64>(q, k, v, out, B, H, KV, Sq, Sk, strides, causal,
                            window, softcap, scale, s);
    case 128:
      return tc::launch<128>(q, k, v, out, B, H, KV, Sq, Sk, strides, causal,
                             window, softcap, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
