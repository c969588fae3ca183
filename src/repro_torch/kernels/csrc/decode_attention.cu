// Paged decode attention for Hopper (sm_90a): split-K over the slot's
// history (flash-decoding), cp.async staging, float32 or bf16 pools, any
// number of query heads per kv head.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ::
// paged_decode_attention_fwd (the Pallas body _decode_kernel).  Same
// contract: q (S, H, hd); k_pages, v_pages (P, page, KV, hd) shared pools;
// page_table (S, max_pages) int32 physical page ids in logical order;
// lengths (S,) int32 valid tokens per slot -> out (S, H, hd) in q's dtype.
// Token w of a slot is live iff w < lengths[s] (and w >= lengths[s] -
// window when a window is set); scores are scaled by hd**-0.5 and
// optionally soft-capped (cap * tanh(s / cap)) before the mask.  q and the
// pools share one dtype (float32 or bf16); bf16 rows are loaded as bf16
// and widened in registers, and every sum runs in float32, as the
// reference's body upcasts.
//
// Design.  The TPU grid (S, KV, max_pages) ran its page axis in order on
// one core, carrying m, l and acc in VMEM between grid steps.  Here the
// logical buffer of each slot (max_pages * page tokens) is cut into
// `splits` page-aligned ranges of `split_tokens` tokens, and one block of
// the (splits, KV, S) grid owns one (range, kv head, slot).  The split
// count is chosen on the host from shapes alone (no read of `lengths`, so
// the serve step gains no sync; kernels/decode_attention.py ::
// split_plan).  The G = H / KV query heads of a kv head share every K/V
// row, so one block takes all of them (MQA's point: granite-20b's 48
// heads read each row once): 128 threads up to G * hd = 4,096
// accumulator elements, 256 above, each thread keeping at most 32 in
// registers.  Only where G * hd passes 8,192 (or the shared tiles pass
// the card's 227 KB) are the heads cut into `gtiles` tiles of a grid
// axis (kernels/decode_attention.py :: group_tiles), each reading the
// rows again; no config of the registry comes near that.  bf16 pools with
// 16 to 128 heads a kv head at hd 64 or 128 run paged_decode_tc_kernel
// (below; kernels/decode_attention.py :: kernel_for): with that many
// heads this kernel's scores and P.V, re-reading K, V and P from shared
// memory for every head, set its time (on an H100, 0.17 ms at
// granite's decode shape, 14 x its float32 FMA bound).  A block whose
// range holds no live token of its slot (start = max(0, len - window),
// end = min(len, max_pages * page)) leaves at once, so the short
// histories of a serve step cost one working block per (kv head, slot).
// The others walk the live part of their range, [max(start, lo), min(end,
// hi)), 32 tokens a tile, through a ring of three shared-memory stages
// filled with 16-byte cp.async.cg copies (each row found through the page
// table, rows past the range zero-filled), so the next tiles' rows load
// while this tile's scores and P.V run.  Scores spread the threads over
// the (query row, token) pairs (several threads a pair for G <= 2); the
// online softmax runs one warp per query row with one token per lane;
// each thread keeps NA accumulator elements in registers.  The
// only live split of a slot writes acc / l in q's dtype itself.  Where a
// slot has more, each writes its partial (m, l, acc[G, hd]) in float32 to
// scratch the wrapper keeps and takes a ticket from its (head tile, kv
// head, slot)'s counter; the block that draws the last one merges the
// partials in split order (rescaling by exp(m_i - m)), so the result is
// the same run to run whichever block merges, writes acc / l in q's dtype
// and resets the counter to 0 for the next call on the stream: one launch
// per call.  A token masked in the
// reference contributes exactly 0 once a live token has set m (exp(-1e30
// - m) underflows to 0, and every visited tile starts at a live token), so
// visiting only live tokens is exact.  A length-0 slot has no live token
// and comes out 0 (finite; the engine never asks for one, since lengths
// are positions + 1).  expf/tanhf and NEG_INF = -1e30 as in the
// reference; no fast-math.
//
// Bound.  The kernel must read the live K/V rows once, in the pool's
// dtype: 2 * sum_s live_s * KV * hd * bytes.  At the serve shape (8
// slots x up to 256 tokens, KV 12, hd 64, float32) that is 6.3 MB, ~1.9
// us at 3.35 TB/s, below one launch: the kernel is latency-bound there,
// and the splits put 576 blocks in flight instead of 96.  At gemma2-27b's
// decode shape (8 slots x up to 8,192 tokens, KV 16, hd 128, bf16) it is
// 268 MB, 80 us: there a block's serial chain of tiles is the limit, so
// the splits (16 per slot of at most 512 tokens, 2,048 blocks) cut the
// longest chain to 16 tiles while every SM streams, bf16 rows halve the
// bytes, and the three-stage ring keeps two tiles of loads in flight per
// block.  The arithmetic (4 * live * H * hd flops) is far below the
// float32 rate there.  At granite-20b's (H 48, KV 1, hd 128, bf16 pools,
// 8 slots up to 8,192 tokens) the rows are 17 MB, 5 us, and the
// arithmetic 0.8 GFLOP: 12 us in float32 FMAs, 1.2 us on the tensor
// cores (q.k once, P.V twice, in bf16), so the tensor-core kernel is
// bound by the bytes; its block holds all 48 heads in three warps' m16
// tiles against each staged tile.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;                  // tokens per step: one per lane
constexpr int kStages = 3;                 // cp.async ring depth
constexpr int kMaxNA = 32;                 // accumulators per thread
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "the softmax update maps one token per lane");

// 16 bytes of T widened to float32
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
  static constexpr int N = 4;
  static __device__ __forceinline__ void load(const float* p, float* f) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    f[0] = v.x;
    f[1] = v.y;
    f[2] = v.z;
    f[3] = v.w;
  }
};

template <>
struct Vec16<__nv_bfloat16> {
  static constexpr int N = 8;
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float* f) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 t = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      f[2 * i] = t.x;
      f[2 * i + 1] = t.y;
    }
  }
};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

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

// shared row stride of a staged K/V row, in elements: 16 bytes of padding
// keep the 16-byte reads of 8 neighbouring rows on 8 distinct bank groups
template <typename T>
__host__ __device__ constexpr int row_ld(int hd) {
  return hd + 16 / (int)sizeof(T);
}

template <typename T>
__host__ __device__ size_t split_smem_bytes(int G, int hd, int split_tokens) {
  const size_t stage = 2 * (size_t)kTile * row_ld<T>(hd) * sizeof(T);
  return kStages * stage +
         sizeof(float) * ((size_t)G * (hd + 4) + (size_t)G * kTile + 3 * G) +
         sizeof(int) * (size_t)split_tokens;
}

// Stages the K and V rows of a split's tile t into ring slot `slot` by
// 16-byte cp.async copies: token i of the range [lo, hi) sits at pool row
// tok_s[i] (read through the page table once, so that no copy waits on a
// dependent table load), rows past hi are zeros.  Each thread's (token,
// chunk) pairs step by the block's thread count, with no division.
template <typename T>
struct KVStager {
  T* kv_s;
  const int* tok_s;
  const T* kbase;
  const T* vbase;
  size_t tok_stride;
  int ld, nchunk, lo, hi, c0, tok0, dc, dtok;

  __device__ KVStager(T* kv_s_, const int* tok_s_, const T* kbase_,
                      const T* vbase_, size_t tok_stride_, int ld_,
                      int nchunk_, int lo_, int hi_, int threads)
      : kv_s(kv_s_), tok_s(tok_s_), kbase(kbase_), vbase(vbase_),
        tok_stride(tok_stride_), ld(ld_), nchunk(nchunk_), lo(lo_), hi(hi_),
        c0(threadIdx.x % nchunk_), tok0(threadIdx.x / nchunk_),
        dc(threads % nchunk_), dtok(threads / nchunk_) {}

  __device__ void operator()(int t, int slot) const {
    constexpr int VN = Vec16<T>::N;
    T* ks = kv_s + (size_t)slot * 2 * kTile * ld;
    T* vs = ks + kTile * ld;
    const int i0 = t * kTile;
    int c = c0;
    for (int tok = tok0; tok < kTile;) {
      const bool in = lo + i0 + tok < hi;
      const size_t off =
          in ? (size_t)tok_s[i0 + tok] * tok_stride + (size_t)c * VN : 0;
      cp_async16(ks + tok * ld + c * VN, kbase + off, in ? 16 : 0);
      cp_async16(vs + tok * ld + c * VN, vbase + off, in ? 16 : 0);
      c += dc;
      tok += dtok;
      if (c >= nchunk) {
        c -= nchunk;
        ++tok;
      }
    }
  }
};

// The last live split of this (head tile, kv head, slot) to finish
// merges: out = sum_i acc_i e^(m_i - m) / sum_i l_i e^(m_i - m), the live
// splits read in order through L2 (__ldcg: another block's partial may
// share an L1 line this SM read earlier), and resets the ticket counter
// for the next call on the stream.  prow0: the partials' row of the
// first live split's first head; a split's rows follow H rows on.
template <typename T>
__device__ void merge_splits(T* out, const float* part_acc,
                             const float* part_ml, int* tickets,
                             size_t head0, size_t prow0, int H, int hd,
                             int G, int n_live) {
  __shared__ int merges;
  __threadfence();                 // this block's partials, device-wide
  __syncthreads();
  int* ticket = tickets + (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) merges = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();                 // every other block's partials seen
  const size_t pstep = H;                    // rows from a split to the next
  for (int e = threadIdx.x; e < G * hd; e += blockDim.x) {
    const int g = e / hd;
    float m = kNegInf;
    for (int i = 0; i < n_live; ++i) {
      m = fmaxf(m, __ldcg(part_ml + (prow0 + i * pstep + g) * 2));
    }
    float l = 0.f, a = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float* ml = part_ml + (prow0 + i * pstep + g) * 2;
      const float c = expf(__ldcg(ml) - m);
      l = fmaf(__ldcg(ml + 1), c, l);
      a = fmaf(__ldcg(part_acc + (prow0 + i * pstep) * hd + e), c, a);
    }
    store(out + head0 + e, a / l);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// kThreads threads; NA: accumulator elements per thread, >= Gt * hd /
// kThreads for the gtile heads a block owns (Gt = ceil(G / gtiles))
template <typename T, int kThreads, int NA>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* part_acc, float* part_ml, int* tickets,
                    int H, int KV, int gtiles, int hd, int page,
                    int max_pages, int split_tokens, int window,
                    float softcap, float scale) {
  constexpr int VN = Vec16<T>::N;            // elements per 16 bytes
  constexpr int kWarps = kThreads / 32;
  const int split = blockIdx.x;
  const int kv = blockIdx.y / gtiles;        // kv head, then head tile
  const int gt = blockIdx.y - kv * gtiles;
  const int s = blockIdx.z;
  const int splits = gridDim.x;
  const int Gt = (H / KV + gtiles - 1) / gtiles;
  const int h0 = kv * (H / KV) + gt * Gt;    // the block's first head
  const int G = min(Gt, (kv + 1) * (H / KV) - h0);  // and its head count
  const int GH = G * hd;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ld = row_ld<T>(hd);
  const int ldq = hd + 4;
  const int nchunk = hd / VN;                // 16-byte chunks per row

  extern __shared__ float4 smem4[];
  T* kv_s = reinterpret_cast<T*>(smem4);     // kStages x {K, V} x kTile x ld
  float* q_s = reinterpret_cast<float*>(kv_s + 2 * kStages * kTile * ld);
  float* p_s = q_s + G * ldq;                // G x kTile scores / probs
  float* m_s = p_s + G * kTile;
  float* l_s = m_s + G;
  float* c_s = l_s + G;
  int* tok_s = reinterpret_cast<int*>(c_s + G);  // pool row of each token

  const size_t head0 = ((size_t)s * H + h0) * hd;
  const int len = lengths[s];
  const int end_live = min(len, max_pages * page);
  const int start_live = window > 0 ? max(len - window, 0) : 0;
  // the splits whose range holds a live token: [first, first + n_live)
  const int first = start_live / split_tokens;
  const int n_live =
      end_live > start_live ? (end_live - 1) / split_tokens - first + 1 : 0;
  if (split < first || split >= first + n_live) {
    // nothing live here: the block leaves at once; a slot with no live
    // token at all comes out 0, written by its split 0
    if (n_live == 0 && split == 0) {
      for (int e = tid; e < GH; e += kThreads) store(out + head0 + e, 0.f);
    }
    return;
  }
  const int lo = max(start_live, split * split_tokens);
  const int hi = min(end_live, (split + 1) * split_tokens);
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  for (int e = tid; e < GH; e += kThreads) {
    q_s[(e / hd) * ldq + e % hd] = to_float(q[head0 + e]);
  }
  for (int g = tid; g < G; g += kThreads) {
    m_s[g] = kNegInf;
    l_s[g] = 0.f;
  }
  float acc[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) acc[i] = 0.f;
  const int* row = page_table + (size_t)s * max_pages;
  const size_t tok_stride = (size_t)KV * hd;
  // the pool row of every live token of the range, read through the page
  // table once, so that no copy waits on a dependent table load
  for (int i = tid; i < hi - lo; i += kThreads) {
    const int w = lo + i;
    tok_s[i] = row[w / page] * page + w % page;
  }
  __syncthreads();                 // tok_s, q_s, m_s, l_s written

  const KVStager<T> stage_tile(kv_s, tok_s, k_pages + (size_t)kv * hd,
                                v_pages + (size_t)kv * hd, tok_stride, ld,
                                nchunk, lo, hi, kThreads);

  // this thread's accumulator elements e = tid + i * 128: (g_i, d_i); when
  // hd divides 128 every d_i is the same and each V element is read once
  int gi[NA], di[NA];
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int e = tid + i * kThreads;
    gi[i] = e < GH ? e / hd : -1;
    di[i] = e % hd;
  }
  const bool one_d = kThreads % hd == 0;

  // threads per score: the largest power of two that still fits every
  // (query row, token) pair of a tile into one pass of the block (4 at
  // G = 1); with more than one, each pair's threads split the chunks
  const int n_pairs = G * kTile;
  int tpp = 1;
  while (tpp < 32 && 2 * tpp * n_pairs <= kThreads) tpp *= 2;
  const int sub = tid % tpp;

#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) stage_tile(st, st);
    cp_async_commit();
  }

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();            // this thread's tile-t copies
    __syncthreads();     // everyone's copies landed; tile t - 1 consumed
    if (t + kStages - 1 < n_tiles) {
      stage_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    }
    cp_async_commit();
    const T* ks = kv_s + (size_t)(t % kStages) * 2 * kTile * ld;
    const T* vs = ks + kTile * ld;
    const int base = lo + t * kTile;

    // scores; when tpp > 1 every thread runs exactly one pair, so the
    // shuffles below always see the full warp
    for (int pr = tid / tpp; pr < n_pairs; pr += kThreads / tpp) {
      const int g = pr / kTile;
      const int tok = pr - g * kTile;
      const float* qr = q_s + g * ldq;
      const T* kr = ks + tok * ld;
      float dot = 0.f;
      for (int c = sub; c < nchunk; c += tpp) {
        float kf[VN];
        Vec16<T>::load(kr + c * VN, kf);
#pragma unroll
        for (int j = 0; j < VN; j += 4) {
          const float4 q4 =
              *reinterpret_cast<const float4*>(qr + c * VN + j);
          dot = fmaf(q4.x, kf[j], dot);
          dot = fmaf(q4.y, kf[j + 1], dot);
          dot = fmaf(q4.z, kf[j + 2], dot);
          dot = fmaf(q4.w, kf[j + 3], dot);
        }
      }
      for (int o = tpp >> 1; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (sub == 0) {
        float sc = dot * scale;
        if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
        p_s[pr] = (base + tok < hi) ? sc : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: one warp per query row, one token per lane
    for (int g = warp; g < G; g += kWarps) {
      const float sc = p_s[g * kTile + lane];
      const float m_prev = m_s[g];
      float mt = sc;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, o));
      }
      const float m_new = fmaxf(m_prev, mt);
      const float pt = expf(sc - m_new);
      float sum = pt;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      }
      p_s[g * kTile + lane] = pt;
      if (lane == 0) {
        const float corr = expf(m_prev - m_new);
        l_s[g] = l_s[g] * corr + sum;
        m_s[g] = m_new;
        c_s[g] = corr;
      }
    }
    __syncthreads();

    // acc[g, d] = acc[g, d] * corr[g] + sum_t p[g, t] * v[t, d], four
    // tokens' probabilities per 16-byte read
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      if (gi[i] >= 0) acc[i] *= c_s[gi[i]];
    }
#pragma unroll 2
    for (int tok = 0; tok < kTile; tok += 4) {
      float v0[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) v0[u] = to_float(vs[(tok + u) * ld + di[0]]);
#pragma unroll
      for (int i = 0; i < NA; ++i) {
        if (gi[i] >= 0) {
          float vv[4];
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            vv[u] = one_d ? v0[u] : to_float(vs[(tok + u) * ld + di[i]]);
          }
          const float4 p4 =
              *reinterpret_cast<const float4*>(p_s + gi[i] * kTile + tok);
          float a = acc[i];
          a = fmaf(p4.x, vv[0], a);
          a = fmaf(p4.y, vv[1], a);
          a = fmaf(p4.z, vv[2], a);
          a = fmaf(p4.w, vv[3], a);
          acc[i] = a;
        }
      }
    }
  }
  cp_async_wait<0>();                        // no copy outlives the block

  if (n_live == 1) {       // the slot's only live split: no merge needed
#pragma unroll
    for (int i = 0; i < NA; ++i) {
      const int e = tid + i * kThreads;
      if (e < GH) store(out + head0 + e, acc[i] / l_s[gi[i]]);
    }
    return;
  }

  // partials: acc unnormalised, (m, l) per query row, at (slot, split,
  // head); every live split has l >= 1 (its largest score contributes
  // exp(0))
  const size_t prow = ((size_t)s * splits + split) * H + h0;
  float* pa = part_acc + prow * hd;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int e = tid + i * kThreads;
    if (e < GH) pa[e] = acc[i];
  }
  for (int g = tid; g < G; g += kThreads) {
    part_ml[(prow + g) * 2] = m_s[g];
    part_ml[(prow + g) * 2 + 1] = l_s[g];
  }

  merge_splits(out, part_acc, part_ml, tickets, head0,
               ((size_t)s * splits + first) * H + h0, H, hd, G, n_live);
}

template <typename T, int kThreads, int NA>
int launch_kernel(const void* q, const void* k_pages, const void* v_pages,
                  const void* page_table, const void* lengths, void* out,
                  float* part_acc, float* part_ml, int* tickets, int S, int H,
                  int KV, int gtiles, int hd, int page, int max_pages,
                  int splits, int split_tokens, int window, float softcap,
                  float scale, cudaStream_t stream) {
  const int Gt = (H / KV + gtiles - 1) / gtiles;
  const size_t smem = split_smem_bytes<T>(Gt, hd, split_tokens);
  auto kern = paged_decode_kernel<T, kThreads, NA>;
  // the opt-in above 48 KB, asked again only when a launch needs more
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid(splits, KV * gtiles, S);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages,
      (const int*)page_table, (const int*)lengths, (T*)out, part_acc,
      part_ml, tickets, H, KV, gtiles, hd, page, max_pages, split_tokens,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 pools, 16 <= G <= 128, hd 64 or 128: the tensor cores
// ---------------------------------------------------------------------------

// D (16 x 8, f32) += A (16 x 16, bf16, row) * B (16 x 8, bf16, col)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// two floats as bf16x2 (round to nearest even), the first in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// two bf16 values as one bf16x2 register, the first in the low half
__device__ __forceinline__ uint32_t pair_bf16(__nv_bfloat16 lo,
                                              __nv_bfloat16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) |
         ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

// merge_splits for a block of many heads (the tensor-core kernel): the
// per-head weights e^(m_i - m) and the l_i go to shared memory once (w_s:
// G x n_live each, then each head's l), and each thread sums 4 columns of a
// head over the splits in order, 16-byte loads; the same sums as
// merge_splits, in the same order.
template <int HD>
__device__ void merge_splits_wide(__nv_bfloat16* out, const float* part_acc,
                                  const float* part_ml, int* tickets,
                                  size_t head0, size_t prow0, int H, int G,
                                  int n_live, float* w_s) {
  __shared__ int merges;
  __threadfence();                 // this block's partials, device-wide
  __syncthreads();
  int* ticket = tickets + (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  if (threadIdx.x == 0) merges = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();                 // every other block's partials seen
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = blockDim.x >> 5;
  const size_t pstep = H;                    // rows from a split to the next
  float* l_s = w_s + (size_t)G * n_live;
  float* sum_s = l_s + (size_t)G * n_live;
  for (int g = warp; g < G; g += warps) {
    const float* ml = part_ml + (prow0 + g) * 2;
    float m = kNegInf;
    for (int i = lane; i < n_live; i += 32) {
      m = fmaxf(m, __ldcg(ml + i * pstep * 2));
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, o));
    }
    for (int i = lane; i < n_live; i += 32) {
      w_s[g * n_live + i] = expf(__ldcg(ml + i * pstep * 2) - m);
      l_s[g * n_live + i] = __ldcg(ml + i * pstep * 2 + 1);
    }
    __syncwarp();
    if (lane == 0) {
      float l = 0.f;
      for (int i = 0; i < n_live; ++i) {
        l = fmaf(l_s[g * n_live + i], w_s[g * n_live + i], l);
      }
      sum_s[g] = l;
    }
  }
  __syncthreads();
  for (int e4 = threadIdx.x; e4 < G * HD / 4; e4 += blockDim.x) {
    const int g = 4 * e4 / HD;
    const float* src = part_acc + prow0 * HD + 4 * e4;
    const float* w = w_s + g * n_live;
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int i = 0; i < n_live; ++i) {
      const float4 v = __ldcg(reinterpret_cast<const float4*>(
          src + i * pstep * HD));
      a.x = fmaf(v.x, w[i], a.x);
      a.y = fmaf(v.y, w[i], a.y);
      a.z = fmaf(v.z, w[i], a.z);
      a.w = fmaf(v.w, w[i], a.w);
    }
    const float l = sum_s[g];
    __nv_bfloat162* dst =
        reinterpret_cast<__nv_bfloat162*>(out + head0 + 4 * e4);
    dst[0] = __floats2bfloat162_rn(a.x / l, a.y / l);
    dst[1] = __floats2bfloat162_rn(a.z / l, a.w / l);
  }
  if (threadIdx.x == 0) *ticket = 0;
}

// One block of 256 threads per (split, kv head, slot) as in
// paged_decode_kernel; its first ceil(G / 16) warps take 16 query heads
// of the kv head each (the m16 rows; rows past G are zeros and never
// written), and all of them stage K/V and merge.  The tile's scores S =
// Q K^T (16 heads x 32 tokens a warp) and O += P V run on the tensor
// cores (mma.sync m16n8k16, bf16 in, float32 sums): q and the pools are
// bf16, so the products are exact, and P enters as two bf16 terms, hi =
// rn(p) and lo = rn(p - hi), as in the flash kernel.  The softmax runs in
// registers on the accumulator fragment (rows reduced across the quad),
// whose layout is P V's A fragment: thread (g, t) holds heads g, g + 8
// and tokens 2 t, 2 t + 1 of each 8-token tile.  K/V staging and the
// page-table gather are paged_decode_kernel's; the merge sums the same
// terms in the same order, with each head's weights computed once.
template <int HD>
__global__ void __launch_bounds__(256)
paged_decode_tc_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k_pages,
                       const __nv_bfloat16* __restrict__ v_pages,
                       const int* __restrict__ page_table,
                       const int* __restrict__ lengths,
                       __nv_bfloat16* __restrict__ out, float* part_acc,
                       float* part_ml, int* tickets, int H, int KV, int page,
                       int max_pages, int split_tokens, int window,
                       float softcap, float scale) {
  using T = __nv_bfloat16;
  constexpr int VN = Vec16<T>::N;            // elements per 16 bytes
  constexpr int NKS = HD / 16;               // k16 steps of q.k
  constexpr int NT = HD / 8;                 // O's 8-column tiles
  constexpr int ld = row_ld<T>(HD);
  constexpr int nchunk = HD / VN;
  const int split = blockIdx.x, kv = blockIdx.y, s = blockIdx.z;
  const int splits = gridDim.x;
  const int G = H / KV;
  const int h0 = kv * G;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t4 = lane & 3;
  const int threads = blockDim.x;
  const bool active = 16 * warp < G;         // a warp with query heads
  const size_t head0 = ((size_t)s * H + h0) * HD;

  const int len = lengths[s];
  const int end_live = min(len, max_pages * page);
  const int start_live = window > 0 ? max(len - window, 0) : 0;
  const int first = start_live / split_tokens;
  const int n_live =
      end_live > start_live ? (end_live - 1) / split_tokens - first + 1 : 0;
  if (split < first || split >= first + n_live) {
    if (n_live == 0 && split == 0) {
      for (int e = tid; e < G * HD; e += threads) {
        store(out + head0 + e, 0.f);
      }
    }
    return;
  }
  const int lo = max(start_live, split * split_tokens);
  const int hi = min(end_live, (split + 1) * split_tokens);
  const int n_tiles = (hi - lo + kTile - 1) / kTile;

  extern __shared__ float4 smem4[];
  T* kv_s = reinterpret_cast<T*>(smem4);     // kStages x {K, V} x kTile x ld
  int* tok_s = reinterpret_cast<int*>(kv_s + 2 * kStages * kTile * ld);
  const int* row = page_table + (size_t)s * max_pages;
  const size_t tok_stride = (size_t)KV * HD;
  for (int i = tid; i < hi - lo; i += threads) {
    const int w = lo + i;
    tok_s[i] = row[w / page] * page + w % page;
  }

  // this warp's Q rows r0 and r0 + 8 as the A fragments of the k16 steps
  const int r0 = 16 * warp + g, r1 = r0 + 8;
  const uint32_t* q32 = reinterpret_cast<const uint32_t*>(q + head0);
  uint32_t qa[NKS][4];
#pragma unroll
  for (int ks = 0; ks < NKS; ++ks) {
    const int c = 8 * ks + t4;               // 32-bit words into a row
    qa[ks][0] = r0 < G ? q32[r0 * (HD / 2) + c] : 0u;
    qa[ks][1] = r1 < G ? q32[r1 * (HD / 2) + c] : 0u;
    qa[ks][2] = r0 < G ? q32[r0 * (HD / 2) + c + 4] : 0u;
    qa[ks][3] = r1 < G ? q32[r1 * (HD / 2) + c + 4] : 0u;
  }
  __syncthreads();                 // tok_s written

  const KVStager<T> stage_tile(kv_s, tok_s, k_pages + (size_t)kv * HD,
                                v_pages + (size_t)kv * HD, tok_stride, ld,
                                nchunk, lo, hi, threads);
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    if (st < n_tiles) stage_tile(st, st);
    cp_async_commit();
  }

  float o[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;

  for (int t = 0; t < n_tiles; ++t) {
    cp_async_wait<kStages - 2>();            // this thread's tile-t copies
    __syncthreads();     // everyone's copies landed; tile t - 1 consumed
    if (t + kStages - 1 < n_tiles) {
      stage_tile(t + kStages - 1, (t + kStages - 1) % kStages);
    }
    cp_async_commit();
    if (!active) continue;
    const T* ks = kv_s + (size_t)(t % kStages) * 2 * kTile * ld;
    const T* vs = ks + kTile * ld;
    const int base = lo + t * kTile;

    // S (heads r0, r1 x the tile's 32 tokens) in four 8-token tiles
    float sc[kTile / 8][4];
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
      sc[j][0] = sc[j][1] = sc[j][2] = sc[j][3] = 0.f;
      const T* krow = ks + (8 * j + g) * ld + 2 * t4;
#pragma unroll
      for (int kk = 0; kk < NKS; ++kk) {
        mma_bf16(sc[j], qa[kk],
                 *reinterpret_cast<const uint32_t*>(krow + 16 * kk),
                 *reinterpret_cast<const uint32_t*>(krow + 16 * kk + 8));
      }
    }

    // scale, softcap, the range's end and the online softmax
    float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[j][e] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        x = (base + 8 * j + 2 * t4 + (e & 1) < hi) ? x : kNegInf;
        sc[j][e] = x;
        if (e < 2) {
          mx0 = fmaxf(mx0, x);
        } else {
          mx1 = fmaxf(mx1, x);
        }
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
    const float cr0 = expf(m0 - n0), cr1 = expf(m1 - n1);
    m0 = n0;
    m1 = n1;
    float sum0 = 0.f, sum1 = 0.f;
#pragma unroll
    for (int j = 0; j < kTile / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = expf(sc[j][e] - (e < 2 ? n0 : n1));
        sc[j][e] = p;
        if (e < 2) {
          sum0 += p;
        } else {
          sum1 += p;
        }
      }
    }
    l0 = l0 * cr0 + sum0;          // this thread's tokens; the quad's are
    l1 = l1 * cr1 + sum1;          // added at the end
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      o[n][0] *= cr0;
      o[n][1] *= cr0;
      o[n][2] *= cr1;
      o[n][3] *= cr1;
    }

    // O += P V, 16 tokens a step: A = P from the 8-token tiles 2 j and
    // 2 j + 1, B = V's rows 16 j + 2 t (+ 1, + 8, + 9) at column g
#pragma unroll
    for (int j = 0; j < kTile / 16; ++j) {
      uint32_t ph[4], pl[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float* p2 = sc[2 * j + (e >> 1)] + 2 * (e & 1);
        const __nv_bfloat162 h2 = __floats2bfloat162_rn(p2[0], p2[1]);
        const float2 hf = __bfloat1622float2(h2);
        ph[e] = *reinterpret_cast<const uint32_t*>(&h2);
        pl[e] = pack_bf16(p2[0] - hf.x, p2[1] - hf.y);
      }
      const T* v0 = vs + (16 * j + 2 * t4) * ld + g;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const T* vp = v0 + 8 * n;
        const uint32_t b0 = pair_bf16(vp[0], vp[ld]);
        const uint32_t b1 = pair_bf16(vp[8 * ld], vp[9 * ld]);
        mma_bf16(o[n], pl, b0, b1);
        mma_bf16(o[n], ph, b0, b1);
      }
    }
  }
  cp_async_wait<0>();                        // no copy outlives the block
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);

  if (n_live == 1) {       // the slot's only live split: no merge needed
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = half ? r1 : r0;
      if (r < G) {
        const float inv = 1.f / (half ? l1 : l0);
        T* orow = out + head0 + (size_t)r * HD + 2 * t4;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) =
              __floats2bfloat162_rn(o[n][2 * half] * inv,
                                    o[n][2 * half + 1] * inv);
        }
      }
    }
    return;
  }

  // partials at (slot, split, head): acc unnormalised, then (m, l)
  const size_t prow = ((size_t)s * splits + split) * H + h0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = half ? r1 : r0;
    if (r < G) {
      float* pa = part_acc + (prow + r) * HD + 2 * t4;
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        *reinterpret_cast<float2*>(pa + 8 * n) =
            make_float2(o[n][2 * half], o[n][2 * half + 1]);
      }
      if (t4 == 0) {
        part_ml[(prow + r) * 2] = half ? m1 : m0;
        part_ml[(prow + r) * 2 + 1] = half ? l1 : l0;
      }
    }
  }
  merge_splits_wide<HD>(out, part_acc, part_ml, tickets, head0,
                        ((size_t)s * splits + first) * H + h0, H, G, n_live,
                        reinterpret_cast<float*>(smem4));
}

template <int HD>
int launch_tc(const void* q, const void* k_pages, const void* v_pages,
              const void* page_table, const void* lengths, void* out,
              float* part_acc, float* part_ml, int* tickets, int S, int H,
              int KV, int page, int max_pages, int splits, int split_tokens,
              int window, float softcap, float scale, cudaStream_t stream) {
  using T = __nv_bfloat16;
  // the K/V ring and the page rows, or the merge's weights if more
  const size_t ring = 2 * (size_t)kStages * kTile * row_ld<T>(HD) *
                          sizeof(T) +
                      sizeof(int) * (size_t)split_tokens;
  const size_t weights = sizeof(float) * (size_t)(H / KV) * (2 * splits + 1);
  const size_t smem = ring > weights ? ring : weights;
  auto kern = paged_decode_tc_kernel<HD>;
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid(splits, KV, S);
  kern<<<grid, 256, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages,
      (const int*)page_table, (const int*)lengths, (T*)out, part_acc,
      part_ml, tickets, H, KV, page, max_pages, split_tokens, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

// 128 threads while a block's heads hold at most 128 * 32 accumulator
// elements (every G <= 16 at hd <= 256), 256 threads up to 256 * 32
template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* out,
           void* part, void* tickets, int S, int H, int KV, int gtiles,
           int hd, int page, int max_pages, int splits, int split_tokens,
           int window, float softcap, float scale, cudaStream_t stream) {
  const int elems = (H / KV + gtiles - 1) / gtiles * hd;
  float* pa = (float*)part;
  float* pm = pa + (size_t)splits * S * H * hd;
  int* tk = (int*)tickets;
#define REPRO_DECODE(THREADS, NA)                                            \
  launch_kernel<T, THREADS, NA>(q, k_pages, v_pages, page_table, lengths,    \
                                out, pa, pm, tk, S, H, KV, gtiles, hd, page, \
                                max_pages, splits, split_tokens, window,     \
                                softcap, scale, stream)
  if (elems <= 128) return REPRO_DECODE(128, 1);
  if (elems <= 2 * 128) return REPRO_DECODE(128, 2);
  if (elems <= 4 * 128) return REPRO_DECODE(128, 4);
  if (elems <= 8 * 128) return REPRO_DECODE(128, 8);
  if (elems <= 16 * 128) return REPRO_DECODE(128, 16);
  if (elems <= kMaxNA * 128) return REPRO_DECODE(128, 32);
  if (elems <= 24 * 256) return REPRO_DECODE(256, 24);
  if (elems <= kMaxNA * 256) return REPRO_DECODE(256, 32);
  return (int)cudaErrorInvalidValue;
#undef REPRO_DECODE
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  dtype 0 = float32, 1 = bf16 (q, the pools and out alike).
// tensor_cores: run paged_decode_tc_kernel (bf16, gtiles 1, 16 <= G <=
// 128, hd 64 or 128; anything else is refused) instead of
// paged_decode_kernel.  gtiles: the tiles the G = H / KV heads of a kv
// head are cut into (1 unless ceil(G / gtiles) * hd would pass 8,192 or
// the shared memory 227 KB).  part: splits * S * H * (hd + 2) float32,
// the partial accumulators and then the (m, l) pairs; tickets: S * KV *
// gtiles int32, all 0 before the call and left 0 after it (the merging
// block resets its own), so the caller keeps one zeroed buffer per
// stream.  The caller has checked shapes, dtypes, contiguity and 16-byte
// alignment, that hd % 16 == 0, hd <= 256, H % KV == 0, and that splits
// * split_tokens covers max_pages * page with split_tokens a multiple of
// page.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* lengths, void* out, void* part,
                           void* tickets, int dtype, int tensor_cores,
                           int S, int H, int KV, int gtiles, int hd, int page,
                           int max_pages, int splits, int split_tokens,
                           int window, float softcap, float scale,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (tensor_cores) {
    const int G = H / KV;
    if (dtype != 1 || gtiles != 1 || G < 16 || G > 128 ||
        (hd != 64 && hd != 128)) {
      return (int)cudaErrorInvalidValue;
    }
    float* pa = (float*)part;
    float* pm = pa + (size_t)splits * S * H * hd;
    return (hd == 64 ? launch_tc<64> : launch_tc<128>)(
        q, k_pages, v_pages, page_table, lengths, out, pa, pm, (int*)tickets,
        S, H, KV, page, max_pages, splits, split_tokens, window, softcap,
        scale, st);
  }
  if (dtype == 0) {
    return launch<float>(q, k_pages, v_pages, page_table, lengths, out, part,
                         tickets, S, H, KV, gtiles, hd, page, max_pages,
                         splits, split_tokens, window, softcap, scale, st);
  }
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, out,
                               part, tickets, S, H, KV, gtiles, hd, page,
                               max_pages, splits, split_tokens, window,
                               softcap, scale, st);
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
