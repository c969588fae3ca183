// Paged decode attention for Hopper (sm_90a): split-K over the slot's
// history (flash-decoding), cp.async staging, float32 or bf16 pools.
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
// split_plan).  A block whose range holds no live token of its slot
// (start = max(0, len - window), end = min(len, max_pages * page)) leaves
// at once, so the short histories of a serve step cost one working block
// per (kv head, slot).  The others walk the live part of their range,
// [max(start, lo), min(end, hi)), 32 tokens a tile, through a ring of
// three shared-memory stages filled with 16-byte cp.async.cg copies (each
// row found through the page table, rows past the range zero-filled), so
// the next tiles' rows load while this tile's scores and P.V run.  Scores
// spread the 128 threads over the (query row, token) pairs; the online
// softmax runs one warp per query row with one token per lane; each
// thread keeps NA accumulator elements in registers.  The only live
// split of a slot writes acc / l in q's dtype itself.  Where a slot has
// more, each writes its partial (m, l, acc[G, hd]) in float32 to scratch
// the wrapper keeps and takes a ticket from its (kv head, slot)'s
// counter; the block that draws the last one merges the partials in
// split order (rescaling by exp(m_i - m)), so the result is the same run
// to run whichever block merges, writes acc / l in q's dtype and resets
// the counter to 0 for the next call on the stream: one launch per
// call.  A token masked in the reference
// contributes exactly 0 once a live token has set m (exp(-1e30 - m)
// underflows to 0, and every visited tile starts at a live token), so
// visiting only live tokens is exact.  A length-0 slot has no live token
// and comes out 0 (finite; the engine never asks for one, since lengths
// are positions + 1).  expf/tanhf and NEG_INF = -1e30 as in
// the reference; no fast-math.
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
// float32 rate.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // tokens per step: one per lane
constexpr int kStages = 3;                 // cp.async ring depth
constexpr int kMaxG = 16;
constexpr int kMaxHd = 256;
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

// NA: accumulator elements per thread, >= G * hd / 128
template <typename T, int NA>
__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const T* __restrict__ q, const T* __restrict__ k_pages,
                    const T* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths, T* __restrict__ out,
                    float* part_acc, float* part_ml, int* tickets,
                    int H, int KV, int hd, int page, int max_pages,
                    int split_tokens, int window, float softcap,
                    float scale) {
  constexpr int VN = Vec16<T>::N;            // elements per 16 bytes
  const int split = blockIdx.x;
  const int kv = blockIdx.y;
  const int s = blockIdx.z;
  const int splits = gridDim.x;
  const int G = H / KV;
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

  const size_t head0 = ((size_t)s * H + (size_t)kv * G) * hd;
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
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
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

  // stage the K and V rows of tile `t` into ring slot `slot`: this
  // thread's (token, chunk) pairs step by kThreads chunks, no division
  const int c0 = tid % nchunk, tok0 = tid / nchunk;
  const int dc = kThreads % nchunk, dtok = kThreads / nchunk;
  const T* kbase = k_pages + (size_t)kv * hd;
  const T* vbase = v_pages + (size_t)kv * hd;
  auto stage_tile = [&](int t, int slot) {
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
  };

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
          const float4 q4 = *reinterpret_cast<const float4*>(qr + c * VN + j);
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

  // partials: acc unnormalised, (m, l) per query row; every live split
  // has l >= 1 (its largest score contributes exp(0))
  const size_t pslot = ((size_t)s * KV + kv) * splits + split;
  float* pa = part_acc + pslot * GH;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    const int e = tid + i * kThreads;
    if (e < GH) pa[e] = acc[i];
  }
  if (tid < G) {
    part_ml[(pslot * G + tid) * 2] = m_s[tid];
    part_ml[(pslot * G + tid) * 2 + 1] = l_s[tid];
  }

  // the last live split of this (kv head, slot) to finish merges: out =
  // sum_i acc_i e^(m_i - m) / sum_i l_i e^(m_i - m), the live splits read
  // in order through L2 (__ldcg: another block's partial may share an L1
  // line this SM read earlier)
  __shared__ int merges;
  __threadfence();                 // this block's partials, device-wide
  __syncthreads();
  int* ticket = tickets + (size_t)s * KV + kv;
  if (tid == 0) merges = atomicAdd(ticket, 1) == n_live - 1;
  __syncthreads();
  if (!merges) return;
  __threadfence();                 // every other block's partials seen
  const size_t pslot0 = ((size_t)s * KV + kv) * splits + first;
  for (int e = tid; e < GH; e += kThreads) {
    const int g = e / hd;
    float m = kNegInf;
    for (int i = 0; i < n_live; ++i) {
      m = fmaxf(m, __ldcg(part_ml + ((pslot0 + i) * G + g) * 2));
    }
    float l = 0.f, a = 0.f;
    for (int i = 0; i < n_live; ++i) {
      const float* ml = part_ml + ((pslot0 + i) * G + g) * 2;
      const float c = expf(__ldcg(ml) - m);
      l = fmaf(__ldcg(ml + 1), c, l);
      a = fmaf(__ldcg(part_acc + (pslot0 + i) * GH + e), c, a);
    }
    store(out + head0 + e, a / l);
  }
  if (tid == 0) *ticket = 0;       // ready for the next call on the stream
}

template <typename T, int NA>
int launch_kernel(const void* q, const void* k_pages, const void* v_pages,
                  const void* page_table, const void* lengths, void* out,
                  float* part_acc, float* part_ml, int* tickets, int S, int H,
                  int KV, int hd, int page, int max_pages, int splits,
                  int split_tokens, int window, float softcap, float scale,
                  cudaStream_t stream) {
  const size_t smem = split_smem_bytes<T>(H / KV, hd, split_tokens);
  auto kern = paged_decode_kernel<T, NA>;
  // the opt-in above 48 KB, asked again only when a launch needs more
  static size_t opted = 48 * 1024;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
    opted = smem;
  }
  const dim3 grid(splits, KV, S);
  kern<<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k_pages, (const T*)v_pages,
      (const int*)page_table, (const int*)lengths, (T*)out, part_acc,
      part_ml, tickets, H, KV, hd, page, max_pages, split_tokens, window,
      softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch(const void* q, const void* k_pages, const void* v_pages,
           const void* page_table, const void* lengths, void* out,
           void* part, void* tickets, int S, int H, int KV, int hd, int page,
           int max_pages, int splits, int split_tokens, int window,
           float softcap, float scale, cudaStream_t stream) {
  const int per_thread = (H / KV * hd + kThreads - 1) / kThreads;
  float* pa = (float*)part;
  float* pm = pa + (size_t)splits * S * H * hd;
  int* tk = (int*)tickets;
#define REPRO_DECODE(NA)                                                     \
  launch_kernel<T, NA>(q, k_pages, v_pages, page_table, lengths, out, pa, pm, \
                       tk, S, H, KV, hd, page, max_pages, splits,            \
                       split_tokens, window, softcap, scale, stream)
  if (per_thread <= 1) return REPRO_DECODE(1);
  if (per_thread <= 2) return REPRO_DECODE(2);
  if (per_thread <= 4) return REPRO_DECODE(4);
  if (per_thread <= 8) return REPRO_DECODE(8);
  if (per_thread <= 16) return REPRO_DECODE(16);
  return REPRO_DECODE(32);
#undef REPRO_DECODE
}

static_assert(kMaxG * kMaxHd / kThreads == 32, "NA tops out at 32");

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() (0 on
// success).  dtype 0 = float32, 1 = bf16 (q, the pools and out alike).
// part: splits * S * H * (hd + 2) float32, the partial accumulators and
// then the (m, l) pairs; tickets: S * KV int32, all 0 before the call
// and left 0 after it (the merging block resets its own), so the caller
// keeps one zeroed buffer per stream.  The caller has checked shapes,
// dtypes, contiguity and 16-byte alignment, that hd % 16 == 0, hd <= 256,
// H % KV == 0, H / KV <= 16, and that splits * split_tokens covers
// max_pages * page with split_tokens a multiple of page.
int paged_decode_attention(const void* q, const void* k_pages,
                           const void* v_pages, const void* page_table,
                           const void* lengths, void* out, void* part,
                           void* tickets, int dtype, int S, int H, int KV,
                           int hd, int page, int max_pages, int splits,
                           int split_tokens, int window, float softcap,
                           float scale, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == 0) {
    return launch<float>(q, k_pages, v_pages, page_table, lengths, out, part,
                         tickets, S, H, KV, hd, page, max_pages, splits,
                         split_tokens, window, softcap, scale, st);
  }
  return launch<__nv_bfloat16>(q, k_pages, v_pages, page_table, lengths, out,
                               part, tickets, S, H, KV, hd, page, max_pages,
                               splits, split_tokens, window, softcap, scale,
                               st);
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
