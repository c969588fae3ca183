// Paged decode attention for Hopper (sm_90a), float32.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py ::
// paged_decode_attention_fwd (the Pallas body _decode_kernel).  Same
// contract: q (S, H, hd); k_pages, v_pages (P, page, KV, hd) shared pools;
// page_table (S, max_pages) int32 physical page ids in logical order;
// lengths (S,) int32 valid tokens per slot -> out (S, H, hd).  Token w of a
// slot is live iff w < lengths[s] (and w >= lengths[s] - window when a
// window is set); scores are scaled by hd**-0.5 and optionally soft-capped
// (cap * tanh(s / cap)) before the mask.
//
// Design.  The TPU grid (S, KV, max_pages) ran its page axis in order on
// one core, carrying m, l and acc in VMEM between grid steps.  Here one
// thread block owns one (slot, kv_head) and walks that slot's live tokens
// itself, 32 at a time: it reads its own table row and length, stages the
// tile's K and V rows in shared memory (each row found through the page
// table; every thread issues all its 16-byte loads of a batch before it
// stores any, so a tile costs about one memory latency), and keeps the
// G = H / KV query rows and the running max m, sum l and accumulator acc
// in float32 (acc private to each thread).  Scores spread the 128 threads over the
// (query row, token) pairs; the online-softmax update runs one warp per
// query row with one token per lane.  It visits only the tokens in
// [max(0, len - window), min(len, max_pages * page)): a token masked in
// the reference contributes exactly 0 there once a live token has set m
// (exp(-1e30 - m) underflows to 0, and every tile starts at a live token),
// so skipping the others is exact.  A length-0 slot visits nothing and
// writes 0 (finite; the engine never issues one, since lengths are
// positions + 1).  expf/tanhf and NEG_INF = -1e30 as in the reference; no
// fast-math.
//
// Bound.  The kernel must read the live K/V rows once:
// 2 * sum_s len_s * KV * hd * 4 bytes, which is 12.6 MB per layer at
// 8 slots x 256 tokens (KV = 12, hd = 64), about 3.8 us at 3.35 TB/s; the
// arithmetic (4 * sum_s len_s * H * hd flops) is far below the float32
// rate.  This version is latency-bound instead: one block per
// (slot, kv_head) is 96 blocks at the serve shape, under one wave of 132
// SMs, and each block waits for every tile's loads before its math.
// Split-K over pages (more blocks per slot, then a merge), cp.async/TMA
// staging that overlaps the next tile's loads with this tile's math, and
// bf16 pools are later work.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kTile = 32;                  // tokens per step: one per lane
constexpr int kMaxG = 16;
constexpr int kMaxHd = 256;
constexpr int kAccPerThread = kMaxG * kMaxHd / kThreads;
constexpr int kLoadBatch = 4;              // float4 loads per matrix in flight
constexpr float kNegInf = -1e30f;
static_assert(kTile == 32, "the softmax update maps one token per lane");

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pages,
                    const float* __restrict__ v_pages,
                    const int* __restrict__ page_table,
                    const int* __restrict__ lengths,
                    float* __restrict__ out,
                    int H, int KV, int hd, int page, int max_pages,
                    int window, float softcap, float scale) {
  const int kv = blockIdx.x;
  const int s = blockIdx.y;
  const int G = H / KV;
  const int GH = G * hd;
  const int hd4 = hd / 4;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int ldk = hd + 1;       // padded rows: column reads spread banks

  extern __shared__ float4 smem4[];
  float* v_s = reinterpret_cast<float*>(smem4);  // kTile x hd, 16 B rows
  float* k_s = v_s + kTile * hd;                 // kTile x ldk
  float* q_s = k_s + kTile * ldk;                // G x ldk
  float* p_s = q_s + G * ldk;                    // G x kTile scores/probs
  float* m_s = p_s + G * kTile;                  // G running max
  float* l_s = m_s + G;                          // G running sum
  float* c_s = l_s + G;                          // G rescale of this tile

  const size_t head0 = ((size_t)s * H + (size_t)kv * G) * hd;
  for (int e = tid; e < GH; e += kThreads) {
    q_s[(e / hd) * ldk + e % hd] = q[head0 + e];
  }
  if (tid < G) {
    m_s[tid] = kNegInf;
    l_s[tid] = 0.f;
  }
  float acc[kAccPerThread];       // this thread's (g, d): e = tid + i * 128
  for (int i = 0; i < kAccPerThread; ++i) acc[i] = 0.f;

  // threads per score: the largest power of two that still fits every
  // (query row, token) pair of a tile into one pass of the block (4 at
  // G = 1); with more than one, each pair's threads split the head dim
  const int n_pairs = G * kTile;
  int tpp = 1;
  while (tpp < 32 && 2 * tpp * n_pairs <= kThreads) tpp *= 2;
  const int sub = tid % tpp;

  const int len = lengths[s];
  const int end = min(len, max_pages * page);
  const int start = window > 0 ? max(len - window, 0) : 0;
  const int* row = page_table + (size_t)s * max_pages;
  const size_t tok_stride = (size_t)KV * hd;
  const int nvec = kTile * hd4;
  __syncthreads();

  for (int t0 = start; t0 < end; t0 += kTile) {
    // stage K/V rows of tokens t0 .. t0 + kTile - 1; rows past `end` are
    // zero-filled (never read from the pool) and masked below
    for (int base = tid; base < nvec; base += kThreads * kLoadBatch) {
      float4 kr[kLoadBatch], vr[kLoadBatch];
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int e = base + j * kThreads;
        const int t = e / hd4;
        const int w = t0 + t;
        kr[j] = vr[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (e < nvec && w < end) {
          const size_t off =
              ((size_t)row[w / page] * page + w % page) * tok_stride +
              (size_t)kv * hd + (size_t)(e - t * hd4) * 4;
          kr[j] = *reinterpret_cast<const float4*>(k_pages + off);
          vr[j] = *reinterpret_cast<const float4*>(v_pages + off);
        }
      }
#pragma unroll
      for (int j = 0; j < kLoadBatch; ++j) {
        const int e = base + j * kThreads;
        if (e < nvec) {
          const int t = e / hd4;
          const int c = (e - t * hd4) * 4;
          float* kd = k_s + t * ldk + c;
          kd[0] = kr[j].x;
          kd[1] = kr[j].y;
          kd[2] = kr[j].z;
          kd[3] = kr[j].w;
          *reinterpret_cast<float4*>(v_s + t * hd + c) = vr[j];
        }
      }
    }
    __syncthreads();

    // scores; when tpp > 1 every thread runs exactly one pair, so the
    // shuffles below always see the full warp
    for (int pr = tid / tpp; pr < n_pairs; pr += kThreads / tpp) {
      const int g = pr / kTile;
      const int t = pr - g * kTile;
      float dot = 0.f;
      for (int d = sub; d < hd; d += tpp) {
        dot += q_s[g * ldk + d] * k_s[t * ldk + d];
      }
      for (int o = tpp >> 1; o > 0; o >>= 1) {
        dot += __shfl_xor_sync(0xffffffffu, dot, o);
      }
      if (sub == 0) {
        float sc = dot * scale;
        if (softcap != 0.f) sc = softcap * tanhf(sc / softcap);
        p_s[pr] = (t0 + t < end) ? sc : kNegInf;
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

    // acc[g, d] = acc[g, d] * corr[g] + sum_t p[g, t] * v[t, d].  Not
    // unrolled over i: 32 copies of the unrolled t loop make a body large
    // enough to miss the instruction cache when the kernel runs between
    // other kernels, as it does in the model step
#pragma unroll 1
    for (int i = 0, e = tid; e < GH; ++i, e += kThreads) {
      const int g = e / hd;
      const int d = e - g * hd;
      const float* pr = p_s + g * kTile;
      float a = acc[i] * c_s[g];
#pragma unroll
      for (int t = 0; t < kTile; ++t) a += pr[t] * v_s[t * hd + d];
      acc[i] = a;
    }
    __syncthreads();              // tiles and p_s are rewritten next step
  }

  for (int i = 0, e = tid; e < GH; ++i, e += kThreads) {
    out[head0 + e] = acc[i] / fmaxf(l_s[e / hd], 1e-30f);
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).  The
// caller has checked shapes, dtypes, contiguity and 16-byte alignment, and
// that hd % 16 == 0, hd <= 256, H % KV == 0 and H / KV <= 16.
int paged_decode_attention_f32(const void* q, const void* k_pages,
                               const void* v_pages, const void* page_table,
                               const void* lengths, void* out, int S, int H,
                               int KV, int hd, int page, int max_pages,
                               int window, float softcap, float scale,
                               void* stream) {
  const int G = H / KV;
  const size_t smem =
      sizeof(float) * ((size_t)kTile * hd + (size_t)(kTile + G) * (hd + 1) +
                       (size_t)G * kTile + 3 * (size_t)G);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid(KV, S);
  paged_decode_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)q, (const float*)k_pages, (const float*)v_pages,
      (const int*)page_table, (const int*)lengths, (float*)out, H, KV, hd,
      page, max_pages, window, softcap, scale);
  return (int)cudaGetLastError();
}

const char* paged_decode_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
