// Blocked flash attention forward for Hopper (sm_90a): causal / sliding
// window / logit softcap, GQA, float32 or bf16 in, float32 arithmetic.
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
// Design.  The TPU kernel ran a sequential (B, KV, G, nq, nk) grid and
// carried m, l and acc in VMEM scratch across the nk axis.  Blocks here
// run in no order, so one block owns one (q tile of 64 rows, head,
// batch) and loops over the k tiles itself: Q, K, V and the 64 x 64 score
// tile are staged in dynamic shared memory as float32 (above 48 KB at
// hd = 128, hence the opt-in), m and l live in registers of the four
// threads that share a row in the softmax stage, and each thread keeps a
// 4-row slice of acc in registers.  The TPU kernel paid one predicated
// vector op for a fully-masked tile; this one skips it, which gives the
// same result for every row that has a live key (a skipped tile would
// have had p = 0 there, or p = 1 wiped later by corr = 0).  A row with no
// live key at all (only with a window and Sq >= Sk + window) would come
// out 0 where the TPU kernel and the plain version give the uniform
// average of V: a block that holds such a row skips nothing.  Products
// are float32 FMAs out of shared memory (16 FMAs per pair of float4
// loads); the loads are 16 bytes wide (8 for bf16) on coalesced rows,
// and the shared layouts are padded to keep every access conflict-free.
// The kernel reads q, k, v and writes out through strides (head dim
// contiguous), so the model's (B, S, H, hd) layout needs no transpose.
//
// Bound.  Arithmetic: 4 hd flops per live (q, k) pair and head, half in
// q.k and half in P.V.  bf16 q and k multiply exactly in float32, so q.k
// of bf16 inputs could run on the tensor cores (989 TFLOP/s, float32
// accumulation); P is float32, so P.V stays at 67 TFLOP/s without them.
// gemma2-27b's prefill at S = 8,192 (H = 32, hd = 128, bf16): 550 GFLOP
// on a global layer, 4.4 ms; the bytes (q, k, v and out once) are ~0.1
// ms.  wgmma for q.k, TMA loads, K/V shared across the G query heads of
// a kv head and two blocks per SM are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBQ = 64;        // q rows per block
constexpr int kBK = 64;        // k rows per tile
constexpr int kThreads = 256;  // 16 x 16
constexpr float kNegInf = -1e30f;

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

__device__ __forceinline__ void store_out(float* p, const float* v, int n) {
  for (int e = 0; e < n; ++e) p[e] = v[e];
}

__device__ __forceinline__ void store_out(__nv_bfloat16* p, const float* v,
                                          int n) {
  for (int e = 0; e < n; ++e) p[e] = __float2bfloat16_rn(v[e]);
}

// rows x HD tile from global (row stride `rs` elements) into shared memory
// as float32 (row stride `ld` floats)
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src,
                                          long long rs, int rows) {
  constexpr int kChunks = HD / 4;
  for (int idx = threadIdx.x; idx < rows * kChunks; idx += kThreads) {
    const int r = idx / kChunks, c = (idx % kChunks) * 4;
    *reinterpret_cast<float4*>(dst + r * ld + c) =
        Load4<T>::load(src + r * rs + c);
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       int H, int G, int Sq, int Sk,
                       long long qb, long long qh, long long qs,
                       long long kb, long long kh, long long ks,
                       long long vb, long long vh, long long vs,
                       long long ob, long long oh, long long os,
                       int causal, int window, float softcap, float scale) {
  constexpr int LDQ = HD + 4;            // padded: conflict-free float4 rows
  constexpr int LDP = kBK + 4;
  constexpr int VEC = HD >= 64 ? 4 : 2;  // acc columns per contiguous group
  constexpr int NJ = HD / (16 * VEC);    // groups per thread
  constexpr int CPT = VEC * NJ;          // acc columns per thread (HD / 16)

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);
  float* Ks = Qs + kBQ * LDQ;
  float* Vs = Ks + kBK * LDQ;
  float* Ps = Vs + kBK * HD;
  float* corr_s = Ps + kBQ * LDP;
  float* l_s = corr_s + kBQ;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / G;
  const T* qp = q + b * qb + h * qh + (long long)q0 * qs;
  const T* kp = k + b * kb + kvh * kh;
  const T* vp = v + b * vb + kvh * vh;

  load_tile<T, HD>(Qs, LDQ, qp, qs, kBQ);

  // softmax stage: four threads per row, columns part + 4 m
  const int srow = tid >> 2, part = tid & 3;
  float m_run = kNegInf, l_run = 0.f;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

  const int qmax = q0 + kBQ - 1;
  // a row with no live key in the whole sequence needs every tile
  const bool dead_rows = window > 0 && qmax - (Sk - 1) >= window;
  const int nk = Sk / kBK;
  for (int it = 0; it < nk; ++it) {
    const int k0 = it * kBK;
    if (!dead_rows && ((causal && k0 > qmax) ||
                       (window > 0 && q0 - (k0 + kBK - 1) >= window))) {
      continue;                           // no live pair in this tile
    }
    __syncthreads();                      // the last tile's readers are done
    load_tile<T, HD>(Ks, LDQ, kp + (long long)k0 * ks, ks, kBK);
    load_tile<T, HD>(Vs, HD, vp + (long long)k0 * vs, vs, kBK);
    __syncthreads();

    // scores: rows ty*4 + i, columns tx + 16 j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (ty * 4 + i) * LDQ + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (tx + 16 * j) * LDQ + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(qv[i].x, kv[j].x, s[i][j]);
          s[i][j] = fmaf(qv[i].y, kv[j].y, s[i][j]);
          s[i][j] = fmaf(qv[i].z, kv[j].z, s[i][j]);
          s[i][j] = fmaf(qv[i].w, kv[j].w, s[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q0 + ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kpos = k0 + tx + 16 * j;
        float x = s[i][j] * scale;
        if (softcap != 0.f) x = softcap * tanhf(x / softcap);
        const bool live = (!causal || qpos >= kpos) &&
                          (window <= 0 || qpos - kpos < window);
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = live ? x : kNegInf;
      }
    }
    __syncthreads();

    // online softmax, one row per four threads
    {
      float* prow = Ps + srow * LDP;
      float mt = kNegInf;
#pragma unroll
      for (int m = 0; m < kBK / 4; ++m) mt = fmaxf(mt, prow[part + 4 * m]);
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
      mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
      const float m_new = fmaxf(m_run, mt);
      float rs = 0.f;
#pragma unroll
      for (int m = 0; m < kBK / 4; ++m) {
        const float p = expf(prow[part + 4 * m] - m_new);
        prow[part + 4 * m] = p;
        rs += p;
      }
      rs += __shfl_xor_sync(0xffffffffu, rs, 1);
      rs += __shfl_xor_sync(0xffffffffu, rs, 2);
      const float corr = expf(m_run - m_new);
      l_run = l_run * corr + rs;
      m_run = m_new;
      if (part == 0) corr_s[srow] = corr;
    }
    __syncthreads();

    // acc = acc * corr + P V: rows ty*4 + i, columns jj*16*VEC + tx*VEC + e
    float pv[4][CPT];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < CPT; ++c) pv[i][c] = 0.f;
#pragma unroll 2
    for (int j = 0; j < kBK; j += 4) {
      float4 pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pr[i] = *reinterpret_cast<const float4*>(Ps + (ty * 4 + i) * LDP + j);
#pragma unroll
      for (int jj4 = 0; jj4 < 4; ++jj4) {
        const float* vrow = Vs + (j + jj4) * HD;
        float vv[CPT];
#pragma unroll
        for (int g = 0; g < NJ; ++g) {
          const float* src = vrow + g * 16 * VEC + tx * VEC;
          if constexpr (VEC == 4) {
            const float4 t = *reinterpret_cast<const float4*>(src);
            vv[g * VEC + 0] = t.x;
            vv[g * VEC + 1] = t.y;
            vv[g * VEC + 2] = t.z;
            vv[g * VEC + 3] = t.w;
          } else {
            const float2 t = *reinterpret_cast<const float2*>(src);
            vv[g * VEC + 0] = t.x;
            vv[g * VEC + 1] = t.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = jj4 == 0 ? pr[i].x : jj4 == 1 ? pr[i].y
                        : jj4 == 2 ? pr[i].z : pr[i].w;
#pragma unroll
          for (int c = 0; c < CPT; ++c) pv[i][c] = fmaf(p, vv[c], pv[i][c]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float corr = corr_s[ty * 4 + i];
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] = acc[i][c] * corr + pv[i][c];
    }
  }

  if (part == 0) l_s[srow] = l_run;
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float l = fmaxf(l_s[r], 1e-30f);
    T* orow = out + b * ob + h * oh + (long long)(q0 + r) * os;
#pragma unroll
    for (int g = 0; g < NJ; ++g) {
      float o[VEC];
#pragma unroll
      for (int e = 0; e < VEC; ++e) o[e] = acc[i][g * VEC + e] / l;
      store_out(orow + g * 16 * VEC + tx * VEC, o, VEC);
    }
  }
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) *
         (size_t)(2 * kBQ * (HD + 4) + kBK * HD + kBQ * (kBK + 4) + 2 * kBQ);
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* out, int B,
           int H, int KV, int Sq, int Sk, const long long* st, int causal,
           int window, float softcap, float scale, cudaStream_t stream) {
  constexpr size_t bytes = smem_bytes<HD>();
  // above 48 KB only after the opt-in (set on the current device: cheap,
  // so every launch asks rather than caching per process)
  const cudaError_t e = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(Sq / kBQ, H, B);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)out, H, H / KV, Sq, Sk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(int hd, const void* q, const void* k, const void* v, void* out,
             int B, int H, int KV, int Sq, int Sk, const long long* st,
             int causal, int window, float softcap, float scale,
             cudaStream_t s) {
  switch (hd) {
    case 32:
      return launch<T, 32>(q, k, v, out, B, H, KV, Sq, Sk, st, causal,
                           window, softcap, scale, s);
    case 64:
      return launch<T, 64>(q, k, v, out, B, H, KV, Sq, Sk, st, causal,
                           window, softcap, scale, s);
    case 128:
      return launch<T, 128>(q, k, v, out, B, H, KV, Sq, Sk, st, causal,
                            window, softcap, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches on `stream` and returns cudaGetLastError() (0 on success).
// dtype 0 = float32, 1 = bf16 (q, k, v and out alike).  strides: 12
// element strides, (batch, head, row) for q, k, v and out in that order;
// the head dim is contiguous.  The caller has checked devices, dtypes,
// shapes (H % KV == 0, Sq and Sk multiples of 64, hd in {32, 64, 128}),
// and 16-byte alignment of the pointers and of every stride.
int flash_attention_fwd(const void* q, const void* k, const void* v,
                        void* out, int dtype, int B, int H, int KV, int Sq,
                        int Sk, int hd, const long long* strides, int causal,
                        int window, float softcap, float scale,
                        void* stream) {
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) {
    return dispatch<float>(hd, q, k, v, out, B, H, KV, Sq, Sk, strides,
                           causal, window, softcap, scale, s);
  }
  return dispatch<__nv_bfloat16>(hd, q, k, v, out, B, H, KV, Sq, Sk, strides,
                                 causal, window, softcap, scale, s);
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
