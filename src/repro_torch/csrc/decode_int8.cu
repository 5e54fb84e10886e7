// Flash decode over an int8 KV cache: one query token per row against int8 K/V with
// fp16 scales per (token, kv head), written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_decode_int8_kernel` in src/repro/kernels/decode_attn/
// decode.py (entry `flash_decode_int8`). Same function: q (B,H,hd) against
// k = kq * k_scale and v = vq * v_scale, kq/vq (B,S,K,hd) int8 and k_scale/v_scale
// (B,S,K) fp16, with GQA (G = H/K query heads per kv head), keys [0, pos] valid,
// optional logit softcap, online softmax in f32, output (B,H,hd) f32. As in
// csrc/decode.cu, `pos` is per row (B,) int32; the TPU kernel's scalar `pos` is the
// case of all rows equal.
//
// Design: csrc/decode.cu's. One thread block of 8 warps per (kv head, batch row);
// each warp walks keys j = 4*warp, 4*warp + 1, ... in groups of 4 (stride 32), the
// lanes of a warp split head_dim (lane l holds elements l*EPL .., EPL =
// max(hd/32, 1)), and the 8 warps' partial softmax states merge through shared
// memory. The int8 values and their fp16 scales are dequantized in registers after
// the load, so the cache crosses device memory at 1 byte an element, which is what
// the TPU kernel fuses the dequant for. The scale is taken out of the sums: a score
// is (q . kq) * k_scale, and a key's value row enters the sum as (p * v_scale) * vq.
// Each warp issues its 4 keys' loads (values and scales) before it unpacks any of
// them, so they are in flight together. Only keys [0, pos[b]] are used.
//
// Bound on this card: memory. The work reads kq and vq up to pos (2*hd bytes per key
// per kv head) plus two 2-byte scales, and does 4*G*hd FLOPs per key, about 2*G
// FLOPs per byte, far below the ~20 FLOPs per byte where the f32 CUDA cores would
// bound it; the least time is (K/V bytes + scales up to pos) / 3.35 TB/s. Left for
// later, as in csrc/decode.cu: a split-S pass for long rows.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kUnroll = 4;  // keys per warp iteration
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// EPL consecutive int8 values of a lane, loaded as one word
template <int EPL>
struct Packed;
template <>
struct Packed<4> {
  using T = char4;
  static __device__ __forceinline__ void unpack(T c, float (&out)[4]) {
    out[0] = c.x;
    out[1] = c.y;
    out[2] = c.z;
    out[3] = c.w;
  }
};
template <>
struct Packed<2> {
  using T = char2;
  static __device__ __forceinline__ void unpack(T c, float (&out)[2]) {
    out[0] = c.x;
    out[1] = c.y;
  }
};
template <>
struct Packed<1> {
  using T = signed char;
  static __device__ __forceinline__ void unpack(T c, float (&out)[1]) { out[0] = c; }
};

// MAXG bounds the group size G = H/K held in registers; G itself is a runtime value
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kThreads)
decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                   const __half* __restrict__ ks, const int8_t* __restrict__ vq,
                   const __half* __restrict__ vs, const int* __restrict__ pos,
                   float* __restrict__ o, int S, int H, int K, float softcap, float scale) {
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // head_dim elements per lane
  __shared__ float m_s[kWarps][MAXG];
  __shared__ float l_s[kWarps][MAXG];
  __shared__ float acc_s[kWarps][MAXG][HD];

  const int G = H / K;
  const int h = blockIdx.x, b = blockIdx.y;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int last = min(pos[b], S - 1);  // keys [0, last] are valid
  const bool holds = lane * EPL < HD;   // false only for the idle lanes at hd < 32

  float qr[MAXG][EPL], m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) {
      acc[g][e] = 0.f;
      qr[g][e] = g < G && holds
                     ? to_f(q[((size_t)b * H + h * G + g) * HD + lane * EPL + e])
                     : 0.f;
    }
  }

  const size_t row_stride = (size_t)K * HD;  // between consecutive positions
  const size_t lane_off = holds ? lane * EPL : 0;
  const int8_t* kb = kq + ((size_t)b * S * K + h) * HD + lane_off;
  const int8_t* vb = vq + ((size_t)b * S * K + h) * HD + lane_off;
  const __half* ksb = ks + (size_t)b * S * K + h;  // scale of key j at ksb[j * K]
  const __half* vsb = vs + (size_t)b * S * K + h;

  using PT = typename Packed<EPL>::T;
  for (int j0 = warp * kUnroll; j0 <= last; j0 += kWarps * kUnroll) {
    // Issue all 4 keys' loads before any use, unconditionally: a key past
    // `last` loads row 0 instead (always in bounds) and is masked out by its
    // score and its zeroed value scale below. A load under a branch with its
    // unpack beside it would wait for each load in turn.
    PT kr[kUnroll], vr[kUnroll];
    __half ksh[kUnroll], vsh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u <= last ? j0 + u : 0;
      kr[u] = *reinterpret_cast<const PT*>(kb + j * row_stride);
      vr[u] = *reinterpret_cast<const PT*>(vb + j * row_stride);
      ksh[u] = ksb[(size_t)j * K];
      vsh[u] = vsb[(size_t)j * K];
    }
    float kk[kUnroll][EPL], vv[kUnroll][EPL], ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      Packed<EPL>::unpack(kr[u], kk[u]);
      Packed<EPL>::unpack(vr[u], vv[u]);
      ksc[u] = __half2float(ksh[u]);
      vsc[u] = j0 + u <= last ? __half2float(vsh[u]) : 0.f;  // p * 0, never p * inf
    }
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float s[kUnroll];
      float mx = kNegInf;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int e = 0; e < EPL; ++e) part = fmaf(qr[g][e], kk[u][e], part);
        float sv = warp_sum(part) * ksc[u] * scale;
        if (softcap > 0.f) sv = softcap * tanhf(sv / softcap);
        s[u] = j0 + u <= last ? sv : kNegInf;
        mx = fmaxf(mx, s[u]);
      }
      const float m_new = fmaxf(m[g], mx);
      const float alpha = expf(m[g] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const float p = j0 + u <= last ? expf(s[u] - m_new) : 0.f;
        rs += p;
        const float pv = p * vsc[u];
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pv, vv[u][e], acc[g][e]);
      }
      l[g] = l[g] * alpha + rs;
      m[g] = m_new;
    }
  }

  // merge the 8 warps' partial softmax states
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      m_s[warp][g] = m[g];
      l_s[warp][g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (holds) acc_s[warp][g][lane * EPL + e] = acc[g][e];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD, d = idx % HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, m_s[w][g]);
    float lsum = 0.f, out = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float a = expf(m_s[w][g] - mx);
      lsum += l_s[w][g] * a;
      out += acc_s[w][g][d] * a;
    }
    o[((size_t)b * H + h * G + g) * HD + d] = out / fmaxf(lsum, 1e-30f);
  }
}

struct Args {
  const void* q;
  const int8_t* kq;
  const __half* ks;
  const int8_t* vq;
  const __half* vs;
  const int* pos;
  float* o;
  int B, S, H, K;
  float softcap;
};

template <typename T, int HD, int MAXG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  decode_int8_kernel<T, HD, MAXG><<<dim3(a.K, a.B), kThreads, 0, stream>>>(
      (const T*)a.q, a.kq, a.ks, a.vq, a.vs, a.pos, a.o, a.S, a.H, a.K, a.softcap, scale);
  return cudaGetLastError();
}

template <typename T, int HD>
cudaError_t dispatch_g(int G, const Args& a, cudaStream_t st) {
  if (G <= 1) return launch<T, HD, 1>(a, st);
  if (G <= 2) return launch<T, HD, 2>(a, st);
  if (G <= 4) return launch<T, HD, 4>(a, st);
  if (G <= 8) return launch<T, HD, 8>(a, st);
  return cudaErrorInvalidValue;
}

template <typename T>
cudaError_t dispatch_hd(int hd, int G, const Args& a, cudaStream_t st) {
  switch (hd) {
    case 16: return dispatch_g<T, 16>(G, a, st);
    case 32: return dispatch_g<T, 32>(G, a, st);
    case 64: return dispatch_g<T, 64>(G, a, st);
    case 128: return dispatch_g<T, 128>(G, a, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q (B,H,hd) float32 (dtype 0) or bfloat16 (dtype 1); kq/vq (B,S,K,hd) int8;
// k_scale/v_scale (B,S,K) float16; pos (B,) int32; o (B,H,hd) float32. All on the
// device, contiguous. Launches on `stream` and returns cudaGetLastError() (0 =
// launched).
int decode_attn_int8_fwd(const void* q, const void* kq, const void* k_scale, const void* vq,
                         const void* v_scale, const void* pos, void* o, int B, int S, int H,
                         int K, int hd, float softcap, int dtype, void* stream) {
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0) return (int)cudaErrorInvalidValue;
  const Args a{q,        (const int8_t*)kq, (const __half*)k_scale, (const int8_t*)vq,
               (const __half*)v_scale, (const int*)pos, (float*)o, B, S, H, K, softcap};
  cudaStream_t st = (cudaStream_t)stream;
  const int G = H / K;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(hd, G, a, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(hd, G, a, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
