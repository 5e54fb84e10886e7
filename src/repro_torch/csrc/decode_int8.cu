// Flash decode over an int8 KV cache: one query token per row against int8 K/V with
// fp16 scales per (token, kv head), written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_decode_int8_kernel` in src/repro/kernels/decode_attn/
// decode.py (entry `flash_decode_int8`). Same function: q (B,H,hd) against
// k = kq * k_scale and v = vq * v_scale, kq/vq (B,S,K,hd) int8 and k_scale/v_scale
// (B,S,K) fp16, with GQA (G = H/K query heads per kv head), keys [0, pos] valid,
// optional logit softcap, online softmax in f32, output (B,H,hd) f32. As in
// csrc/decode.cu, `pos` is per row (B,) int32; the TPU kernel's scalar `pos` is the
// case of all rows equal. A row with no valid key outputs 0 (max(l, 1e-30)).
//
// Bound on this card: memory. The work reads kq and vq up to pos (2*hd bytes per key
// per kv head) plus two 2-byte scales, and does 4*G*hd FLOPs per key, about 2*G
// FLOPs per byte, far below the ~20 FLOPs per byte where the f32 CUDA cores would
// bound it; the least time is (K/V bytes + scales up to pos) / 3.35 TB/s.
//
// What held the one-block-per-(kv head, row) design back: 128 blocks on 132 SMs at
// the main shape (B=4, K=32, S=1024), the row at pos 1023 setting the time while the
// short rows' blocks sat idle, and 4-byte loads with ~8 KB in flight per block. The
// design now is split-S, in csrc/decode_split.cuh (shared with the fp kernel of
// csrc/decode.cu): a (K, B, ceil(S/chunk)) grid whose blocks past pos exit at once,
// q and the scales loaded first, the chunk's K/V rows by 16-byte cp.async (2*chunk*hd
// bytes a block, 16 KB at chunk 64), warps on 16-key tiles as they land, and the
// chunks of a long row merged in the same launch by the block that draws the last
// ticket. What is this kernel's own:
//   - int8 becomes f32 by a byte permute into the bits of 2^23 + 128 + b and one
//     subtraction (no I2F, which runs at a quarter of the FMA rate).
//   - The scale is taken out of the sums: a score is (q . kq) * k_scale * hd^-0.5,
//     and a key's value row enters the sum as (p * v_scale) * vq.

#include "decode_split.cuh"

namespace {

using namespace decode_split;

// Byte k (0..3) of a packed int8 word as a float, without a conversion instruction:
// with u = word ^ 0x80808080, the bits 0x4B0000uu are the float 2^23 + (b + 128), so
// subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ float s8f(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.f;
}

struct Int8Cache {
  using E = int8_t;
  static constexpr bool kScaled = true;

  __device__ static __forceinline__ void piece(const int4& w, float (&f)[16]) {
    const uint32_t words[4] = {(uint32_t)w.x ^ 0x80808080u, (uint32_t)w.y ^ 0x80808080u,
                               (uint32_t)w.z ^ 0x80808080u, (uint32_t)w.w ^ 0x80808080u};
#pragma unroll
    for (int e = 0; e < 16; ++e) f[e] = s8f(words[e / 4], e % 4);
  }

  template <int N>
  __device__ static __forceinline__ void elems(const uint8_t* p, float (&f)[N]) {
    uint32_t v;
    if constexpr (N == 4)
      v = *reinterpret_cast<const uint32_t*>(p);
    else if constexpr (N == 2)
      v = *reinterpret_cast<const uint16_t*>(p);
    else
      v = *p;
    v ^= 0x80808080u;
#pragma unroll
    for (int e = 0; e < N; ++e) f[e] = s8f(v, e);
  }
};

// MAXG bounds the group size G = H/K held in registers; G itself is a runtime value.
// Blocks of 4 or 8 warps; at most 64 registers a thread (128 from G 3 on).
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kMaxThreads, MAXG <= 2 ? 4 : 2)
decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                   const __half* __restrict__ ks, const int8_t* __restrict__ vq,
                   const __half* __restrict__ vs, const int* __restrict__ pos,
                   float* __restrict__ o, float* __restrict__ part,
                   int* __restrict__ ticket, int S, int H, int K, int chunk,
                   float softcap, float scale) {
  split_decode<Int8Cache, T, HD, MAXG>(q, kq, ks, vq, vs, pos, o, part, ticket, S, H, K,
                                       chunk, softcap, scale);
}

template <typename T, int HD, int MAXG>
struct Int8Kernel {
  static constexpr int kRowBytes = HD;
  static cudaError_t set_smem(int bytes) {
    return cudaFuncSetAttribute(decode_int8_kernel<T, HD, MAXG>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  }
  static void launch(dim3 grid, int threads, size_t smem, cudaStream_t st,
                     const Args& a, float scale) {
    decode_int8_kernel<T, HD, MAXG><<<grid, threads, smem, st>>>(
        (const T*)a.q, (const int8_t*)a.k, a.ks, (const int8_t*)a.v, a.vs, a.pos, a.o,
        a.part, a.ticket, a.S, a.H, a.K, a.chunk, a.softcap, scale);
  }
};

}  // namespace

extern "C" {

// q (B,H,hd) float32 (dtype 0) or bfloat16 (dtype 1); kq/vq (B,S,K,hd) int8 with
// 16-byte aligned bases; k_scale/v_scale (B,S,K) float16; pos (B,) int32; o (B,H,hd)
// float32. `chunk` (64, 128, 192 or 256) keys per block; `part` an f32
// scratch of B*K*ceil(S/chunk)*G*(hd+4) floats (unused, may be null, when S <= chunk);
// `ticket` B*K int32 counters that are 0 on entry and are left 0. All on the device,
// contiguous. Launches on `stream` and returns cudaGetLastError() (0 = launched).
int decode_attn_int8_fwd(const void* q, const void* kq, const void* k_scale, const void* vq,
                         const void* v_scale, const void* pos, void* o, void* part,
                         void* ticket, int B, int S, int H, int K, int hd, int chunk,
                         float softcap, int dtype, void* stream) {
  const Args a{q,         kq,       (const __half*)k_scale,
               vq,        (const __half*)v_scale,
               (const int*)pos,      (float*)o,
               (float*)part,         (int*)ticket,
               B,         S,        H,
               K,         chunk,    softcap};
  return (int)dispatch<Int8Kernel>(dtype, hd, a, (cudaStream_t)stream);
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
