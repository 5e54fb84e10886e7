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
// design now, split-S:
//   - Block (h, b, c) of a (K, B, ceil(S/chunk)) grid takes keys [c*chunk,
//     (c+1)*chunk) of kv head h in row b; the wrapper picks `chunk`
//     (kernels/decode_attn/ops.py::int8_chunk_plan) and passes it. A block whose chunk
//     starts past pos[b] exits at once, so the long rows get many blocks and the short
//     ones one. The chunk index is the grid's slowest, so every row's first chunks
//     are dispatched before any row's later ones.
//   - Loads, in the order they are needed: q and the lane's fp16 scales (which lie K
//     apart in the cache, one load a key) into registers first, then the chunk's K and
//     V rows by 16-byte `cp.async` copies into shared memory (at hd 128, 8 lanes per
//     key row), all in flight together: 2*chunk*hd bytes a block (16 KB at chunk 64).
//     Rows are padded by 16 bytes in shared memory so 16-byte reads of consecutive
//     keys fall in distinct banks.
//   - Warps work alone. Warp w takes a quarter of the chunk in tiles of 16 keys, one
//     cp.async group per tile, and starts on a tile as soon as it has landed: scores
//     (2 lanes per key, q from shared memory), an online softmax in registers, then
//     P.V with each lane owning hd/32 output elements and each key's p * v_scale
//     broadcast from the lane that holds it. int8 becomes f32 by a byte permute into
//     the bits of 2^23 + 128 + b and one subtraction (no I2F, which runs at a quarter
//     of the FMA rate). The 4 warps' states merge once, through shared memory.
//   - Merge in the same launch. A row with one chunk writes its output at once. For
//     longer rows each block writes its (acc, m, l) to an f32 scratch record; thread 0
//     fences (`__threadfence`) and takes a ticket (`atomicAdd` on the (row, kv head)
//     counter); the block that draws the last ticket resets the counter to 0 for the
//     next call and merges the records 8 at a time (every load of a batch issued
//     before any is used): m = max m_i, l = sum l_i e^(m_i - m), o = sum acc_i
//     e^(m_i - m) / max(l, 1e-30). The wrapper allocates the scratch per call
//     (torch.empty) and keeps the counters, zeroed once, per device.
// The scale is taken out of the sums: a score is (q . kq) * k_scale * hd^-0.5, and a
// key's value row enters the sum as (p * v_scale) * vq.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cmath>

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kPad = 16;       // bytes after each shared K/V row
constexpr int kMaxGroup = 8;   // query heads per kv head
constexpr int kMaxChunk = 256;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Byte k (0..3) of a packed int8 word as a float, without a conversion instruction
// (I2F runs at a quarter of the FMA rate): with u = word ^ 0x80808080, the bits
// 0x4B0000uu are the float 2^23 + (b + 128), so subtracting 2^23 + 128 leaves b.
__device__ __forceinline__ float s8f(uint32_t u, int k) {
  return __int_as_float(__byte_perm(u, 0x4B000000u, 0x7540u | k)) - 8388736.f;
}

// at most n of this thread's cp.async groups still in flight (n clamped to 0 .. 3)
__device__ __forceinline__ void cp_async_wait_upto(int n) {
  if (n <= 0)
    cp_async_wait<0>();
  else if (n == 1)
    cp_async_wait<1>();
  else if (n == 2)
    cp_async_wait<2>();
  else
    cp_async_wait<3>();
}

constexpr int kTile = 16;                              // keys per warp tile
constexpr int kMaxTiles = kMaxChunk / kWarps / kTile;  // tiles per warp

// bytes of dynamic shared memory one block takes (the layout in the kernel)
__host__ __device__ constexpr size_t smem_bytes(int hd, int G, int chunk) {
  return (size_t)2 * chunk * (hd + kPad) +  // K, V rows
         sizeof(float) * ((size_t)G * hd + (size_t)kWarps * G * (hd + 2));
}

// MAXG bounds the group size G = H/K held in registers; G itself is a runtime value
template <typename T, int HD, int MAXG>
__global__ void __launch_bounds__(kThreads, MAXG <= 2 ? 8 : 4)
decode_int8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                   const __half* __restrict__ ks, const int8_t* __restrict__ vq,
                   const __half* __restrict__ vs, const int* __restrict__ pos,
                   float* __restrict__ o, float* __restrict__ part, int* __restrict__ ticket,
                   int S, int H, int K, int chunk, float softcap, float scale) {
  constexpr int LDS = HD + kPad;               // shared row stride, bytes
  constexpr int CPR = HD / 16;                 // 16-byte pieces per row
  constexpr int TPK = CPR >= 2 ? 2 : 1;        // lanes per key in the scores
  constexpr int EPL = HD >= 32 ? HD / 32 : 1;  // output elements per lane in P.V
  const int G = H / K;
  const int h = blockIdx.x, b = blockIdx.y, c = blockIdx.z;
  const int last = min(pos[b], S - 1);  // keys [0, last] are valid
  const int nsplit = last < 0 ? 1 : last / chunk + 1;
  if (c >= nsplit) return;  // the chunk starts past pos[b]
  const int j0 = c * chunk;
  const int nk = last < 0 ? 0 : min(chunk, last + 1 - j0);  // valid keys of this chunk
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  extern __shared__ __align__(16) uint8_t smem[];
  int8_t* sK = reinterpret_cast<int8_t*>(smem);                      // [chunk][LDS]
  int8_t* sV = sK + (size_t)chunk * LDS;                             // [chunk][LDS]
  float* sq = reinterpret_cast<float*>(sV + (size_t)chunk * LDS);    // [G][HD]
  float* wacc = sq + G * HD;                                         // [warp][G][HD]
  float* wm = wacc + kWarps * G * HD;                                // [warp][G]
  float* wl = wm + kWarps * G;                                       // [warp][G]

  // ---- loads, in the order they are needed: q and this lane's scales into registers,
  // then the K/V rows. Warp w takes keys [w*chunk/4, (w+1)*chunk/4) of the chunk in
  // tiles of 16; every tile's rows are issued at once, one cp.async group per tile.
  constexpr int QPT = (MAXG * HD + kThreads - 1) / kThreads;  // q elements per thread
  const T* qb = q + ((size_t)b * H + (size_t)h * G) * HD;  // the group's G query rows
  float qr[QPT];
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = threadIdx.x + r * kThreads;
    qr[r] = i < G * HD ? to_f(qb[i]) : 0.f;
  }
  const size_t row = (size_t)K * HD;  // bytes between consecutive positions
  const size_t base = (((size_t)b * S + j0) * K + h) * HD;
  const size_t sbase = ((size_t)b * S + j0) * K + h;  // scale of chunk key j at sbase + j*K
  const int per_warp = chunk / kWarps;
  const int kw0 = warp * per_warp;
  const int nkw = max(0, min(per_warp, nk - kw0));  // this warp's valid keys
  const int ntiles = (nkw + kTile - 1) / kTile;
  const int kk = lane / TPK, sub = lane % TPK;  // this lane's key in each tile
  float ksc[kMaxTiles], vsc[kMaxTiles];
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    const int j = kw0 + i * kTile + kk;
    const bool in = kk < kTile && i * kTile + kk < nkw;
    ksc[i] = in ? __half2float(ks[sbase + (size_t)j * K]) : 0.f;
    vsc[i] = in ? __half2float(vs[sbase + (size_t)j * K]) : 0.f;
  }
  for (int i = 0; i < ntiles; ++i) {
    const int t0 = kw0 + i * kTile, nt = min(kTile, nkw - i * kTile);
    for (int e = lane; e < nt * CPR; e += 32) {
      const int j = t0 + e / CPR, p = (e % CPR) * 16;
      cp_async16(sK + j * LDS + p, kq + base + j * row + p);
      cp_async16(sV + j * LDS + p, vq + base + j * row + p);
    }
    cp_async_commit();
  }
#pragma unroll
  for (int r = 0; r < QPT; ++r) {
    const int i = threadIdx.x + r * kThreads;
    if (i < G * HD) sq[i] = qr[r];
  }
  __syncthreads();  // q is in shared memory

  // ---- each warp: its tiles as they land, with an online softmax in registers
  const int d0 = lane * EPL;  // this lane's output elements in P.V
  const bool holds = d0 < HD;  // false only for the idle lanes at hd 16
  float m[MAXG], l[MAXG], acc[MAXG][EPL];
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    m[g] = kNegInf;
    l[g] = 0.f;
#pragma unroll
    for (int e = 0; e < EPL; ++e) acc[g][e] = 0.f;
  }
#pragma unroll
  for (int i = 0; i < kMaxTiles; ++i) {
    if (i >= ntiles) break;
    cp_async_wait_upto(ntiles - 1 - i);  // tile i has landed (this lane's copies)
    __syncwarp();                         // ... and every lane's
    const int t0 = kw0 + i * kTile, nt = min(kTile, nkw - i * kTile);
    const bool valid = kk < nt;
    // scores: TPK lanes per key, each taking every TPK-th 16-byte piece
    float dot[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) dot[g] = 0.f;
    if (valid) {
      const int8_t* kr = sK + (t0 + kk) * LDS;
#pragma unroll
      for (int pp = 0; pp < CPR / TPK; ++pp) {
        const int p = pp * TPK + sub;
        const int4 w = *reinterpret_cast<const int4*>(kr + p * 16);
        const uint32_t words[4] = {(uint32_t)w.x ^ 0x80808080u, (uint32_t)w.y ^ 0x80808080u,
                                   (uint32_t)w.z ^ 0x80808080u, (uint32_t)w.w ^ 0x80808080u};
        float kf[16];
#pragma unroll
        for (int e = 0; e < 16; ++e) kf[e] = s8f(words[e / 4], e % 4);
#pragma unroll
        for (int g = 0; g < MAXG; ++g) {
          if (g >= G) break;
          const float4* q4 = reinterpret_cast<const float4*>(sq + g * HD + p * 16);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 qv = q4[e];
            dot[g] = fmaf(qv.x, kf[4 * e], dot[g]);
            dot[g] = fmaf(qv.y, kf[4 * e + 1], dot[g]);
            dot[g] = fmaf(qv.z, kf[4 * e + 2], dot[g]);
            dot[g] = fmaf(qv.w, kf[4 * e + 3], dot[g]);
          }
        }
      }
    }
    // the tile's softmax, folded into the running state; pv = p * v_scale of this
    // lane's key
    float pv[MAXG];
#pragma unroll
    for (int g = 0; g < MAXG; ++g) {
      if (g >= G) break;
      float d = dot[g];
      if (TPK == 2) d += __shfl_xor_sync(0xffffffffu, d, 1);
      float s = d * ksc[i] * scale;
      if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      s = valid ? s : kNegInf;
      const float m_new = fmaxf(m[g], warp_max(s));
      const float alpha = expf(m[g] - m_new);
      const float p = valid ? expf(s - m_new) : 0.f;
      l[g] = l[g] * alpha + warp_sum(sub == 0 ? p : 0.f);
      m[g] = m_new;
#pragma unroll
      for (int e = 0; e < EPL; ++e) acc[g][e] *= alpha;
      pv[g] = p * vsc[i];
    }
    // P.V: every key of the tile, its p * v_scale broadcast from the lane holding it
    for (int key = 0; key < nt; ++key) {
      uint32_t v = 0;
      const int8_t* vr = sV + (t0 + key) * LDS + d0;
      if (holds) {
        if (EPL == 4)
          v = *reinterpret_cast<const uint32_t*>(vr);
        else if (EPL == 2)
          v = *reinterpret_cast<const uint16_t*>(vr);
        else
          v = *reinterpret_cast<const uint8_t*>(vr);
      }
      v ^= 0x80808080u;
      float vf[EPL];
#pragma unroll
      for (int e = 0; e < EPL; ++e) vf[e] = s8f(v, e);
#pragma unroll
      for (int g = 0; g < MAXG; ++g) {
        if (g >= G) break;
        const float pg = __shfl_sync(0xffffffffu, pv[g], key * TPK);
#pragma unroll
        for (int e = 0; e < EPL; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
  }

  // ---- the 4 warps' states merge through shared memory into the block's (m, l, acc)
#pragma unroll
  for (int g = 0; g < MAXG; ++g) {
    if (g >= G) break;
    if (lane == 0) {
      wm[warp * G + g] = m[g];
      wl[warp * G + g] = l[g];
    }
#pragma unroll
    for (int e = 0; e < EPL; ++e)
      if (holds) wacc[(warp * G + g) * HD + d0 + e] = acc[g][e];
  }
  __syncthreads();
  const int rec_len = G * (HD + 4);  // acc [G][HD], m [G], l [G]; 16-byte records
  const size_t rows_base = ((size_t)b * K + h) * gridDim.z;
  float* rec = nsplit > 1 ? part + (rows_base + c) * rec_len : nullptr;
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float mx = kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w * G + g]);
    float lsum = 0.f, a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(wm[w * G + g] - mx);
      lsum = fmaf(wl[w * G + g], f, lsum);
      a = fmaf(wacc[w * G * HD + idx], f, a);
    }
    if (nsplit == 1) {
      o[((size_t)b * H + (size_t)h * G) * HD + idx] = a / fmaxf(lsum, 1e-30f);
    } else {
      rec[idx] = a;
      if (idx % HD == 0) {
        rec[G * HD + g] = mx;
        rec[G * HD + G + g] = lsum;
      }
    }
  }
  if (nsplit == 1) return;

  // ---- ticket: the block that arrives last for (row, kv head) merges the records
  __syncthreads();  // every thread's record writes precede thread 0's release
  __shared__ int is_last;
  if (threadIdx.x == 0) {
    int* t = ticket + (size_t)b * K + h;
    __threadfence();
    is_last = atomicAdd(t, 1) == nsplit - 1;
    if (is_last) {
      *t = 0;  // every block of the row has drawn: reset for the next call
      __threadfence();
    }
  }
  __syncthreads();
  if (!is_last) return;

  // the row's records, read through L2 (other blocks wrote them) 8 at a time, every
  // load of a batch issued before any is used; an online merge across batches
  constexpr int RB = 8;
  const float* recs = part + rows_base * rec_len;
  for (int idx = threadIdx.x; idx < G * HD; idx += kThreads) {
    const int g = idx / HD;
    float mx = kNegInf, lsum = 0.f, a = 0.f;
    for (int r0 = 0; r0 < nsplit; r0 += RB) {
      float mv[RB], lv[RB], av[RB];
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const bool in = r0 + u < nsplit;
        const float* rr = recs + (size_t)(in ? r0 + u : 0) * rec_len;
        mv[u] = in ? __ldcg(rr + G * HD + g) : kNegInf;
        lv[u] = in ? __ldcg(rr + G * HD + G + g) : 0.f;
        av[u] = in ? __ldcg(rr + idx) : 0.f;
      }
      float m_new = mx;
#pragma unroll
      for (int u = 0; u < RB; ++u) m_new = fmaxf(m_new, mv[u]);
      const float f = expf(mx - m_new);
      lsum *= f;
      a *= f;
#pragma unroll
      for (int u = 0; u < RB; ++u) {
        const float w = expf(mv[u] - m_new);
        lsum = fmaf(lv[u], w, lsum);
        a = fmaf(av[u], w, a);
      }
      mx = m_new;
    }
    o[((size_t)b * H + (size_t)h * G) * HD + idx] = a / fmaxf(lsum, 1e-30f);
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
  float* part;
  int* ticket;
  int B, S, H, K, chunk;
  float softcap;
};

template <typename T, int HD, int MAXG>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  static bool configured = false;
  if (!configured) {  // the most any chunk takes
    cudaError_t e = cudaFuncSetAttribute(decode_int8_kernel<T, HD, MAXG>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem_bytes(HD, MAXG, kMaxChunk));
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int nchunks = (a.S + a.chunk - 1) / a.chunk;
  const size_t smem = smem_bytes(HD, a.H / a.K, a.chunk);
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  // chunk slowest: every row's first chunks are dispatched before any row's later ones
  const dim3 grid(a.K, a.B, nchunks);
  decode_int8_kernel<T, HD, MAXG><<<grid, kThreads, smem, stream>>>(
      (const T*)a.q, a.kq, a.ks, a.vq, a.vs, a.pos, a.o, a.part, a.ticket, a.S, a.H, a.K,
      a.chunk, a.softcap, scale);
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
cudaError_t dispatch_hd(int hd, const Args& a, cudaStream_t st) {
  const int G = a.H / a.K;
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
  if (B <= 0 || S <= 0 || K <= 0 || H % K != 0 || H / K > kMaxGroup ||
      chunk < kWarps * kTile || chunk > kMaxChunk || chunk % (kWarps * kTile) != 0 ||
      (S > chunk && (!part || !ticket)) ||
      ((uintptr_t)kq | (uintptr_t)vq) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  const Args a{q,       (const int8_t*)kq, (const __half*)k_scale, (const int8_t*)vq,
               (const __half*)v_scale, (const int*)pos, (float*)o, (float*)part,
               (int*)ticket, B, S, H, K, chunk, softcap};
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(hd, a, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(hd, a, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
