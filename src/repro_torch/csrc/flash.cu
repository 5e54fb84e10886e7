// Flash attention for prefill, written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_flash_kernel` in src/repro/kernels/flash_attn/flash.py
// (entry `flash_attention`, padded wrapper `ops.py::flash_attn`). Same function:
// q (B,S,H,hd) against k, v (B,T,K,hd) with GQA (G = H/K query heads share a kv
// head), causal or not, an optional sliding window, an optional logit softcap and
// a per-row valid key length `lens` (B,). Online softmax (m, l, acc) in f32; a row
// whose keys are all masked gives 0. Output (B,S,H,hd) in the input type.
//
// Prefill chunks (the JAX package's chunk path, src/repro/models/attention.py:366-387,
// which attends in jnp) come through the same two kernels with two optional (B,)
// int32 arrays. `q_off`: query i of row b sits at absolute position q_off[b] + i, so
// the causal frontier, the window and the tile range all shift by q_off[b] (key j is
// visible iff j <= q_off[b] + i, j < lens[b], and within the window). `kv_rows`: row b
// reads K/V row kv_rows[b] of a k, v whose batch extent Bk may differ from B, so a
// chunk group attends the engine's whole (slots, max_len, K, hd) cache in place, with
// no gather. A null pointer means offset 0 and row b. A kv row outside [0, Bk) reads
// no key and gives 0 (the tensor-core kernel loads zero tiles there: TMA fills a box
// outside the tensor with zeros; a guard in that kernel cost 15% at the chunk shape,
// scripts/torch_flash_chunks.py).
//
// Rows. A "row" is one (query position, group head) pair: flattened row r = s*G + g,
// so all G heads that share a kv head are served by the same K/V tiles. A block
// owns one (batch, kv head, tile of rows) and loops over the kv tiles from the
// window's left edge to its last row's causal frontier and lens[b]; tiles past
// either are never loaded. The kernel masks the ragged S and T edges itself (the
// TPU wrapper pads to its block grid instead).
//
// Two kernels, chosen up front by shape in `dispatch_hd`:
//   - bf16 at hd 64, 128 and 256, any G up to 128, 16-byte aligned tensors (the
//     serving path): `flash_fwd_kernel_tma`, on the tensor cores. 128 rows per block:
//     P = 128/G (rounded down) whole query positions of the G heads, R = P*G real
//     rows. Where G does not divide 128, rows R..127 are padding: zeroed, never
//     stored, given the tile's last real position (so no mask or key range widens),
//     and they cost their share of the products: 2/128 at G 6 (dbrx-132b), 8/128 at
//     G 12 (command-r-plus), 63/128 at G 65 (the worst). Three warpgroups.
//     Warpgroup 0 is the producer: one thread loads the Q tile (R rows) once and
//     streams K/V tiles of KEYS keys (128; 64 at hd 256) through a 2-stage ring,
//     all by TMA into 128B-swizzled shared memory (hd = 128 or 256 as two or four
//     64-column boxes), each stage completing on its "full" mbarrier and freed on its
//     "empty" one. Warpgroups 1 and 2 own 64 rows each: S = Q K^T by
//     `wgmma.m64n{KEYS}k16` with both operands in shared memory; the
//     online softmax on the accumulator fragments in registers (a row lives in the 4
//     threads of a quad: two shuffles per reduction; masks only on tiles that cross
//     the lens, causal or window edge); P converted to bf16 in registers and used as
//     the register A operand of `wgmma.m64n{hd}k16` against V in shared memory with the
//     transpose bit (V is stored MN-major; at hd 256 two N-128 products, one per half
//     of the head); O rescaled in registers; the epilogue
//     stages bf16 O in the block's own Q rows and stores 16-byte chunks. The row tiles
//     with the most keys launch first.
//     hd 256 (gemma-2b: 16 query heads over one kv head, so a block is 8 query
//     positions x 16 heads) takes 64-key tiles: at 128 keys, Q (64 KB) and two
//     stages of K and V (4 x 64 KB) would need 320 KB of shared memory; at 64 keys
//     they take 192 KB. Each consumer thread then holds 128 output floats and 32
//     scores (`setmaxnreg` gives it 232 registers).
//     Where the numbers depart from the TPU kernel: that kernel casts q, k and v to
//     f32. Q K^T on bf16 inputs with f32 sums differs from it only in the order of the
//     sums (a product of two bf16 values is exact in f32). P is rounded to bf16 for the
//     P V product, where the TPU kernel keeps it in f32: a relative error up to 2^-9
//     per weight, inside the bf16 tolerance of 2e-2. The row sum l adds the f32 P.
//   - f32 at any hd, and bf16 at hd 16 and 32, G above 128 or a tensor not on 16
//     bytes:
//     `flash_fwd_kernel` on the CUDA cores. 64 rows per block, 4 warps; Q and a
//     32-key K/V tile in shared memory as f32 (rows padded by one float), thread
//     (ty, tx) owns rows ty*4..+3 and output columns tx + 8*c, scores reduced across
//     the 8 column lanes of a row with warp shuffles. f32 stays off the tensor cores:
//     TF32 products would not reliably meet its 2e-3 tolerance. At hd 256 its shared
//     memory is 140 KB (Q and the K/V tile padded by one float a row) and each thread
//     holds 4 x 32 output floats.
//
// Bound on this card: at the main path's prefill shapes (S = T = 512, hd = 128,
// bf16) the work is 4*S*T*H*hd/2 FLOPs against Q+K+V+O bytes, about 180 FLOPs per
// byte, below the ~295 at which the bf16 tensor cores (989 TFLOP/s) bound it, so the
// least time is the bytes at 3.35 TB/s; with lens (512, 300, 77, 1) little work is
// left per block and the tile's latency (load, two products, softmax in series)
// bounds the kernel. A prefill chunk is the same: at deepseek-7b's chunk call (4 rows
// of 128 queries at offsets 384, 128, 0, 256) the bytes bound it at 7.89 us, and each
// of its 128 blocks walks 1 to 4 key tiles in series (23 us on an H100 80GB HBM3 at
// 700 W, PERF.md). A long prefill is bound by its operations: dbrx-132b's (B 4,
// S = T = 4096, lens (4096, 3900, 2100, 300), 48 heads over 8 kv heads, G 6) needs
// 605 us of bf16 tensor-core time for the (query, key) pairs its mask keeps; its
// tiles of 126 real rows do 128/126 of that work. Left for later: overlapping one
// tile's softmax with the next tile's products (two tiles in flight per warpgroup)
// and splitting long rows' key range across blocks.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#include <cmath>
#include <type_traits>

#include "hopper.cuh"

namespace {

constexpr int kRows = 64;      // flattened (query, group-head) rows per block
constexpr int kBk = 32;        // keys per K/V tile
constexpr int kThreads = 128;  // 16 row groups x 8 column lanes
constexpr int kColsPerThread = kBk / 8;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// reduce across the 8 lanes (tx = lane & 7) that share one row
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 1; off < 8; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr size_t smem_bytes() {
  return sizeof(float) * ((size_t)kRows * (HD + 1) + 2 * (size_t)kBk * (HD + 1) +
                          (size_t)kRows * (kBk + 1));
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                 const int* __restrict__ lens, const int* __restrict__ q_off,
                 const int* __restrict__ kv_rows, T* __restrict__ o, int Bk, int S, int T_,
                 int H, int K, int causal, int window, float softcap, float scale) {
  constexpr int LD = HD + 1;            // padded smem row stride for Q, K, V
  constexpr int LP = kBk + 1;           // padded smem row stride for P
  constexpr int CPT = HD / 8;           // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;                     // [kRows][LD]
  float* ks = qs + kRows * LD;          // [kBk][LD]
  float* vs = ks + kBk * LD;            // [kBk][LD]
  float* ps = vs + kBk * LD;            // [kRows][LP]

  const int G = H / K;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = blockIdx.x * kRows;    // first flattened row of this block
  const int n_rows = S * G;
  const int tid = threadIdx.x;
  const int ty = tid >> 3, tx = tid & 7;

  // Q tile; rows past the ragged S edge load zeros and are never stored
  for (int i = tid; i < kRows * HD; i += kThreads) {
    const int row = i / HD, d = i % HD, r = r0 + row;
    float val = 0.f;
    if (r < n_rows) {
      const int s = r / G, g = r % G;
      val = to_f(q[(((size_t)b * S + s) * H + h * G + g) * HD + d]);
    }
    qs[row * LD + d] = val;
  }

  // key range this block needs: from the window's left edge to the causal
  // frontier of its last row, and never past lens[b]; positions are absolute
  // (shifted by the row's query offset)
  const int qoff = q_off ? q_off[b] : 0;
  const int kb = kv_rows ? kv_rows[b] : b;
  const bool bad_row = kb < 0 || kb >= Bk;
  const int len_b = bad_row ? 0 : min(lens[b], T_);
  const int q_first = qoff + r0 / G;
  const int q_last = qoff + (min(r0 + kRows, n_rows) - 1) / G;
  int k_end = len_b;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_first - window + 1) / kBk) * kBk;

  int qpos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) qpos[i] = qoff + (r0 + ty * 4 + i) / G;

  float m[4], l[4], acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBk) {
    __syncthreads();  // the previous tile's K, V and P are no longer read
    for (int i = tid; i < kBk * HD; i += kThreads) {
      const int row = i / HD, d = i % HD, t = k0 + row;
      float kv = 0.f, vv = 0.f;
      if (t < T_) {
        const size_t at = (((size_t)kb * T_ + t) * K + h) * HD + d;
        kv = to_f(k[at]);
        vv = to_f(v[at]);
      }
      ks[row * LD + d] = kv;
      vs[row * LD + d] = vv;
    }
    __syncthreads();

    // S = Q K^T for this thread's 4 rows x 4 columns
    float sc[4][kColsPerThread];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) sc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < HD; ++d) {
      float qv[4], kv[kColsPerThread];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) kv[j] = ks[(tx + 8 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kColsPerThread; ++j) sc[i][j] = fmaf(qv[i], kv[j], sc[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok[kColsPerThread];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const int kpos = k0 + tx + 8 * j;
        float s = sc[i][j] * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
        ok[j] = kpos < len_b && (!causal || kpos <= qpos[i]) &&
                (window <= 0 || qpos[i] - kpos < window);
        sc[i][j] = ok[j] ? s : kNegInf;
        mx = fmaxf(mx, sc[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPerThread; ++j) {
        const float p = ok[j] ? expf(sc[i][j] - m_new) : 0.f;
        ps[(ty * 4 + i) * LP + tx + 8 * j] = p;
        rs += p;
      }
      l[i] = l[i] * alpha + row_sum(rs);
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < CPT; ++c) acc[i][c] *= alpha;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int j = 0; j < kBk; ++j) {
      float vv[CPT];
#pragma unroll
      for (int c = 0; c < CPT; ++c) vv[c] = vs[j * LD + tx + 8 * c];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float p = ps[(ty * 4 + i) * LP + j];
#pragma unroll
        for (int c = 0; c < CPT; ++c) acc[i][c] = fmaf(p, vv[c], acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = r0 + ty * 4 + i;
    if (r >= n_rows) continue;
    const int s = r / G, g = r % G;
    const float denom = fmaxf(l[i], 1e-30f);
    T* out = o + (((size_t)b * S + s) * H + h * G + g) * HD;
#pragma unroll
    for (int c = 0; c < CPT; ++c) out[tx + 8 * c] = from_f<T>(acc[i][c] / denom);
  }
}

template <typename T, int HD>
cudaError_t launch(const void* q, const void* k, const void* v, const int* lens,
                   const int* q_off, const int* kv_rows, void* o, int B, int Bk, int S, int T_,
                   int H, int K, int causal, int window, float softcap, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<HD>();
  static bool configured = false;  // one attribute call per instantiation
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int G = H / K;
  dim3 grid((S * G + kRows - 1) / kRows, K, B);
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem, stream>>>(
      (const T*)q, (const T*)k, (const T*)v, lens, q_off, kv_rows, (T*)o, Bk, S, T_, H, K,
      causal, window, softcap, scale);
  return cudaGetLastError();
}

// ---- bf16, hd 64 and 128: TMA ring and wgmma ------------------------------------

constexpr int kFaRows = 128;        // flattened rows per block: 2 consumer warpgroups x 64
constexpr int kFaStages = 2;
constexpr int kFaThreads = 384;     // producer + 2 consumer warpgroups
constexpr int kBox = 128 * 128;     // one 64-column bf16 box of the 128 Q rows, bytes
                                    // (the stride between boxes: R rows are loaded)
constexpr float kLog2e = 1.4426950408889634f;

// keys per K/V tile: 128, and 64 at hd 256, where the Q tile (64 KB) and two stages
// of 128-key K and V tiles (256 KB) would not fit the block's 227 KB
template <int HD>
__host__ __device__ constexpr int fa_keys() {
  return HD == 256 ? 64 : 128;
}

// the Q tile, then kFaStages K and V tiles of fa_keys<HD>() rows, each HD / 64 boxes
// of 128-byte rows; the barriers after them
template <int HD>
constexpr size_t tma_smem_bytes() {
  return 1024 + (size_t)(HD / 64) * (kBox + 2 * kFaStages * fa_keys<HD>() * 128) +
         (2 * kFaStages + 1) * sizeof(uint64_t);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// OFFSETS: whether q_off / kv_rows may be given. The kernel without them compiles
// as it did before chunks: with the offset logic in, even with null pointers, the
// main prefill shape ran 12% slower (scripts/torch_flash_chunks.py).
template <int HD, bool OFFSETS>
__global__ void __launch_bounds__(kFaThreads, 1)
flash_fwd_kernel_tma(const __grid_constant__ CUtensorMap qmap,
                     const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const int* __restrict__ lens,
                     const int* __restrict__ q_off, const int* __restrict__ kv_rows,
                     __nv_bfloat16* __restrict__ o, int Bk, int S, int T_, int H, int K,
                     int causal, int window, float softcap, float scale) {
  constexpr int HALVES = HD / 64;               // 64-column boxes of a row
  constexpr int KEYS = fa_keys<HD>();           // keys per K/V tile
  constexpr int Q_BYTES = HALVES * kBox;        // the Q tile
  constexpr int KV_BOX = KEYS * 128;            // one box of a K or V tile
  constexpr int KV_BYTES = HALVES * KV_BOX;     // one K or V tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));  // [box][row][128 B]
  uint8_t* sK = sQ + Q_BYTES;                             // [stage][box][key][128 B]
  uint8_t* sV = sK + kFaStages * KV_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(sV + kFaStages * KV_BYTES);
  uint64_t* empty = full + kFaStages;
  uint64_t* qbar = empty + kFaStages;

  const int G = H / K;
  // a tile is P whole query positions of all G heads: R = P * G real rows of the
  // block's 128; rows R..127 are padding (none where G divides 128)
  const int P = kFaRows / G, R = P * G;
  const int h = blockIdx.x, b = blockIdx.y;
  const int r0 = (gridDim.z - 1 - blockIdx.z) * R;  // last row tiles (most keys) first
  const int n_rows = S * G;
  // absolute positions: the row's query offset shifts the causal frontier, the
  // window and the tile range; the Q tile itself is loaded at its local row q_lo
  const int qoff = OFFSETS && q_off ? q_off[b] : 0;
  const int kb = OFFSETS && kv_rows ? kv_rows[b] : b;  // outside [0, Bk): zero tiles
  const int len_b = min(lens[b], T_);
  const int q_lo = r0 / G;
  const int q_first = qoff + q_lo;
  const int q_last = qoff + (min(r0 + R, n_rows) - 1) / G;  // the last real row's
  int k_end = len_b;
  if (causal) k_end = min(k_end, q_last + 1);
  int k_begin = 0;
  if (window > 0) k_begin = (max(0, q_first - window + 1) / KEYS) * KEYS;
  const int n_kv = k_end > k_begin ? (k_end - k_begin + KEYS - 1) / KEYS : 0;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kFaStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);       // every consumer thread
    }
    hopper::mbar_init(qbar, 1);
    hopper::mbar_fence_init();
  }
  // TMA writes rows 0..R-1 of the Q tile alone; the pad rows are zeroed so that the
  // products never read stale shared memory (their scores stay finite), and fenced
  // for the async proxy that wgmma reads through
  if (R < kFaRows) {
    constexpr int CHUNKS = 128 / 16;  // 16-byte chunks of a 128-byte row
    const int pad = (kFaRows - R) * CHUNKS;
    for (int i = threadIdx.x; i < HALVES * pad; i += kFaThreads)
      *reinterpret_cast<uint4*>(sQ + (i / pad) * kBox + R * 128 + (i % pad) * 16) =
          make_uint4(0u, 0u, 0u, 0u);
    hopper::fence_proxy_async();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 0 && n_kv > 0) {
      hopper::mbar_arrive_expect_tx(qbar, HALVES * R * 128);  // the box's own bytes
      for (int hf = 0; hf < HALVES; ++hf)
        hopper::tma_load_5d(sQ + hf * kBox, &qmap, qbar, hf * 64, 0, h, q_lo, b);
      for (int i = 0; i < n_kv; ++i) {
        const int s = i % kFaStages, k0 = k_begin + i * KEYS;
        hopper::mbar_wait(&empty[s], ((i / kFaStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], 2 * KV_BYTES);
        for (int hf = 0; hf < HALVES; ++hf) {
          hopper::tma_load_4d(sK + s * KV_BYTES + hf * KV_BOX, &kmap, &full[s], hf * 64, h, k0, kb);
          hopper::tma_load_4d(sV + s * KV_BYTES + hf * KV_BOX, &vmap, &full[s], hf * 64, h, k0, kb);
        }
      }
    }
    return;
  }

  // consumers: warpgroup c owns block rows c*64 .. c*64+63; this thread rows ra, ra + 8
  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  const int warp = tid / 32, lane = tid % 32, t = lane % 4;
  const int ra = c * 64 + warp * 16 + lane / 4;
  // a pad row takes the position of the tile's last real row: it widens no mask
  const int qpos[2] = {qoff + (r0 + min(ra, R - 1)) / G, qoff + (r0 + min(ra + 8, R - 1)) / G};
  const float qk_scale = scale * kLog2e;      // scores in the log2 domain

  float acc[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) acc[i] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (n_kv > 0) hopper::mbar_wait(qbar, 0);

  for (int i = 0; i < n_kv; ++i) {
    const int s = i % kFaStages, k0 = k_begin + i * KEYS;
    hopper::mbar_wait(&full[s], (i / kFaStages) & 1);

    // S = Q K^T: 64 rows x KEYS keys, f32
    float sc[KEYS / 2];
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int hf = kk / 4, off = (kk % 4) * 32;
      const uint64_t da = hopper::desc_sw128(sQ + hf * kBox + c * 64 * 128 + off, 16, 1024);
      const uint64_t db = hopper::desc_sw128(sK + s * KV_BYTES + hf * KV_BOX + off, 16, 1024);
      if constexpr (KEYS == 128)
        hopper::wgmma_bf16_ss_n128(sc, da, db, kk > 0);
      else
        hopper::wgmma_bf16_ss_n64(sc, da, db, kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(sc);

    // scale, softcap and mask; sc[4j + e] is row ra + 8*(e/2), key k0 + 8j + 2t + e%2
    const bool edge = k0 + KEYS > len_b || (causal && k0 + KEYS - 1 > q_first) ||
                      (window > 0 && q_last - k0 >= window);
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = sc[4 * j + e];
        x = softcap > 0.f ? softcap * tanhf(x * scale / softcap) * kLog2e : x * qk_scale;
        if (edge) {
          const int kpos = k0 + 8 * j + 2 * t + (e & 1), qp = qpos[e / 2];
          const bool ok = kpos < len_b && (!causal || kpos <= qp) &&
                          (window <= 0 || qp - kpos < window);
          if (!ok) x = -INFINITY;
        }
        sc[4 * j + e] = x;
        mx[e / 2] = fmaxf(mx[e / 2], x);
      }
    float alpha[2], base[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 1));
      mx[rr] = fmaxf(mx[rr], __shfl_xor_sync(0xffffffffu, mx[rr], 2));
      const float m_new = fmaxf(m[rr], mx[rr]);
      base[rr] = m_new == -INFINITY ? 0.f : m_new;     // a row with no key yet
      alpha[rr] = exp2f(m[rr] - base[rr]);
      m[rr] = m_new;
      l[rr] *= alpha[rr];
    }
    // P = exp2(S - m) as the register A operand, 16 keys per k-step
    uint32_t pa[KEYS / 16][4];
#pragma unroll
    for (int j = 0; j < KEYS / 8; ++j) {
      const float p0 = exp2f(sc[4 * j] - base[0]), p1 = exp2f(sc[4 * j + 1] - base[0]);
      const float p2 = exp2f(sc[4 * j + 2] - base[1]), p3 = exp2f(sc[4 * j + 3] - base[1]);
      l[0] += p0 + p1;
      l[1] += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
#pragma unroll
    for (int j = 0; j < HD / 8; ++j) {
      acc[4 * j] *= alpha[0];
      acc[4 * j + 1] *= alpha[0];
      acc[4 * j + 2] *= alpha[1];
      acc[4 * j + 3] *= alpha[1];
    }

    // O += P V; V (keys x hd) is MN-major: 8 keys to a 1024-byte group, 64-column
    // boxes KV_BOX apart; at hd 256 one N-128 product per half of the head (columns
    // 0-127 in acc[0..63], 128-255 in acc[64..127], the fragment order the epilogue
    // reads)
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < KEYS / 16; ++kk) {
      const uint8_t* vk = sV + s * KV_BYTES + kk * 16 * 128;
      if constexpr (HD == 256) {
#pragma unroll
        for (int n = 0; n < 2; ++n)
          hopper::wgmma_bf16_rs_n128(*reinterpret_cast<float(*)[64]>(acc + 64 * n), pa[kk],
                                     hopper::desc_sw128(vk + 2 * n * KV_BOX, KV_BOX, 1024), 1);
      } else if constexpr (HD == 128) {
        hopper::wgmma_bf16_rs_n128(acc, pa[kk], hopper::desc_sw128(vk, KV_BOX, 1024), 1);
      } else {
        hopper::wgmma_bf16_rs_n64(acc, pa[kk], hopper::desc_sw128(vk, KV_BOX, 1024), 1);
      }
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);
  }

  // epilogue: O / l in bf16, staged in this warpgroup's own (swizzled) Q rows
  float inv[2];
#pragma unroll
  for (int rr = 0; rr < 2; ++rr) {
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 1);
    l[rr] += __shfl_xor_sync(0xffffffffu, l[rr], 2);
    inv[rr] = l[rr] > 0.f ? 1.f / l[rr] : 0.f;
  }
  hopper::named_sync(2 + c, 128);   // every product of this warpgroup has read its Q rows
  hopper::fence_proxy_async();
#pragma unroll
  for (int j = 0; j < HD / 8; ++j) {
    const int col = 8 * j + 2 * t, hf = col / 64, chunk = (col % 64) / 8;
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const int row = ra + 8 * rr;
      uint8_t* p = sQ + hf * kBox + row * 128 + ((chunk ^ (row % 8)) * 16) + (col % 8) * 2;
      *reinterpret_cast<uint32_t*>(p) =
          pack_bf16(acc[4 * j + 2 * rr] * inv[rr], acc[4 * j + 2 * rr + 1] * inv[rr]);
    }
  }
  hopper::named_sync(2 + c, 128);
  for (int idx = tid; idx < 64 * (HD / 8); idx += 128) {
    const int row = c * 64 + idx / (HD / 8), cc = idx % (HD / 8);
    const int r = r0 + row;
    if (row >= R || r >= n_rows) continue;  // a pad row's r is the next tile's first row
    const int sq = r / G, g = r % G, hf = cc / 8, chunk = cc % 8;
    const uint4 v = *reinterpret_cast<const uint4*>(sQ + hf * kBox + row * 128 +
                                                    ((chunk ^ (row % 8)) * 16));
    *reinterpret_cast<uint4*>(o + (((size_t)b * S + sq) * H + h * G + g) * HD + cc * 8) = v;
  }
}

template <int HD, bool OFFSETS>
cudaError_t launch_tma(const void* q, const void* k, const void* v, const int* lens,
                       const int* q_off, const int* kv_rows, void* o, int B, int Bk, int S,
                       int T_, int H, int K, int causal, int window, float softcap,
                       cudaStream_t stream) {
  constexpr size_t smem = tma_smem_bytes<HD>();
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel_tma<HD, OFFSETS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  const int G = H / K;
  const uint64_t e2 = sizeof(__nv_bfloat16);
  CUtensorMap qmap, kmap, vmap;
  // q as (B, S, K, G, hd): a box is G heads x P = 128/G (rounded down) positions,
  // P * G flattened rows; positions past S fill with zeros
  const int P = kFaRows / G;
  cudaError_t e = hopper::make_map<5>(
      &qmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, q,
      {(uint64_t)HD, (uint64_t)G, (uint64_t)K, (uint64_t)S, (uint64_t)B},
      {HD * e2, (uint64_t)G * HD * e2, (uint64_t)H * HD * e2, (uint64_t)S * H * HD * e2},
      {64u, (uint32_t)G, 1u, (uint32_t)P, 1u});
  if (e != cudaSuccess) return e;
  const void* kv[2] = {k, v};
  CUtensorMap* maps[2] = {&kmap, &vmap};
  // k, v as (Bk, T, K, hd): a chunk's row b loads its tiles at batch coordinate
  // kv_rows[b]; keys past T_ fill with zeros (and are masked)
  for (int i = 0; i < 2; ++i) {
    e = hopper::make_map<4>(maps[i], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, kv[i],
                            {(uint64_t)HD, (uint64_t)K, (uint64_t)T_, (uint64_t)Bk},
                            {HD * e2, (uint64_t)K * HD * e2, (uint64_t)T_ * K * HD * e2},
                            {64u, 1u, (uint32_t)fa_keys<HD>(), 1u});
    if (e != cudaSuccess) return e;
  }
  dim3 grid(K, B, (S + P - 1) / P);
  const float scale = (float)(1.0 / std::sqrt((double)HD));  // hd ** -0.5
  flash_fwd_kernel_tma<HD, OFFSETS><<<grid, kFaThreads, smem, stream>>>(
      qmap, kmap, vmap, lens, q_off, kv_rows, (__nv_bfloat16*)o, Bk, S, T_, H, K, causal,
      window, softcap, scale);
  return cudaGetLastError();
}

// the TMA kernel takes bf16 at hd 64, 128 and 256 for G up to its 128-row tile when
// every tensor starts on 16 bytes
bool takes_tma(int hd, int G, const void* q, const void* k, const void* v, const void* o) {
  const uintptr_t any = (uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o;
  return (hd == 64 || hd == 128 || hd == 256) && G <= kFaRows && any % 16 == 0;
}

template <int HD>
cudaError_t launch_tma_hd(const void* q, const void* k, const void* v, const int* lens,
                          const int* q_off, const int* kv_rows, void* o, int B, int Bk, int S,
                          int T_, int H, int K, int causal, int window, float softcap,
                          cudaStream_t st) {
  if (q_off != nullptr || kv_rows != nullptr)
    return launch_tma<HD, true>(q, k, v, lens, q_off, kv_rows, o, B, Bk, S, T_, H, K, causal,
                                window, softcap, st);
  return launch_tma<HD, false>(q, k, v, lens, q_off, kv_rows, o, B, Bk, S, T_, H, K, causal,
                               window, softcap, st);
}

template <typename T>
cudaError_t dispatch_hd(int hd, const void* q, const void* k, const void* v, const int* lens,
                        const int* q_off, const int* kv_rows, void* o, int B, int Bk, int S,
                        int T_, int H, int K, int causal, int window, float softcap,
                        cudaStream_t st) {
#define FLASH_ARGS q, k, v, lens, q_off, kv_rows, o, B, Bk, S, T_, H, K, causal, window, softcap, st
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (takes_tma(hd, H / K, q, k, v, o)) {
      switch (hd) {
        case 64: return launch_tma_hd<64>(FLASH_ARGS);
        case 128: return launch_tma_hd<128>(FLASH_ARGS);
        case 256: return launch_tma_hd<256>(FLASH_ARGS);
      }
    }
  }
  switch (hd) {
    case 16: return launch<T, 16>(FLASH_ARGS);
    case 32: return launch<T, 32>(FLASH_ARGS);
    case 64: return launch<T, 64>(FLASH_ARGS);
    case 128: return launch<T, 128>(FLASH_ARGS);
    case 256: return launch<T, 256>(FLASH_ARGS);
    default: return cudaErrorInvalidValue;
  }
#undef FLASH_ARGS
}

}  // namespace

extern "C" {

// q (B,S,H,hd), k/v (Bk,T,K,hd), o (B,S,H,hd): contiguous, all float32 (dtype 0)
// or all bfloat16 (dtype 1); lens (B,) int32 on the device; q_off and kv_rows (B,)
// int32 on the device or null (offset 0, row b; Bk == B then). Launches on `stream`
// and returns cudaGetLastError() (0 = launched).
int flash_attn_fwd(const void* q, const void* k, const void* v, const void* lens,
                   const void* q_off, const void* kv_rows, void* o, int B, int Bk, int S, int T,
                   int H, int K, int hd, int causal, int window, float softcap, int dtype,
                   void* stream) {
  if (B <= 0 || Bk <= 0 || S <= 0 || T <= 0 || K <= 0 || H % K != 0 ||
      (kv_rows == nullptr && Bk != B))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const int* ln = (const int*)lens;
  const int* qo = (const int*)q_off;
  const int* kr = (const int*)kv_rows;
  cudaError_t e;
  if (dtype == 0)
    e = dispatch_hd<float>(hd, q, k, v, ln, qo, kr, o, B, Bk, S, T, H, K, causal, window,
                           softcap, st);
  else if (dtype == 1)
    e = dispatch_hd<__nv_bfloat16>(hd, q, k, v, ln, qo, kr, o, B, Bk, S, T, H, K, causal,
                                   window, softcap, st);
  else
    e = cudaErrorInvalidValue;
  return (int)e;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
