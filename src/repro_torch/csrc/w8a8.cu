// w8a8 GEMM: int8 activations times int8 weights with exact int32 accumulation and
// the dequantizing epilogue fused, written for Hopper (sm_90a) in plain CUDA C++.
//
// Replaces the TPU kernel `_w8a8_kernel` in src/repro/kernels/w8a8/matmul.py (entry
// `w8a8_matmul`). Same function: out[m, n] = float(sum_k xq[m, k] * wq[k, n]) * xs[m]
// * ws[n], xq (M,K) int8, wq (K,N) int8, xs (M,) f32 per-row activation scales, ws
// (N,) f32 per-column weight scales, out (M,N) f32. The int32 sum is exact, so the
// result equals the plain version bit for bit. One layout difference: the weight is
// passed as its (N,K) row-major storage (the logical (K,N) weight stored
// column-major), so that both operands are K-contiguous, the only layout the int8
// tensor-core products take. The TPU wrapper zero-pads ragged M, N and K to its tile
// grid; this kernel masks the edges itself (zero-filled loads, guarded stores).
//
// Three kernels, chosen up front by shape in `w8a8_matmul_fwd` (never a retry):
//   - M > 16 and K % 16 == 0 with 16-byte aligned operands (prefill): `w8a8_kernel_tma`.
//     A 128 x 256 output tile per block of three warpgroups. Warpgroup 0 is the
//     producer: one thread keeps a 4-stage ring of 128-byte K tiles (128 rows of xq,
//     256 rows of the weight) filled by TMA loads into 128B-swizzled shared memory, each
//     stage completing on its "full" mbarrier; the warpgroup gives its registers back
//     (`setmaxnreg`). Warpgroups 1 and 2 each own 64 rows: per stage they issue four
//     `wgmma.m64n256k32.s32.s8.s8` from shared memory (int32 sums in 128 registers a
//     thread), keep one stage's products in flight, and release a stage on its "empty"
//     mbarrier when its products are done. Ragged M, N and K read zeros (TMA fills
//     outside the tensor). The epilogue stages the int32 tile in the freed ring and
//     stores f32 rows with 16-byte stores.
//   - M <= 16 and K % 16 == 0 with 16-byte aligned operands (decode rows):
//     `w8a8_splitk_kernel`, below. It streams the weight once.
//   - Otherwise (M <= 16, or M > 16 with a K or an alignment TMA cannot describe):
//     `w8a8_kernel`, `mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32` on tiles loaded
//     by a byte-wise loader: 16 x 16 tiles whose 4 warps split each 128-byte K tile for
//     M <= 16; 64 x 128 tiles (2 x 2 warps of 32 x 64) for M > 16.
// Every path computes (float(acc) * xs[m]) * ws[n] in that order.
//
// Bound on this card. Decode (M = 4): memory. The weight is read once, K*N bytes,
// against 2*M*K*N int operations: 8 operations per byte, far below the ~590 a byte
// at which the int8 tensor cores (1,979 TOP/s) would bound it at 3.35 TB/s; the
// least time is K*N / 3.35 TB/s. Prefill (M = 2048): operations, 2*M*K*N at
// 1,979 TOP/s, which only `wgmma` reaches (`mma.sync` runs well below it on Hopper).
//
// The decode-rows kernel. The one-block-per-16x16-tile design it replaces (N/16
// blocks, each walking all of K behind a 4-stage ring of 2 KB stages and a
// `__syncthreads` per 128-byte tile) kept ~12 KB in flight per SM and read the weight
// at ~42% of the bytes rate. Now:
//   - Split K. Block (r, t) of a (split, ceil(N/64)) grid owns 64 weight rows (output
//     columns) t*64 .. t*64+63 and K slice r: [k16*r/split, k16*(r+1)/split) in
//     16-byte units (k16 = K/16), so a slice may end inside a step. The wrapper picks
//     the split (kernels/w8a8/ops.py::splitk_plan): as many slices as keep the grid
//     within one block per SM, which measured fastest (scripts/torch_decode_plans.py).
//   - Loads straight into registers. Each of the block's 4 warps streams its 16
//     weight rows in 256-byte steps of K: a lane loads 16 bytes at k + 64*i + 16*t
//     (i = 0..3) of its rows g and g+8 (`ld.global.nc.L1::no_allocate`, 16 bytes a
//     lane, 64 contiguous bytes per row per instruction) and of its activation rows,
//     and the next step's loads are issued before this step's products, so two steps
//     (8 KB a warp) are in flight. No shared-memory ring: 1-D bulk copies of one
//     256-byte row piece each, completing on mbarriers, were tried first and streamed
//     at ~1 TB/s (a copy per row per stage is too small for the TMA unit).
//   - Products. Swap-AB `mma.sync.m16n8k32`: weight rows are the 16-row A operand and
//     the <= 16 activation rows the n8 B operand (one n8 tile for M <= 8, two for M <=
//     16), so no product is spent on padding rows of M. A lane's 16 bytes feed two k32
//     products; the k order inside them is the same permutation in A and B (both come
//     from lanes of the same t), so the sum is unchanged. Past a slice's end a lane
//     loads nothing and multiplies zeros. Memory bounds the kernel, so `mma.sync` (not
//     `wgmma`, whose 64-row A would hold the padding) is enough.
//   - Reduction across the split, in the same launch and exact: the split's blocks
//     form one thread-block cluster. Each block leaves its int32 64 x 16 partial tile
//     in shared memory; after a cluster barrier, block r adds its share of the tile
//     over all the cluster's blocks through distributed shared memory (`mapa` +
//     `ld.shared::cluster`) and writes the f32 outputs, with the scales it fetched at
//     its start; a second barrier keeps every block resident until the others have
//     read it. Integer addition makes the order irrelevant, so the result stays bit
//     for bit equal to the plain version. One launch, no workspace, no host state.
// What holds it now: ~2.5-3 us before the first weight bytes arrive and ~1.5 us of
// block skew and reduction at the end, around a stream of ~3 TB/s.
// Left for later: a persistent prefill kernel whose epilogue overlaps the next tile's
// loads.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Copy rows [r0, r0 + ROWS) x bytes [k0, k0 + BK) of a (rows, K) row-major int8
// matrix into a shared tile with row stride LDS, byte by byte (any K, any alignment);
// out-of-range bytes become 0.
template <int ROWS, int BK, int LDS>
__device__ __forceinline__ void load_tile(int8_t* dst, const int8_t* __restrict__ src,
                                          int r0, int rows, int k0, int K) {
  constexpr int W = BK / 4;
  for (int i = threadIdx.x; i < ROWS * W; i += kThreads) {
    const int r = i / W, c = i % W;
    const int gr = r0 + r, gk = k0 + c * 4;
    uint32_t word = 0;
    if (gr < rows) {
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (gk + e < K)
          word |= (uint32_t)(uint8_t)src[(size_t)gr * K + gk + e] << (8 * e);
    }
    *reinterpret_cast<uint32_t*>(dst + r * LDS + c * 4) = word;
  }
}

// Block tile BM x BN, K tile BK bytes; warps WM x WN x WK (WK warps split each K
// tile and add their partial sums at the end).
template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
__global__ void __launch_bounds__(kThreads)
w8a8_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
            const float* __restrict__ xs, const float* __restrict__ ws,
            float* __restrict__ out, int M, int N, int K) {
  static_assert(WM * WN * WK * 32 == kThreads, "4 warps");
  constexpr int LDS = BK + 16;  // padded shared row, bytes
  constexpr int TM = BM / WM, TN = BN / WN;
  constexpr int MI = TM / 16, NI = TN / 8;
  constexpr int KSUB = BK / 32;
  static_assert(TM % 16 == 0 && TN % 8 == 0 && KSUB % WK == 0, "tile shapes");
  constexpr int A_STAGE = BM * LDS, B_STAGE = BN * LDS;
  constexpr int PIPE = STAGES * (A_STAGE + B_STAGE);
  constexpr int RED = WK * BM * BN * 4;
  __shared__ __align__(16) int8_t smem[PIPE > RED ? PIPE : RED];
  int8_t* sA = smem;
  int8_t* sB = smem + STAGES * A_STAGE;

  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int wk = warp % WK, wn = (warp / WK) % WN, wm = warp / (WK * WN);
  const int g = lane >> 2, t = lane & 3;
  const int nk = (K + BK - 1) / BK;

  int acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk) {
      load_tile<BM, BK, LDS>(sA + s * A_STAGE, x, m0, M, s * BK, K);
      load_tile<BN, BK, LDS>(sB + s * B_STAGE, wt, n0, N, s * BK, K);
    }
  }

  for (int kt = 0; kt < nk; ++kt) {
    __syncthreads();  // tile kt is in; every warp is done with tile kt - 1
    const int pf = kt + STAGES - 1;
    if (pf < nk) {
      const int st = pf % STAGES;
      load_tile<BM, BK, LDS>(sA + st * A_STAGE, x, m0, M, pf * BK, K);
      load_tile<BN, BK, LDS>(sB + st * B_STAGE, wt, n0, N, pf * BK, K);
    }

    const int8_t* a_s = sA + (kt % STAGES) * A_STAGE;
    const int8_t* b_s = sB + (kt % STAGES) * B_STAGE;
#pragma unroll
    for (int ks = wk; ks < KSUB; ks += WK) {
      const int kk = ks * 32 + t * 4;
      uint32_t a[MI][4], b[NI][2];
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int8_t* p = a_s + (wm * TM + i * 16 + g) * LDS + kk;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const int8_t* p = b_s + (wn * TN + j * 8 + g) * LDS + kk;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i)
#pragma unroll
        for (int j = 0; j < NI; ++j) mma_s8(acc[i][j], a[i], b[j]);
    }
  }
  __syncthreads();  // the ring is free: reuse it for the partial sums

  int* red = reinterpret_cast<int*>(smem);  // [WK][BM][BN]
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j) {
      const int r = wm * TM + i * 16 + g, c = wn * TN + j * 8 + t * 2;
      int* p = red + (wk * BM + r) * BN + c;
      p[0] = acc[i][j][0];
      p[1] = acc[i][j][1];
      p[8 * BN] = acc[i][j][2];
      p[8 * BN + 1] = acc[i][j][3];
    }
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int m = m0 + r, n = n0 + c;
    if (m >= M || n >= N) continue;
    int sum = 0;
#pragma unroll
    for (int s = 0; s < WK; ++s) sum += red[(s * BM + r) * BN + c];
    // (float(acc) * xs) * ws, in the plain version's order
    out[(size_t)m * N + n] = __int2float_rn(sum) * xs[m] * ws[n];
  }
}

template <int BM, int BN, int BK, int WM, int WN, int WK, int STAGES>
cudaError_t launch(const int8_t* x, const int8_t* wt, const float* xs, const float* ws,
                   float* out, int M, int N, int K, cudaStream_t st) {
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  w8a8_kernel<BM, BN, BK, WM, WN, WK, STAGES>
      <<<grid, kThreads, 0, st>>>(x, wt, xs, ws, out, M, N, K);
  return cudaGetLastError();
}

// ---- M <= 16: split-K weight streaming ------------------------------------------------

constexpr int kSkBN = 64;                // weight rows (output columns) per block, 16 per warp
constexpr int kSkThreads = 128;          // 4 warps
constexpr int kSkPieces = 4;             // 16-byte pieces of a row a lane loads per step
constexpr int kSkStep = 64 * kSkPieces;  // bytes of K a warp takes per step
constexpr int kSkMaxSplit = 8;           // the portable cluster size

// 16 bytes of the weight: read once, so kept out of L1
__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// One step of K for one lane: 16 bytes at k + 64*i + 16*t (i = 0..3) of weight rows g
// and g+8 and of the MT activation rows g (+8); zeros past the slice or the matrix.
template <int MT>
struct SkStep {
  int4 wa[kSkPieces], wb[kSkPieces], xv[MT][kSkPieces];

  __device__ __forceinline__ void load(const int8_t* pa, bool ok_a, const int8_t* pb,
                                       bool ok_b, const int8_t* const (&px)[MT],
                                       const bool (&ok_x)[MT], int k, int kend) {
    const int4 zero = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int i = 0; i < kSkPieces; ++i) {
      const bool in = k + 64 * i < kend;  // kend - k is a multiple of 16, as is k + 64 i
      wa[i] = in && ok_a ? ld_stream(pa + k + 64 * i) : zero;
      wb[i] = in && ok_b ? ld_stream(pb + k + 64 * i) : zero;
#pragma unroll
      for (int j = 0; j < MT; ++j)
        xv[j][i] = in && ok_x[j] ? __ldg(reinterpret_cast<const int4*>(px[j] + k + 64 * i))
                                 : zero;
    }
  }

  // two k32 products per 16-byte piece: the k order inside a piece is the same
  // permutation in A and B (both come from lanes of the same t), so the sum is unchanged
  __device__ __forceinline__ void mma(int (&acc)[MT][4]) const {
#pragma unroll
    for (int i = 0; i < kSkPieces; ++i) {
      const uint32_t a_lo[4] = {(uint32_t)wa[i].x, (uint32_t)wb[i].x, (uint32_t)wa[i].y,
                                (uint32_t)wb[i].y};
      const uint32_t a_hi[4] = {(uint32_t)wa[i].z, (uint32_t)wb[i].z, (uint32_t)wa[i].w,
                                (uint32_t)wb[i].w};
#pragma unroll
      for (int j = 0; j < MT; ++j) {
        const uint32_t b_lo[2] = {(uint32_t)xv[j][i].x, (uint32_t)xv[j][i].y};
        const uint32_t b_hi[2] = {(uint32_t)xv[j][i].z, (uint32_t)xv[j][i].w};
        mma_s8(acc[j], a_lo, b_lo);
        mma_s8(acc[j], a_hi, b_hi);
      }
    }
  }
};

// MT n8 tiles of activation rows: 1 for M <= 8, 2 for M <= 16
template <int MT>
__global__ void __launch_bounds__(kSkThreads)
w8a8_splitk_kernel(const int8_t* __restrict__ x, const int8_t* __restrict__ wt,
                   const float* __restrict__ xs, const float* __restrict__ ws,
                   float* __restrict__ out, int M, int N, int K) {
  __shared__ __align__(16) int part[16 * kSkBN];  // [m][n] int32 partial sums
  __shared__ float sxs[16], sws[kSkBN];             // the epilogue's scales

  const int split = gridDim.x, rank = blockIdx.x;  // the cluster is the split
  const int n0 = blockIdx.y * kSkBN;
  const int rows = min(kSkBN, N - n0);
  // the scales are fetched first, into registers, so the epilogue does not wait on memory
  const int si = threadIdx.x - kSkBN;
  const float scale_r = threadIdx.x < rows ? ws[n0 + threadIdx.x] : si >= 0 && si < M ? xs[si] : 0.f;
  const int k16 = K / 16;
  const int kbeg = (int)((long long)k16 * rank / split) * 16;
  const int kend = (int)((long long)k16 * (rank + 1) / split) * 16;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, t = lane % 4;

  // this lane's rows: weight rows (A) g and g+8 of the warp's 16, activation rows (B) g
  // (+8); a row outside the matrix reads zeros
  const int na = n0 + warp * 16 + g, nb = na + 8;
  const bool ok_a = na < N, ok_b = nb < N;
  const int8_t* pa = wt + (size_t)(ok_a ? na : 0) * K + t * 16;
  const int8_t* pb = wt + (size_t)(ok_b ? nb : 0) * K + t * 16;
  const int8_t* px[MT];
  bool ok_x[MT];
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    ok_x[j] = j * 8 + g < M;
    px[j] = x + (size_t)(ok_x[j] ? j * 8 + g : 0) * K + t * 16;
  }

  int acc[MT][4];
#pragma unroll
  for (int j = 0; j < MT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0;
  // two steps in registers: the next step's loads are in flight while this one's
  // products run
  SkStep<MT> s0, s1;
  const int kend_t = kend - t * 16;  // this lane's pieces start t*16 bytes in
  const int nsteps = (kend - kbeg + kSkStep - 1) / kSkStep;
  if (nsteps > 0) s0.load(pa, ok_a, pb, ok_b, px, ok_x, kbeg, kend_t);
  for (int st = 0; st < nsteps; st += 2) {
    if (st + 1 < nsteps) s1.load(pa, ok_a, pb, ok_b, px, ok_x, kbeg + (st + 1) * kSkStep, kend_t);
    s0.mma(acc);
    if (st + 2 < nsteps) s0.load(pa, ok_a, pb, ok_b, px, ok_x, kbeg + (st + 2) * kSkStep, kend_t);
    if (st + 1 < nsteps) s1.mma(acc);
  }

  if (threadIdx.x < kSkBN)
    sws[threadIdx.x] = scale_r;
  else if (si < 16)
    sxs[si] = scale_r;
  // C fragment: rows (weight) g and g+8, columns (activation rows) 2t and 2t+1
#pragma unroll
  for (int j = 0; j < MT; ++j) {
    const int n = warp * 16 + g, m = j * 8 + t * 2;
    part[m * kSkBN + n] = acc[j][0];
    part[(m + 1) * kSkBN + n] = acc[j][1];
    part[m * kSkBN + n + 8] = acc[j][2];
    part[(m + 1) * kSkBN + n + 8] = acc[j][3];
  }

  hopper::cluster_sync();  // every block's partial tile is in its shared memory
  // block `rank` adds its share of the tile's M x 64 sums, 4 at a time, over the split
  const int quads = M * (kSkBN / 4);
  const int q_lo = quads * rank / split, q_hi = quads * (rank + 1) / split;
  for (int qi = q_lo + threadIdx.x; qi < q_hi; qi += kSkThreads) {
    int4 sum = make_int4(0, 0, 0, 0);
#pragma unroll
    for (int r = 0; r < kSkMaxSplit; ++r) {
      if (r >= split) break;
      const int4 v = hopper::ld_dsmem_v4(part + qi * 4, (uint32_t)r);
      sum.x += v.x;
      sum.y += v.y;
      sum.z += v.z;
      sum.w += v.w;
    }
    const int m = qi / (kSkBN / 4), nl = (qi % (kSkBN / 4)) * 4;
    const float sx = sxs[m];
    const int s4[4] = {sum.x, sum.y, sum.z, sum.w};
    float* o = out + (size_t)m * N + n0 + nl;
#pragma unroll
    for (int e = 0; e < 4; ++e)  // (float(acc) * xs) * ws, in the plain version's order
      if (nl + e < rows) o[e] = __int2float_rn(s4[e]) * sx * sws[nl + e];
  }
  hopper::cluster_sync();  // no block exits while another reads its shared memory
}

template <int MT>
cudaError_t launch_splitk(const int8_t* x, const int8_t* wt, const float* xs, const float* ws,
                          float* out, int M, int N, int K, int split, cudaStream_t st) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(split, (N + kSkBN - 1) / kSkBN);
  cfg.blockDim = dim3(kSkThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, w8a8_splitk_kernel<MT>, x, wt, xs, ws, out, M, N, K);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// ---- M > 16: TMA ring and wgmma ---------------------------------------------------

constexpr int kTmaBM = 128, kTmaBN = 256, kTmaBK = 128, kTmaStages = 4;
constexpr int kTmaThreads = 384;                       // producer + 2 consumer warpgroups
constexpr int kStageA = kTmaBM * kTmaBK;               // bytes
constexpr int kStageB = kTmaBN * kTmaBK;
constexpr int kEpiLd = kTmaBN + 8;                     // int32 row stride of the epilogue
constexpr size_t kTmaSmem = 1024 + (size_t)kTmaStages * (kStageA + kStageB) +
                            2 * kTmaStages * sizeof(uint64_t);
static_assert(2 * 64 * kEpiLd * 4 <= kTmaStages * (kStageA + kStageB), "epilogue fits");

__global__ void __launch_bounds__(kTmaThreads, 1)
w8a8_kernel_tma(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap wmap,
                const float* __restrict__ xs, const float* __restrict__ ws,
                float* __restrict__ out, int M, int N, int K) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* smem = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  int8_t* sA = reinterpret_cast<int8_t*>(smem);          // [stage][128 rows][128 B]
  int8_t* sB = sA + kTmaStages * kStageA;                 // [stage][256 rows][128 B]
  uint64_t* full = reinterpret_cast<uint64_t*>(sB + kTmaStages * kStageB);
  uint64_t* empty = full + kTmaStages;

  const int wg = threadIdx.x / 128, tid = threadIdx.x % 128;
  const int m0 = blockIdx.y * kTmaBM, n0 = blockIdx.x * kTmaBN;
  const int nk = (K + kTmaBK - 1) / kTmaBK;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kTmaStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);                  // every consumer thread
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (wg == 0) {  // producer
    hopper::setmaxnreg_dec<40>();
    if (tid == 0) {
      for (int kt = 0; kt < nk; ++kt) {
        const int s = kt % kTmaStages;
        hopper::mbar_wait(&empty[s], ((kt / kTmaStages) & 1) ^ 1);
        hopper::mbar_arrive_expect_tx(&full[s], kStageA + kStageB);
        hopper::tma_load_2d(sA + s * kStageA, &xmap, &full[s], kt * kTmaBK, m0);
        hopper::tma_load_2d(sB + s * kStageB, &wmap, &full[s], kt * kTmaBK, n0);
      }
    }
    return;
  }

  // consumers: warpgroup c owns rows c*64 .. c*64+63 of the tile
  hopper::setmaxnreg_inc<232>();
  const int c = wg - 1;
  int acc[kTmaBN / 2];
#pragma unroll
  for (int i = 0; i < kTmaBN / 2; ++i) acc[i] = 0;
  for (int kt = 0; kt < nk; ++kt) {
    const int s = kt % kTmaStages;
    hopper::mbar_wait(&full[s], (kt / kTmaStages) & 1);
    const int8_t* a = sA + s * kStageA + c * 64 * kTmaBK;
    const int8_t* b = sB + s * kStageB;
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < kTmaBK / 32; ++kk)
      hopper::wgmma_s8_ss_n256(acc, hopper::desc_sw128(a + kk * 32, 16, 1024),
                               hopper::desc_sw128(b + kk * 32, 16, 1024), 1);
    hopper::wgmma_commit();
    hopper::wgmma_wait<1>();  // the previous stage's products are done: release it
    if (kt > 0) hopper::mbar_arrive(&empty[(kt - 1) % kTmaStages]);
  }
  hopper::wgmma_wait<0>();
  hopper::fence_regs(acc);

  // epilogue: both consumers are done with the ring; stage the int32 tile there
  hopper::named_sync(1, 256);
  hopper::fence_proxy_async();
  int* tile = reinterpret_cast<int*>(smem) + c * 64 * kEpiLd;
  const int warp = tid / 32, lane = tid % 32, g = lane / 4, t = lane % 4;
#pragma unroll
  for (int j = 0; j < kTmaBN / 8; ++j) {
    int* p = tile + (warp * 16 + g) * kEpiLd + j * 8 + t * 2;
    p[0] = acc[4 * j];
    p[1] = acc[4 * j + 1];
    p[8 * kEpiLd] = acc[4 * j + 2];
    p[8 * kEpiLd + 1] = acc[4 * j + 3];
  }
  hopper::named_sync(2 + c, 128);
  const bool vec_out = N % 4 == 0 && (reinterpret_cast<uintptr_t>(out) & 15) == 0;
  for (int idx = tid; idx < 64 * (kTmaBN / 4); idx += 128) {
    const int row = idx / (kTmaBN / 4), c4 = idx % (kTmaBN / 4);
    const int m = m0 + c * 64 + row, n = n0 + c4 * 4;
    if (m >= M || n >= N) continue;
    const int4 v = *reinterpret_cast<const int4*>(tile + row * kEpiLd + c4 * 4);
    const float sx = xs[m];
    float* o = out + (size_t)m * N + n;
    // (float(acc) * xs) * ws, in the plain version's order
    if (vec_out && n + 3 < N) {
      *reinterpret_cast<float4*>(o) =
          make_float4(__int2float_rn(v.x) * sx * ws[n], __int2float_rn(v.y) * sx * ws[n + 1],
                      __int2float_rn(v.z) * sx * ws[n + 2], __int2float_rn(v.w) * sx * ws[n + 3]);
    } else {
      const int e4[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int e = 0; e < 4; ++e)
        if (n + e < N) o[e] = __int2float_rn(e4[e]) * sx * ws[n + e];
    }
  }
}

cudaError_t launch_tma(const int8_t* x, const int8_t* wt, const float* xs, const float* ws,
                       float* out, int M, int N, int K, cudaStream_t st) {
  static bool configured = false;
  if (!configured) {
    cudaError_t e = cudaFuncSetAttribute(
        w8a8_kernel_tma, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)kTmaSmem);
    if (e != cudaSuccess) return e;
    configured = true;
  }
  CUtensorMap xmap, wmap;
  cudaError_t e = hopper::make_map<2>(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, x,
                                      {(uint64_t)K, (uint64_t)M}, {(uint64_t)K},
                                      {(uint32_t)kTmaBK, (uint32_t)kTmaBM});
  if (e != cudaSuccess) return e;
  e = hopper::make_map<2>(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, wt,
                          {(uint64_t)K, (uint64_t)N}, {(uint64_t)K},
                          {(uint32_t)kTmaBK, (uint32_t)kTmaBN});
  if (e != cudaSuccess) return e;
  const dim3 grid((N + kTmaBN - 1) / kTmaBN, (M + kTmaBM - 1) / kTmaBM);
  w8a8_kernel_tma<<<grid, kTmaThreads, kTmaSmem, st>>>(xmap, wmap, xs, ws, out, M, N, K);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// xq (M,K) int8 row-major; wq_t (N,K) int8 row-major (the (K,N) weight stored
// column-major); xs (M,) f32; ws (N,) f32; out (M,N) f32. All on the device,
// contiguous. `split` (1 .. 8) is the number of K slices of the decode-rows kernel
// (kernels/w8a8/ops.py::splitk_plan); the other kernels do not read it. Launches on
// `stream` and returns cudaGetLastError() (0 = launched).
int w8a8_matmul_fwd(const void* xq, const void* wq_t, const void* xs, const void* ws,
                    void* out, int M, int N, int K, int split, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || split < 1 || split > kSkMaxSplit)
    return (int)cudaErrorInvalidValue;
  const int8_t* x = (const int8_t*)xq;
  const int8_t* wt = (const int8_t*)wq_t;
  const bool vec = K % 16 == 0 && ((uintptr_t)x % 16 == 0) && ((uintptr_t)wt % 16 == 0);
  cudaStream_t st = (cudaStream_t)stream;
  const float* a = (const float*)xs;
  const float* b = (const float*)ws;
  float* o = (float*)out;
  cudaError_t e;
  if (M <= 16 && vec)  // bulk copies take it: 16-byte row strides and aligned bases
    e = M <= 8 ? launch_splitk<1>(x, wt, a, b, o, M, N, K, split, st)
               : launch_splitk<2>(x, wt, a, b, o, M, N, K, split, st);
  else if (M <= 16)
    e = launch<16, 16, 128, 1, 1, 4, 4>(x, wt, a, b, o, M, N, K, st);
  else if (vec)  // TMA describes it: 16-byte row strides and aligned bases
    e = launch_tma(x, wt, a, b, o, M, N, K, st);
  else
    e = launch<64, 128, 64, 2, 2, 1, 3>(x, wt, a, b, o, M, N, K, st);
  return (int)e;
}

const char* error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
