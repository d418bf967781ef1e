// Fused UC-NeRF MLP forward for Hopper (sm_90a), bound with ctypes.
//
// Replaces ucnerf_tpu/pallas/mlp_kernel.py::fused_nerf_mlp (the one Pallas
// kernel of the JAX package).  Per tile of points it computes, without any
// intermediate reaching device memory:
//   PE(pts, L=10) and PE(dirs, L=4);
//   depth_bias = Linear([mvs 24 | colours 4(V-1)]); feats_bias = Linear(img
//   feats 8(V-1)); a 6-layer trunk relu(Linear(h) * depth_bias) with the
//   PE(pts) skip concat after layer 4; the base rgb / alpha heads; the
//   adaptive branch Linear(h * feats_bias) ++ PE(dirs) -> two 64-wide heads;
//   the blend rgb = sigmoid(base(1-u) + adapt u), alpha = relu(adapt(1-u) +
//   base u), u = 1 - confidence.
//
// What bounds it: the arithmetic.  At V=7 a point costs 147,328 MACs against
// 408 input bytes (about 720 FLOP per byte, over the card's ~295 bf16 FLOP per
// byte of device memory), so the tensor cores are the limit in bf16 and the
// FP32 pipes in f32.
//
// bf16 (the main path), what the design does about it:
// - A warp owns 16 points for the whole chain and runs every layer on the
//   tensor cores with mma.sync m16n8k16 (bf16 operands, f32 accumulation).
//   The accumulator of n-tiles 2j, 2j+1 is, element for element, the A
//   fragment of k-tile j of the next layer, so each epilogue runs in
//   registers on bf16 pairs and its result is the next layer's A operand:
//   activations never leave registers.  The accumulator starts at the bias
//   (the f32 bias add before rounding); the epilogue rounds to bf16 and, in
//   the trunk, multiplies by depth_bias in bf16 (which rounds as the f32
//   product rounded to bf16 does) and applies ReLU.  The concats
//   [PE(pts) | h] and [feature | PE(dirs)] are just more k-tiles.
// - Live registers are kept small: depth_bias is held as 32 bf16-pair
//   registers through the trunk; feats_bias is computed after the trunk;
//   PE(pts) and PE(dirs) are staged in shared memory and loaded as
//   fragments where a layer needs them; the packing merges
//   confi_rgb_linear with alpha_linear_1 (128x16), views_linears_0 with
//   view_confi_linears_0 (160x128), and rgb_linear with alpha_linear
//   (block-diagonal, 128x16): 12 weight blocks, not 15.
// - 8 warps = 128 points share each pass over the weights (~300 KB, more
//   than a block's shared memory).  Blocks are persistent (one per SM).  The
//   weights and biases stream from L2 through a two-stage ring in shared
//   memory: thread 0 copies block i + 1 with one cp.async.bulk (and one for
//   its bias) completed on the stage's `full` mbarrier while the warps
//   multiply block i; each warp hands the stage back on its `empty`
//   mbarrier as soon as its mma loop is done.  No block-wide barrier per
//   layer: warps drift up to a block apart, so one warp's epilogue overlaps
//   another's mma.
// - kernels/fused_mlp.py stores each [K, N] block in B-fragment order: a
//   lane gets the B fragments of two n-tiles with one conflict-free 16-byte
//   shared-memory load, and a block copies as one contiguous piece.
// - Inputs: each warp copies its next tile's 16 feats, pts and dirs rows
//   (zero past the last point) into its stage with cp.async as soon as the
//   current tile's feats_bias layer has read them, so no tile waits on
//   device memory.  PE takes one sincosf per (point, coordinate,
//   frequency), written once per tile as bf16.
// - Shared memory per block: 2 x (48 KB + 512 B) ring, 128 B of mbarriers,
//   and per warp 16 x F f32 feats, pts, dirs and a 16 x 72 bf16 PE buffer:
//   170,624 B at V=7 (232,064 at V=17, the packing's limit).  One block per
//   SM (up to 255 registers a thread); 92,160 points = 720 tiles over 132
//   SMs, 5.45 tiles per block.
// What is left: every warp reads every weight block from shared memory
// into its registers (8 x 300 KB per tile per SM), which with mma.sync
// takes most of the time.  The wgmma step removes that: wgmma reads B from
// shared memory itself (the A and accumulator fragments here already have
// its register layout), with TMA tensor copies in its swizzled layout, a
// producer warp, and clusters that multicast one weight copy to several
// SMs.
//
// f32 (parity only, off the main path): PR 1's design.  FMA on 4x4 register
// tiles, 32-point tiles whose activations live in shared memory, weights
// streamed through shared memory one layer at a time with a blocking copy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPePts = 63;
constexpr int kPeDirs = 27;

// positional-encoding entry j of (x0, x1, x2): [x | sin(x 2^k) | cos(x 2^k)],
// frequency-major inside each block, zero past the last entry; x * 2^k is
// exact in f32
__device__ __forceinline__ float pe_val(float x0, float x1, float x2, int j,
                                        int L) {
  if (j >= 3 + 6 * L) return 0.0f;
  if (j < 3) return j == 0 ? x0 : (j == 1 ? x1 : x2);
  int t = j - 3;
  const bool is_cos = t >= 3 * L;
  if (is_cos) t -= 3 * L;
  const int c = t % 3;
  const float a = (c == 0 ? x0 : (c == 1 ? x1 : x2)) * (float)(1 << (t / 3));
  return is_cos ? cosf(a) : sinf(a);
}

// ================================================================ bf16 path

constexpr int kTileBf16 = kWarps * 16;              // points per block
constexpr int kBlockBytes = (64 + 128) * 128 * 2;   // pts_linears_5's block
constexpr int kStageBytes = kBlockBytes + 128 * 4;  // + the block's bias
constexpr int kBarBytes = 128;                      // the ring's mbarriers
constexpr int kLdPePts = 64 + 8;                    // staged row strides,
constexpr int kLdPeDirs = 32 + 8;                   // bf16 elements

// weight blocks in ring order (kernels/fused_mlp.py::BF16_STEPS)
enum {
  S_DB = 0, S_P0, S_P1, S_P2, S_P3, S_P4, S_P5, S_HEAD, S_FB, S_FEAT,
  S_VIEWS, S_OUT, kNumSteps
};

struct Bf16Params {
  const float* pts;     // [P, 3]
  const float* dirs;    // [P / S, 3]
  const float* feats;   // [P, F]
  const bf16* w;        // packed blocks in B-fragment order
  const float* b;       // packed [N_i] biases
  float* out;           // [P, 4]
  int P, S, F, v1, tiles;
  int k[kNumSteps], n[kNumSteps], w_off[kNumSteps], b_off[kNumSteps];
};

// A warp's staged inputs: its 16 feats rows, pts and dirs rows as f32
// (copied ahead with cp.async), and one bf16 buffer that holds PE(pts) for
// the trunk, then PE(dirs) for the views layer (its row strides keep the
// A-fragment loads free of bank conflicts).
struct Stage {
  size_t feats, pts, dirs, pe, bytes;
  __host__ __device__ explicit Stage(int F) {
    feats = 0;
    pts = feats + sizeof(float) * 16 * (size_t)F;
    dirs = pts + sizeof(float) * 16 * 3;
    pe = dirs + sizeof(float) * 16 * 3;
    bytes = pe + 2 * 16 * kLdPePts;
  }
};

size_t bf16_smem(int F) {
  return 2 * (size_t)kStageBytes + kBarBytes + kWarps * Stage(F).bytes;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
__device__ __forceinline__ uint32_t mul_bf16x2(uint32_t a, uint32_t b) {
  uint32_t d;
  asm("mul.rn.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ uint32_t relu_bf16x2(uint32_t a) {
  uint32_t d;
  asm("max.bf16x2 %0, %1, %2;\n" : "=r"(d) : "r"(a), "r"(0u));
  return d;
}
__device__ __forceinline__ float rnd(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}
// copies `bytes` (<= 16, or <= 4 for the 4-byte form) and zero-fills the rest
__device__ __forceinline__ void cp_async16_fill(void* smem, const void* gmem,
                                                int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes) : "memory");
}
__device__ __forceinline__ void cp_async4_fill(void* smem, const void* gmem,
                                               int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(smem)), "l"(gmem), "r"(bytes) : "memory");
}

// Accumulator element (n-tile nt, e) is row g + 8 (e / 2), column
// 8 nt + 2 tq + e % 2 (g = lane / 4, tq = lane % 4).  It starts at the bias
// (staged with the weights), so the f32 bias add happens before the
// layer's output is rounded.
template <int NT>
__device__ __forceinline__ void init_bias(float (&acc)[NT][4], const float* b,
                                          int tq) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const float2 bb = *reinterpret_cast<const float2*>(b + nt * 8 + 2 * tq);
    acc[nt][0] = acc[nt][2] = bb.x;
    acc[nt][1] = acc[nt][3] = bb.y;
  }
}

// acc[16, 16 NP] += a[16, 16] @ one k-tile of the block; wk points at the
// k-tile's NP rows of 32 lanes x uint4 (B fragments of two n-tiles each)
template <int NP>
__device__ __forceinline__ void mma_ktile(float (&acc)[2 * NP][4],
                                          const uint32_t (&a)[4],
                                          const uint4* wk, int lane) {
#pragma unroll
  for (int np = 0; np < NP; ++np) {
    const uint4 b = wk[np * 32 + lane];
    mma_bf16(acc[2 * np], a, b.x, b.y);
    mma_bf16(acc[2 * np + 1], a, b.z, b.w);
  }
}

// A fragment of k-tile kt of 16 staged bf16 rows (row stride ld)
__device__ __forceinline__ void frag_smem(uint32_t (&a)[4], const bf16* x,
                                          int ld, int kt, int lane) {
  const bf16* r0 = x + (lane / 4) * ld + kt * 16 + 2 * (lane % 4);
  const bf16* r1 = r0 + 8 * ld;
  a[0] = *reinterpret_cast<const uint32_t*>(r0);
  a[1] = *reinterpret_cast<const uint32_t*>(r1);
  a[2] = *reinterpret_cast<const uint32_t*>(r0 + 8);
  a[3] = *reinterpret_cast<const uint32_t*>(r1 + 8);
}

template <int KT>
__device__ __forceinline__ void frags_smem(uint32_t (&a)[KT][4], const bf16* x,
                                           int ld, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt) frag_smem(a[kt], x, ld, kt, lane);
}

// acc += A @ rows [16 kt0, 16 (kt0 + KT)) of the block; A in registers
template <int KT, int NP>
__device__ __forceinline__ void mma_regs(float (&acc)[2 * NP][4],
                                         const uint32_t (&a)[KT][4],
                                         const uint4* w, int kt0, int lane) {
#pragma unroll
  for (int kt = 0; kt < KT; ++kt)
    mma_ktile<NP>(acc, a[kt], w + (kt0 + kt) * NP * 32, lane);
}

// acc += X[:, c0:c0 + ncols] @ block (K rows), X this warp's 16 staged
// f32 feats rows (row stride F); columns past ncols read as zero
template <int NP>
__device__ __forceinline__ void mma_rows(float (&acc)[2 * NP][4],
                                         const float* x, int F, int c0,
                                         int ncols, int K, const uint4* w,
                                         int lane) {
  const int g = lane / 4, tq = lane % 4;
  auto at = [&](int r, int c) {
    return c < ncols ? x[r * F + c0 + c] : 0.0f;
  };
  for (int kt = 0; kt < K / 16; ++kt) {
    const int c = kt * 16 + 2 * tq;
    const uint32_t a[4] = {pack_bf16(at(g, c), at(g, c + 1)),
                           pack_bf16(at(g + 8, c), at(g + 8, c + 1)),
                           pack_bf16(at(g, c + 8), at(g, c + 9)),
                           pack_bf16(at(g + 8, c + 8), at(g + 8, c + 9))};
    mma_ktile<NP>(acc, a, w + kt * NP * 32, lane);
  }
}

// Epilogues: output k-tile j, register 2 half + r is n-tile 2 j + half,
// row g + 8 r, so the packed pairs are the next layer's A fragments.
// h = bf16(acc), optionally through ReLU
template <int NP, bool RELU>
__device__ __forceinline__ void epi_store(uint32_t (&h)[NP][4],
                                          const float (&acc)[2 * NP][4]) {
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const uint32_t v = pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]);
      h[nt / 2][2 * (nt % 2) + r] = RELU ? relu_bf16x2(v) : v;
    }
}

// trunk: h = relu(bf16(bf16(acc) * depth_bias)); a bf16 product of two
// bf16 values rounds as the f32 product rounded to bf16 does
template <int NP>
__device__ __forceinline__ void epi_trunk(uint32_t (&h)[NP][4],
                                          const float (&acc)[2 * NP][4],
                                          const uint32_t (&db)[NP][4]) {
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int j = nt / 2, i = 2 * (nt % 2) + r;
      h[j][i] = relu_bf16x2(
          mul_bf16x2(pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]), db[j][i]));
    }
}

// feats_bias: h = bf16(h * bf16(acc))
template <int NP>
__device__ __forceinline__ void epi_mul(uint32_t (&h)[NP][4],
                                        const float (&acc)[2 * NP][4]) {
#pragma unroll
  for (int nt = 0; nt < 2 * NP; ++nt)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      uint32_t& x = h[nt / 2][2 * (nt % 2) + r];
      x = mul_bf16x2(x, pack_bf16(acc[nt][2 * r], acc[nt][2 * r + 1]));
    }
}

// The weight ring: two stages of [block | bias], each with a `full`
// mbarrier (the producer's expect_tx plus the bulk copies' bytes) and an
// `empty` one (one arrive per warp).  Blocks are numbered b = 0, 1, ... over
// all of this CTA's tiles; block b uses stage b & 1 for the (b >> 1)-th
// time.  Thread 0 produces: at block b it waits until every warp has left
// block b - 1, then copies block b + 1 into that stage.  Warps wait only for
// the block they need, so they drift up to a block apart instead of
// meeting at a barrier per layer.
struct Ring {
  unsigned char* stage;   // 2 x kStageBytes
  uint64_t* bar;          // full[2], empty[2]
  int b, total;
};

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n"
               :: "r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_u32(bar)), "r"(bytes) : "memory");
}
// Wait for the phase of `parity` to complete.  A copy that never lands
// traps (an error at the next synchronisation) instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_u32(bar)), "r"(parity) : "memory");
    if (done) return;
    if (clock64() - t0 > (1LL << 34)) __trap();   // ~10 s
  }
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          int bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// thread 0: copy block nb (weight step nb % kNumSteps) into its stage
__device__ void ring_issue(Ring& r, const Bf16Params& p, int nb) {
  const int st = nb & 1, use = nb >> 1, step = nb % kNumSteps;
  if (use > 0) mbar_wait(r.bar + 2 + st, (use - 1) & 1);
  const int wbytes = p.k[step] * p.n[step] * 2, bbytes = p.n[step] * 4;
  unsigned char* dst = r.stage + st * kStageBytes;
  mbar_expect_tx(r.bar + st, wbytes + bbytes);
  bulk_copy(dst, p.w + p.w_off[step], wbytes, r.bar + st);
  bulk_copy(dst + kBlockBytes, p.b + p.b_off[step], bbytes, r.bar + st);
}

// The next block: start the copy of the one after it, wait for this one.
__device__ __forceinline__ const unsigned char* ring_next(Ring& r,
                                                          const Bf16Params& p) {
  const int b = r.b++;
  if (threadIdx.x == 0 && b + 1 < r.total) ring_issue(r, p, b + 1);
  __syncwarp();
  mbar_wait(r.bar + (b & 1), (b >> 1) & 1);
  return r.stage + (b & 1) * kStageBytes;
}

// This warp has read the current block (its weights and bias).
__device__ __forceinline__ void ring_done(Ring& r, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(r.bar + 2 + ((r.b - 1) & 1));
}

// Start copying one warp's inputs for points [p0, p0 + 16) into its stage,
// zero past the last point: feats rows as 16-byte pieces (the wrapper
// hands in a 16-byte aligned feats; p0 F floats is a multiple of 16 bytes),
// pts and dirs as 4-byte pieces.  Commits one copy group.
__device__ void prefetch_rows(const Bf16Params& p, const Stage& st,
                              unsigned char* base, int p0, int lane) {
  const long long total = (long long)p.P * p.F, first = (long long)p0 * p.F;
  for (int i = lane; i < 4 * p.F; i += 32) {
    const long long e = first + 4 * i, left = total - e;
    const int n = left <= 0 ? 0 : (left >= 4 ? 4 : (int)left);
    cp_async16_fill(base + st.feats + 16 * i, p.feats + (n ? e : 0), 4 * n);
  }
  for (int i = lane; i < 2 * 48; i += 32) {
    const int j = i % 48, pt = p0 + j / 3;
    const bool ok = pt < p.P;
    const float* src = i < 48 ? p.pts + (ok ? 3 * (size_t)pt + j % 3 : 0)
                              : p.dirs + (ok ? 3 * (size_t)(pt / p.S) + j % 3 : 0);
    cp_async4_fill(base + (i < 48 ? st.pts : st.dirs) + 4 * j, src, ok ? 4 : 0);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// PE(x) of the warp's 16 staged rows x [16, 3] into pe (row stride ld), in
// bf16: [x | sin(x 2^k) | cos(x 2^k)], k < L, frequency-major, zero up to
// column `cols`; one sincosf per (point, coordinate, frequency)
__device__ void stage_pe(bf16* pe, int ld, const float* x, int L, int cols,
                         int lane) {
  for (int i = lane; i < 16 * 3 * L; i += 32) {
    const int r = i / (3 * L), j = i % (3 * L);
    const float v = x[3 * r + j % 3];
    float sn, cs;
    sincosf(v * (float)(1 << (j / 3)), &sn, &cs);
    pe[r * ld + 3 + j] = __float2bfloat16_rn(sn);
    pe[r * ld + 3 + 3 * L + j] = __float2bfloat16_rn(cs);
    if (j < 3) pe[r * ld + j] = __float2bfloat16_rn(v);
  }
  const int pad = cols - 3 - 6 * L;
  for (int i = lane; i < 16 * pad; i += 32)
    pe[(i / pad) * ld + cols - pad + i % pad] = __float2bfloat16_rn(0.0f);
  __syncwarp();
}

__global__ void __launch_bounds__(kThreads, 1)
fused_mlp_bf16_kernel(const Bf16Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int F = p.F, cdb = 24 + 4 * p.v1, cfb = 8 * p.v1;
  const Stage st(F);
  unsigned char* base =
      smem + 2 * kStageBytes + kBarBytes + warp * st.bytes;
  const float* xf = reinterpret_cast<const float*>(base + st.feats);
  bf16* pe = reinterpret_cast<bf16*>(base + st.pe);
  const int my_tiles =
      blockIdx.x < p.tiles ? (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  Ring ring{smem, reinterpret_cast<uint64_t*>(smem + 2 * kStageBytes), 0,
            my_tiles * kNumSteps};
  if (threadIdx.x == 0) {
    for (int i = 0; i < 2; ++i) {
      mbar_init(ring.bar + i, 1);           // full: the producer's arrive
      mbar_init(ring.bar + 2 + i, kWarps);  // empty: one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (my_tiles == 0) return;
  if (threadIdx.x == 0) ring_issue(ring, p, 0);
  prefetch_rows(p, st, base, blockIdx.x * kTileBf16 + warp * 16, lane);

  // Each step: take the next block from the ring, multiply, hand the block
  // back (ring_done), then run the epilogue in registers.
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const int p0 = tile * kTileBf16 + warp * 16;     // this warp's points
    auto block = [&](const float*& bias) {
      const unsigned char* blk = ring_next(ring, p);
      bias = reinterpret_cast<const float*>(blk + kBlockBytes);
      return reinterpret_cast<const uint4*>(blk);
    };
    const float* b;

    // ---- this tile's inputs (copied during the last tile), PE(pts), and
    // depth_bias, held as A-fragment pairs through the trunk
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    stage_pe(pe, kLdPePts, reinterpret_cast<const float*>(base + st.pts), 10,
             64, lane);
    uint32_t db[8][4], h[8][4];
    {
      const uint4* w = block(b);
      float acc[16][4];
      init_bias(acc, b, tq);
      mma_rows<8>(acc, xf, F, 0, cdb, p.k[S_DB], w, lane);
      ring_done(ring, lane);
      epi_store<8, false>(db, acc);
    }
    // ---- trunk; layer 5 takes [PE(pts) | h]
    {
      uint32_t a[4][4];
      frags_smem(a, pe, kLdPePts, lane);
      const uint4* w = block(b);
      float acc[16][4];
      init_bias(acc, b, tq);
      mma_regs<4, 8>(acc, a, w, 0, lane);
      ring_done(ring, lane);
      epi_trunk<8>(h, acc, db);
    }
    for (int l = S_P1; l <= S_P4; ++l) {
      const uint4* w = block(b);
      float acc[16][4];
      init_bias(acc, b, tq);
      mma_regs<8, 8>(acc, h, w, 0, lane);
      ring_done(ring, lane);
      epi_trunk<8>(h, acc, db);
    }
    {
      uint32_t a[4][4];
      frags_smem(a, pe, kLdPePts, lane);
      const uint4* w = block(b);
      float acc[16][4];
      init_bias(acc, b, tq);
      mma_regs<4, 8>(acc, a, w, 0, lane);
      mma_regs<8, 8>(acc, h, w, 4, lane);
      ring_done(ring, lane);
      epi_trunk<8>(h, acc, db);
    }
    // ---- base heads [confi_rgb | alpha_1](h): (r, g) in lanes tq 0,
    // (b, alpha) in tq 1, rows g and g + 8; PE(dirs) replaces PE(pts)
    float base_o[4], adapt_o[4], u[2];
    __syncwarp();
    stage_pe(pe, kLdPeDirs, reinterpret_cast<const float*>(base + st.dirs), 4,
             32, lane);
    {
      const uint4* w = block(b);
      float acc[2][4];
      init_bias(acc, b, tq);
      mma_regs<8, 1>(acc, h, w, 0, lane);
      ring_done(ring, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) base_o[e] = rnd(acc[0][e]);
    }
    // ---- h = bf16(h * feats_bias), the last use of the staged feats: the
    // next tile's inputs start copying behind it
    {
      const uint4* w = block(b);
      float acc[16][4];
      init_bias(acc, b, tq);
      mma_rows<8>(acc, xf, F, cdb, cfb, p.k[S_FB], w, lane);
      ring_done(ring, lane);
      epi_mul<8>(h, acc);
      u[0] = 1.0f - xf[g * F + F - 1];
      u[1] = 1.0f - xf[(g + 8) * F + F - 1];
      __syncwarp();
      if (next < p.tiles)
        prefetch_rows(p, st, base, next * kTileBf16 + warp * 16, lane);
    }
    // ---- feature; [feature | PE(dirs)] -> [views | view_confi]
    {
      const uint4* w = block(b);
      float acc[16][4];
      init_bias(acc, b, tq);
      mma_regs<8, 8>(acc, h, w, 0, lane);
      ring_done(ring, lane);
      epi_store<8, false>(h, acc);
    }
    {
      uint32_t a[2][4];
      frags_smem(a, pe, kLdPeDirs, lane);
      const uint4* w = block(b);
      float acc[16][4];
      init_bias(acc, b, tq);
      mma_regs<8, 8>(acc, h, w, 0, lane);
      mma_regs<2, 8>(acc, a, w, 8, lane);
      ring_done(ring, lane);
      epi_store<8, true>(h, acc);
    }
    // ---- adaptive heads: [views | view_confi] @ blockdiag(rgb, alpha)
    {
      const uint4* w = block(b);
      float acc[2][4];
      init_bias(acc, b, tq);
      mma_regs<8, 1>(acc, h, w, 0, lane);
      ring_done(ring, lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) adapt_o[e] = rnd(acc[0][e]);
    }
    // ---- uncertainty blend
    if (tq < 2) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int pt = p0 + g + 8 * r;
        if (pt >= p.P) continue;
        const float ur = u[r], vr = 1.0f - ur;
        const float b0 = base_o[2 * r], b1 = base_o[2 * r + 1];
        const float a0 = adapt_o[2 * r], a1 = adapt_o[2 * r + 1];
        float2 o;
        o.x = 1.0f / (1.0f + expf(-(b0 * vr + a0 * ur)));
        o.y = tq == 0 ? 1.0f / (1.0f + expf(-(b1 * vr + a1 * ur)))
                      : fmaxf(a1 * vr + b1 * ur, 0.0f);
        reinterpret_cast<float2*>(p.out)[(size_t)pt * 2 + tq] = o;
      }
    }
  }
}

cudaError_t launch_bf16(Bf16Params p, cudaStream_t stream) {
  const size_t smem = bf16_smem(p.F);
  if (smem > 232448) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_mlp_bf16_kernel, kThreads, smem);
  if (err != cudaSuccess) return err;
  p.tiles = (p.P + kTileBf16 - 1) / kTileBf16;
  const int blocks = std::min(p.tiles, sms * std::max(per_sm, 1));
  fused_mlp_bf16_kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// ================================================================ f32 path

namespace f32 {

constexpr int kTile = 32;
constexpr int kPad = 8;                 // smem row padding, elements
constexpr int kWidth = 128;             // trunk width
constexpr int kPePtsPad = 64, kPeDirsPad = 32;
constexpr int kLdX = kPePtsPad + kWidth + kPad;      // [pe_pts | h]
constexpr int kLdY = kWidth + kPad;
constexpr int kLdZ = kWidth + kPeDirsPad + kPad;     // [feature | pe_dirs]
constexpr int kMaxK = kPePtsPad + kWidth;            // pts_linears_5

// layer order of ucnerf_tpu/pallas/mlp_kernel.py::_LAYER_NAMES
enum {
  L_DB = 0, L_FB, L_P0, L_P1, L_P2, L_P3, L_P4, L_P5, L_CRGB, L_A1, L_FEAT,
  L_V0, L_RGB, L_VC0, L_AL, kNumLayers
};

struct Params {
  const float* pts;     // [P, 3]
  const float* dirs;    // [P / S, 3]
  const float* feats;   // [P, F]
  const float* w;       // packed [K_i, N_i] blocks, row-major
  const float* b;       // packed [N_i] blocks
  float* out;           // [P, 4]
  int P, S, F, v1;
  int k[kNumLayers], n[kNumLayers], w_off[kNumLayers], b_off[kNumLayers];
};

constexpr size_t align128(size_t x) { return (x + 127) / 128 * 128; }

// Shared-memory carve-up, in bytes.
struct Smem {
  static constexpr size_t x = 0;
  static constexpr size_t y = x + align128(sizeof(float) * kTile * kLdX);
  static constexpr size_t db = y + align128(sizeof(float) * kTile * kLdY);
  static constexpr size_t fb = db + align128(sizeof(float) * kTile * kLdY);
  static constexpr size_t z = fb + align128(sizeof(float) * kTile * kLdY);
  static constexpr size_t w = z + align128(sizeof(float) * kTile * kLdZ);
  static constexpr size_t base =
      w + align128(sizeof(float) * kMaxK * (kWidth + kPad));
  static constexpr size_t adapt = base + align128(sizeof(float) * kTile * 4);
  static constexpr size_t u = adapt + align128(sizeof(float) * kTile * 4);
  static constexpr size_t total = u + align128(sizeof(float) * kTile);
};

// Copy one layer's [K, N] weight block to shared memory (row stride ldw).
__device__ void load_weights(float* ws, int ldw, const float* wg, int K,
                             int N) {
  const int vpr = N / 4;
  const int total = K * vpr;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int k = i / vpr, v = i % vpr;
    reinterpret_cast<float4*>(ws + k * ldw)[v] =
        __ldg(reinterpret_cast<const float4*>(wg + (size_t)k * N) + v);
  }
}

// out[kTile, N] = A[kTile, K] @ W[K, N]; epi(row, col, sum) writes it.
// Starts with a barrier, so the caller's previous writes are visible.
template <class Epi>
__device__ void dense(const float* A, int lda, const Params& p, int layer,
                      float* ws, Epi epi) {
  const int K = p.k[layer], N = p.n[layer], ldw = N + kPad;
  __syncthreads();
  load_weights(ws, ldw, p.w + p.w_off[layer], K, N);
  __syncthreads();
  const int nq = N / 4, tiles = (kTile / 4) * nq;
  for (int t = threadIdx.x; t < tiles; t += kThreads) {
    const int r0 = (t / nq) * 4, c0 = (t % nq) * 4;
    float acc[4][4] = {};
    for (int k = 0; k < K; ++k) {
      const float4 bv = *reinterpret_cast<const float4*>(ws + k * ldw + c0);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float a = A[(r0 + i) * lda + k];
        acc[i][0] = fmaf(a, bv.x, acc[i][0]);
        acc[i][1] = fmaf(a, bv.y, acc[i][1]);
        acc[i][2] = fmaf(a, bv.z, acc[i][2]);
        acc[i][3] = fmaf(a, bv.w, acc[i][3]);
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) epi(r0 + i, c0 + j, acc[i][j]);
  }
}

__global__ void __launch_bounds__(kThreads) fused_mlp_f32_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* X = reinterpret_cast<float*>(smem + Smem::x);    // [pe_pts 64 | h 128]
  float* Y = reinterpret_cast<float*>(smem + Smem::y);    // h ping-pong / mvs_colors
  float* DB = reinterpret_cast<float*>(smem + Smem::db);  // depth_bias
  float* FB = reinterpret_cast<float*>(smem + Smem::fb);  // feats_bias
  float* Z = reinterpret_cast<float*>(smem + Smem::z);    // [feature 128 | pe_dirs 32]
  float* W = reinterpret_cast<float*>(smem + Smem::w);
  float* base = reinterpret_cast<float*>(smem + Smem::base);    // [kTile, 4]
  float* adapt = reinterpret_cast<float*>(smem + Smem::adapt);  // [kTile, 4]
  float* u = reinterpret_cast<float*>(smem + Smem::u);          // [kTile]

  const int p0 = blockIdx.x * kTile;
  const int cdb = 24 + 4 * p.v1, cfb = 8 * p.v1;       // unpadded fan-ins
  const int kdb = p.k[L_DB], kfb = p.k[L_FB];          // padded fan-ins

  // ---- inputs: feats split into mvs_colors (Y), img_feats (X[:, 64:]), u
  for (int i = threadIdx.x; i < kTile * p.F; i += kThreads) {
    const int r = i / p.F, j = i % p.F;
    const float v = p0 + r < p.P ? p.feats[(size_t)p0 * p.F + i] : 0.0f;
    if (j < cdb) Y[r * kLdY + j] = v;
    else if (j < cdb + cfb) X[r * kLdX + kPePtsPad + j - cdb] = v;
    else if (j == p.F - 1) u[r] = 1.0f - v;
  }
  for (int i = threadIdx.x; i < kTile * kLdZ; i += kThreads) {
    const int r = i / kLdZ, j = i % kLdZ;
    if (j >= cdb && j < kdb) Y[r * kLdY + j] = 0.0f;
    if (j >= cfb && j < kfb) X[r * kLdX + kPePtsPad + j] = 0.0f;
    if (j < kPePtsPad) {        // PE(pts) -> X[:, 0:64]
      float v = 0.0f;
      if (j < kPePts && p0 + r < p.P) {
        const float* x = p.pts + (size_t)(p0 + r) * 3;
        v = pe_val(x[0], x[1], x[2], j, 10);
      }
      X[r * kLdX + j] = v;
    }
    if (j >= kWidth && j < kWidth + kPeDirsPad) {   // PE(dirs) -> Z[:, 128:]
      const int jj = j - kWidth;
      float v = 0.0f;
      if (jj < kPeDirs && p0 + r < p.P) {
        const float* x = p.dirs + (size_t)((p0 + r) / p.S) * 3;
        v = pe_val(x[0], x[1], x[2], jj, 4);
      }
      Z[r * kLdZ + j] = v;
    }
  }

  const float* bias = p.b;
  auto store = [&](float* dst, int ld, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) { dst[r * ld + c] = acc + __ldg(bl + c); };
  };
  auto trunk = [&](float* dst, int ld, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) {
      dst[r * ld + c] = fmaxf((acc + __ldg(bl + c)) * DB[r * kLdY + c], 0.0f);
    };
  };
  auto relu = [&](float* dst, int ld, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) {
      dst[r * ld + c] = fmaxf(acc + __ldg(bl + c), 0.0f);
    };
  };
  auto head = [&](float* dst, int off, int ncols, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) {
      if (c < ncols) dst[r * 4 + off + c] = acc + __ldg(bl + c);
    };
  };

  float* Xh = X + kPePtsPad;
  dense(Y, kLdY, p, L_DB, W, store(DB, kLdY, L_DB));
  dense(Xh, kLdX, p, L_FB, W, store(FB, kLdY, L_FB));
  // trunk, ping-pong X[:, 64:] <-> Y; after layer 4 X holds [pe_pts | h]
  dense(X, kLdX, p, L_P0, W, trunk(Xh, kLdX, L_P0));
  dense(Xh, kLdX, p, L_P1, W, trunk(Y, kLdY, L_P1));
  dense(Y, kLdY, p, L_P2, W, trunk(Xh, kLdX, L_P2));
  dense(Xh, kLdX, p, L_P3, W, trunk(Y, kLdY, L_P3));
  dense(Y, kLdY, p, L_P4, W, trunk(Xh, kLdX, L_P4));
  dense(X, kLdX, p, L_P5, W, trunk(Y, kLdY, L_P5));
  // base heads from h = Y
  dense(Y, kLdY, p, L_CRGB, W, head(base, 0, 3, L_CRGB));
  dense(Y, kLdY, p, L_A1, W, head(base, 3, 1, L_A1));
  // adaptive branch: X[:, 64:] = h * feats_bias; Z[:, :128] = feature
  __syncthreads();
  for (int i = threadIdx.x; i < kTile * kWidth; i += kThreads) {
    const int r = i / kWidth, c = i % kWidth;
    Xh[r * kLdX + c] = Y[r * kLdY + c] * FB[r * kLdY + c];
  }
  dense(Xh, kLdX, p, L_FEAT, W, store(Z, kLdZ, L_FEAT));
  dense(Z, kLdZ, p, L_V0, W, relu(Y, kLdY, L_V0));
  dense(Z, kLdZ, p, L_VC0, W, relu(Y + kWidth / 2, kLdY, L_VC0));
  dense(Y, kLdY, p, L_RGB, W, head(adapt, 0, 3, L_RGB));
  dense(Y + kWidth / 2, kLdY, p, L_AL, W, head(adapt, 3, 1, L_AL));
  __syncthreads();

  // ---- uncertainty blend
  for (int r = threadIdx.x; r < kTile; r += kThreads) {
    if (p0 + r >= p.P) continue;
    const float ur = u[r], vr = 1.0f - ur;
    float4 o;
    o.x = 1.0f / (1.0f + expf(-(base[r * 4 + 0] * vr + adapt[r * 4 + 0] * ur)));
    o.y = 1.0f / (1.0f + expf(-(base[r * 4 + 1] * vr + adapt[r * 4 + 1] * ur)));
    o.z = 1.0f / (1.0f + expf(-(base[r * 4 + 2] * vr + adapt[r * 4 + 2] * ur)));
    o.w = fmaxf(adapt[r * 4 + 3] * vr + base[r * 4 + 3] * ur, 0.0f);
    reinterpret_cast<float4*>(p.out)[p0 + r] = o;
  }
}

cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Smem::total;
  static_assert(smem <= 232448, "tile does not fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_f32_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.P + kTile - 1) / kTile;
  fused_mlp_f32_kernel<<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// table: one row of (K, N, weight offset, bias offset) per weight block, in
// elements, as kernels/fused_mlp.py packs them: 12 blocks in bf16
// (BF16_STEPS), 15 in f32 (LAYER_NAMES).  Returns the CUDA error code of the
// launch (0 on success).
int ucnerf_fused_mlp_forward(const float* pts, const float* dirs,
                             const float* feats, const void* w,
                             const float* b, float* out, int P, int S, int F,
                             int v1, const int* table, int use_bf16,
                             void* stream) {
  if (P == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (use_bf16) {
    Bf16Params p;
    p.pts = pts; p.dirs = dirs; p.feats = feats;
    p.w = static_cast<const bf16*>(w); p.b = b; p.out = out;
    p.P = P; p.S = S; p.F = F; p.v1 = v1; p.tiles = 0;
    for (int i = 0; i < kNumSteps; ++i) {
      p.k[i] = table[4 * i]; p.n[i] = table[4 * i + 1];
      p.w_off[i] = table[4 * i + 2]; p.b_off[i] = table[4 * i + 3];
    }
    return (int)launch_bf16(p, st);
  }
  f32::Params p;
  p.pts = pts; p.dirs = dirs; p.feats = feats;
  p.w = static_cast<const float*>(w); p.b = b; p.out = out;
  p.P = P; p.S = S; p.F = F; p.v1 = v1;
  for (int i = 0; i < f32::kNumLayers; ++i) {
    p.k[i] = table[4 * i]; p.n[i] = table[4 * i + 1];
    p.w_off[i] = table[4 * i + 2]; p.b_off[i] = table[4 * i + 3];
  }
  return (int)f32::launch(p, st);
}

// What the launch of one mode uses at view_num v1 + 1: out = {registers a
// thread, local (stack or spill) bytes a thread, dynamic shared memory a
// block, blocks resident per SM, points per block}.  Returns the CUDA
// error code.
int ucnerf_fused_mlp_attrs(int use_bf16, int v1, int* out) {
  const void* fn = use_bf16 ? (const void*)fused_mlp_bf16_kernel
                            : (const void*)f32::fused_mlp_f32_kernel;
  const size_t smem = use_bf16 ? bf16_smem(24 + 12 * v1 + 1)
                               : f32::Smem::total;
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, kThreads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = use_bf16 ? kTileBf16 : f32::kTile;
  return 0;
}

}  // extern "C"
