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
// byte of device memory), so the tensor cores are the limit: bf16 at its
// rate, f32 as three TF32 products per product (faster than the FP32 pipes:
// 3 x 27.16 GFLOP at 494.7 TFLOP/s is 0.165 ms a 92,160-point tile, against
// 0.405 ms on FMA at 67).
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
// f32 (--nerf_dtype float32), the same structure on m16n8k8 TF32:
// - 3xTF32: each product is a_small b_big + a_big b_small + a_big b_big,
//   big = x rounded to tf32 (11 significant bits), small = x - big (exact
//   in f32; the tensor core reads its top 11 bits).  One pass of TF32 does
//   not keep f32's 1e-4.  The three products of a k-tile go into a fresh
//   accumulator that one rounded f32 add then adds to the layer's, which
//   starts at the bias: the tensor core truncates as it accumulates.
// - Activations stay in registers: for m16n8k8 the accumulator of n-tile j
//   holds columns 8 j + 2 tq, 8 j + 2 tq + 1 and the A fragment of k-tile j
//   wants columns 8 j + tq, 8 j + tq + 4, so the packing permutes each
//   block's rows inside every group of 8 (logical row l < 4 is input 2 l,
//   l >= 4 input 2 (l - 4) + 1) and the accumulator is the next layer's A
//   fragment, register for register.  Staged inputs load as float2 pairs.
// - The weights are split into big and small on the host (twice the bytes:
//   one 16-byte load gives a lane both parts of one n-tile's B fragment),
//   so no lane spends ALU on B; the activations split once per k-tile.  The
//   12 blocks stream through a four-stage ring of 16 KB k-slabs (16 rows of
//   an N=128 block, a whole head block), thread 0 copying two slabs ahead
//   on the same full / empty mbarriers; all biases stay in shared memory.
//   Blocks pad to multiples of 8, so each merged head block is one n-tile.
// - Registers: two 16 x 128 f32 sets a lane (64 each: the layer's input
//   and its accumulator); depth_bias lives in shared memory as each lane's
//   own accumulator quads (8 KB a warp), read in the trunk's epilogues.
// - Shared memory: 64 KB ring, 6 KB biases, and per warp 16 x F feats, pts,
//   dirs, a 16 x 72 f32 PE buffer and depth_bias: 226,944 B at V=7 with 8
//   warps (128 points a block); from V=8 fewer warps fit (5 at V=17).
// What is left: the B fragments of both parts are read from shared memory
// by every warp, 255 registers with spills, and only 8 warps an SM to hide
// the loads' and the mma chains' latency.  wgmma (B from shared memory, A
// and the accumulator already in its register layout) is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// ================================================================ bf16 path

constexpr int kTileBf16 = kWarps * 16;              // points per block
constexpr int kBlockBytes = (64 + 128) * 128 * 2;   // pts_linears_5's block
constexpr int kStageBytes = kBlockBytes + 128 * 4;  // + the block's bias
constexpr int kBarBytes = 128;                      // the ring's mbarriers
constexpr int kLdPePts = 64 + 8;                    // staged row strides,
constexpr int kLdPeDirs = 32 + 8;                   // bf16 elements

// weight blocks in ring order (kernels/fused_mlp.py::WEIGHT_STEPS)
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
// pts and dirs as 4-byte pieces.  Commits one copy group.  (Either mode's
// parameters and stage.)
template <class ParamsT, class StageT>
__device__ void prefetch_rows(const ParamsT& p, const StageT& st,
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

constexpr int kMaxWarps = 8;
constexpr int kSlabBytes = 16384;   // a ring stage: 16 rows x 128 x 2 f32
constexpr int kStages = 4;
constexpr int kLead = 2;            // slabs the producer copies ahead
constexpr int kMaxSlabs = 96;       // slabs per tile (82 at view_num 17)
constexpr int kBiasBytes = 6144;    // every block's bias, resident
constexpr int kLdPts = 64 + 8;      // staged PE row strides, floats
constexpr int kLdDirs = 32 + 8;
constexpr int kSmemLimit = 232448;
constexpr int kBarOff = kStages * kSlabBytes;
constexpr int kBiasOff = kBarOff + 128;
constexpr int kFixedBytes = kBiasOff + kBiasBytes;
// each block's fan-in in k-tiles of 8 and its n-tiles of 8 (0: set by
// view_num), as kernels/fused_mlp.py::WEIGHT_STEPS packs them
constexpr int kStepKt[kNumSteps] = {0, 8, 16, 16, 16, 16, 24, 16, 0, 16, 20,
                                    16};
constexpr int kStepNt[kNumSteps] = {16, 16, 16, 16, 16, 16, 16, 1, 16, 16, 16,
                                    1};

struct Params {
  const float* pts;     // [P, 3]
  const float* dirs;    // [P / S, 3]
  const float* feats;   // [P, F]
  const float* w;       // packed blocks, tf32 big and small B fragments
  const float* b;       // packed [N_i] biases
  float* out;           // [P, 4]
  int P, S, F, v1, tiles, nbias, nslabs;
  int k[kNumSteps], n[kNumSteps], w_off[kNumSteps], b_off[kNumSteps];
  int slab_off[kMaxSlabs], slab_bytes[kMaxSlabs];   // one tile's slabs
};

// A warp's staged inputs: 16 feats, pts and dirs rows (copied ahead with
// cp.async), one f32 buffer that holds PE(pts) for the trunk, then
// PE(dirs) for the views layer (row strides 8 mod 32 floats: the
// A-fragment float2 loads are free of bank conflicts), and depth_bias as
// each lane's 16 accumulator quads.
struct Stage {
  size_t feats, pts, dirs, pe, db, bytes;
  __host__ __device__ explicit Stage(int F) {
    feats = 0;
    pts = feats + sizeof(float) * 16 * (size_t)F;
    dirs = pts + sizeof(float) * 16 * 3;
    pe = dirs + sizeof(float) * 16 * 3;
    db = pe + sizeof(float) * 16 * kLdPts;
    bytes = db + sizeof(float4) * 16 * 32;
  }
};

// warps a block can hold at this feats width (8 up to view_num 7)
int warps_for(int F) {
  return std::min(kMaxWarps,
                  (kSmemLimit - kFixedBytes) / (int)Stage(F).bytes);
}
size_t smem_for(int F) {
  return kFixedBytes + warps_for(F) * Stage(F).bytes;
}

// tf32(x) rounded to nearest, ties away: half a tf32 ulp added to the
// bits, the low 13 mantissa bits cleared, as kernels/fused_mlp.py's
// split_tf32 splits the weights.  For finite x this is cvt.rna.tf32.f32,
// which compiles with extra instructions for NaN and infinity (2-4% of
// the kernel's time on the card: scripts/k1_f32_variants.py).
__device__ __forceinline__ uint32_t tf32_big(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}
// x = big + small exactly (x - big is exact in f32); the tensor core reads
// small's top 11 significant bits
__device__ __forceinline__ uint32_t tf32_small(float x, uint32_t big) {
  return __float_as_uint(x - __uint_as_float(big));
}

// d = a b (a zero accumulator)
__device__ __forceinline__ void mma_tf32_zero(float (&d)[4],
                                              const uint32_t (&a)[4],
                                              uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%10, %10, %10, %10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1),
        "f"(0.0f));
}
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc += a b at f32 accuracy (3xTF32): a_small b_big + a_big b_small, then
// a_big b_big, summed in a fresh accumulator that one rounded f32 add per
// element then adds to acc.  (The tensor core truncates as it adds into its
// accumulator: run over a layer's 48-72 products into acc itself, that
// bias grows with the running sum, to 4.4e-4 at the output on the card,
// scripts/k1_f32_variants.py.)
// b = (b0 big, b1 big, b0 small, b1 small): rows tq and tq + 4, column g.
__device__ __forceinline__ void mma3(float (&acc)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], float4 b) {
  const uint32_t bb0 = __float_as_uint(b.x), bb1 = __float_as_uint(b.y);
  float d[4];
  mma_tf32_zero(d, as, bb0, bb1);
  mma_tf32(d, ab, __float_as_uint(b.z), __float_as_uint(b.w));
  mma_tf32(d, ab, bb0, bb1);
#pragma unroll
  for (int i = 0; i < 4; ++i) acc[i] += d[i];
}

// acc[16, 8 NT] += x[16, 8] @ one k-tile of a block; x in A-fragment order
// (a0 = row g, a1 = row g + 8 at logical k tq; a2, a3 at tq + 4), split
// here; wk points at the k-tile: per n-tile 32 lanes x float4
template <int NT>
__device__ __forceinline__ void mma_ktile(float (&acc)[NT][4],
                                          const float (&x)[4],
                                          const float* wk, int lane) {
  uint32_t ab[4], as[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    ab[i] = tf32_big(x[i]);
    as[i] = tf32_small(x[i], ab[i]);
  }
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
    mma3(acc[nt], ab, as, reinterpret_cast<const float4*>(wk)[nt * 32 + lane]);
}

// A fragments.  The packing permutes each block's rows inside every group
// of 8: logical k-row l < 4 holds input 2 l, l >= 4 input 2 (l - 4) + 1.
// So a lane's A values of k-tile j are inputs 8 j + 2 tq and 8 j + 2 tq + 1
// of rows g and g + 8: one float2 from a staged row, and in registers the
// accumulator of n-tile j as it stands (c0 c1 row g, c2 c3 row g + 8).
__device__ __forceinline__ void frag_regs(float (&x)[4], const float (&h)[4]) {
  x[0] = h[0]; x[1] = h[2]; x[2] = h[1]; x[3] = h[3];
}
__device__ __forceinline__ void frag_smem(float (&x)[4], const float* X,
                                          int ld, int kt, int lane) {
  const float* r0 = X + (lane / 4) * ld + kt * 8 + 2 * (lane % 4);
  const float2 u = *reinterpret_cast<const float2*>(r0);
  const float2 v = *reinterpret_cast<const float2*>(r0 + 8 * ld);
  x[0] = u.x; x[1] = v.x; x[2] = u.y; x[3] = v.y;
}
// columns [c0, c0 + ncols) of the warp's 16 staged feats rows (odd row
// stride F: scalar loads), zero past ncols
__device__ __forceinline__ void frag_feats(float (&x)[4], const float* xf,
                                           int F, int c0, int ncols, int kt,
                                           int lane) {
  const int g = lane / 4, c = kt * 8 + 2 * (lane % 4);
  auto at = [&](int r, int cc) {
    return cc < ncols ? xf[r * F + c0 + cc] : 0.0f;
  };
  x[0] = at(g, c); x[1] = at(g + 8, c); x[2] = at(g, c + 1);
  x[3] = at(g + 8, c + 1);
}

// The weight ring: kStages stages of one slab (up to 16 KB of one block's
// k-tiles, both parts), each with a `full` mbarrier (the producer's
// expect_tx plus the bulk copy's bytes) and an `empty` one (one arrive per
// warp).  Slabs are numbered b = 0, 1, ... over all of this CTA's tiles;
// slab b uses stage b % kStages.  Thread 0 produces: at slab b it copies
// slab b + kLead into the stage that slab b + kLead - kStages used, once
// every warp has left that slab, so the warps may drift one slab apart
// without stalling it.
struct Ring {
  unsigned char* stage;
  uint64_t* bar;          // full[kStages], empty[kStages]
  int b, total;
};

__device__ void ring_issue(Ring& r, const Params& p, int nb) {
  const int st = nb % kStages, use = nb / kStages, s = nb % p.nslabs;
  if (use > 0) mbar_wait(r.bar + kStages + st, (use - 1) & 1);
  mbar_expect_tx(r.bar + st, p.slab_bytes[s]);
  bulk_copy(r.stage + st * kSlabBytes, p.w + p.slab_off[s], p.slab_bytes[s],
            r.bar + st);
}

__device__ __forceinline__ const float* ring_next(Ring& r, const Params& p) {
  const int b = r.b++;
  if (threadIdx.x == 0 && b + kLead < r.total) ring_issue(r, p, b + kLead);
  __syncwarp();
  mbar_wait(r.bar + b % kStages, (b / kStages) & 1);
  return reinterpret_cast<const float*>(r.stage + (b % kStages) * kSlabBytes);
}

__device__ __forceinline__ void ring_done(Ring& r, int lane) {
  __syncwarp();
  if (lane == 0) mbar_arrive(r.bar + kStages + (r.b - 1) % kStages);
}

// acc += A @ one block of KT k-tiles (NT n-tiles), slab by slab; frag(kt,
// x) gives A's k-tile kt.  Fully unrolled: register A indexes by constants.
template <int NT, int KT, class Frag>
__device__ __forceinline__ void run_block(float (&acc)[NT][4], Ring& r,
                                          const Params& p, Frag frag,
                                          int lane) {
  constexpr int kSlabKt = kSlabBytes / (NT * 512);
#pragma unroll
  for (int s = 0; s < (KT + kSlabKt - 1) / kSlabKt; ++s) {
    const float* w = ring_next(r, p);
#pragma unroll
    for (int kt = s * kSlabKt; kt < KT && kt < (s + 1) * kSlabKt; ++kt) {
      float x[4];
      frag(kt, x);
      mma_ktile<NT>(acc, x, w + (kt - s * kSlabKt) * NT * 128, lane);
    }
    ring_done(r, lane);
  }
}

// the same for a fan-in set by view_num, A from staged feats
__device__ __forceinline__ void run_block_feats(float (&acc)[16][4], Ring& r,
                                                const Params& p, int kts,
                                                const float* xf, int c0,
                                                int ncols, int lane) {
  constexpr int kSlabKt = kSlabBytes / (16 * 512);
  for (int s0 = 0; s0 < kts; s0 += kSlabKt) {
    const float* w = ring_next(r, p);
    const int n = kts - s0 < kSlabKt ? kts - s0 : kSlabKt;
    for (int kt = 0; kt < n; ++kt) {
      float x[4];
      frag_feats(x, xf, p.F, c0, ncols, s0 + kt, lane);
      mma_ktile<16>(acc, x, w + kt * 16 * 128, lane);
    }
    ring_done(r, lane);
  }
}

// trunk epilogue: h = relu(acc * depth_bias), in f32
__device__ __forceinline__ void epi_trunk(float (&h)[16][4],
                                          const float (&acc)[16][4],
                                          const float4* db, int lane) {
#pragma unroll
  for (int nt = 0; nt < 16; ++nt) {
    const float4 d = db[nt * 32 + lane];
    h[nt][0] = fmaxf(acc[nt][0] * d.x, 0.0f);
    h[nt][1] = fmaxf(acc[nt][1] * d.y, 0.0f);
    h[nt][2] = fmaxf(acc[nt][2] * d.z, 0.0f);
    h[nt][3] = fmaxf(acc[nt][3] * d.w, 0.0f);
  }
}

// PE(x) of the warp's 16 staged rows x [16, 3] into pe (row stride ld), in
// f32, zero up to column `cols`; one sincosf per (point, coordinate,
// frequency)
__device__ void stage_pe(float* pe, int ld, const float* x, int L, int cols,
                         int lane) {
  for (int i = lane; i < 16 * 3 * L; i += 32) {
    const int r = i / (3 * L), j = i % (3 * L);
    const float v = x[3 * r + j % 3];
    float sn, cs;
    sincosf(v * (float)(1 << (j / 3)), &sn, &cs);
    pe[r * ld + 3 + j] = sn;
    pe[r * ld + 3 + 3 * L + j] = cs;
    if (j < 3) pe[r * ld + j] = v;
  }
  const int pad = cols - 3 - 6 * L;
  for (int i = lane; i < 16 * pad; i += 32)
    pe[(i / pad) * ld + cols - pad + i % pad] = 0.0f;
  __syncwarp();
}

__global__ void __launch_bounds__(kMaxWarps * 32, 1)
fused_mlp_f32_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nw = blockDim.x / 32, warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int F = p.F, cdb = 24 + 4 * p.v1, cfb = 8 * p.v1, tile_pts = 16 * nw;
  const Stage st(F);
  unsigned char* base = smem + kFixedBytes + warp * st.bytes;
  const float* xf = reinterpret_cast<const float*>(base + st.feats);
  float* pe = reinterpret_cast<float*>(base + st.pe);
  float4* db = reinterpret_cast<float4*>(base + st.db);
  float* bias = reinterpret_cast<float*>(smem + kBiasOff);
  const int my_tiles =
      blockIdx.x < p.tiles ? (p.tiles - blockIdx.x + gridDim.x - 1) / gridDim.x
                           : 0;
  Ring ring{smem, reinterpret_cast<uint64_t*>(smem + kBarOff), 0,
            my_tiles * p.nslabs};
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      mbar_init(ring.bar + i, 1);              // full: the producer's arrive
      mbar_init(ring.bar + kStages + i, nw);   // empty: one arrive per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int i = threadIdx.x; i < p.nbias; i += blockDim.x) bias[i] = p.b[i];
  __syncthreads();
  if (my_tiles == 0) return;
  if (threadIdx.x == 0)
    for (int nb = 0; nb < kLead && nb < ring.total; ++nb)
      ring_issue(ring, p, nb);
  prefetch_rows(p, st, base, blockIdx.x * tile_pts + warp * 16, lane);

  auto regs = [](const float (&h)[16][4]) {
    return [&h](int kt, float (&x)[4]) { frag_regs(x, h[kt]); };
  };
  for (int tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const int next = tile + gridDim.x;
    const int p0 = tile * tile_pts + warp * 16;     // this warp's points
    float h[16][4];

    // ---- this tile's inputs (copied during the last tile), PE(pts), and
    // depth_bias, kept in shared memory through the trunk
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncwarp();
    stage_pe(pe, kLdPts, reinterpret_cast<const float*>(base + st.pts), 10,
             64, lane);
    {
      float acc[16][4];
      init_bias(acc, bias + p.b_off[S_DB], tq);
      run_block_feats(acc, ring, p, p.k[S_DB] / 8, xf, 0, cdb, lane);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
        db[nt * 32 + lane] =
            make_float4(acc[nt][0], acc[nt][1], acc[nt][2], acc[nt][3]);
    }
    // ---- trunk; layer 5 takes [PE(pts) | h]
    auto pe_pts = [&](int kt, float (&x)[4]) {
      frag_smem(x, pe, kLdPts, kt, lane);
    };
    {
      float acc[16][4];
      init_bias(acc, bias + p.b_off[S_P0], tq);
      run_block<16, 8>(acc, ring, p, pe_pts, lane);
      epi_trunk(h, acc, db, lane);
    }
    for (int l = S_P1; l <= S_P4; ++l) {
      float acc[16][4];
      init_bias(acc, bias + p.b_off[l], tq);
      run_block<16, 16>(acc, ring, p, regs(h), lane);
      epi_trunk(h, acc, db, lane);
    }
    {
      float acc[16][4];
      init_bias(acc, bias + p.b_off[S_P5], tq);
      run_block<16, 24>(acc, ring, p, [&](int kt, float (&x)[4]) {
        if (kt < 8) frag_smem(x, pe, kLdPts, kt, lane);
        else frag_regs(x, h[kt - 8]);
      }, lane);
      epi_trunk(h, acc, db, lane);
    }
    // ---- base heads [confi_rgb | alpha_1](h): (r, g) in lanes tq 0,
    // (b, alpha) in tq 1, rows g and g + 8; PE(dirs) replaces PE(pts)
    float base_o[4], adapt_o[4], u[2];
    __syncwarp();
    stage_pe(pe, kLdDirs, reinterpret_cast<const float*>(base + st.dirs), 4,
             32, lane);
    {
      float acc[1][4];
      init_bias(acc, bias + p.b_off[S_HEAD], tq);
      run_block<1, 16>(acc, ring, p, regs(h), lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) base_o[e] = acc[0][e];
    }
    // ---- h = h * feats_bias, the last use of the staged feats: the next
    // tile's inputs start copying behind it
    {
      float acc[16][4];
      init_bias(acc, bias + p.b_off[S_FB], tq);
      run_block_feats(acc, ring, p, p.k[S_FB] / 8, xf, cdb, cfb, lane);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[nt][e] *= acc[nt][e];
      u[0] = 1.0f - xf[g * F + F - 1];
      u[1] = 1.0f - xf[(g + 8) * F + F - 1];
      __syncwarp();
      if (next < p.tiles)
        prefetch_rows(p, st, base, next * tile_pts + warp * 16, lane);
    }
    // ---- feature; [feature | PE(dirs)] -> relu([views | view_confi])
    {
      float acc[16][4];
      init_bias(acc, bias + p.b_off[S_FEAT], tq);
      run_block<16, 16>(acc, ring, p, regs(h), lane);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[nt][e] = acc[nt][e];
    }
    {
      float acc[16][4];
      init_bias(acc, bias + p.b_off[S_VIEWS], tq);
      run_block<16, 20>(acc, ring, p, [&](int kt, float (&x)[4]) {
        if (kt < 16) frag_regs(x, h[kt]);
        else frag_smem(x, pe, kLdDirs, kt - 16, lane);
      }, lane);
#pragma unroll
      for (int nt = 0; nt < 16; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) h[nt][e] = fmaxf(acc[nt][e], 0.0f);
    }
    // ---- adaptive heads: [views | view_confi] @ blockdiag(rgb, alpha)
    {
      float acc[1][4];
      init_bias(acc, bias + p.b_off[S_OUT], tq);
      run_block<1, 16>(acc, ring, p, regs(h), lane);
#pragma unroll
      for (int e = 0; e < 4; ++e) adapt_o[e] = acc[0][e];
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

// Check the table against the blocks the kernel is written for, and cut
// one tile's pass over the weights into slabs of whole k-tiles.
cudaError_t plan(Params& p) {
  p.nslabs = 0;
  for (int i = 0; i < kNumSteps; ++i) {
    const int fan_in = i == S_DB ? 24 + 4 * p.v1 : 8 * p.v1;
    const int kt = kStepKt[i] ? kStepKt[i] : (fan_in + 7) / 8;
    if (p.k[i] != 8 * kt || p.n[i] != 8 * kStepNt[i] || p.w_off[i] % 8 ||
        p.b_off[i] % 2)
      return cudaErrorInvalidValue;
    const int rows = kSlabBytes / (8 * p.n[i]);
    for (int r0 = 0; r0 < p.k[i]; r0 += rows) {
      if (p.nslabs == kMaxSlabs) return cudaErrorInvalidValue;
      p.slab_off[p.nslabs] = p.w_off[i] + 2 * r0 * p.n[i];
      p.slab_bytes[p.nslabs++] = std::min(rows, p.k[i] - r0) * p.n[i] * 8;
    }
  }
  p.nbias = p.b_off[kNumSteps - 1] + p.n[kNumSteps - 1];
  return p.nbias * 4 <= kBiasBytes ? cudaSuccess : cudaErrorInvalidValue;
}

cudaError_t launch(Params p, cudaStream_t stream) {
  cudaError_t err = plan(p);
  if (err != cudaSuccess) return err;
  const int nw = warps_for(p.F);
  if (nw < 1) return cudaErrorInvalidValue;
  const size_t smem = smem_for(p.F);
  err = cudaFuncSetAttribute(fused_mlp_f32_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, fused_mlp_f32_kernel, 32 * nw, smem);
  if (err != cudaSuccess) return err;
  p.tiles = (p.P + 16 * nw - 1) / (16 * nw);
  const int blocks = std::min(p.tiles, sms * std::max(per_sm, 1));
  fused_mlp_f32_kernel<<<blocks, 32 * nw, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace f32

}  // namespace

extern "C" {

// table: one row of (K, N, weight offset, bias offset) per weight block, in
// elements, as kernels/fused_mlp.py packs them: the 12 blocks of
// WEIGHT_STEPS in either mode.  Returns the CUDA error code of the launch (0
// on success).
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
  p.P = P; p.S = S; p.F = F; p.v1 = v1; p.tiles = 0;
  for (int i = 0; i < kNumSteps; ++i) {
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
  const int F = 24 + 12 * v1 + 1;
  const int threads = use_bf16 ? kThreads : 32 * f32::warps_for(F);
  const size_t smem = use_bf16 ? bf16_smem(F) : f32::smem_for(F);
  cudaError_t err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes a;
  if ((err = cudaFuncGetAttributes(&a, fn)) != cudaSuccess) return (int)err;
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fn, threads,
                                                      smem);
  if (err != cudaSuccess) return (int)err;
  out[0] = a.numRegs;
  out[1] = (int)a.localSizeBytes;
  out[2] = (int)smem;
  out[3] = per_sm;
  out[4] = threads / 2;   // 16 points a warp
  return 0;
}

}  // extern "C"
