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
// What the design does about it:
// - bf16 mode: every layer runs on the tensor cores (WMMA m16n16k16, bf16
//   operands, f32 accumulation); operands and each layer's output are rounded
//   to bf16 where the Pallas kernel rounds.  f32 mode: FMA on 4x4 register
//   tiles, for parity work.
// - Activations of a tile (64 points in bf16, 32 in f32) live in shared
//   memory for the whole chain, in a fixed set of buffers whose columns are
//   arranged so the skip concat [PE(pts) | h] and [feature | PE(dirs)] are
//   contiguous rows: no copies for the concats.
// - The packed weights (~300 KB in bf16, ~600 KB in f32) exceed a block's
//   227 KB, so they stream through shared memory one layer at a time (the
//   largest, pts_linears_5, is 192 x 128); across blocks they stay in L2.
// - Fan-ins and head widths that are not multiples of 16 are zero-padded once
//   at packing time (kernels/fused_mlp.py), so the inner loops never branch
//   on them.
// A simple first version: no cp.async / TMA double buffering of the weight
// stream and no wgmma yet.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <mma.h>
#include <stdint.h>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kPad = 8;                 // smem row padding, elements
constexpr int kWidth = 128;             // trunk width
constexpr int kPePts = 63, kPePtsPad = 64;
constexpr int kPeDirs = 27, kPeDirsPad = 32;
constexpr int kLdX = kPePtsPad + kWidth + kPad;      // [pe_pts | h]
constexpr int kLdY = kWidth + kPad;
constexpr int kLdZ = kWidth + kPeDirsPad + kPad;     // [feature | pe_dirs]
constexpr int kMaxK = kPePtsPad + kWidth;            // pts_linears_5
constexpr int kLdScr = 16 + 4;                       // WMMA scratch row

// layer order of ucnerf_tpu/pallas/mlp_kernel.py::_LAYER_NAMES
enum {
  L_DB = 0, L_FB, L_P0, L_P1, L_P2, L_P3, L_P4, L_P5, L_CRGB, L_A1, L_FEAT,
  L_V0, L_RGB, L_VC0, L_AL, kNumLayers
};

struct Params {
  const float* pts;     // [P, 3]
  const float* dirs;    // [P / S, 3]
  const float* feats;   // [P, F]
  const void* w;        // packed [K_i, N_i] blocks, row-major, T
  const float* b;       // packed [N_i] blocks
  float* out;           // [P, 4]
  int P, S, F, v1;
  int k[kNumLayers], n[kNumLayers], w_off[kNumLayers], b_off[kNumLayers];
};

template <typename T> __device__ __forceinline__ T to_t(float v);
template <> __device__ __forceinline__ float to_t<float>(float v) { return v; }
template <> __device__ __forceinline__ bf16 to_t<bf16>(float v) {
  return __float2bfloat16_rn(v);
}
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(to_t<T>(v));
}

__host__ __device__ constexpr size_t align128(size_t x) {
  return (x + 127) / 128 * 128;
}

// Shared-memory carve-up, in bytes.
template <typename T, int TILE>
struct Smem {
  static constexpr size_t x = 0;
  static constexpr size_t y = x + align128(sizeof(T) * TILE * kLdX);
  static constexpr size_t db = y + align128(sizeof(T) * TILE * kLdY);
  static constexpr size_t fb = db + align128(sizeof(T) * TILE * kLdY);
  static constexpr size_t z = fb + align128(sizeof(T) * TILE * kLdY);
  static constexpr size_t w = z + align128(sizeof(T) * TILE * kLdZ);
  static constexpr size_t scr = w + align128(sizeof(T) * kMaxK * (kWidth + kPad));
  static constexpr size_t scr_bytes =
      sizeof(T) == 2 ? sizeof(float) * kWarps * 16 * kLdScr : 0;
  static constexpr size_t base = scr + align128(scr_bytes);
  static constexpr size_t adapt = base + align128(sizeof(float) * TILE * 4);
  static constexpr size_t u = adapt + align128(sizeof(float) * TILE * 4);
  static constexpr size_t total = u + align128(sizeof(float) * TILE);
};

// positional-encoding entry j of x[0..2]: [x | sin(x 2^k) | cos(x 2^k)],
// frequency-major inside each block; x * 2^k is exact in f32
__device__ __forceinline__ float pe_val(const float* x, int j, int L) {
  if (j < 3) return x[j];
  int t = j - 3;
  const bool is_cos = t >= 3 * L;
  if (is_cos) t -= 3 * L;
  const float a = x[t % 3] * (float)(1 << (t / 3));
  return is_cos ? cosf(a) : sinf(a);
}

// Copy one layer's [K, N] weight block to shared memory (row stride ldw).
template <typename T>
__device__ void load_weights(T* ws, int ldw, const T* wg, int K, int N) {
  const int vpr = N * (int)sizeof(T) / 16;
  const int total = K * vpr;
  for (int i = threadIdx.x; i < total; i += kThreads) {
    const int k = i / vpr, v = i % vpr;
    reinterpret_cast<int4*>(ws + k * ldw)[v] =
        __ldg(reinterpret_cast<const int4*>(wg + (size_t)k * N) + v);
  }
}

// out[TILE, N] = A[TILE, K] @ W[K, N]; epi(row, col, f32 sum) writes it.
// Starts with a barrier, so the caller's previous writes are visible.
template <typename T, int TILE, class Epi>
__device__ void dense(const T* A, int lda, const Params& p, int layer, T* ws,
                      float* scr, Epi epi) {
  const int K = p.k[layer], N = p.n[layer], ldw = N + kPad;
  __syncthreads();
  load_weights(ws, ldw, static_cast<const T*>(p.w) + p.w_off[layer], K, N);
  __syncthreads();
  if constexpr (sizeof(T) == 2) {
    using namespace nvcuda;
    const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
    const int nt = N / 16, tiles = (TILE / 16) * nt;
    float* s = scr + warp * 16 * kLdScr;
    for (int t = warp; t < tiles; t += kWarps) {
      const int tm = t / nt, tn = t % nt;
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
      for (int k = 0; k < K; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> b;
        wmma::load_matrix_sync(a, A + tm * 16 * lda + k, lda);
        wmma::load_matrix_sync(b, ws + k * ldw + tn * 16, ldw);
        wmma::mma_sync(acc, a, b, acc);
      }
      wmma::store_matrix_sync(s, acc, kLdScr, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32)
        epi(tm * 16 + e / 16, tn * 16 + e % 16, s[(e / 16) * kLdScr + e % 16]);
      __syncwarp();
    }
  } else {
    const int nq = N / 4, tiles = (TILE / 4) * nq;
    for (int t = threadIdx.x; t < tiles; t += kThreads) {
      const int r0 = (t / nq) * 4, c0 = (t % nq) * 4;
      float acc[4][4] = {};
      for (int k = 0; k < K; ++k) {
        const float4 bv = *reinterpret_cast<const float4*>(ws + k * ldw + c0);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float a = to_f(A[(r0 + i) * lda + k]);
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
}

template <typename T, int TILE>
__global__ void __launch_bounds__(kThreads) fused_mlp_kernel(const Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  using L = Smem<T, TILE>;
  T* X = reinterpret_cast<T*>(smem + L::x);    // [pe_pts 64 | h 128]
  T* Y = reinterpret_cast<T*>(smem + L::y);    // h ping-pong / mvs_colors
  T* DB = reinterpret_cast<T*>(smem + L::db);  // depth_bias
  T* FB = reinterpret_cast<T*>(smem + L::fb);  // feats_bias
  T* Z = reinterpret_cast<T*>(smem + L::z);    // [feature 128 | pe_dirs 32]
  T* W = reinterpret_cast<T*>(smem + L::w);
  float* scr = reinterpret_cast<float*>(smem + L::scr);
  float* base = reinterpret_cast<float*>(smem + L::base);    // [TILE, 4]
  float* adapt = reinterpret_cast<float*>(smem + L::adapt);  // [TILE, 4]
  float* u = reinterpret_cast<float*>(smem + L::u);          // [TILE]

  const int p0 = blockIdx.x * TILE;
  const int cdb = 24 + 4 * p.v1, cfb = 8 * p.v1;       // unpadded fan-ins
  const int kdb = p.k[L_DB], kfb = p.k[L_FB];          // padded fan-ins

  // ---- inputs: feats split into mvs_colors (Y), img_feats (X[:, 64:]), u
  for (int i = threadIdx.x; i < TILE * p.F; i += kThreads) {
    const int r = i / p.F, j = i % p.F;
    const float v = p0 + r < p.P ? p.feats[(size_t)p0 * p.F + i] : 0.0f;
    if (j < cdb) Y[r * kLdY + j] = to_t<T>(v);
    else if (j < cdb + cfb) X[r * kLdX + kPePtsPad + j - cdb] = to_t<T>(v);
    else if (j == p.F - 1) u[r] = 1.0f - v;
  }
  for (int i = threadIdx.x; i < TILE * kLdZ; i += kThreads) {
    const int r = i / kLdZ, j = i % kLdZ;
    if (j >= cdb && j < kdb) Y[r * kLdY + j] = to_t<T>(0.0f);
    if (j >= cfb && j < kfb) X[r * kLdX + kPePtsPad + j] = to_t<T>(0.0f);
    if (j < kPePtsPad) {        // PE(pts) -> X[:, 0:64]
      float v = 0.0f;
      if (j < kPePts && p0 + r < p.P) v = pe_val(p.pts + (size_t)(p0 + r) * 3, j, 10);
      X[r * kLdX + j] = to_t<T>(v);
    }
    if (j >= kWidth && j < kWidth + kPeDirsPad) {   // PE(dirs) -> Z[:, 128:]
      const int jj = j - kWidth;
      float v = 0.0f;
      if (jj < kPeDirs && p0 + r < p.P)
        v = pe_val(p.dirs + (size_t)((p0 + r) / p.S) * 3, jj, 4);
      Z[r * kLdZ + j] = to_t<T>(v);
    }
  }

  const float* bias = p.b;
  auto store = [&](T* dst, int ld, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) {
      dst[r * ld + c] = to_t<T>(acc + __ldg(bl + c));
    };
  };
  auto trunk = [&](T* dst, int ld, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) {
      const float v = rnd<T>(acc + __ldg(bl + c));
      dst[r * ld + c] = to_t<T>(fmaxf(rnd<T>(v * to_f(DB[r * kLdY + c])), 0.0f));
    };
  };
  auto relu = [&](T* dst, int ld, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) {
      dst[r * ld + c] = to_t<T>(fmaxf(rnd<T>(acc + __ldg(bl + c)), 0.0f));
    };
  };
  auto head = [&](float* dst, int off, int ncols, int layer) {
    const float* bl = bias + p.b_off[layer];
    return [=](int r, int c, float acc) {
      if (c < ncols) dst[r * 4 + off + c] = rnd<T>(acc + __ldg(bl + c));
    };
  };

  T* Xh = X + kPePtsPad;
  dense<T, TILE>(Y, kLdY, p, L_DB, W, scr, store(DB, kLdY, L_DB));
  dense<T, TILE>(Xh, kLdX, p, L_FB, W, scr, store(FB, kLdY, L_FB));
  // trunk, ping-pong X[:, 64:] <-> Y; after layer 4 X holds [pe_pts | h]
  dense<T, TILE>(X, kLdX, p, L_P0, W, scr, trunk(Xh, kLdX, L_P0));
  dense<T, TILE>(Xh, kLdX, p, L_P1, W, scr, trunk(Y, kLdY, L_P1));
  dense<T, TILE>(Y, kLdY, p, L_P2, W, scr, trunk(Xh, kLdX, L_P2));
  dense<T, TILE>(Xh, kLdX, p, L_P3, W, scr, trunk(Y, kLdY, L_P3));
  dense<T, TILE>(Y, kLdY, p, L_P4, W, scr, trunk(Xh, kLdX, L_P4));
  dense<T, TILE>(X, kLdX, p, L_P5, W, scr, trunk(Y, kLdY, L_P5));
  // base heads from h = Y
  dense<T, TILE>(Y, kLdY, p, L_CRGB, W, scr, head(base, 0, 3, L_CRGB));
  dense<T, TILE>(Y, kLdY, p, L_A1, W, scr, head(base, 3, 1, L_A1));
  // adaptive branch: X[:, 64:] = h * feats_bias; Z[:, :128] = feature
  __syncthreads();
  for (int i = threadIdx.x; i < TILE * kWidth; i += kThreads) {
    const int r = i / kWidth, c = i % kWidth;
    Xh[r * kLdX + c] = to_t<T>(to_f(Y[r * kLdY + c]) * to_f(FB[r * kLdY + c]));
  }
  dense<T, TILE>(Xh, kLdX, p, L_FEAT, W, scr, store(Z, kLdZ, L_FEAT));
  dense<T, TILE>(Z, kLdZ, p, L_V0, W, scr, relu(Y, kLdY, L_V0));
  dense<T, TILE>(Z, kLdZ, p, L_VC0, W, scr, relu(Y + kWidth / 2, kLdY, L_VC0));
  dense<T, TILE>(Y, kLdY, p, L_RGB, W, scr, head(adapt, 0, 3, L_RGB));
  dense<T, TILE>(Y + kWidth / 2, kLdY, p, L_AL, W, scr, head(adapt, 3, 1, L_AL));
  __syncthreads();

  // ---- uncertainty blend
  for (int r = threadIdx.x; r < TILE; r += kThreads) {
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

template <typename T, int TILE>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = Smem<T, TILE>::total;
  static_assert(smem <= 232448, "tile does not fit in shared memory");
  cudaError_t err = cudaFuncSetAttribute(
      fused_mlp_kernel<T, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (p.P + TILE - 1) / TILE;
  fused_mlp_kernel<T, TILE><<<blocks, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Points per block for each mode (the wrapper pads nothing: the kernel
// masks the ragged last tile itself).
int ucnerf_fused_mlp_tile(int use_bf16) { return use_bf16 ? 64 : 32; }

// table: kNumLayers rows of (K, N, weight offset, bias offset), in
// elements, padded as kernels/fused_mlp.py packs them.  Returns the CUDA
// error code of the launch (0 on success).
int ucnerf_fused_mlp_forward(const float* pts, const float* dirs,
                             const float* feats, const void* w,
                             const float* b, float* out, int P, int S, int F,
                             int v1, const int* table, int use_bf16,
                             void* stream) {
  Params p;
  p.pts = pts; p.dirs = dirs; p.feats = feats; p.w = w; p.b = b; p.out = out;
  p.P = P; p.S = S; p.F = F; p.v1 = v1;
  for (int i = 0; i < kNumLayers; ++i) {
    p.k[i] = table[4 * i]; p.n[i] = table[4 * i + 1];
    p.w_off[i] = table[4 * i + 2]; p.b_off[i] = table[4 * i + 3];
  }
  if (P == 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(use_bf16 ? launch<bf16, 64>(p, s) : launch<float, 32>(p, s));
}

}  // extern "C"
