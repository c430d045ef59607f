// Fused positional encoding + NeRF MLP forward, for Hopper (sm_90a).
//
// Replaces the Pallas kernel scade_tpu/ops/fused_mlp.py::_kernel, launched by
// _fused_forward. For a tile of points it computes the whole network:
//   emb = [x, sin(pi 2^f x), cos(pi 2^f x)]_{f < F}            (E = 3 + 6F)
//   h   = relu(W_l h + b_l) for l < D, layer skip+1 reading [emb, h]
//   alpha = w_a h + b_a;  feature = W_f h + b_f
//   hv  = relu(W_v [feature, dirs] + b_v)                        (W/2 units)
//   out = [W_rgb hv + b_rgb, softplus(10 alpha) / 10]            (N, 4)
// Only the 6 input floats and 4 output floats of a point touch device memory.
//
// Bound: operations. A point costs 587,264 multiply-adds at D=8, W=256, F=9
// (1.17 MFLOP), against 40 bytes of input and output, far above the card's
// ridge point. Every layer of width W runs on the tensor cores with the
// warp-level mma.sync:
//  - bf16 mode: m16n8k16 bf16 x bf16 -> f32. Operands are rounded to bf16
//    (activations where they are stored, weights when they are packed), sums
//    are f32, and the f32 bias is added after the sum: the rounding of the
//    Pallas kernel. The tensor cores truncate as they accumulate, so each
//    staged chunk (32 deep) is summed apart and added to the running f32 sum
//    with a rounded add.
//  - f32 mode, "3xTF32": each f32 operand x is split into hi = rna_tf32(x)
//    and lo = rna_tf32(x - hi), and a product is summed as lo*hi + hi*lo +
//    hi*hi with m16n8k8 tf32 -> f32. The dropped lo*lo term is ~2^-22
//    relative, so the result is f32-accurate at 3x the TF32 work. The
//    tensor cores truncate as they accumulate, so each depth of 8 is summed
//    apart and added to the running f32 sum with a rounded add.
// The alpha head (1 output), the rgb head (3), the softplus and the PE stay
// on the CUDA cores.
//
// Design:
//  - One block of 256 threads (8 warps) owns a tile of 128 points for all
//    D+4 layers. Its activations (128 x W), embedding (128 x 64) and dirs
//    stay in shared memory; the warps sit 2 x 4, each computing a 64 x W/4
//    slice of a layer's output in registers (128 f32 sums a thread at W=256).
//  - Weights come packed by ops/fused_mlp.py::pack_weights, one row-major
//    (out, K) matrix per part with K padded to a product depth and every row
//    32-byte aligned; the skip layer is split into its emb and h parts and
//    the view layer into its feature and dirs parts. Each block streams the
//    parts from L2 in chunks of 64 bytes of every row (32 bf16 or 16 f32
//    columns) with cp.async, into a 2-stage ring, one chunk ahead of the
//    products; the first chunk of the next part is fetched during the last
//    chunk of the current one, across the epilogue. Every tile rereads all
//    weights (1.18 MB bf16, 2.36 MB f32 at W=256): the tile is as tall as
//    shared memory allows (f32 mode takes 217 KB) to keep that L2 traffic
//    under the tensor cores' time.
//  - Row strides are padded (+16 bytes for ldmatrix, +4 words for the tf32
//    loads) so that a warp's fragment reads hit 32 different banks.
//  - The ragged last tile is masked on load and store, never padded.
//  - sinf/cosf with full range reduction: arguments reach pi 2^(F-1) |x|.
//    Built without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 128;           // points per block
constexpr int THREADS = 256;        // 8 warps, 2 (rows) x 4 (columns)
constexpr int MAX_D = 16;           // trunk depth supported
constexpr int MAX_PARTS = 2 * MAX_D + 4;
constexpr int EMB_COLS = 64;        // E = 3 + 6F <= 64, zero-filled past E
constexpr int CHUNK_BYTES = 64;     // bytes of every weight row per staged chunk
constexpr int STAGE_LD = 80;        // bytes between staged rows (64 + 16 against bank conflicts)

typedef __nv_bfloat16 bf16;

struct Params {
  const void* w;            // packed weights (bf16 or f32)
  int off[MAX_PARTS];       // element offset, rows and padded K of each part,
  int rows[MAX_PARTS];      // in pack_layout's order
  int kp[MAX_PARTS];
  int next[MAX_PARTS];      // the next part that is a product (not a head), or -1
  const float* b[MAX_D + 4];  // f32 biases: trunk, alpha, feature, views, rgb
  int D;
  int E;
  int skip_mask;
};

template <typename T>
struct Mode;
template <>
struct Mode<bf16> {
  static constexpr int KSTEP = 16;  // m16n8k16
  static constexpr int PAD = 8;     // elements of row padding (16 bytes)
};
template <>
struct Mode<float> {
  static constexpr int KSTEP = 8;   // m16n8k8
  static constexpr int PAD = 4;
};

__device__ __forceinline__ float to_f(bf16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ void store2(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_1() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void ldmatrix_x4(uint32_t& r0, uint32_t& r1, uint32_t& r2,
                                            uint32_t& r3, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r0), "=r"(r1), "=r"(r2), "=r"(r3)
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x2(uint32_t& r0, uint32_t& r1, unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r0), "=r"(r1)
               : "r"(addr));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// x = hi + lo + O(2^-22 x), both tf32 and rounded to nearest. The explicit
// cvt matters: an f32 fed to the tf32 product as it is gets truncated.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// The ring of staged weight chunks: two stages of up to W rows x STAGE_LD
// bytes. `cur` is the stage that holds (or receives) the next chunk to use.
struct Ring {
  char* buf;
  int stage_bytes;
  int cur;
};

// Issues (does not commit) the cp.async copies of chunk c of part i into dst.
template <typename T>
__device__ __forceinline__ void stage_chunk(char* dst, const Params& p, int i, int c) {
  constexpr int KC = CHUNK_BYTES / sizeof(T);
  const int kp = p.kp[i];
  const int k0 = c * KC;
  // 4 segments of 16 bytes a row, or 2 for the half chunk that ends a part
  const int seg_log = (kp - k0 >= KC) ? 2 : 1;
  const char* src = reinterpret_cast<const char*>(static_cast<const T*>(p.w) + p.off[i] + k0);
  const int row_bytes = kp * (int)sizeof(T);
  const int total = p.rows[i] << seg_log;
  for (int e = threadIdx.x; e < total; e += THREADS) {
    const int r = e >> seg_log;
    const int s = e & ((1 << seg_log) - 1);
    cp_async16(dst + r * STAGE_LD + s * 16, src + (size_t)r * row_bytes + s * 16);
  }
}

// One staged chunk (1 or 2 product depths) into the warp's 64 x 8NT sums,
// A from the activation tile at column k0, B from the staged rows. The
// tensor cores truncate as they accumulate. Summed straight into acc, that
// bias flipped activations' bf16 roundings often enough that 3.8% of points
// ended over 1e-4 from the plain version, against 2.6% for the plain version
// with its sums reordered (H100). So each chunk's products go to a fresh
// sum, which a rounded f32 add takes into acc (2.1% of points over 1e-4).
template <int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][NT][4], const bf16* A, int lda, int k0,
                                          const char* st, int ksteps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  // ldmatrix.x4 of A: lanes 0-15 address rows 0-15 at k, lanes 16-31 at k+8
  const unsigned a_addr = smem_u32(A + (wm * 64 + (lane & 15)) * lda + k0 + (lane >> 4) * 8);
  // ldmatrix.x4 of B from W[n][k]: (n 0-7, k 0-7), (n 0-7, k 8-15), (n 8-15, k 0-7), (n 8-15, k 8-15)
  const unsigned b_addr = smem_u32(st + (wn * NT * 8 + (lane & 7) + ((lane >> 4) << 3)) * STAGE_LD +
                                   ((lane >> 3) & 1) * 16);
  uint32_t b[2][NT][2];
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= ksteps) break;
#pragma unroll
    for (int j = 0; j + 1 < NT; j += 2) {
      ldmatrix_x4(b[ks][j][0], b[ks][j][1], b[ks][j + 1][0], b[ks][j + 1][1],
                  b_addr + j * 8 * STAGE_LD + ks * 32);
    }
    if constexpr (NT & 1) {
      ldmatrix_x2(b[ks][NT - 1][0], b[ks][NT - 1][1], b_addr + (NT - 1) * 8 * STAGE_LD + ks * 32);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    uint32_t a[2][4];
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      if (ks >= ksteps) break;
      ldmatrix_x4(a[ks][0], a[ks][1], a[ks][2], a[ks][3],
                  a_addr + (i * 16 * lda + ks * 16) * (int)sizeof(bf16));
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      float part[4] = {0.f, 0.f, 0.f, 0.f};
      mma_bf16(part, a[0], b[0][j][0], b[0][j][1]);
      if (ksteps > 1) mma_bf16(part, a[1], b[1][j][0], b[1][j][1]);
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
    }
  }
}

template <int NT>
__device__ __forceinline__ void mma_chunk(float (&acc)[4][NT][4], const float* A, int lda, int k0,
                                          const char* st, int ksteps) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
  // m16n8k8 tf32 fragments: a = A[g][t], A[g+8][t], A[g][t+4], A[g+8][t+4];
  // b = W[n=g][k=t], W[g][t+4]
  const float* a_ptr = A + (wm * 64 + g) * lda + k0 + t;
  const float* b_ptr = reinterpret_cast<const float*>(st + (wn * NT * 8 + g) * STAGE_LD) + t;
  constexpr int LDS = STAGE_LD / 4;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    if (ks >= ksteps) break;
    // A split once per depth for the four m-tiles, B one n-tile at a time:
    // 128 sums + 32 + 4 registers stay under the 255 a thread may hold
    uint32_t ah[4][4], al[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float* ap = a_ptr + i * 16 * lda + ks * 8;
      split_tf32(ap[0], ah[i][0], al[i][0]);
      split_tf32(ap[8 * lda], ah[i][1], al[i][1]);
      split_tf32(ap[4], ah[i][2], al[i][2]);
      split_tf32(ap[8 * lda + 4], ah[i][3], al[i][3]);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      uint32_t bh0, bh1, bl0, bl1;
      split_tf32(b_ptr[j * 8 * LDS + ks * 8], bh0, bl0);
      split_tf32(b_ptr[j * 8 * LDS + ks * 8 + 4], bh1, bl1);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        // the tensor cores truncate as they accumulate: summed straight into
        // acc, that bias grows with K (5e-5 at the output, W=256). So each
        // depth's three products go to a fresh sum, added with a rounded add.
        float part[4] = {0.f, 0.f, 0.f, 0.f};
        mma_tf32(part, al[i], bh0, bh1);
        mma_tf32(part, ah[i], bl0, bl1);
        mma_tf32(part, ah[i], bh0, bh1);
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[i][j][q] += part[q];
      }
    }
  }
}

// acc += A[:, 0:kp] @ part_i^T over the warp's slice. On entry chunk 0 of part
// i is in flight into ring.cur (its group committed); on exit chunk 0 of
// part next[i], if any, is. Every thread passes a barrier after its last read
// of A and of the ring, so the caller may overwrite A at once.
template <typename T, int NT>
__device__ __forceinline__ void gemm(float (&acc)[4][NT][4], const T* A, int lda, const Params& p,
                                     int i, Ring& ring) {
  constexpr int KC = CHUNK_BYTES / sizeof(T);
  const int kp = p.kp[i];
  const int nchunks = (kp + KC - 1) / KC;
  for (int c = 0; c < nchunks; ++c) {
    char* other = ring.buf + (ring.cur ^ 1) * ring.stage_bytes;
    if (c + 1 < nchunks) {
      stage_chunk<T>(other, p, i, c + 1);
    } else if (p.next[i] >= 0) {
      stage_chunk<T>(other, p, p.next[i], 0);
    }
    cp_async_commit();
    cp_async_wait_1();  // chunk c has landed, for this thread's copies
    __syncthreads();    // ... and for everyone's
    mma_chunk<NT>(acc, A, lda, c * KC, ring.buf + ring.cur * ring.stage_bytes,
                  min(KC, kp - c * KC) / Mode<T>::KSTEP);
    __syncthreads();    // the stage is free to refill, A free to overwrite
    ring.cur ^= 1;
  }
}

template <int NT>
__device__ __forceinline__ void zero(float (&acc)[4][NT][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;
}

// dst[row][col] = (relu)(acc + bias) in the activation type, from the mma
// accumulator layout: c0, c1 at (g, 2t..2t+1), c2, c3 at (g + 8, 2t..2t+1).
template <typename T, int NT>
__device__ __forceinline__ void epilogue(const float (&acc)[4][NT][4],
                                         const float* __restrict__ bias, T* dst, int ldd,
                                         bool relu) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    const int col = wn * NT * 8 + j * 8 + 2 * t;
    const float b0 = __ldg(&bias[col]), b1 = __ldg(&bias[col + 1]);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = wm * 64 + i * 16 + g;
      float v0 = acc[i][j][0] + b0, v1 = acc[i][j][1] + b1;
      float v2 = acc[i][j][2] + b0, v3 = acc[i][j][3] + b1;
      if (relu) {
        v0 = fmaxf(v0, 0.f);
        v1 = fmaxf(v1, 0.f);
        v2 = fmaxf(v2, 0.f);
        v3 = fmaxf(v3, 0.f);
      }
      store2(dst + row * ldd + col, v0, v1);
      store2(dst + (row + 8) * ldd + col, v2, v3);
    }
  }
}

// A head with NOUT outputs over K inputs on the CUDA cores: two threads per
// row, each summing every other k, then one shuffle. dst[r * 4 + o].
template <int NOUT, typename T>
__device__ __forceinline__ void head(const T* act, int lda, int K, const T* __restrict__ w,
                                     const float* __restrict__ bias, float* dst) {
  const int r = threadIdx.x >> 1;
  const int q = threadIdx.x & 1;
  float s[NOUT];
#pragma unroll
  for (int o = 0; o < NOUT; ++o) s[o] = 0.f;
  for (int k = q; k < K; k += 2) {
    const float a = to_f(act[r * lda + k]);
#pragma unroll
    for (int o = 0; o < NOUT; ++o) s[o] = fmaf(a, to_f(w[o * K + k]), s[o]);
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o) s[o] += __shfl_xor_sync(0xffffffffu, s[o], 1);
  if (q == 0) {
#pragma unroll
    for (int o = 0; o < NOUT; ++o) dst[r * 4 + o] = s[o] + __ldg(&bias[o]);
  }
}

template <typename T, int W>
struct Smem {
  static constexpr int LDA = W + Mode<T>::PAD;           // activations
  static constexpr int LDE = EMB_COLS + Mode<T>::PAD;    // embedding
  static constexpr int LDD = Mode<T>::KSTEP + Mode<T>::PAD;  // dirs, zero past 3
  static constexpr int STAGE_BYTES = W * STAGE_LD;
  static constexpr size_t BYTES = (size_t)TILE * (LDA + LDE + LDD) * sizeof(T) +
                                  2 * (size_t)STAGE_BYTES + TILE * 4 * sizeof(float);
};

template <typename T, int W>
__global__ void __launch_bounds__(THREADS, 1)
    fused_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                     float* __restrict__ out, int n, const __grid_constant__ Params p) {
  static_assert(W % 64 == 0, "W must be a multiple of 64");
  using S = Smem<T, W>;
  constexpr int NT = W / 32;   // n8 tiles per warp, W-wide layers
  constexpr int NTV = W / 64;  // the W/2-wide view layer
  constexpr int KSTEP = Mode<T>::KSTEP;
  extern __shared__ __align__(16) char smem[];
  T* act = reinterpret_cast<T*>(smem);
  T* emb = act + TILE * S::LDA;
  T* dsm = emb + TILE * S::LDE;
  Ring ring{reinterpret_cast<char*>(dsm + TILE * S::LDD), S::STAGE_BYTES, 0};
  float* res = reinterpret_cast<float*>(ring.buf + 2 * S::STAGE_BYTES);

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * TILE;
  const int E = p.E;
  const float kPi = 3.14159265358979323846f;

  // the first weight chunk streams in while the PE is computed
  stage_chunk<T>(ring.buf, p, 0, 0);
  cp_async_commit();

  // positional encoding and raw dirs, zero past E / 3 (and past n); the
  // first gemm's barrier orders these stores before any read
  for (int e = tid; e < TILE * EMB_COLS; e += THREADS) {
    const int r = e / EMB_COLS;
    const int c = e - r * EMB_COLS;
    const int g = row0 + r;
    float v = 0.f;
    if (g < n && c < E) {
      if (c < 3) {
        v = pts[(size_t)g * 3 + c];
      } else {
        const int f = (c - 3) / 6;
        const int rem = (c - 3) - 6 * f;
        const float x = pts[(size_t)g * 3 + rem % 3];
        const float xb = (x * kPi) * (float)(1 << f);  // exact power-of-two scale
        v = rem < 3 ? sinf(xb) : cosf(xb);
      }
    }
    emb[r * S::LDE + c] = from_f<T>(v);
  }
  for (int e = tid; e < TILE * KSTEP; e += THREADS) {
    const int r = e / KSTEP;
    const int c = e - r * KSTEP;
    const int g = row0 + r;
    dsm[r * S::LDD + c] = from_f<T>((g < n && c < 3) ? dirs[(size_t)g * 3 + c] : 0.f);
  }

  const int D = p.D;
  const T* wbuf = static_cast<const T*>(p.w);
  int i = 0;  // the next part of the packed buffer
  float acc[4][NT][4];
  for (int l = 0; l < D; ++l) {
    zero(acc);
    if (l == 0) {
      gemm<T, NT>(acc, emb, S::LDE, p, i++, ring);
    } else {
      if ((p.skip_mask >> (l - 1)) & 1) {
        // concat([emb, h]) @ W^T == emb @ W[:, :E]^T + h @ W[:, E:]^T
        gemm<T, NT>(acc, emb, S::LDE, p, i++, ring);
      }
      gemm<T, NT>(acc, act, S::LDA, p, i++, ring);
    }
    epilogue<T, NT>(acc, p.b[l], act, S::LDA, true);
  }
  __syncthreads();

  // the alpha head reads the trunk output before the feature layer replaces
  // it; the feature gemm's barriers order the two
  head<1, T>(act, S::LDA, W, wbuf + p.off[i++], p.b[D], res + 3);

  zero(acc);
  gemm<T, NT>(acc, act, S::LDA, p, i++, ring);
  epilogue<T, NT>(acc, p.b[D + 1], act, S::LDA, false);

  // view layer on concat([feature, dirs]) as two partial sums
  float accv[4][NTV][4];
  zero(accv);
  gemm<T, NTV>(accv, act, S::LDA, p, i++, ring);
  gemm<T, NTV>(accv, dsm, S::LDD, p, i++, ring);
  epilogue<T, NTV>(accv, p.b[D + 2], act, S::LDA, true);
  __syncthreads();

  head<3, T>(act, S::LDA, W / 2, wbuf + p.off[i], p.b[D + 3], res);
  __syncthreads();

  for (int e = tid; e < TILE * 4; e += THREADS) {
    const int g = row0 + (e >> 2);
    if (g >= n) continue;
    float v = res[e];
    if ((e & 3) == 3) {
      const float z = 10.f * v;  // softplus(10 x) / 10
      v = (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) / 10.f;
    }
    out[(size_t)g * 4 + (e & 3)] = v;
  }
}

template <typename T, int W>
cudaError_t launch(const float* pts, const float* dirs, float* out, int n, const Params& p,
                   cudaStream_t stream) {
  const size_t smem = Smem<T, W>::BYTES;
  auto kernel = fused_mlp_kernel<T, W>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const int blocks = (n + TILE - 1) / TILE;
  kernel<<<blocks, THREADS, smem, stream>>>(pts, dirs, out, n, p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_t(const float* pts, const float* dirs, float* out, int n, int W,
                     const Params& p, cudaStream_t stream) {
  switch (W) {
    case 64: return launch<T, 64>(pts, dirs, out, n, p, stream);
    case 128: return launch<T, 128>(pts, dirs, out, n, p, stream);
    case 256: return launch<T, 256>(pts, dirs, out, n, p, stream);
    default: return cudaErrorInvalidValue;
  }
}

// The parts pack_layout writes, checked against the order the kernel reads
// them in: rows W for the trunk and feature, W/2 for the view layer, 1 and
// 3 for the heads; K padded to a product depth: the emb parts to between E
// and EMB_COLS, the dirs part to exactly one depth, the others not at all.
bool check_layout(Params& p, int W, int kstep, int n_parts) {
  const int D = p.D;
  int rows[MAX_PARTS], kmin[MAX_PARTS], kmax[MAX_PARTS];
  int m = 0;
  auto expect = [&](int r, int lo, int hi) {
    if (m < MAX_PARTS) rows[m] = r, kmin[m] = lo, kmax[m] = hi;
    ++m;
  };
  for (int l = 0; l < D; ++l) {
    if (l == 0 || ((p.skip_mask >> (l - 1)) & 1)) expect(W, p.E, EMB_COLS);
    if (l > 0) expect(W, W, W);
  }
  const int alpha = m;
  expect(1, W, W);
  expect(W, W, W);
  const int views = m;
  expect(W / 2, W, W);
  expect(W / 2, kstep, kstep);
  expect(3, W / 2, W / 2);
  if (m != n_parts) return false;
  for (int i = 0; i < m; ++i) {
    if (p.rows[i] != rows[i] || p.kp[i] < kmin[i] || p.kp[i] > kmax[i] || p.kp[i] % kstep != 0 ||
        p.off[i] < 0 || p.off[i] % 8 != 0)
      return false;
    const bool last_product = i == alpha || i == views + 1 || i == m - 1;
    p.next[i] = last_product ? -1 : (i + 1 == alpha ? alpha + 1 : i + 1);
  }
  return true;
}

}  // namespace

// pts, dirs: (n, 3) f32; out: (n, 4) f32. packed: the weights as
// ops/fused_mlp.py::pack_weights writes them, bf16 when bf16 != 0 and f32
// otherwise; layout: n_parts triples (element offset, rows, padded K) from
// pack_layout; biases: D + 4 device pointers to the f32 biases in the order
// trunk 0..D-1, alpha, feature, views, rgb. Returns a cudaError_t; 0 is
// success.
extern "C" int fused_mlp_forward(const float* pts, const float* dirs, float* out, int n, int D,
                                 int W, int num_freqs, int skip_mask, int bf16_mode,
                                 const void* packed, const int* layout, int n_parts,
                                 const void* const* biases, void* stream) {
  if (n <= 0) return 0;
  if (D < 1 || D > MAX_D || num_freqs < 1 || 3 + 6 * num_freqs > EMB_COLS ||
      n_parts < 1 || n_parts > MAX_PARTS)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.w = packed;
  for (int i = 0; i < n_parts; ++i) {
    p.off[i] = layout[3 * i];
    p.rows[i] = layout[3 * i + 1];
    p.kp[i] = layout[3 * i + 2];
  }
  for (int l = 0; l < D + 4; ++l) p.b[l] = static_cast<const float*>(biases[l]);
  p.D = D;
  p.E = 3 + 6 * num_freqs;
  p.skip_mask = skip_mask & ((1 << (D - 1)) - 1);
  if (!check_layout(p, W, bf16_mode ? Mode<bf16>::KSTEP : Mode<float>::KSTEP, n_parts))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_mode ? (int)launch_t<bf16>(pts, dirs, out, n, W, p, s)
                   : (int)launch_t<float>(pts, dirs, out, n, W, p, s);
}
