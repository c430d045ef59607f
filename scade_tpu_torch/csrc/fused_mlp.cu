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
// Bound: operations. At D=8, W=256, F=9 a point costs 587,264 multiply-adds
// (1.17 MFLOP) against 40 bytes of input and output, far above the card's
// ridge point; padded to whole chunks the tensor cores do 598,016 of them in
// bf16 and 3 x 590,848 in 3xTF32. Every W-wide and W/2-wide layer runs on the
// tensor cores with the warpgroup product wgmma.mma_async (m64n64, or m64n32
// for the view layer at W=64), A (the activations) from registers, B (the
// weights) from shared memory:
//  - bf16 mode: k16 bf16 x bf16 -> f32. Operands are rounded to bf16
//    (activations where they are stored, weights when they are packed), sums
//    are f32, and the f32 bias is added after the sum: the rounding of the
//    Pallas kernel. The tensor cores truncate as they accumulate, so each
//    64-deep chunk is summed apart (four k16 products into a fresh sum) and
//    added to the running f32 sum with a rounded add. Summed straight into
//    the running sums, 96.2% of the points of a render chunk stayed within
//    1e-4 of the plain version against 97.4% for the plain version with its
//    sums reordered; with the 64-deep groups 97.4%, with 32-deep ones 97.9%
//    at 1.3x the time (H100; PERF.md).
//  - f32 mode, "3xTF32": each f32 operand x is split into hi = rna_tf32(x)
//    and lo = rna_tf32(x - hi), and a product is summed as lo*hi + hi*lo +
//    hi*hi with k8 tf32 -> f32. The dropped lo*lo term is ~2^-22 relative, so
//    the result is f32-accurate at 3x the TF32 work. Each depth of 8 (the
//    three products) is summed apart and added with a rounded add. The
//    activations are split in registers; the weights' hi and lo halves come
//    packed (pack_weights), since the tensor cores truncate an f32 that is
//    fed to them as it is.
// The alpha head (1 output), the rgb head (3), the softplus and the PE stay
// on the CUDA cores.
//
// Design:
//  - A block is 3 warpgroups: two consumers, each owning 64 points of a
//    128-point tile for all D+4 layers, and one producer. Every warp of a
//    consumer reads and writes only its own 16 rows of the activations
//    (128 x W), embedding (128 x 64) and dirs in shared memory, so the
//    consumers never wait on each other; they meet only at the weights.
//    setmaxnreg gives each consumer thread 232 registers and the producer
//    40: 64 x 256 f32 sums take 128 of them, the two fresh sums below 64.
//  - The weights stream through a ring of STAGES chunks in shared memory.
//    pack_weights writes every chunk (64 bf16 or 8 f32 of K for every row of
//    a part; f32 as hi then lo) in the exact image that the wgmma B
//    descriptor reads: 8-row x 16-byte core matrices, 128 contiguous bytes
//    each, K-adjacent ones 128 bytes apart (LBO), row-adjacent ones one
//    chunk row of core matrices apart (SBO), no swizzle. So one thread of the
//    producer copies a chunk with one cp.async.bulk (the TMA engine, no
//    tensor map) that completes on the stage's "full" mbarrier; every
//    consumer warp arrives on its "empty" mbarrier when the products that
//    read it are done. The producer runs ahead across layers and tiles.
//  - Every block reads every chunk from L2: 9,364 bytes a point in bf16 and
//    36,968 in f32 (hi and lo) at D=8, W=256, F=9. A pair of blocks sharing
//    each chunk by a multicast copy halved those bytes and made K1 no faster
//    on an H100 (PERF.md): L2 is not what bounds it at the rate it reaches.
//  - Persistent blocks: as many blocks as fit on the card walk the tiles,
//    so the next tile's first chunks load while the current one finishes.
//  - Within a layer a consumer walks its output columns in slabs of 64: each
//    slab's products go to one of two fresh sums that alternate, so the
//    rounded add of slab s-1 overlaps the products of slab s
//    (wgmma.wait_group 1).
//  - The PE takes two lanes a row: all loads first, then one sincosf per
//    (coordinate, frequency). bf16 activations are stored with stmatrix.
//  - Shared memory a block at W=256, f32: 133,120 (activations) + 34,816
//    (embedding) + 6,144 (dirs) + 3 x 16,384 (ring); bf16: 67,584 + 18,432 +
//    6,144 + 4 x 32,768; 223,232 bytes either way, and the barriers.
//    Registers a block: 384 threads x 168 = 64,512.
//  - The ragged last tile is masked on load and store, never padded: its
//    rows past n encode x = 0 and are not stored.
//  - sincosf with full range reduction: arguments reach pi 2^(F-1) |x|.
//    Built without --use_fast_math.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int ROWS = 64;                     // points of a consumer warpgroup
constexpr int CONSUMERS = 2;                 // consumer warpgroups a block
constexpr int TILE = ROWS * CONSUMERS;       // points a block takes at a time
constexpr int THREADS = 128 * (CONSUMERS + 1);
constexpr int CONSUMER_WARPS = 4 * CONSUMERS;
constexpr int CONSUMER_REGS = 232;           // setmaxnreg: 2 x 128 x 232 + 128 x 40
constexpr int PRODUCER_REGS = 40;            //   = 384 x 168, the launch's registers
constexpr int MAX_D = 16;                    // trunk depth supported
constexpr int MAX_PARTS = 2 * MAX_D + 4;
constexpr int EMB_COLS = 64;                 // E = 3 + 6F <= 64, zero-filled past E
constexpr int SLAB = 64;                     // output columns of one group of products
constexpr int DEPTH_BYTES = 32;              // K bytes of one wgmma (k16 bf16, k8 tf32)

typedef __nv_bfloat16 bf16;

struct Params {
  const char* w;              // packed weights
  int off[MAX_PARTS];         // element offset, rows and padded K of each part,
  int rows[MAX_PARTS];        // in pack_layout's order
  int kp[MAX_PARTS];
  const float* b[MAX_D + 4];  // f32 biases: trunk, alpha, feature, views, rgb
  int D;
  int E;
  int skip_mask;
  int n_parts;
};

template <typename T>
struct Mode;
template <>
struct Mode<bf16> {
  static constexpr int KSTEP = 16;   // k of one wgmma
  static constexpr int DEPTHS = 4;   // wgmma depths a chunk: the rounded-add group is 64 deep
  static constexpr int COPIES = 1;   // the weights as they are
  static constexpr int AREGS = DEPTHS;  // A fragments a chunk: one a depth
  static constexpr int PAD = 8;      // elements of row padding (16 bytes)
  static constexpr int STAGES = 4;
};
template <>
struct Mode<float> {
  static constexpr int KSTEP = 8;
  static constexpr int DEPTHS = 1;   // the group is one depth of 8
  static constexpr int COPIES = 2;   // hi, then lo
  static constexpr int AREGS = 2;    // the depth's hi and lo
  static constexpr int PAD = 4;
  static constexpr int STAGES = 3;
};

template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ bf16 from_f<bf16>(float x) { return __float2bfloat16_rn(x); }
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }

__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// ---- mbarriers, bulk copies -------------------------------------------------

__device__ __forceinline__ void mbar_init(unsigned bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Returns once the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

// What the arrival releases is this warp's finished reads of a stage, which
// the next bulk copy overwrites.
__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// `bytes` from global `src` into shared `dst`, completing on `bar`.
__device__ __forceinline__ void bulk_copy(unsigned dst, const void* src, int bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// ---- warpgroup products ------------------------------------------------------

// B descriptor of a K-major, unswizzled operand: core matrices of 8 rows x 16
// bytes (128 contiguous bytes), K-adjacent ones 128 bytes apart (leading
// byte offset), row-adjacent ones `sbo` bytes apart (stride byte offset).
__device__ __forceinline__ uint64_t desc_b(unsigned addr, int sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wg_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Ties registers that an in-flight wgmma reads or writes to this point of the
// program, so that the compiler neither reads nor reuses them earlier.
template <int R>
__device__ __forceinline__ void keep(float (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int R>
__device__ __forceinline__ void keep(uint32_t (&r)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define D8(i)                                                                                  \
  "+f"(d[(i) + 0]), "+f"(d[(i) + 1]), "+f"(d[(i) + 2]), "+f"(d[(i) + 3]), "+f"(d[(i) + 4]),   \
      "+f"(d[(i) + 5]), "+f"(d[(i) + 6]), "+f"(d[(i) + 7])

// d (+)= A (64 x 16, registers) @ B (16 x N, shared memory); sums f32.
__device__ __forceinline__ void wgmma_bf16(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_bf16(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
// d (+)= A (64 x 8, registers, tf32) @ B (8 x N, shared memory, tf32); sums f32.
__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8), D8(16), D8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n"
      "}\n"
      : D8(0), D8(8)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(accumulate));
}
#undef D8

__device__ __forceinline__ void stmatrix_x4(unsigned addr, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], unsigned addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// x = hi + lo + O(2^-22 x), both tf32 and rounded to nearest. The explicit
// cvt matters: an f32 fed to the tf32 product as it is gets truncated.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(hi) : "f"(x));
  const float rest = x - __uint_as_float(hi);  // exact
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(lo) : "f"(rest));
}

// The A fragments of one chunk for this warp's 16 rows: a[0..depths) the
// depths (bf16), or a[0] hi and a[1] lo of the one depth (f32). The fragment
// of a warp is that of mma.m16n8k16 (bf16) / m16n8k8 (tf32).
template <int R>
__device__ __forceinline__ void load_a(uint32_t (&a)[R][4], const bf16* A, int lda, int k0,
                                       int cols) {
  const int lane = threadIdx.x & 31;
  const unsigned addr = smem_u32(A + (lane & 15) * lda + k0 + (lane >> 4) * 8);
#pragma unroll
  for (int d = 0; d < R; ++d) {
    if (k0 + 16 * d < cols) {
      ldmatrix_x4(a[d], addr + 32 * d);
    } else {  // past the buffer's columns (the dirs' 16): the part's zero padding
      a[d][0] = a[d][1] = a[d][2] = a[d][3] = 0;
    }
  }
}
template <int R>
__device__ __forceinline__ void load_a(uint32_t (&a)[R][4], const float* A, int lda, int k0,
                                       int) {
  const int lane = threadIdx.x & 31;
  const float* ap = A + (lane >> 2) * lda + k0 + (lane & 3);
  split_tf32(ap[0], a[0][0], a[1][0]);            // (g, t)
  split_tf32(ap[8 * lda], a[0][1], a[1][1]);      // (g + 8, t)
  split_tf32(ap[4], a[0][2], a[1][2]);            // (g, t + 4)
  split_tf32(ap[8 * lda + 4], a[0][3], a[1][3]);  // (g + 8, t + 4)
}

// One group of products into the fresh sum d: the chunk at shared address
// `st` (`rows` rows), its columns from `col` on.
template <int SN, int R>
__device__ __forceinline__ void group(float (&d)[SN / 2], const uint32_t (&a)[R][4], unsigned st,
                                      int rows, int col, bf16*) {
  constexpr int SBO = R * 2 * 128;  // the core matrices of 8 rows, all depths
  const unsigned base = st + (col / 8) * SBO;
#pragma unroll
  for (int i = 0; i < R; ++i) wgmma_bf16(d, a[i], desc_b(base + 256 * i, SBO), i > 0);
}
template <int SN, int R>
__device__ __forceinline__ void group(float (&d)[SN / 2], const uint32_t (&a)[R][4], unsigned st,
                                      int rows, int col, float*) {
  const unsigned hi = st + (col / 8) * 256;
  const unsigned lo = hi + rows * DEPTH_BYTES;
  wgmma_tf32(d, a[1], desc_b(hi, 256), 0);  // lo * hi
  wgmma_tf32(d, a[0], desc_b(lo, 256), 1);  // hi * lo
  wgmma_tf32(d, a[0], desc_b(hi, 256), 1);  // hi * hi
}

// ---- the ring ----------------------------------------------------------------

// A stage's bars: full[s] at bars + 8 s, empty[s] at bars + 8 (STAGES + s).
struct Ring {
  unsigned buf;    // shared address of stage 0
  unsigned bars;
  int stage_bytes;
  int stages;
  int stage;
  unsigned phase;
  __device__ __forceinline__ unsigned full() const { return bars + 8 * stage; }
  __device__ __forceinline__ unsigned empty() const { return bars + 8 * (stages + stage); }
  __device__ __forceinline__ unsigned data() const { return buf + stage * stage_bytes; }
  __device__ __forceinline__ void advance() {
    if (++stage == stages) stage = 0, phase ^= 1;
  }
};

// Bytes of a chunk of a product part: `copies` x rows x the chunk's depth.
template <typename T>
__device__ __forceinline__ int chunk_bytes(int rows) {
  return Mode<T>::COPIES * rows * Mode<T>::KSTEP * Mode<T>::DEPTHS * (int)sizeof(T);
}

__device__ __forceinline__ bool is_head(const Params& p, int i) {
  return p.rows[i] < 8;  // alpha (1 row) and rgb (3)
}

// One thread: every chunk of every product part, tile after tile.
template <typename T>
__device__ void produce(const Params& p, Ring ring, int tiles) {
  for (int t = 0; t < tiles; ++t) {
    for (int i = 0; i < p.n_parts; ++i) {
      if (is_head(p, i)) continue;
      const char* src = p.w + (size_t)p.off[i] * sizeof(T);
      constexpr int CK = Mode<T>::KSTEP * Mode<T>::DEPTHS;
      const int bytes = chunk_bytes<T>(p.rows[i]);
      for (int c = 0; c < p.kp[i] / CK; ++c) {
        mbar_wait(ring.empty(), ring.phase ^ 1);
        mbar_expect_tx(ring.full(), bytes);
        bulk_copy(ring.data(), src, bytes, ring.full());
        src += bytes;
        ring.advance();
      }
    }
  }
}

// acc (64 x NOUT of this warpgroup) += A[:, 0:kp] @ part^T, chunk by chunk
// from the ring. A points at this warp's first row; its buffer has `cols`
// columns, zeros past them.
template <typename T, int NOUT>
__device__ __forceinline__ void gemm(float (&acc)[NOUT / 2], const T* A, int lda, int cols,
                                     int rows, int kp, Ring& ring) {
  constexpr int SN = NOUT < SLAB ? NOUT : SLAB;
  constexpr int NS = NOUT / SN;
  constexpr int CK = Mode<T>::KSTEP * Mode<T>::DEPTHS;
  const int lane = threadIdx.x & 31;
  const int nch = kp / CK;
  float fresh[2][SN / 2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < SN / 2; ++q) fresh[h][q] = 0.f;
  for (int c = 0; c < nch; ++c) {
    uint32_t a[Mode<T>::AREGS][4];
    load_a(a, A, lda, c * CK, cols);
    mbar_wait(ring.full(), ring.phase);
    const unsigned st = ring.data();
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      wg_fence();
      group<SN>(fresh[s & 1], a, st, rows, s * SN, (T*)nullptr);
      wg_commit();
      if (s > 0) {
        // the products of slab s run while slab s-1's fresh sum is added
        wg_wait<1>();
        keep(fresh[(s - 1) & 1]);
#pragma unroll
        for (int q = 0; q < SN / 2; ++q) acc[(s - 1) * (SN / 2) + q] += fresh[(s - 1) & 1][q];
      }
    }
    wg_wait<0>();
    keep(fresh[(NS - 1) & 1]);
#pragma unroll
    for (int r = 0; r < Mode<T>::AREGS; ++r) keep(a[r]);
#pragma unroll
    for (int q = 0; q < SN / 2; ++q) acc[(NS - 1) * (SN / 2) + q] += fresh[(NS - 1) & 1][q];
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty());
    ring.advance();
  }
}

template <int R>
__device__ __forceinline__ void zero(float (&acc)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) acc[i] = 0.f;
}

// dst[row][col] = (relu)(acc + bias) in the activation type, for this warp's
// 16 rows, from the wgmma accumulator layout: acc[4j], acc[4j+1] at (g,
// 8j+2t..8j+2t+1), acc[4j+2], acc[4j+3] at (g + 8, the same columns).
template <typename T, int NOUT>
__device__ __forceinline__ void epilogue(const float (&acc)[NOUT / 2],
                                         const float* __restrict__ bias, T* dst, int ldd,
                                         bool relu) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  uint32_t part[4];
#pragma unroll
  for (int j = 0; j < NOUT / 8; ++j) {
    const int col = j * 8 + 2 * t;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + col));
    const float b0 = bb.x, b1 = bb.y;
    float v0 = acc[4 * j] + b0, v1 = acc[4 * j + 1] + b1;
    float v2 = acc[4 * j + 2] + b0, v3 = acc[4 * j + 3] + b1;
    if (relu) {
      v0 = fmaxf(v0, 0.f);
      v1 = fmaxf(v1, 0.f);
      v2 = fmaxf(v2, 0.f);
      v3 = fmaxf(v3, 0.f);
    }
    if constexpr (sizeof(T) == 2) {
      // stmatrix stores the warp's 16 x 16 block of columns 8j' .. 8j'+15
      // (j' = j - 1, j odd) as four 8 x 8 matrices: rows 0-7 and 8-15 of
      // each 8 columns; lane l gives the address of row l % 8 of matrix l / 8
      part[(j & 1) * 2] = bf16x2(v0, v1);
      part[(j & 1) * 2 + 1] = bf16x2(v2, v3);
      if (j & 1) {
        const int m = lane >> 3;
        const unsigned addr =
            smem_u32(dst + ((m & 1) * 8 + (lane & 7)) * ldd + (j - 1 + (m >> 1)) * 8);
        stmatrix_x4(addr, part);
      }
    } else {
      store2(dst + g * ldd + col, v0, v1);
      store2(dst + (g + 8) * ldd + col, v2, v3);
    }
  }
  __syncwarp();
}

// 8 activations or weights from 16 aligned bytes (bf16), or 4 (f32), as f32.
__device__ __forceinline__ void unpack16(const bf16* p, float (&v)[8]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const uint32_t w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v[2 * i] = __uint_as_float(w[i] << 16);
    v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}
__device__ __forceinline__ void unpack16(const float* p, float (&v)[8]) {
  const float4 u = *reinterpret_cast<const float4*>(p);
  v[0] = u.x, v[1] = u.y, v[2] = u.z, v[3] = u.w;
}

// A head with NOUT outputs over K inputs on the CUDA cores for this warp's 16
// rows: two lanes a row, each summing one half of k in 16-byte pieces, then
// one shuffle. Lane 2r holds row r's sums.
template <int NOUT, typename T>
__device__ __forceinline__ void head(const T* act, int lda, int K, const T* __restrict__ w,
                                     const float* __restrict__ bias, float (&s)[NOUT]) {
  constexpr int PIECE = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int r = lane >> 1, k0 = (lane & 1) * (K / 2);
#pragma unroll
  for (int o = 0; o < NOUT; ++o) s[o] = 0.f;
#pragma unroll 4
  for (int k = k0; k < k0 + K / 2; k += PIECE) {
    float a[8], b[8];
    unpack16(act + r * lda + k, a);
#pragma unroll
    for (int o = 0; o < NOUT; ++o) {
      unpack16(w + o * K + k, b);
#pragma unroll
      for (int e = 0; e < PIECE; ++e) s[o] = fmaf(a[e], b[e], s[o]);
    }
  }
#pragma unroll
  for (int o = 0; o < NOUT; ++o) {
    s[o] += __shfl_xor_sync(0xffffffffu, s[o], 1);
    s[o] += __ldg(&bias[o]);
  }
}

template <typename T, int W>
struct Smem {
  static constexpr int LDA = W + Mode<T>::PAD;               // activations
  static constexpr int LDE = EMB_COLS + Mode<T>::PAD;        // embedding
  static constexpr int LDD = Mode<T>::KSTEP + Mode<T>::PAD;  // dirs, zero past 3
  static constexpr int STAGE_BYTES =
      W * DEPTH_BYTES * Mode<T>::DEPTHS * Mode<T>::COPIES;   // the largest chunk
  static constexpr int ACT = 0;
  static constexpr int EMB = ACT + TILE * LDA * (int)sizeof(T);
  static constexpr int DIRS = EMB + TILE * LDE * (int)sizeof(T);
  static constexpr int RING = (DIRS + TILE * LDD * (int)sizeof(T) + 127) / 128 * 128;
  static constexpr int BARS = RING + Mode<T>::STAGES * STAGE_BYTES;
  static constexpr int BYTES = BARS + 2 * Mode<T>::STAGES * 8;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

// One consumer warp's share of the tiles: rows r0 .. r0+15 of each, the
// warp's rows of the block's buffers at act, emb, dsm.
template <typename T, int W>
__device__ void consume(const float* __restrict__ pts, const float* __restrict__ dirs,
                        float* __restrict__ out, int n, const Params& p, Ring ring, T* act,
                        T* emb, T* dsm, int first_tile, int tile_step, int tiles) {
  using S = Smem<T, W>;
  constexpr int KSTEP = Mode<T>::KSTEP;
  const int lane = threadIdx.x & 31;
  const int wrow = (threadIdx.x >> 5) * 16;  // this warp's first row in the tile
  const float kPi = 3.14159265358979323846f;
  const T* wbuf = reinterpret_cast<const T*>(p.w);
  const int D = p.D, E = p.E;

  // the embedding's columns past E and the dirs' past 3 stay zero
  for (int e = lane; e < 16 * EMB_COLS; e += 32)
    if (e % EMB_COLS >= E) emb[(e / EMB_COLS) * S::LDE + e % EMB_COLS] = from_f<T>(0.f);
  for (int e = lane; e < 16 * KSTEP; e += 32)
    if (e % KSTEP >= 3) dsm[(e / KSTEP) * S::LDD + e % KSTEP] = from_f<T>(0.f);

  for (int it = 0; it < tiles; ++it) {
    const int r0 = (first_tile + it * tile_step) * TILE + wrow;

    // positional encoding and raw dirs: two lanes a row, all loads first,
    // each lane then taking every other (coordinate, frequency) of its row.
    // A row past n encodes x = 0 (finite; its outputs are not stored).
    {
      const int r = lane & 15, half = lane >> 4;
      const int g = r0 + r;
      const bool in = g < n;
      const float x0 = in ? pts[(size_t)g * 3] : 0.f;
      const float x1 = in ? pts[(size_t)g * 3 + 1] : 0.f;
      const float x2 = in ? pts[(size_t)g * 3 + 2] : 0.f;
      T* er = emb + r * S::LDE;
      if (half == 0) {
        er[0] = from_f<T>(x0), er[1] = from_f<T>(x1), er[2] = from_f<T>(x2);
      } else {
        T* dr = dsm + r * S::LDD;
        for (int d = 0; d < 3; ++d) dr[d] = from_f<T>(in ? dirs[(size_t)g * 3 + d] : 0.f);
      }
      for (int j = half; j < (E - 3) / 2; j += 2) {  // j = 3 f + d
        const int f = j / 3, d = j - 3 * f;
        const float x = d == 0 ? x0 : d == 1 ? x1 : x2;
        float sn, cs;
        sincosf((x * kPi) * (float)(1 << f), &sn, &cs);  // exact power-of-two scale
        er[3 + 6 * f + d] = from_f<T>(sn);
        er[6 + 6 * f + d] = from_f<T>(cs);
      }
    }
    __syncwarp();

    int i = 0;  // the next part of the packed buffer
    float acc[W / 2];
    for (int l = 0; l < D; ++l) {
      zero(acc);
      if (l == 0) {
        gemm<T, W>(acc, emb, S::LDE, EMB_COLS, p.rows[i], p.kp[i], ring), ++i;
      } else {
        if ((p.skip_mask >> (l - 1)) & 1) {
          // concat([emb, h]) @ W^T == emb @ W[:, :E]^T + h @ W[:, E:]^T
          gemm<T, W>(acc, emb, S::LDE, EMB_COLS, p.rows[i], p.kp[i], ring), ++i;
        }
        gemm<T, W>(acc, act, S::LDA, W, p.rows[i], p.kp[i], ring), ++i;
      }
      epilogue<T, W>(acc, p.b[l], act, S::LDA, true);
    }

    // the alpha head reads the trunk output before the feature layer replaces it
    float alpha[1];
    head<1, T>(act, S::LDA, W, wbuf + p.off[i++], p.b[D], alpha);

    zero(acc);
    gemm<T, W>(acc, act, S::LDA, W, p.rows[i], p.kp[i], ring), ++i;
    epilogue<T, W>(acc, p.b[D + 1], act, S::LDA, false);

    // view layer on concat([feature, dirs]) as two partial sums
    float accv[W / 4];
    zero(accv);
    gemm<T, W / 2>(accv, act, S::LDA, W, p.rows[i], p.kp[i], ring), ++i;
    gemm<T, W / 2>(accv, dsm, S::LDD, KSTEP, p.rows[i], p.kp[i], ring), ++i;
    epilogue<T, W / 2>(accv, p.b[D + 2], act, S::LDA, true);

    float rgb[3];
    head<3, T>(act, S::LDA, W / 2, wbuf + p.off[i], p.b[D + 3], rgb);
    const int g = r0 + (lane >> 1);
    if ((lane & 1) == 0 && g < n) {
      const float z = 10.f * alpha[0];  // softplus(10 x) / 10
      const float sigma = (fmaxf(z, 0.f) + log1pf(expf(-fabsf(z)))) / 10.f;
      *reinterpret_cast<float4*>(out + (size_t)g * 4) = make_float4(rgb[0], rgb[1], rgb[2], sigma);
    }
    __syncwarp();  // the next tile's embedding overwrites what the heads read
  }
}

template <typename T, int W>
__global__ void __launch_bounds__(THREADS, 1)
    fused_mlp_kernel(const float* __restrict__ pts, const float* __restrict__ dirs,
                     float* __restrict__ out, int n, const __grid_constant__ Params p) {
  static_assert(W % 64 == 0, "W must be a multiple of 64");
  using S = Smem<T, W>;
  constexpr int STAGES = Mode<T>::STAGES;
  extern __shared__ __align__(128) char smem[];
  Ring ring{smem_u32(smem + S::RING), smem_u32(smem + S::BARS), S::STAGE_BYTES, STAGES, 0, 0};

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.bars + 8 * s, 1);                         // the producer
      mbar_init(ring.bars + 8 * (STAGES + s), CONSUMER_WARPS);  // every consumer warp
    }
    // the initialised barriers are seen by the bulk copies (the async proxy)
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = (n + TILE - 1) / TILE;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (threadIdx.x >= 128 * CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS) produce<T>(p, ring, mine);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wrow = (threadIdx.x >> 5) * 16;
    T* act = reinterpret_cast<T*>(smem + S::ACT) + wrow * S::LDA;
    T* emb = reinterpret_cast<T*>(smem + S::EMB) + wrow * S::LDE;
    T* dsm = reinterpret_cast<T*>(smem + S::DIRS) + wrow * S::LDD;
    consume<T, W>(pts, dirs, out, n, p, ring, act, emb, dsm, blockIdx.x, gridDim.x, mine);
  }
}

// Sets the kernel's shared memory and returns in *blocks how many of its
// blocks the card holds at once, on the first call only.
template <typename T, int W>
cudaError_t prepare(int* blocks) {
  static int resident = 0;
  if (resident == 0) {
    auto kernel = fused_mlp_kernel<T, W>;
    const int smem = Smem<T, W>::BYTES;
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    // setmaxnreg moves registers between the warpgroups; it can only hand
    // out what the launch allocated (else .inc would wait forever)
    cudaFuncAttributes attr;
    err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (attr.numRegs * THREADS < CONSUMER_REGS * 128 * CONSUMERS + PRODUCER_REGS * 128)
      return cudaErrorInvalidConfiguration;
    int per_sm = 0, dev = 0, sms = 0;
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, THREADS, smem);
    if (err != cudaSuccess) return err;
    if (per_sm < 1) return cudaErrorInvalidConfiguration;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    resident = per_sm * sms;
  }
  *blocks = resident;
  return cudaSuccess;
}

template <typename T, int W>
cudaError_t launch(const float* pts, const float* dirs, float* out, int n, const Params& p,
                   cudaStream_t stream) {
  int resident;
  cudaError_t err = prepare<T, W>(&resident);
  if (err != cudaSuccess) return err;
  const int tiles = (n + TILE - 1) / TILE;
  fused_mlp_kernel<T, W><<<min(tiles, resident), THREADS, Smem<T, W>::BYTES, stream>>>(
      pts, dirs, out, n, p);
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
// 3 for the heads; a product part's K padded to whole chunks: the emb parts
// to between E and EMB_COLS, the dirs part to one chunk, the others not at
// all (W is a whole number of chunks), a head's not at all. Each product
// part is `copies` images of rows x kp, a head rows x kp; the parts follow
// each other with no gap.
bool check_layout(const Params& p, int W, int chunk, int copies) {
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
  expect(1, W, W);
  expect(W, W, W);
  expect(W / 2, W, W);
  expect(W / 2, chunk, chunk);
  expect(3, W / 2, W / 2);
  if (m != p.n_parts) return false;
  int end = 0;
  for (int i = 0; i < m; ++i) {
    if (p.rows[i] != rows[i] || p.kp[i] < kmin[i] || p.kp[i] > kmax[i] ||
        (rows[i] >= 8 && p.kp[i] % chunk != 0) || p.off[i] != end)
      return false;
    end += (rows[i] < 8 ? 1 : copies) * rows[i] * p.kp[i];
  }
  return true;
}

}  // namespace

// pts, dirs: (n, 3) f32; out: (n, 4) f32. packed: the weights as
// ops/fused_mlp.py::pack_weights writes them, bf16 when bf16 != 0 and f32
// otherwise, 16-byte aligned; layout: n_parts triples (element offset, rows,
// padded K) from pack_layout; biases: D + 4 device pointers to the f32
// biases in the order trunk 0..D-1, alpha, feature, views, rgb. Launches one
// kernel on `stream`. Returns a cudaError_t; 0 is success.
extern "C" int fused_mlp_forward(const float* pts, const float* dirs, float* out, int n, int D,
                                 int W, int num_freqs, int skip_mask, int bf16_mode,
                                 const void* packed, const int* layout, int n_parts,
                                 const void* const* biases, void* stream) {
  if (n <= 0) return 0;
  if (D < 1 || D > MAX_D || num_freqs < 1 || 3 + 6 * num_freqs > EMB_COLS ||
      n_parts < 1 || n_parts > MAX_PARTS || reinterpret_cast<uintptr_t>(packed) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.w = static_cast<const char*>(packed);
  for (int i = 0; i < n_parts; ++i) {
    p.off[i] = layout[3 * i];
    p.rows[i] = layout[3 * i + 1];
    p.kp[i] = layout[3 * i + 2];
  }
  for (int l = 0; l < D + 4; ++l) p.b[l] = static_cast<const float*>(biases[l]);
  p.D = D;
  p.E = 3 + 6 * num_freqs;
  p.skip_mask = skip_mask & ((1 << (D - 1)) - 1);
  p.n_parts = n_parts;
  const bool ok =
      bf16_mode ? check_layout(p, W, Mode<bf16>::KSTEP * Mode<bf16>::DEPTHS, Mode<bf16>::COPIES)
                : check_layout(p, W, Mode<float>::KSTEP * Mode<float>::DEPTHS, Mode<float>::COPIES);
  if (!ok) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_mode ? (int)launch_t<bf16>(pts, dirs, out, n, W, p, s)
                   : (int)launch_t<float>(pts, dirs, out, n, W, p, s);
}

// The geometry the built kernel uses: points a block takes at a time, the
// ring's stages in bf16 and f32 mode, and the blocks the card holds at once
// at W=256 in each mode. Returns a cudaError_t.
extern "C" int fused_mlp_geometry(int* tile, int* stages_bf16, int* stages_f32, int* blocks_bf16,
                                  int* blocks_f32) {
  *tile = TILE;
  *stages_bf16 = Mode<bf16>::STAGES;
  *stages_f32 = Mode<float>::STAGES;
  cudaError_t err = prepare<bf16, 256>(blocks_bf16);
  return (int)(err != cudaSuccess ? err : prepare<float, 256>(blocks_f32));
}
