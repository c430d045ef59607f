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
// d (+)= A (64 x 8, tf32) @ B (8 x 8, tf32): K1's backward, on the dirs rows.
__device__ __forceinline__ void wgmma_tf32(float (&d)[4], const uint32_t (&a)[4], uint64_t b,
                                           int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %9, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, %8, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
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

// The embedding's columns past E and the dirs' past 3, which stay zero, for
// this warp's 16 rows.
template <typename T, int W>
__device__ __forceinline__ void clear_pads(T* emb, T* dsm, int E) {
  using S = Smem<T, W>;
  constexpr int KSTEP = Mode<T>::KSTEP;
  const int lane = threadIdx.x & 31;
  for (int e = lane; e < 16 * EMB_COLS; e += 32)
    if (e % EMB_COLS >= E) emb[(e / EMB_COLS) * S::LDE + e % EMB_COLS] = from_f<T>(0.f);
  for (int e = lane; e < 16 * KSTEP; e += 32)
    if (e % KSTEP >= 3) dsm[(e / KSTEP) * S::LDD + e % KSTEP] = from_f<T>(0.f);
}

// Positional encoding and raw dirs of rows r0 .. r0+15 into this warp's rows
// of emb and dsm: two lanes a row, all loads first, each lane then taking
// every other (coordinate, frequency) of its row. A row past n encodes x = 0
// (finite; its outputs are not stored).
template <typename T, int W>
__device__ __forceinline__ void encode(const float* __restrict__ pts,
                                       const float* __restrict__ dirs, int n, int r0, int E,
                                       T* emb, T* dsm) {
  using S = Smem<T, W>;
  const int lane = threadIdx.x & 31;
  const float kPi = 3.14159265358979323846f;
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
  const T* wbuf = reinterpret_cast<const T*>(p.w);
  const int D = p.D, E = p.E;

  clear_pads<T, W>(emb, dsm, E);
  for (int it = 0; it < tiles; ++it) {
    const int r0 = (first_tile + it * tile_step) * TILE + wrow;
    encode<T, W>(pts, dirs, n, r0, E, emb, dsm);
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

// ==== K1's backward ===========================================================
//
// Replaces the plain recompute of the JAX package's custom VJP
// (scade_tpu/ops/fused_mlp.py::_bwd, :265, which runs _reference_apply again
// under jax.vjp; no pallas_call). From the upstream gradient g (n, 4) it
// computes the gradient of every weight and bias of the f32 network, in
// 3xTF32 as the forward's f32 mode, whichever mode the forward ran in (the
// bf16 forward's backward is the f32 network's gradient). Not the gradient
// of pts or dirs: the wrapper takes the plain recompute when they ask.
//
// Bound: operations. On the tensor cores a point costs the recompute's and
// the weight gradients' 586,624 multiply-adds each at D=8, W=256, F=9 (the
// forward's less its heads) and the input gradients' 557,056 (the view
// layer's feature columns, the feature layer, trunk layers 7 .. 1 without
// the skip layer's emb columns), x3 in 3xTF32: at a train step's 262,144
// points 2.72e12 TF32 FLOP, 5.50 ms at 495 TFLOP/s.
//
// ReLU decisions. A pre-activation within rounding of 0 may fall on either
// side of it in 3xTF32 and in plain f32, and the decision switches its
// unit's gradient on or off at that point; at a train step's sizes that
// moves a weight's gradient by 0.4-1.4% of its largest entry, as far as
// plain f32 lies from f64. So the backward takes plain f32's decisions, as
// PyTorch's plain recompute on cuBLAS takes them: a sum of one fused
// multiply-add after another in the order of the inputs, then the bias
// (cuBLAS's f32 GEMM at these shapes, bit for bit on an H100). The delta
// kernel lists the points at which some |z| of the 3xTF32 recompute lies
// within AMBIGUOUS (2^-19) of the row's largest: 1% of a train step's
// points, against 3xTF32-vs-f32 differences measured below 2^-20 of it
// (builds at 2^-17 .. 2^-20 gave the same bits). The fix-up kernel
// evaluates those points' networks in plain f32, and where a decision
// differs from the recompute's it takes the point's deltas again.
//
// Design, four kernels on the caller's stream:
//  - k1_backward_delta_kernel: the forward's block (two consumer
//    warpgroups of 64 points, one producer thread, the bulk-copy ring,
//    persistent blocks) and its device code (PE, 3xTF32 layer loop,
//    heads) recompute each 128-point tile on chip, then go back through
//    it: rgb and alpha heads and softplus in f32 on the CUDA cores, then
//    delta_l = (delta_{l+1} W_{l+1}) * 1[h_l > 0] for the view, feature and
//    trunk layers on wgmma (the skip layer through its h columns only). The
//    products read the transposed weights, packed per call like the
//    forward's (pack_weights, transposed: tf32 wgmma takes both operands K-major
//    only), streamed through the same ring after the forward's parts. The
//    ReLU masks of the trunk go out as bits to a per-block slot (L2) in the
//    forward pass and come back in the backward one. Every layer's input x
//    and every delta go to scratch in device memory, feature-major, each
//    chunk of 8 points in the image the weight-gradient products read:
//    inputs as wgmma B images (8-row x 16-byte core matrices), deltas as
//    the A fragments of m16n8k8, one float4 a lane. The heads' weight and
//    bias gradients are summed per warp over its tiles into a per-warp slot.
//  - k1_backward_fix_kernel: the listed points, 8 at a time a block, as
//    many blocks as the card holds: each layer's weights staged through
//    shared memory in tiles of 32 columns by cp.async, two buffers, each
//    thread one output unit (or, going back, one input column) for the 8
//    points; f32 on the CUDA cores. Where a point's decisions all agree
//    with the recompute's (its stored h > 0, its view delta nonzero) it
//    writes nothing. The list's order varies from run to run, but a point's
//    deltas depend on the point alone.
//  - k1_backward_dw_kernel: dW_l = delta_l^T x_l with K the points. A block
//    takes 128 rows of one weight part's gradient over one of S fixed
//    ranges of the points. Each chunk of 8 points of the layer input and of
//    the block's deltas comes by cp.async into a raw ring 8 deep (the kernel
//    streams both operands from HBM, so it keeps ~96 KB in flight an SM);
//    the producer warpgroup splits the input into its tf32 hi and lo images
//    in a second ring that wgmma reads, and moves the deltas beside them,
//    which the consumers split in registers (A). Each depth of 8
//    points is summed apart and added with a rounded add, as in the
//    forward. The bias gradient is the sum of the delta rows, taken in
//    registers beside the products. Each block writes its partial; no
//    float atomics.
//  - k1_backward_reduce_kernel: each gradient element is the sum of its S
//    partials (heads: of the per-warp slots) in a fixed order. The
//    partition depends only on n, the shapes and the card's SM count, so
//    the gradients are bit-reproducible.
// Scratch: 19.2 KB a point at W=256 (inputs 2,376 floats, deltas 2,432),
// written once and read once; the slabs of points the L2 could hold are
// too small to fill the card at 128 points an SM, so it goes to HBM.
// Measured (H100 80GB HBM3, 700 W; a train step's 65,536 + 196,608 points):
// the delta kernel 6.9 ms (the forward's own rate on twice its products),
// the fix-up 0.74 ms (a chain of ~77 staged tiles a batch; the listed
// points take one wave), the dW kernel 5.7 ms, of which 4.2 ms is its data
// path alone (the inputs and deltas streamed through shared memory at ~1.8
// TB/s), the reduction 0.14 ms: 13.5 ms against the 5.50 ms bound and the
// plain recompute's 31.4 ms.

constexpr int MAX_TPARTS = MAX_D + 1;  // view (feature rows), feature, trunk D-1 .. 1
constexpr int DW_STAGES = 4;           // split (hi, lo) images of a depth of 8 points
constexpr int RAW_STAGES = 8;          // raw chunks of a layer input
constexpr int DW_ROWS = 128;           // gradient rows a dW block takes: 2 x 64
constexpr int DIRS_ROWS = 8;           // dirs stored as 8 rows, zero past 3
constexpr float AMBIGUOUS = 0x1p-19f;  // |z| / max |z| of a row below which the fix-up decides
constexpr int FIX_POINTS = 8;          // points a fix-up block takes at a time
constexpr int FIX_KT = 32;             // K of one staged weight tile of the fix-up

// Where a backward's scratch lies (floats), for n_pad = whole tiles of
// points, and where each gradient lies in the flat output (the weights and
// biases in flat_weights' order).
struct Bwd {
  int D, W, E, skip_mask;
  long long n_pad;
  __host__ __device__ bool skip(int l) const { return l > 0 && ((skip_mask >> (l - 1)) & 1); }
  // layer inputs: the embedding (64 rows), h_0 .. h_{D-1}, the feature, dirs
  __host__ __device__ long long x_emb() const { return 0; }
  __host__ __device__ long long x_h(int l) const { return n_pad * (EMB_COLS + (long long)l * W); }
  __host__ __device__ long long x_feat() const { return x_h(D); }
  __host__ __device__ long long x_dirs() const { return x_h(D + 1); }
  __host__ __device__ long long x_size() const { return x_dirs() + n_pad * DIRS_ROWS; }
  // deltas: trunk 0 .. D-1, feature, view
  __host__ __device__ long long d_z(int l) const { return n_pad * (long long)l * W; }
  __host__ __device__ long long d_feat() const { return d_z(D); }
  __host__ __device__ long long d_v() const { return d_z(D + 1); }
  __host__ __device__ long long d_size() const { return d_v() + n_pad * (W / 2); }
  // weight l's (out, in) in flat_weights' order: trunk, alpha, feature, views, rgb
  __host__ __device__ int n_out(int l) const {
    return l < D ? W : l == D ? 1 : l == D + 1 ? W : l == D + 2 ? W / 2 : 3;
  }
  __host__ __device__ int k_in(int l) const {
    return l < D ? (l == 0 ? E : skip(l) ? E + W : W) : l == D + 2 ? W + 3 : l == D + 3 ? W / 2 : W;
  }
  __host__ __device__ long long w_at(int l) const {  // the weight; its bias follows it
    long long at = 0;
    for (int j = 0; j < l; ++j) at += (long long)n_out(j) * (k_in(j) + 1);
    return at;
  }
  __host__ __device__ long long total() const { return w_at(D + 4); }
  // a warp's head slot: dw_alpha (W), db_alpha, dW_rgb (3 x W/2), db_rgb (3)
  __host__ __device__ int head_floats() const { return W + 1 + 3 * (W / 2) + 3; }
};

// One block's share of the weight gradients: rows o0 .. o0+127 (those below
// m) of delta (m rows) times the layer input x (nx rows stored, ncols kept),
// into the gradient at dst + row * stride + col, the bias at bias + row.
struct DwJob {
  long long d, x, dst, bias;
  int m, o0, nx, ncols, stride;
};

// Fills *out with job `want` (if out) and returns the number of jobs; *heavy
// is the number of jobs whose input is W rows, which come first.
__host__ __device__ inline int dw_job(const Bwd& s, int want, DwJob* out, int* heavy) {
  int t = 0;
  auto part = [&](long long d, int m, long long x, int nx, int ncols, int layer, int col0,
                  bool bias) {
    for (int o0 = 0; o0 < m; o0 += DW_ROWS, ++t) {
      if (t != want || out == nullptr) continue;
      const int stride = s.k_in(layer);
      const long long at = s.w_at(layer);
      *out = DwJob{d, x, at + col0, bias ? at + (long long)s.n_out(layer) * stride : -1,
                   m, o0, nx, ncols, stride};
    }
  };
  const int D = s.D, W = s.W;
  for (int l = 1; l < D; ++l) part(s.d_z(l), W, s.x_h(l - 1), W, W, l, s.skip(l) ? s.E : 0, true);
  part(s.d_feat(), W, s.x_h(D - 1), W, W, D + 1, 0, true);
  part(s.d_v(), W / 2, s.x_feat(), W, W, D + 2, 0, true);
  if (heavy) *heavy = t;
  for (int l = 0; l < D; ++l)
    if (l == 0 || s.skip(l)) part(s.d_z(l), W, s.x_emb(), EMB_COLS, s.E, l, 0, l == 0);
  part(s.d_v(), W / 2, s.x_dirs(), DIRS_ROWS, 3, D + 2, W, false);
  return t;
}

struct BwdParams {
  Params f;                    // the forward's f32 parts, heads and biases
  const char* wt;              // transposed parts, in the order the deltas read them
  int t_off[MAX_TPARTS], t_rows[MAX_TPARTS], t_kp[MAX_TPARTS];
  int n_tparts;
  Bwd s;
  const float* g;              // (n, 4) upstream gradient
  float* xs;                   // scratch: layer inputs
  float* ds;                   // scratch: deltas
  uint32_t* masks;             // per block: D x (W/64) words x 256 threads
  float* heads;                // per warp: Bwd::head_floats
  int* fix_count;              // points whose ReLU decisions the fix-up retakes,
  int* fix_rows;               //   and their rows, in no fixed order
};

struct DwParams {
  Bwd s;
  int splits;
  long long chunks;            // n_pad / 8
  const float* xs;
  const float* ds;
  float* part;                 // splits x total
};

// Every chunk of the parts in order, rows >= 8 only (the heads are read
// from device memory).
__device__ __forceinline__ void produce_parts(const char* w, const int* off, const int* rows,
                                              const int* kp, int n_parts, Ring& ring) {
  for (int i = 0; i < n_parts; ++i) {
    if (rows[i] < 8) continue;
    const char* src = w + (size_t)off[i] * sizeof(float);
    const int bytes = chunk_bytes<float>(rows[i]);
    for (int c = 0; c < kp[i] / 8; ++c) {
      mbar_wait(ring.empty(), ring.phase ^ 1);
      mbar_expect_tx(ring.full(), bytes);
      bulk_copy(ring.data(), src, bytes, ring.full());
      src += bytes;
      ring.advance();
    }
  }
}

// This warp's 16 rows (two chunks of 8 points) of an n-column input from
// shared memory to its scratch chunks at dst, as wgmma B images: column i
// of point k at (i / 8) * 64 + ((k % 8) / 4) * 32 + (i % 8) * 4 + k % 4 of
// the chunk's n * 8 floats. A lane writes 4 points of one column, 16 bytes.
template <int N>
__device__ __forceinline__ void store_x(const float* src, int ld, float* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int fi = lane & 7, kh = (lane >> 3) & 1;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
#pragma unroll 4
    for (int j = lane >> 4; j < N / 8; j += 2) {
      const float* s = src + (ch * 8 + kh * 4) * ld + j * 8 + fi;
      *reinterpret_cast<float4*>(dst + ch * N * 8 + j * 64 + kh * 32 + fi * 4) =
          make_float4(s[0], s[ld], s[2 * ld], s[3 * ld]);
    }
  }
}

// This warp's 16 rows (points) of an m-column delta (m a multiple of 16) to
// its scratch chunks at dst, as m16n8k8 A fragments of the m x 8 transpose:
// for rows o16 .. o16+15 of a chunk, lane 4g + t holds (g, t), (g + 8, t),
// (g, t + 4), (g + 8, t + 4) as one float4, at (o16 / 16) * 128 + lane * 4
// of the chunk's m * 8 floats.
template <int M>
__device__ __forceinline__ void store_delta(const float* src, int ld, float* __restrict__ dst) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int ch = 0; ch < 2; ++ch) {
    const float* s = src + (ch * 8 + t) * ld + g;
#pragma unroll 4
    for (int o = 0; o < M; o += 16)
      *reinterpret_cast<float4*>(dst + ch * M * 8 + o * 8 + lane * 4) =
          make_float4(s[o], s[o + 8], s[4 * ld + o], s[4 * ld + o + 8]);
  }
}

// acc (the wgmma layout) to this warp's 16 rows of dst, as it is.
template <int NOUT>
__device__ __forceinline__ void store_rows(const float (&acc)[NOUT / 2], float* dst, int ldd) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < NOUT / 8; ++j) {
    store2(dst + g * ldd + j * 8 + 2 * t, acc[4 * j], acc[4 * j + 1]);
    store2(dst + (g + 8) * ldd + j * 8 + 2 * t, acc[4 * j + 2], acc[4 * j + 3]);
  }
  __syncwarp();
}

// The ReLU mask of a trunk layer, 1[acc + bias > 0] as the epilogue decides
// it, one bit per accumulator, to this thread's words of its slot (words
// 256 apart), and back onto a delta in the same layout.
template <int W>
__device__ __forceinline__ void save_mask(const float (&acc)[W / 2],
                                          const float* __restrict__ bias, uint32_t* slot) {
  const int t = threadIdx.x & 3;
#pragma unroll
  for (int w = 0; w < W / 64; ++w) {
    uint32_t bits = 0;
#pragma unroll
    for (int j = 8 * w; j < 8 * w + 8; ++j) {  // 4 accumulators a column pair
      const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + j * 8 + 2 * t));
      const int q = 4 * (j - 8 * w);
      bits |= (uint32_t)(acc[4 * j] + bb.x > 0.f) << q;
      bits |= (uint32_t)(acc[4 * j + 1] + bb.y > 0.f) << (q + 1);
      bits |= (uint32_t)(acc[4 * j + 2] + bb.x > 0.f) << (q + 2);
      bits |= (uint32_t)(acc[4 * j + 3] + bb.y > 0.f) << (q + 3);
    }
    slot[w * 256] = bits;
  }
}
template <int W>
__device__ __forceinline__ void apply_mask(float (&acc)[W / 2], const uint32_t* slot) {
#pragma unroll
  for (int w = 0; w < W / 64; ++w) {
    const uint32_t bits = slot[w * 256];
#pragma unroll
    for (int q = 0; q < 32; ++q)
      if (!((bits >> q) & 1)) acc[32 * w + q] = 0.f;
  }
}

// Whether row g (r0) and row g + 8 (r1) of this warp hold a pre-activation
// acc + bias within AMBIGUOUS of 0, relative to the row's largest |acc +
// bias|: there the 3xTF32 sum and the plain f32 one may fall on different
// sides of 0. The four lanes of a quad hold a row between them.
template <int NOUT>
__device__ __forceinline__ void near_zero(const float (&acc)[NOUT / 2],
                                          const float* __restrict__ bias, bool& r0, bool& r1) {
  const int t = threadIdx.x & 3;
  const float inf = __int_as_float(0x7f800000);
  float mx0 = 0.f, mn0 = inf, mx1 = 0.f, mn1 = inf;
#pragma unroll
  for (int j = 0; j < NOUT / 8; ++j) {
    const float2 bb = __ldg(reinterpret_cast<const float2*>(bias + j * 8 + 2 * t));
    const float a = fabsf(acc[4 * j] + bb.x), b = fabsf(acc[4 * j + 1] + bb.y);
    const float c = fabsf(acc[4 * j + 2] + bb.x), d = fabsf(acc[4 * j + 3] + bb.y);
    mx0 = fmaxf(mx0, fmaxf(a, b)), mn0 = fminf(mn0, fminf(a, b));
    mx1 = fmaxf(mx1, fmaxf(c, d)), mn1 = fminf(mn1, fminf(c, d));
  }
#pragma unroll
  for (int o = 1; o < 4; o <<= 1) {
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o));
    mn0 = fminf(mn0, __shfl_xor_sync(0xffffffffu, mn0, o));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o));
    mn1 = fminf(mn1, __shfl_xor_sync(0xffffffffu, mn1, o));
  }
  r0 |= mn0 <= AMBIGUOUS * mx0;
  r1 |= mn1 <= AMBIGUOUS * mx1;
}

// s (+)= v into a per-warp slot: stored on the warp's first tile, added to
// after; the same lane reads and writes an entry.
__device__ __forceinline__ void slot_add(float* p, float v, bool first) {
  *p = first ? v : *p + v;
}

// One consumer warp of the delta kernel: rows r0 .. r0+15 of each of its tiles.
template <int W>
__device__ void consume_backward(const float* __restrict__ pts, const float* __restrict__ dirs,
                                 int n, const BwdParams& p, Ring ring, float* act, float* emb,
                                 float* dsm, float* gal, int first_tile, int tile_step,
                                 int tiles) {
  using S = Smem<float, W>;
  constexpr int H = W / 2;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const Bwd& s = p.s;
  const float* wbuf = reinterpret_cast<const float*>(p.f.w);
  const int D = p.f.D, E = p.f.E;
  uint32_t* mask = p.masks + (size_t)blockIdx.x * D * (W / 64) * 256 + threadIdx.x;
  float* hs = p.heads + ((size_t)blockIdx.x * CONSUMER_WARPS + warp) * s.head_floats();

  clear_pads<float, W>(emb, dsm, E);
  for (int it = 0; it < tiles; ++it) {
    const bool first = it == 0;
    const int r0 = (first_tile + it * tile_step) * TILE + warp * 16;
    const long long c0 = r0 / 8;  // this warp's first chunk of 8 points
    encode<float, W>(pts, dirs, n, r0, E, emb, dsm);
    __syncwarp();
    store_x<EMB_COLS>(emb, S::LDE, p.xs + s.x_emb() + c0 * EMB_COLS * 8);
    store_x<DIRS_ROWS>(dsm, S::LDD, p.xs + s.x_dirs() + c0 * DIRS_ROWS * 8);

    // ---- the forward again, keeping every layer's input
    int i = 0;
    float acc[W / 2];
    bool amb0 = false, amb1 = false;  // rows g, g + 8: a ReLU decision near 0
    for (int l = 0; l < D; ++l) {
      zero(acc);
      if (l == 0) {
        gemm<float, W>(acc, emb, S::LDE, EMB_COLS, p.f.rows[i], p.f.kp[i], ring), ++i;
      } else {
        if (s.skip(l)) gemm<float, W>(acc, emb, S::LDE, EMB_COLS, p.f.rows[i], p.f.kp[i], ring), ++i;
        gemm<float, W>(acc, act, S::LDA, W, p.f.rows[i], p.f.kp[i], ring), ++i;
      }
      epilogue<float, W>(acc, p.f.b[l], act, S::LDA, true);
      near_zero<W>(acc, p.f.b[l], amb0, amb1);
      save_mask<W>(acc, p.f.b[l], mask + (size_t)l * (W / 64) * 256);
      store_x<W>(act, S::LDA, p.xs + s.x_h(l) + c0 * W * 8);
    }

    // alpha, and its upstream gradient through softplus(10 alpha) / 10 as
    // PyTorch's softplus backward takes it (threshold 20); lanes 2r, 2r+1
    // hold row r's. dw_alpha and db_alpha from h_{D-1}, still in act.
    const int ia = i++;
    {
      float alpha[1];
      head<1, float>(act, S::LDA, W, wbuf + p.f.off[ia], p.f.b[D], alpha);
      const int row = r0 + (lane >> 1);
      const float gs = row < n ? __ldg(p.g + (size_t)row * 4 + 3) : 0.f;
      const float z = 10.f * alpha[0];
      const float e = expf(z);
      const float ga = (z > 20.f ? gs / 10.f : gs / 10.f * e / (e + 1.f)) * 10.f;
      if ((lane & 1) == 0) gal[lane >> 1] = ga;
      __syncwarp();
      float sw[W / 32], sb = 0.f;
#pragma unroll
      for (int k = 0; k < W / 32; ++k) sw[k] = 0.f;
      for (int r = 0; r < 16; ++r) {
        const float gr = gal[r];
        sb += gr;
#pragma unroll
        for (int k = 0; k < W / 32; ++k) sw[k] = fmaf(gr, act[r * S::LDA + lane + 32 * k], sw[k]);
      }
#pragma unroll
      for (int k = 0; k < W / 32; ++k) slot_add(hs + lane + 32 * k, sw[k], first);
      if (lane == 0) slot_add(hs + W, sb, first);
    }

    zero(acc);
    gemm<float, W>(acc, act, S::LDA, W, p.f.rows[i], p.f.kp[i], ring), ++i;
    epilogue<float, W>(acc, p.f.b[D + 1], act, S::LDA, false);
    store_x<W>(act, S::LDA, p.xs + s.x_feat() + c0 * W * 8);
    {
      float accv[W / 4];
      zero(accv);
      gemm<float, W / 2>(accv, act, S::LDA, W, p.f.rows[i], p.f.kp[i], ring), ++i;
      gemm<float, W / 2>(accv, dsm, S::LDD, Mode<float>::KSTEP, p.f.rows[i], p.f.kp[i], ring), ++i;
      epilogue<float, W / 2>(accv, p.f.b[D + 2], act, S::LDA, true);
      near_zero<W / 2>(accv, p.f.b[D + 2], amb0, amb1);
    }
    if (t == 0) {  // the fix-up takes these rows' deltas again
      if (amb0 && r0 + g < n) p.fix_rows[atomicAdd(p.fix_count, 1)] = r0 + g;
      if (amb1 && r0 + g + 8 < n) p.fix_rows[atomicAdd(p.fix_count, 1)] = r0 + g + 8;
    }

    // ---- back through the rgb head on the CUDA cores: delta_v =
    // (g_rgb W_rgb) * 1[hv > 0] into act[:, H:W]; dW_rgb, db_rgb per warp
    {
      const float* wr = wbuf + p.f.off[i];
      float w[3][H / 32], sw[3][H / 32], sb[3] = {0.f, 0.f, 0.f};
#pragma unroll
      for (int k = 0; k < H / 32; ++k)
#pragma unroll
        for (int c = 0; c < 3; ++c) w[c][k] = wr[c * H + lane + 32 * k], sw[c][k] = 0.f;
      const int row = r0 + (lane & 15);
      const float4 g4 = row < n ? __ldg(reinterpret_cast<const float4*>(p.g) + row)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
      for (int r = 0; r < 16; ++r) {
        const float gx = __shfl_sync(0xffffffffu, g4.x, r);
        const float gy = __shfl_sync(0xffffffffu, g4.y, r);
        const float gz = __shfl_sync(0xffffffffu, g4.z, r);
        sb[0] += gx, sb[1] += gy, sb[2] += gz;
        float* a = act + r * S::LDA;
#pragma unroll
        for (int k = 0; k < H / 32; ++k) {
          const int j = lane + 32 * k;
          const float hv = a[j];
          const float d = fmaf(gz, w[2][k], fmaf(gy, w[1][k], gx * w[0][k]));
          a[H + j] = hv > 0.f ? d : 0.f;
          sw[0][k] = fmaf(gx, hv, sw[0][k]);
          sw[1][k] = fmaf(gy, hv, sw[1][k]);
          sw[2][k] = fmaf(gz, hv, sw[2][k]);
        }
      }
#pragma unroll
      for (int c = 0; c < 3; ++c) {
#pragma unroll
        for (int k = 0; k < H / 32; ++k) slot_add(hs + W + 1 + c * H + lane + 32 * k, sw[c][k], first);
        if (lane == 0) slot_add(hs + W + 1 + 3 * H + c, sb[c], first);
      }
    }
    __syncwarp();
    store_delta<H>(act + H, S::LDA, p.ds + s.d_v() + c0 * H * 8);

    // ---- the deltas on wgmma, through the transposed parts
    int k = 0;
    zero(acc);  // feature: no ReLU
    gemm<float, W>(acc, act + H, S::LDA, H, p.t_rows[k], p.t_kp[k], ring), ++k;
    store_rows<W>(acc, act, S::LDA);
    store_delta<W>(act, S::LDA, p.ds + s.d_feat() + c0 * W * 8);

    zero(acc);  // h_{D-1} feeds the feature layer and alpha
    gemm<float, W>(acc, act, S::LDA, W, p.t_rows[k], p.t_kp[k], ring), ++k;
    {
      const float ga0 = gal[g], ga1 = gal[g + 8];
      const float* wa = wbuf + p.f.off[ia];
#pragma unroll
      for (int j = 0; j < W / 8; ++j) {
        const float2 w2 = *reinterpret_cast<const float2*>(wa + j * 8 + 2 * t);
        acc[4 * j] += ga0 * w2.x, acc[4 * j + 1] += ga0 * w2.y;
        acc[4 * j + 2] += ga1 * w2.x, acc[4 * j + 3] += ga1 * w2.y;
      }
    }
    for (int l = D - 1;; --l) {  // acc holds the gradient of h_l
      apply_mask<W>(acc, mask + (size_t)l * (W / 64) * 256);
      store_rows<W>(acc, act, S::LDA);
      store_delta<W>(act, S::LDA, p.ds + s.d_z(l) + c0 * W * 8);
      if (l == 0) break;
      zero(acc);  // through layer l's h columns (the skip layer's past E)
      gemm<float, W>(acc, act, S::LDA, W, p.t_rows[k], p.t_kp[k], ring), ++k;
    }
    __syncwarp();  // the next tile's embedding and act overwrite what this one read
  }
}

template <int W>
__global__ void __launch_bounds__(THREADS, 1)
    k1_backward_delta_kernel(const float* __restrict__ pts, const float* __restrict__ dirs, int n,
                             const __grid_constant__ BwdParams p) {
  using S = Smem<float, W>;
  constexpr int STAGES = Mode<float>::STAGES;
  extern __shared__ __align__(128) char smem[];
  Ring ring{smem_u32(smem + S::RING), smem_u32(smem + S::BARS), S::STAGE_BYTES, STAGES, 0, 0};

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(ring.bars + 8 * s, 1);
      mbar_init(ring.bars + 8 * (STAGES + s), CONSUMER_WARPS);
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  const int tiles = (n + TILE - 1) / TILE;
  const int mine = (tiles - (int)blockIdx.x + (int)gridDim.x - 1) / (int)gridDim.x;

  if (threadIdx.x >= 128 * CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x == 128 * CONSUMERS)
      for (int t = 0; t < mine; ++t) {
        produce_parts(p.f.w, p.f.off, p.f.rows, p.f.kp, p.f.n_parts, ring);
        produce_parts(p.wt, p.t_off, p.t_rows, p.t_kp, p.n_tparts, ring);
      }
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    const int wrow = (threadIdx.x >> 5) * 16;
    float* act = reinterpret_cast<float*>(smem + S::ACT) + wrow * S::LDA;
    float* emb = reinterpret_cast<float*>(smem + S::EMB) + wrow * S::LDE;
    float* dsm = reinterpret_cast<float*>(smem + S::DIRS) + wrow * S::LDD;
    float* gal = reinterpret_cast<float*>(smem + S::BYTES) + wrow;  // alpha's gradient a row
    consume_backward<W>(pts, dirs, n, p, ring, act, emb, dsm, gal, blockIdx.x, gridDim.x, mine);
  }
}

constexpr int DW_DELTA_BYTES = DW_ROWS * DEPTH_BYTES;  // a block's deltas of one chunk

template <int W>
struct DwSmem {
  static constexpr int X_BYTES = W * DEPTH_BYTES;              // the largest input chunk
  static constexpr int STAGE_BYTES = 2 * X_BYTES + DW_DELTA_BYTES;  // hi, lo, the deltas
  static constexpr int RAW_BYTES = X_BYTES + DW_DELTA_BYTES;         // the input, the deltas
  static constexpr int RING = 0;
  static constexpr int RAW = RING + DW_STAGES * STAGE_BYTES;
  static constexpr int BARS = RAW + RAW_STAGES * RAW_BYTES;
  static constexpr int BYTES = BARS + 2 * 8 * DW_STAGES;
  static_assert(BYTES <= 232448, "shared memory of one block");
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// A 4-byte copy by cp.async, or a zero (nothing read) where !valid.
__device__ __forceinline__ void cp_async4(void* dst, const float* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// ---- the fix-up: plain f32 ReLU decisions where the 3xTF32 ones may differ

struct FixParams {
  Bwd s;
  const float* pts;
  const float* dirs;
  const float* g;
  const float* w[MAX_D + 4];   // the f32 weights (out, in), flat_weights' order
  const float* b[MAX_D + 4];   // and biases
  const int* count;
  const int* rows;
  const float* xs;             // the delta kernel's layer inputs
  float* ds;                   // and deltas, rewritten for the rows that need it
};

template <int W>
struct FixSmem {
  // a point's inputs: [emb (E), zeros to EMB_COLS, h (W)], or from EMB_COLS
  // [feature (W), dirs (3)]; zeros past what a layer reads, up to whole tiles
  static constexpr int LDX = EMB_COLS + W + FIX_KT;
  static constexpr int LDT = FIX_KT + 4;  // a row of W's tile: float4 reads without conflicts
  static constexpr int LDTT = FIX_KT + 1;  // a row of W^T's tile: its transposing stores too
  static constexpr int X = 0;                                    // FIX_POINTS x LDX
  static constexpr int D0 = X + FIX_POINTS * LDX;                // FIX_POINTS x W deltas
  static constexpr int TILE_W = D0 + FIX_POINTS * W;             // 2 x W x LDT weights
  static constexpr int MASKS = TILE_W + 2 * W * LDT;             // (D+1) x FIX_POINTS x W/32
  static constexpr int ROWS = MASKS + (MAX_D + 1) * FIX_POINTS * (W / 32);
  static constexpr int GA = ROWS + FIX_POINTS;
  static constexpr int NEED = GA + FIX_POINTS;
  static constexpr int BYTES = (NEED + FIX_POINTS) * 4;
  static_assert(BYTES <= 232448 / 2, "shared memory of two blocks");
};

// Where the delta kernel stored column col of point row of an m-column
// delta starting at base (store_delta's layout), and of an n-column layer
// input (store_x's).
__device__ __forceinline__ long long delta_at(long long base, int m, int row, int col) {
  return base + (long long)(row >> 3) * m * 8 + (col >> 4) * 128 + (4 * (col & 7) + (row & 3)) * 4 +
         ((col >> 3) & 1) + 2 * ((row >> 2) & 1);
}
__device__ __forceinline__ long long input_at(long long base, int n, int row, int col) {
  return base + (long long)(row >> 3) * n * 8 + (col >> 3) * 64 + ((row >> 2) & 1) * 32 +
         (col & 7) * 4 + (row & 3);
}

// One thread's share of copying weight tile `at` of a layer into buf, by
// cp.async (zeros where it reads nothing), committed as one group. Tile at of W:
// rows j < nout, K positions at * FIX_KT .. + FIX_KT, at buf[j][kk]
// (stride LDT), input position k reading weight column c(k) (see
// fix_dense); of W^T (transposed): rows j = at * FIX_KT + jj < nout,
// columns c0 .. c0 + W, at buf[k][jj] (stride LDTT).
template <int W>
__device__ __forceinline__ void fix_tile(float* buf, const float* __restrict__ w, int K, int nout,
                                         int a, int b, int kin, int c0, int at, bool transposed) {
  using S = FixSmem<W>;
  if (!transposed && a == kin && K % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0) {
    for (int e = threadIdx.x; e < nout * (FIX_KT / 4); e += W) {
      const int r = e / (FIX_KT / 4), k = at * FIX_KT + 4 * (e % (FIX_KT / 4));
      cp_async16(buf + r * S::LDT + k - at * FIX_KT, w + (size_t)r * K + k);
    }
  } else if (!transposed) {
    for (int e = threadIdx.x; e < nout * FIX_KT; e += W) {
      const int r = e / FIX_KT, kk = e % FIX_KT, k = at * FIX_KT + kk;
      const int c = k < a ? k : k < b || k >= kin ? -1 : a + k - b;
      cp_async4(buf + r * S::LDT + kk, w + (c < 0 ? 0 : (size_t)r * K + c), c >= 0);
    }
  } else {
    for (int e = threadIdx.x; e < FIX_KT * W; e += W) {
      const int jj = e / W, kk = e % W, j = at * FIX_KT + jj;
      cp_async4(buf + kk * S::LDTT + jj, w + (j < nout ? (size_t)j * K + c0 + kk : 0), j < nout);
    }
  }
  cp_async_commit();
}

// acc[q] = sum over k of x[q][k] w[j][c(k)] for this thread's output j <
// nout, as one fused multiply-add after another in the order of k from 0,
// which is the arithmetic of cuBLAS's f32 GEMM at these shapes (checked on
// an H100). Input positions k < a read weight column k, a <= k < b none
// (zeros of x), b <= k < kin column a + k - b; x holds zeros up to whole
// tiles past kin. The tiles come through two buffers, the next one's
// copies in flight while this one is summed.
template <int W>
__device__ void fix_dense(const float* __restrict__ w, int K, int nout, const float* x, int a,
                          int b, int kin, float* tiles, float (&acc)[FIX_POINTS]) {
  using S = FixSmem<W>;
  const int j = threadIdx.x;
  const int n_tiles = (kin + FIX_KT - 1) / FIX_KT;
#pragma unroll
  for (int q = 0; q < FIX_POINTS; ++q) acc[q] = 0.f;
  __syncthreads();  // whoever read the buffers last is done
  fix_tile<W>(tiles, w, K, nout, a, b, kin, 0, 0, false);
  for (int t = 0; t < n_tiles; ++t) {
    const float* tile = tiles + (t & 1) * W * S::LDT;
    if (t + 1 < n_tiles) {
      fix_tile<W>(tiles + ((t + 1) & 1) * W * S::LDT, w, K, nout, a, b, kin, 0, t + 1, false);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j < nout) {
      const float* wr = tile + j * S::LDT;
      const int k0 = t * FIX_KT;
#pragma unroll 2
      for (int kk = 0; kk < FIX_KT; kk += 4) {
        const float4 w4 = *reinterpret_cast<const float4*>(wr + kk);
#pragma unroll
        for (int q = 0; q < FIX_POINTS; ++q) {
          const float4 x4 = *reinterpret_cast<const float4*>(x + q * S::LDX + k0 + kk);
          acc[q] = fmaf(x4.x, w4.x, acc[q]);
          acc[q] = fmaf(x4.y, w4.y, acc[q]);
          acc[q] = fmaf(x4.z, w4.z, acc[q]);
          acc[q] = fmaf(x4.w, w4.w, acc[q]);
        }
      }
    }
    __syncthreads();  // this buffer is read before the copies after next overwrite it
  }
}

// acc[q] = sum over j < nout of w[j][c0 + k] d[q][j] for this thread's
// input column k < W (d: FIX_POINTS x W), the tiles as fix_dense takes them.
template <int W>
__device__ void fix_dense_t(const float* __restrict__ w, int K, int nout, int c0, const float* d,
                            float* tiles, float (&acc)[FIX_POINTS]) {
  using S = FixSmem<W>;
  const int k = threadIdx.x;
  const int n_tiles = (nout + FIX_KT - 1) / FIX_KT;
#pragma unroll
  for (int q = 0; q < FIX_POINTS; ++q) acc[q] = 0.f;
  __syncthreads();
  fix_tile<W>(tiles, w, K, nout, 0, 0, 0, c0, 0, true);
  for (int t = 0; t < n_tiles; ++t) {
    const float* tile = tiles + (t & 1) * W * S::LDT;
    if (t + 1 < n_tiles) {
      fix_tile<W>(tiles + ((t + 1) & 1) * W * S::LDT, w, K, nout, 0, 0, 0, c0, t + 1, true);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const float* wr = tile + k * S::LDTT;
    const int j0 = t * FIX_KT;
#pragma unroll 2
    for (int jj = 0; jj < FIX_KT; jj += 4) {
      const float w0 = wr[jj], w1 = wr[jj + 1], w2 = wr[jj + 2], w3 = wr[jj + 3];
#pragma unroll
      for (int q = 0; q < FIX_POINTS; ++q) {
        const float4 d4 = j0 + jj < nout ? *reinterpret_cast<const float4*>(d + q * W + j0 + jj)
                                         : make_float4(0.f, 0.f, 0.f, 0.f);
        acc[q] = fmaf(d4.x, w0, acc[q]);
        acc[q] = fmaf(d4.y, w1, acc[q]);
        acc[q] = fmaf(d4.z, w2, acc[q]);
        acc[q] = fmaf(d4.w, w3, acc[q]);
      }
    }
    __syncthreads();
  }
}

// z = acc + bias (one rounding, as cuBLAS's epilogue adds it), its ReLU
// decisions as bits (m: FIX_POINTS x W/32 words) and, if dst, relu(z) or z
// there. need[q] is set where a decision differs from the delta kernel's:
// h > 0 in its layer input at xin (a trunk layer), or, at dv (the view
// layer), a nonzero delta (its delta is 0 where the ReLU stopped it; where
// the product itself is 0 the decision does not matter).
template <int W>
__device__ __forceinline__ void fix_out(const float (&acc)[FIX_POINTS], const float* __restrict__ bias,
                                        int nout, uint32_t* m, float* dst, bool relu,
                                        const int* rows, int np, const float* xin, long long at,
                                        int* need) {
  using S = FixSmem<W>;
  const int j = threadIdx.x;
  if (j >= nout) return;  // nout is a whole number of warps
  const float bj = __ldg(bias + j);
#pragma unroll
  for (int q = 0; q < FIX_POINTS; ++q) {
    const float z = acc[q] + bj;
    const unsigned bits = __ballot_sync(0xffffffffu, z > 0.f);
    if (m != nullptr && (j & 31) == 0) m[q * (W / 32) + (j >> 5)] = bits;
    if (dst != nullptr) dst[q * S::LDX + j] = relu ? fmaxf(z, 0.f) : z;
    if (m != nullptr && q < np) {
      const bool before = relu && dst != nullptr ? xin[input_at(at, W, rows[q], j)] > 0.f
                                                 : xin[delta_at(at, W / 2, rows[q], j)] != 0.f;
      if (before != (z > 0.f)) need[q] = 1;
    }
  }
}

// d[q][k] = acc[q] where layer l's ReLU let it through, else 0; and that to
// the scratch of the rows that need it.
template <int W>
__device__ __forceinline__ void fix_delta(const float (&acc)[FIX_POINTS], const uint32_t* m,
                                          float* d, float* __restrict__ ds, long long base,
                                          const int* rows, const int* need) {
  const int k = threadIdx.x;
#pragma unroll
  for (int q = 0; q < FIX_POINTS; ++q) {
    const float v = m == nullptr || ((m[q * (W / 32) + (k >> 5)] >> (k & 31)) & 1) ? acc[q] : 0.f;
    d[q * W + k] = v;
    if (need[q]) ds[delta_at(base, W, rows[q], k)] = v;
  }
}

// The rows the delta kernel listed, FIX_POINTS at a time: the network again
// in plain f32 (the PE as PyTorch's sin and cos take it, every product as
// fix_dense sums it) and its ReLU decisions. Where one differs from the
// delta kernel's, every delta of the row again from the heads down, in f32
// on the CUDA cores; the weight gradients then read these deltas as any
// others. A row's result depends on nothing but the row, so the order of
// the list does not matter. Two blocks an SM, as the shared memory allows,
// cap a thread at 128 registers and spill 52 bytes (W=256); one block of
// 192 registers and no spills took 0.61 ms in place of 0.44 at a fine
// pass's 196,608 points (H100).
template <int W>
__global__ void __launch_bounds__(W, 2) k1_backward_fix_kernel(const __grid_constant__ FixParams p) {
  using S = FixSmem<W>;
  constexpr int H = W / 2;
  extern __shared__ __align__(16) float fsm[];
  float* x = fsm + S::X;
  float* d1 = fsm + S::D0;
  float* d2 = x;  // the inputs are not needed once the deltas start
  float* tile = fsm + S::TILE_W;
  uint32_t* masks = reinterpret_cast<uint32_t*>(fsm + S::MASKS);
  int* rows = reinterpret_cast<int*>(fsm + S::ROWS);
  float* ga = fsm + S::GA;
  int* need = reinterpret_cast<int*>(fsm + S::NEED);
  const Bwd& s = p.s;
  const int D = s.D, E = s.E;
  const int count = *p.count;
  const float kPi = 3.14159265358979323846f;
  float acc[FIX_POINTS];

  for (int q0 = blockIdx.x * FIX_POINTS; q0 < count; q0 += gridDim.x * FIX_POINTS) {
    const int np = count - q0 < FIX_POINTS ? count - q0 : FIX_POINTS;
    __syncthreads();  // the last batch is done with shared memory
    if (threadIdx.x < FIX_POINTS) {
      rows[threadIdx.x] = threadIdx.x < np ? p.rows[q0 + threadIdx.x] : 0;
      need[threadIdx.x] = 0;
    }
    for (int e = threadIdx.x; e < FIX_POINTS * S::LDX; e += W) x[e] = 0.f;
    __syncthreads();
    for (int e = threadIdx.x; e < np * E; e += W) {  // [x, sin, cos of each frequency]
      const int q = e / E, c = e % E, row = rows[q];
      float v;
      if (c < 3) {
        v = p.pts[(size_t)row * 3 + c];
      } else {
        const int f = (c - 3) / 6, o = (c - 3) % 6;
        const float arg = (p.pts[(size_t)row * 3 + o % 3] * kPi) * (float)(1 << f);
        v = o < 3 ? sinf(arg) : cosf(arg);
      }
      x[q * S::LDX + c] = v;
    }

    // ---- forward: the trunk, alpha, the feature, the view layer
    for (int l = 0; l < D; ++l) {
      if (l == 0)
        fix_dense<W>(p.w[0], E, W, x, E, EMB_COLS, EMB_COLS, tile, acc);
      else if (s.skip(l))
        fix_dense<W>(p.w[l], E + W, W, x, E, EMB_COLS, EMB_COLS + W, tile, acc);
      else
        fix_dense<W>(p.w[l], W, W, x + EMB_COLS, W, W, W, tile, acc);
      fix_out<W>(acc, p.b[l], W, masks + l * FIX_POINTS * (W / 32), x + EMB_COLS, true, rows, np,
                 p.xs, s.x_h(l), need);
    }
    __syncthreads();
    if (threadIdx.x < FIX_POINTS) {  // alpha and its upstream gradient, as the delta kernel takes it
      const int q = threadIdx.x;
      float a = 0.f;
      for (int k = 0; k < W; ++k) a = fmaf(x[q * S::LDX + EMB_COLS + k], __ldg(p.w[D] + k), a);
      a += __ldg(p.b[D]);
      const float gs = q < np ? __ldg(p.g + (size_t)rows[q] * 4 + 3) : 0.f;
      const float z = 10.f * a;
      const float ez = expf(z);
      ga[q] = (z > 20.f ? gs / 10.f : gs / 10.f * ez / (ez + 1.f)) * 10.f;
    }
    fix_dense<W>(p.w[D + 1], W, W, x + EMB_COLS, W, W, W, tile, acc);  // syncs before and after
    fix_out<W>(acc, p.b[D + 1], W, nullptr, x + EMB_COLS, false, rows, np, nullptr, 0, need);
    for (int e = threadIdx.x; e < np * 3; e += W)
      x[(e / 3) * S::LDX + EMB_COLS + W + e % 3] = p.dirs[(size_t)rows[e / 3] * 3 + e % 3];
    fix_dense<W>(p.w[D + 2], W + 3, H, x + EMB_COLS, W + 3, W + 3, W + 3, tile, acc);
    uint32_t* mv = masks + D * FIX_POINTS * (W / 32);
    fix_out<W>(acc, p.b[D + 2], H, mv, nullptr, true, rows, np, p.ds, s.d_v(), need);
    __syncthreads();
    bool any = false;
#pragma unroll
    for (int q = 0; q < FIX_POINTS; ++q) any |= need[q] != 0;
    if (!any) continue;  // the same for every thread

    // ---- back: the rgb head, the view layer, the feature, the trunk
    if (threadIdx.x < H) {
      const int j = threadIdx.x;
      const float* wr = p.w[D + 3];
      const float w0 = __ldg(wr + j), w1 = __ldg(wr + H + j), w2 = __ldg(wr + 2 * H + j);
      for (int q = 0; q < FIX_POINTS; ++q) {
        const float4 g4 = q < np ? __ldg(reinterpret_cast<const float4*>(p.g) + rows[q])
                                 : make_float4(0.f, 0.f, 0.f, 0.f);
        const float v = fmaf(g4.z, w2, fmaf(g4.y, w1, g4.x * w0));
        const float dv = (mv[q * (W / 32) + (j >> 5)] >> (j & 31)) & 1 ? v : 0.f;
        d1[q * W + j] = dv;
        if (need[q]) p.ds[delta_at(s.d_v(), H, rows[q], j)] = dv;
      }
    }
    fix_dense_t<W>(p.w[D + 2], W + 3, H, 0, d1, tile, acc);
    fix_delta<W>(acc, nullptr, d2, p.ds, s.d_feat(), rows, need);
    fix_dense_t<W>(p.w[D + 1], W, W, 0, d2, tile, acc);
    {
      const float wa = __ldg(p.w[D] + threadIdx.x);
#pragma unroll
      for (int q = 0; q < FIX_POINTS; ++q) acc[q] = fmaf(ga[q], wa, acc[q]);
    }
    float* dl = d1;  // delta_l, then delta_{l-1} in the other buffer
    fix_delta<W>(acc, masks + (D - 1) * FIX_POINTS * (W / 32), dl, p.ds, s.d_z(D - 1), rows, need);
    for (int l = D - 1; l > 0; --l) {
      fix_dense_t<W>(p.w[l], s.k_in(l), W, s.skip(l) ? E : 0, dl, tile, acc);
      dl = dl == d1 ? d2 : d1;
      fix_delta<W>(acc, masks + (l - 1) * FIX_POINTS * (W / 32), dl, p.ds, s.d_z(l - 1), rows, need);
    }
  }
}

// x = hi + lo as split_tf32 splits it (cvt.rna.tf32.f32: to nearest, ties
// away from zero; the same bits), in integer operations at full rate.
__device__ __forceinline__ void split_tf32_int(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xFFFFE000u;
  lo = (__float_as_uint(x - __uint_as_float(hi)) + 0x1000u) & 0xFFFFE000u;
}

// The producer warpgroup of a dW block. Each of its 128 threads copies its
// share of each chunk's raw input (nx rows) and of the block's deltas
// (`d_bytes` of its rows) with cp.async into a raw ring RAW_STAGES deep,
// then splits the same elements of the input into their tf32 hi and lo
// images in a stage of the ring that wgmma reads and moves its deltas
// after them (zero past d_bytes). A thread reads back only what it copied,
// so the raw ring needs no barrier. (One-dimensional bulk copies of the
// same chunks reached about 1.5 TB/s, which held the kernel back.)
template <int W>
__device__ void produce_split(const float* x, int nx, const float* d, int d_floats, int d_bytes,
                              long long c_begin, long long c_end, Ring ring, char* smem) {
  using S = DwSmem<W>;
  constexpr int X4 = S::X_BYTES / 16 / 128;        // float4s a thread of the largest input chunk
  constexpr int D4 = DW_DELTA_BYTES / 16 / 128;    // and of the deltas
  const int tid = threadIdx.x - 128 * CONSUMERS;
  const unsigned base = smem_u32(smem);
  const int n4 = nx * DEPTH_BYTES / 16, d4 = d_bytes / 16;
  auto slot = [&](long long c) { return smem + S::RAW + (int)((c - c_begin) % RAW_STAGES) * S::RAW_BYTES; };
  auto fetch = [&](long long c) {
    if (c < c_end) {
      char* raw = slot(c);
      const float4* xs = reinterpret_cast<const float4*>(x + c * nx * 8);
      const float4* dd = reinterpret_cast<const float4*>(d + c * d_floats);
#pragma unroll
      for (int q = 0; q < X4; ++q)
        if (tid + 128 * q < n4) cp_async16(raw + 16 * (tid + 128 * q), xs + tid + 128 * q);
#pragma unroll
      for (int q = 0; q < D4; ++q)
        if (tid + 128 * q < d4) cp_async16(raw + S::X_BYTES + 16 * (tid + 128 * q), dd + tid + 128 * q);
    }
    cp_async_commit();  // one group a chunk, empty past the end
  };
  for (int k = 0; k < RAW_STAGES - 1; ++k) fetch(c_begin + k);
  for (long long c = c_begin; c < c_end; ++c) {
    fetch(c + RAW_STAGES - 1);  // into the slot chunk c - 1 left
    cp_async_wait<RAW_STAGES - 1>();  // chunk c's group is in
    mbar_wait(ring.empty(), ring.phase ^ 1);
    const char* raw = slot(c);
    char* st = smem + (ring.data() - base);
    const float4* src = reinterpret_cast<const float4*>(raw);
    float4* hi = reinterpret_cast<float4*>(st);
    float4* lo = hi + n4;
#pragma unroll
    for (int q = 0; q < X4; ++q) {
      const int e = tid + 128 * q;
      if (e >= n4) break;
      const float4 v = src[e];
      uint32_t h[4], l[4];
      split_tf32_int(v.x, h[0], l[0]);
      split_tf32_int(v.y, h[1], l[1]);
      split_tf32_int(v.z, h[2], l[2]);
      split_tf32_int(v.w, h[3], l[3]);
      hi[e] = make_float4(__uint_as_float(h[0]), __uint_as_float(h[1]), __uint_as_float(h[2]),
                          __uint_as_float(h[3]));
      lo[e] = make_float4(__uint_as_float(l[0]), __uint_as_float(l[1]), __uint_as_float(l[2]),
                          __uint_as_float(l[3]));
    }
    const float4* dsrc = reinterpret_cast<const float4*>(raw + S::X_BYTES);
    float4* ddst = reinterpret_cast<float4*>(st + 2 * S::X_BYTES);
#pragma unroll
    for (int q = 0; q < D4; ++q) {
      const int e = tid + 128 * q;
      ddst[e] = e < d4 ? dsrc[e] : make_float4(0.f, 0.f, 0.f, 0.f);
    }
    // the split images are read by wgmma (the async proxy); one arrival a
    // warp, after its lanes' writes
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncwarp();
    if ((tid & 31) == 0) mbar_arrive(ring.full());
    ring.advance();
  }
  cp_async_wait<0>();
}

// One consumer warp of a dW block: its 16 gradient rows over the block's
// chunks, NX input rows, then its partial (and the bias's) to `part`.
template <int W, int NX>
__device__ void dw_consume(const DwJob& j, float* __restrict__ part, long long c_begin,
                           long long c_end, Ring ring, const char* smem) {
  constexpr int SN = NX < SLAB ? NX : SLAB;
  constexpr int NS = NX / SN;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int row0 = j.o0 + warp * 16;  // warps 0-3: rows o0 .. o0+63, 4-7 the next 64
  const unsigned base = smem_u32(smem);

  float acc[NX / 2], fresh[2][SN / 2], bsum[2] = {0.f, 0.f};
  zero(acc);
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int q = 0; q < SN / 2; ++q) fresh[h][q] = 0.f;
  for (long long c = c_begin; c < c_end; ++c) {
    mbar_wait(ring.full(), ring.phase);
    const unsigned st = ring.data();
    // this warp's A fragment of the chunk's deltas (zero past the part's rows)
    const float4 v = reinterpret_cast<const float4*>(smem + (st - base) + 2 * DwSmem<W>::X_BYTES)
        [warp * 32 + lane];
    uint32_t a[2][4];
    split_tf32(v.x, a[0][0], a[1][0]);  // (g, t)
    split_tf32(v.y, a[0][1], a[1][1]);  // (g + 8, t)
    split_tf32(v.z, a[0][2], a[1][2]);  // (g, t + 4)
    split_tf32(v.w, a[0][3], a[1][3]);  // (g + 8, t + 4)
    bsum[0] += v.x, bsum[0] += v.z, bsum[1] += v.y, bsum[1] += v.w;
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      wg_fence();
      group<SN>(fresh[s & 1], a, st, NX, s * SN, (float*)nullptr);
      wg_commit();
      if (s > 0) {
        wg_wait<1>();
        keep(fresh[(s - 1) & 1]);
#pragma unroll
        for (int q = 0; q < SN / 2; ++q) acc[(s - 1) * (SN / 2) + q] += fresh[(s - 1) & 1][q];
      }
    }
    wg_wait<0>();
    keep(fresh[(NS - 1) & 1]);
    keep(a[0]);
    keep(a[1]);
#pragma unroll
    for (int q = 0; q < SN / 2; ++q) acc[(NS - 1) * (SN / 2) + q] += fresh[(NS - 1) & 1][q];
    __syncwarp();
    if (lane == 0) mbar_arrive(ring.empty());
    ring.advance();
  }
  if (row0 >= j.m) return;  // m is a multiple of 16
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 1);
    bsum[h] += __shfl_xor_sync(0xffffffffu, bsum[h], 2);
  }
  float* out = part + j.dst + (long long)(row0 + g) * j.stride;
#pragma unroll
  for (int q = 0; q < NX / 8; ++q) {
    const int col = q * 8 + 2 * t;
    if (col < j.ncols) out[col] = acc[4 * q], out[8 * j.stride + col] = acc[4 * q + 2];
    if (col + 1 < j.ncols) out[col + 1] = acc[4 * q + 1], out[8 * j.stride + col + 1] = acc[4 * q + 3];
  }
  if (j.bias >= 0 && t == 0) part[j.bias + row0 + g] = bsum[0], part[j.bias + row0 + g + 8] = bsum[1];
}

template <int W>
__global__ void __launch_bounds__(THREADS, 1) k1_backward_dw_kernel(const __grid_constant__ DwParams p) {
  using S = DwSmem<W>;
  extern __shared__ __align__(128) char smem[];
  const unsigned bars = smem_u32(smem + S::BARS);
  Ring ring{smem_u32(smem + S::RING), bars, S::STAGE_BYTES, DW_STAGES, 0, 0};
  if (threadIdx.x == 0) {
    for (int s = 0; s < DW_STAGES; ++s) {
      mbar_init(ring.bars + 8 * s, 4);                            // every producer warp
      mbar_init(ring.bars + 8 * (DW_STAGES + s), CONSUMER_WARPS);  // every consumer warp
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
  }
  __syncthreads();

  DwJob j;
  dw_job(p.s, blockIdx.x / p.splits, &j, nullptr);
  const int split = blockIdx.x % p.splits;
  const long long c_begin = p.chunks * split / p.splits, c_end = p.chunks * (split + 1) / p.splits;
  float* part = p.part + (long long)split * p.s.total();

  if (threadIdx.x >= 128 * CONSUMERS) {
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    const int rows = j.m - j.o0 < DW_ROWS ? j.m - j.o0 : DW_ROWS;
    produce_split<W>(p.xs + j.x, j.nx, p.ds + j.d + j.o0 * 8, j.m * 8, rows * DEPTH_BYTES, c_begin,
                     c_end, ring, smem);
  } else {
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
    if (j.nx == W)
      dw_consume<W, W>(j, part, c_begin, c_end, ring, smem);
    else if (j.nx == EMB_COLS)
      dw_consume<W, EMB_COLS>(j, part, c_begin, c_end, ring, smem);
    else
      dw_consume<W, DIRS_ROWS>(j, part, c_begin, c_end, ring, smem);
  }
}

// grad[e] = the sum of e's partials in order: the heads' entries over the
// per-warp slots, every other entry over the dW splits.
__global__ void k1_backward_reduce_kernel(const float* __restrict__ part, int splits, long long total,
                                          const float* __restrict__ heads, int slots, int hf,
                                          long long alpha_at, int alpha_len, long long rgb_at,
                                          int rgb_len, float* __restrict__ grad) {
  for (long long e = blockIdx.x * (long long)blockDim.x + threadIdx.x; e < total;
       e += (long long)gridDim.x * blockDim.x) {
    float sum = 0.f;
    if (e >= alpha_at && e < alpha_at + alpha_len) {
      for (int k = 0; k < slots; ++k) sum += heads[(long long)k * hf + (e - alpha_at)];
    } else if (e >= rgb_at && e < rgb_at + rgb_len) {
      for (int k = 0; k < slots; ++k) sum += heads[(long long)k * hf + alpha_len + (e - rgb_at)];
    } else {
      for (int k = 0; k < splits; ++k) sum += part[k * total + e];
    }
    grad[e] = sum;
  }
}

// Sets a kernel's shared memory, checks that the launch holds the registers
// setmaxnreg hands out, and returns in *blocks how many blocks the card
// holds at once.
template <typename K>
cudaError_t resident_blocks(K kernel, int smem, int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
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
  *blocks = per_sm * sms;
  return cudaSuccess;
}

// The launch geometry and workspace of one backward call.
struct BwdPlan {
  Bwd s;
  int delta_blocks, jobs, splits, fix_blocks;
  long long masks, heads, fix, part, bytes;  // byte offsets in the workspace, and its size
};

// Sets the fix-up kernel's shared memory and returns in *blocks how many of
// its blocks the card holds at once.
template <int W>
cudaError_t fix_blocks(int* blocks) {
  cudaError_t err = cudaFuncSetAttribute(k1_backward_fix_kernel<W>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, FixSmem<W>::BYTES);
  if (err != cudaSuccess) return err;
  int per_sm = 0, dev = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k1_backward_fix_kernel<W>, W,
                                                      FixSmem<W>::BYTES);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  *blocks = per_sm * sms;
  return cudaSuccess;
}

template <int W>
cudaError_t plan_w(BwdPlan* q) {
  static int delta_res = 0, dw_res = 0, fix_res = 0;
  if (delta_res == 0) {
    cudaError_t err = resident_blocks(k1_backward_delta_kernel<W>,
                                      Smem<float, W>::BYTES + TILE * (int)sizeof(float), &delta_res);
    if (err != cudaSuccess) return err;
    err = resident_blocks(k1_backward_dw_kernel<W>, DwSmem<W>::BYTES, &dw_res);
    if (err == cudaSuccess) err = fix_blocks<W>(&fix_res);
    if (err != cudaSuccess) return (delta_res = 0, err);
  }
  q->fix_blocks = fix_res;
  const Bwd& s = q->s;
  const int tiles = (int)(s.n_pad / TILE);
  q->delta_blocks = tiles < delta_res ? tiles : delta_res;
  int heavy = 0;
  q->jobs = dw_job(s, -1, nullptr, &heavy);
  const long long chunks = s.n_pad / 8;
  int splits = dw_res / (heavy > 0 ? heavy : 1);
  splits = splits < 1 ? 1 : splits;
  q->splits = splits > chunks ? (int)chunks : splits;
  const long long floats = s.x_size() + s.d_size();
  q->masks = floats * 4;
  q->heads = q->masks + (long long)q->delta_blocks * s.D * (W / 64) * 256 * 4;
  q->fix = q->heads + (long long)q->delta_blocks * CONSUMER_WARPS * s.head_floats() * 4;
  q->part = q->fix + 16 + s.n_pad * 4;  // the count, then the rows
  q->bytes = q->part + (long long)q->splits * s.total() * 4;
  return cudaSuccess;
}

// The plan of a backward call on n points.
cudaError_t backward_plan(int n, int D, int W, int num_freqs, int skip_mask, BwdPlan* q) {
  if (n <= 0 || D < 1 || D > MAX_D || num_freqs < 1 || 3 + 6 * num_freqs > EMB_COLS)
    return cudaErrorInvalidValue;
  q->s = Bwd{D, W, 3 + 6 * num_freqs, skip_mask & ((1 << (D - 1)) - 1),
             (long long)((n + TILE - 1) / TILE) * TILE};
  switch (W) {
    case 64: return plan_w<64>(q);
    case 128: return plan_w<128>(q);
    case 256: return plan_w<256>(q);
    default: return cudaErrorInvalidValue;
  }
}

template <int W>
cudaError_t launch_backward(const float* pts, const float* dirs, int n, BwdParams& bp,
                            FixParams& fp, const BwdPlan& q, char* ws, float* grad,
                            cudaStream_t stream) {
  const Bwd& s = q.s;
  bp.s = s;
  bp.xs = reinterpret_cast<float*>(ws);
  bp.ds = bp.xs + s.x_size();
  bp.masks = reinterpret_cast<uint32_t*>(ws + q.masks);
  bp.heads = reinterpret_cast<float*>(ws + q.heads);
  bp.fix_count = reinterpret_cast<int*>(ws + q.fix);
  bp.fix_rows = bp.fix_count + 4;
  cudaError_t err = cudaMemsetAsync(bp.fix_count, 0, sizeof(int), stream);
  if (err != cudaSuccess) return err;
  k1_backward_delta_kernel<W><<<q.delta_blocks, THREADS,
                                Smem<float, W>::BYTES + TILE * (int)sizeof(float), stream>>>(
      pts, dirs, n, bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  fp.s = s;
  fp.pts = pts, fp.dirs = dirs, fp.g = bp.g;
  fp.count = bp.fix_count, fp.rows = bp.fix_rows, fp.xs = bp.xs, fp.ds = bp.ds;
  k1_backward_fix_kernel<W><<<q.fix_blocks, W, FixSmem<W>::BYTES, stream>>>(fp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  DwParams dp{s, q.splits, s.n_pad / 8, bp.xs, bp.ds, reinterpret_cast<float*>(ws + q.part)};
  k1_backward_dw_kernel<W><<<q.jobs * q.splits, THREADS, DwSmem<W>::BYTES, stream>>>(dp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long total = s.total();
  const long long alpha_at = s.w_at(s.D), rgb_at = s.w_at(s.D + 3);
  const int blocks = (int)((total + 255) / 256 < 1024 ? (total + 255) / 256 : 1024);
  k1_backward_reduce_kernel<<<blocks, 256, 0, stream>>>(
      dp.part, q.splits, total, bp.heads, q.delta_blocks * CONSUMER_WARPS, s.head_floats(),
      alpha_at, W + 1, rgb_at, 3 * (W / 2) + 3, grad);
  return cudaGetLastError();
}

// The transposed parts pack_layout_t writes, in the order the deltas read
// them: rows W each, K the view layer's W/2 outputs, then W for the
// feature and trunk layers, whole chunks, one after another from 0.
bool check_layout_t(const BwdParams& p, int W) {
  if (p.n_tparts != p.f.D + 1) return false;
  int end = 0;
  for (int i = 0; i < p.n_tparts; ++i) {
    if (p.t_rows[i] != W || p.t_kp[i] != (i == 0 ? W / 2 : W) || p.t_off[i] != end) return false;
    end += 2 * W * p.t_kp[i];
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

// The bytes of device workspace fused_mlp_backward needs for n points, in
// *bytes. Returns a cudaError_t.
extern "C" int fused_mlp_backward_workspace(int n, int D, int W, int num_freqs, int skip_mask,
                                            long long* bytes) {
  BwdPlan q;
  const cudaError_t err = backward_plan(n, D, W, num_freqs, skip_mask, &q);
  *bytes = err == cudaSuccess ? q.bytes : 0;
  return (int)err;
}

// K1's backward (see "K1's backward" above): from pts, dirs (n, 3) and the
// upstream gradient g (n, 4), all f32, the gradient of every weight and bias
// into grad (grad_len floats: flat_weights' tensors one after another).
// g 16-byte aligned. packed/layout: the f32 weights as pack_weights writes
// them and its parts; packed_t/layout_t: its transposed buffer and parts;
// weights: D + 4 device pointers to the f32 weights (out, in) as they are,
// and biases to the biases, both in the order of fused_mlp_forward's
// biases; workspace: `bytes` of device memory, 16-byte aligned, at least
// what fused_mlp_backward_workspace gives. Launches four kernels on
// `stream`. Returns a cudaError_t; 0 is success.
extern "C" int fused_mlp_backward(const float* pts, const float* dirs, const float* g, float* grad,
                                  long long grad_len, int n, int D, int W, int num_freqs,
                                  int skip_mask, const void* packed, const int* layout, int n_parts,
                                  const void* packed_t, const int* layout_t, int n_tparts,
                                  const void* const* weights, const void* const* biases,
                                  void* workspace, long long bytes, void* stream) {
  if (n <= 0) return 0;
  BwdPlan q;
  cudaError_t err = backward_plan(n, D, W, num_freqs, skip_mask, &q);
  if (err != cudaSuccess) return (int)err;
  if (n_parts < 1 || n_parts > MAX_PARTS || n_tparts < 1 || n_tparts > MAX_TPARTS ||
      grad_len != q.s.total() || bytes < q.bytes ||
      reinterpret_cast<uintptr_t>(packed) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(packed_t) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(g) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(workspace) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p;
  p.f.w = static_cast<const char*>(packed);
  for (int i = 0; i < n_parts; ++i) {
    p.f.off[i] = layout[3 * i];
    p.f.rows[i] = layout[3 * i + 1];
    p.f.kp[i] = layout[3 * i + 2];
  }
  for (int l = 0; l < D + 4; ++l) p.f.b[l] = static_cast<const float*>(biases[l]);
  p.f.D = D;
  p.f.E = q.s.E;
  p.f.skip_mask = q.s.skip_mask;
  p.f.n_parts = n_parts;
  p.wt = static_cast<const char*>(packed_t);
  for (int i = 0; i < n_tparts; ++i) {
    p.t_off[i] = layout_t[3 * i];
    p.t_rows[i] = layout_t[3 * i + 1];
    p.t_kp[i] = layout_t[3 * i + 2];
  }
  p.n_tparts = n_tparts;
  p.g = g;
  if (!check_layout(p.f, W, Mode<float>::KSTEP * Mode<float>::DEPTHS, Mode<float>::COPIES) ||
      !check_layout_t(p, W))
    return (int)cudaErrorInvalidValue;
  FixParams fp;
  for (int l = 0; l < D + 4; ++l) {
    fp.w[l] = static_cast<const float*>(weights[l]);
    fp.b[l] = p.f.b[l];
  }
  char* ws = static_cast<char*>(workspace);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (W) {
    case 64: return (int)launch_backward<64>(pts, dirs, n, p, fp, q, ws, grad, s);
    case 128: return (int)launch_backward<128>(pts, dirs, n, p, fp, q, ws, grad, s);
    case 256: return (int)launch_backward<256>(pts, dirs, n, p, fp, q, ws, grad, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
