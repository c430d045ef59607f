// Inverse-CDF sampling for hierarchical sampling, for Hopper (sm_90a): the
// whole forward of sample_pdf in one kernel, from the weights to the samples.
//
// Replaces the Pallas kernel scade_tpu/ops/fused_sampling.py::_lookup_kernel,
// launched by _lookup, together with the CDF build that the JAX package does
// outside it (_cdf_of at :135, called at :164). Per ray r, with bins (R, M)
// ascending, weights (R, M-1) and draws u (R, S):
//   w'    = w + 1e-5;  pdf = w' / sum(w');  cdf = [0, cumsum(pdf)]
//   below = last m with cdf[m] <= u;  above = first m with cdf[m] > u, else M-1
//   denom = cdf[above] - cdf[below], replaced by 1 where it is below 1e-5
//   out   = bins[below] + (u - cdf[below]) / denom * (bins[above] - bins[below])
//
// Bound: bytes. A ray reads M bins, M-1 weights and S draws and writes S
// samples, (2M - 1 + 2S) * 4 bytes (the draws once in all where their row
// stride is 0), against a few dozen operations per draw.
//
// Design:
//  - One warp per ray, WARPS rays a block: a train step's 1,024 rays are 256
//    blocks, about two on each of the 132 SMs. A ray's weights and bins are
//    read once, coalesced, into its warp's rows of shared memory (8M bytes:
//    1.5 KB at M = 191), so the launch needs no opt-in to more than 48 KB of
//    shared memory up to M = 1,536.
//  - The CDF never leaves the SM. Lane l owns the contiguous segment
//    [l L, (l + 1) L) of the M-1 weights, L = ceil((M-1) / 32). It sums its
//    segment serially; a butterfly of shuffles gives every lane the same
//    total; it divides its segment by the total and sums the quotients
//    serially; a Kogge-Stone scan of those sums gives its exclusive offset;
//    it then writes its segment's CDF as a serial sum starting from that
//    offset. Every add and divide is an explicit round-to-nearest intrinsic,
//    so nvcc cannot contract or reorder them: the order is fixed and
//    ops/fused_sampling.py::cdf_kernel_order repeats it with torch ops bit
//    for bit. It is not torch.cumsum's order, so against the plain
//    sample_pdf the CDF differs by f32 ulps, which the lookup amplifies by
//    bin width / denom.
//  - Each lane takes every 32nd draw: u is read and out written coalesced.
//    A binary search in the ray's shared CDF row gives the selections of
//    the TPU kernel's sweep, u = 0 and u = 1 included (cdf ascends, so
//    {m : cdf[m] <= u} is a prefix); the interpolation is again explicit
//    round-to-nearest, rounding operation by operation as the plain
//    version does.
//  - Inputs are read in place: each has a row stride and an inner stride of
//    1, so a weights[..., 1:-1] view and a draw row broadcast with row
//    stride 0 are passed as they are. No load assumes more than 4-byte
//    alignment (the [1:-1] slice starts one float into its row).
//
// The backward (sample_pdf_backward_kernel) is the VJP of that function for
// an upstream gradient g (R, S). It replaces no Pallas kernel: the JAX
// package's backward (scade_tpu/ops/fused_sampling.py::_bwd, :172) is a VJP
// of the plain sample_pdf, which XLA runs in a fixed order. Per draw, with
// t = (u - cdf[below]) / denom and gu = g (bins[above] - bins[below]) / denom:
//   grad_u = gu;  bins[below] += g - g t;  bins[above] += g t
//   cdf[below] += gu t - gu, cdf[above] += -gu t  (where the guard fired,
//   cdf[below] += -gu and cdf[above] nothing);  cdf[0] takes no gradient
//   grad_pdf[i] = sum_{k > i} grad_cdf[k]
//   grad_w = (grad_pdf - sum(grad_pdf pdf)) / sum(w')
//
// Bound: bytes. A ray reads M bins, M-1 weights, S draws and S upstream
// gradients and writes M-1 weight gradients (and M bin and S draw
// gradients where they are asked for): (2M - 1 + 2S + M - 1) * 4 bytes,
// 1.01 us at R = 1,024, M = 191, S = 128 (3.35 TB/s).
//
// The order of the sums is fixed: each CDF entry's and each bin's sum runs
// over the draws in index order, a draw's below term before its above term
// (also where both are entry M-1), from +0, exact zeros included; cdf[0]
// takes none. ops/fused_sampling.py::sample_pdf_backward_kernel_order
// repeats it with torch ops bit for bit. There is no floating-point atomic:
// the P_depth draws are iid, so several draws of a ray land on one entry.
//
// The first design walked the draws 32 at a time and, for each of the 32 in
// index order, broadcast its indices and terms by 6 shuffles to the lane
// owning the entry: a chain of S dependent steps a ray (18-20 us at the
// train step's shape on an H100, flat in M), with 1,024 warps on 132 SMs
// and nothing to hide its latency. This design sorts instead, and the chain
// is the busiest entry's list (12.2 us on uniform weights, 10.7 on peaked
// ones, on the same card; the rest is latency of the CDF build, the sort's
// steps and the reverse scan, which ops/fused_sampling.py's order fixes):
//  - One warp per ray, WARPS rays a block, and the forward's CDF build, so
//    that below/above are the forward's. Each lane computes the terms of
//    every 32nd draw of a tile of TILE draws (4 a lane at TILE = 128; the
//    draws' loads are issued before the CDF build).
//  - A stable counting sort of the tile's 2 TILE terms by entry, on
//    integers only: term 2j is draw j's below, 2j + 1 its above, and a
//    round gives lane l term 32 i + l (two shuffles from the draw's lane).
//    __match_any_sync on the entry gives a term's rank among the round's
//    terms on that entry; a per-entry count in shared memory, bumped by the
//    last lane of each match group, carries it over the rounds; an
//    exclusive scan of the counts (lane segments and a Kogge-Stone scan, as
//    the CDF build) gives each entry's list start. Each term goes to its
//    slot: every entry's list is its terms in the order above.
//  - Lane l owns the entries l, l + 32, ...: a trained ray's weight sits in
//    a few adjacent bins, and adjacent entries land on different lanes. The
//    owner adds its lists serially onto the entry's running sum, which
//    carries over the tiles in shared memory, so no buffer grows with S.
//  - Without grad_bins (the train step's call) no bin term is computed,
//    moved or added.
// Tried on the same card and left out: the match groups from one ballot per
// bit of the entry (faster on uniform weights, slower on peaked ones, where
// __match_any_sync has few groups to find); owners summing 4 entries at once
// (slower, 2x on peaked weights); ranks from each draw's key (count_le) in 4
// rounds in place of the terms' 8 (slower: more registers).
// The reverse scan to grad_pdf and the sum of grad_pdf pdf use the lane
// segments of the CDF build: segment sums from the top down, a Kogge-Stone
// suffix scan over the lanes, serial sums from each lane's offset; a
// butterfly for the dot product. Every floating-point operation is an
// explicit round-to-nearest intrinsic. The gradients are written coalesced
// from shared memory.

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

// Loads ray r's bins into bs and builds its CDF into cs (cs[0] = 0), in
// the order the header describes; the pdf goes to pdf when it is not null.
// Returns the total of w' (the same in every lane). Ends with a __syncwarp.
__device__ __forceinline__ float build_cdf(const float* __restrict__ w,
                                           const float* __restrict__ b, float* cs, float* bs,
                                           float* pdf, int M, int lane) {
  float* seg = cs + 1;  // w', then pdf where pdf is null, then cdf[1:]
  const int n = M - 1;
  for (int i = lane; i < n; i += 32) seg[i] = __fadd_rn(w[i], 1e-5f);
  for (int i = lane; i < M; i += 32) bs[i] = b[i];
  if (lane == 0) cs[0] = 0.f;
  __syncwarp();
  float* ps = pdf ? pdf : seg;

  const int len = (n + 31) / 32;
  const int lo = min(lane * len, n);
  const int hi = min(lo + len, n);
  float s = 0.f;
  for (int i = lo; i < hi; ++i) s = __fadd_rn(s, seg[i]);
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, off));
  float t = 0.f;  // s is now the row's total in every lane
  for (int i = lo; i < hi; ++i) {
    const float p = __fdiv_rn(seg[i], s);
    ps[i] = p;
    t = __fadd_rn(t, p);
  }
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, t, off);
    if (lane >= off) t = __fadd_rn(y, t);
  }
  float c = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) c = 0.f;
  for (int i = lo; i < hi; ++i) {
    c = __fadd_rn(c, ps[i]);
    seg[i] = c;
  }
  __syncwarp();
  return s;
}

// The count of entries of the ascending row cs[0, M) that are <= uu.
__device__ __forceinline__ int count_le(const float* cs, int M, float uu) {
  int lo = 0;
  int hi = M;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (cs[mid] <= uu) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(THREADS)
    sample_pdf_kernel(const float* __restrict__ bins, long long bins_stride,
                      const float* __restrict__ weights, long long weights_stride,
                      const float* __restrict__ u, long long u_stride, float* __restrict__ out,
                      int R, int M, int S) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= R) return;  // a whole warp; the kernel has no block-wide barrier
  float* cs = sm + (size_t)warp * 2 * M;  // cdf row
  float* bs = cs + M;                     // bins row
  build_cdf(weights + r * weights_stride, bins + r * bins_stride, cs, bs, nullptr, M, lane);

  const float* ur = u + r * u_stride;
  float* o = out + (size_t)r * S;
  for (int j = lane; j < S; j += 32) {
    const float uu = ur[j];
    const int k = count_le(cs, M, uu);
    const int below = max(k - 1, 0);
    const int above = min(k, M - 1);
    const float cb = cs[below];
    const float bb = bs[below];
    float denom = __fsub_rn(cs[above], cb);
    if (denom < 1e-5f) denom = 1.f;
    const float f = __fdiv_rn(__fsub_rn(uu, cb), denom);
    o[j] = __fadd_rn(bb, __fmul_rn(f, __fsub_rn(bs[above], bb)));
  }
}

constexpr int TILE = 128;       // draws a warp sorts at a time
constexpr int GROUPS = TILE / 32;  // draws a lane computes a tile
constexpr int ROUNDS = TILE / 16;  // terms a lane holds a tile: 2 a draw

// Shared memory of one warp of the backward, in 4-byte words: cdf, bins,
// pdf and the sums of the CDF entries and bins (M each), the counts and
// list starts (M + 1), and the sorted terms of the CDF entries and the bins
// (2 TILE each). ops/fused_sampling.py checks the same size.
__host__ __device__ constexpr size_t backward_words(int M) {
  return 6 * (size_t)M + 1 + 4 * TILE;
}

__global__ void __launch_bounds__(THREADS)
    sample_pdf_backward_kernel(const float* __restrict__ bins, long long bins_stride,
                               const float* __restrict__ weights, long long weights_stride,
                               const float* __restrict__ u, long long u_stride,
                               const float* __restrict__ g, long long g_stride,
                               float* __restrict__ grad_w, float* __restrict__ grad_bins,
                               float* __restrict__ grad_u, int R, int M, int S) {
  extern __shared__ float sm[];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int r = blockIdx.x * WARPS + warp;
  if (r >= R) return;  // a whole warp; the kernel has no block-wide barrier
  float* cs = sm + warp * backward_words(M);  // cdf row
  float* bs = cs + M;                          // bins row
  float* pdf = bs + M;                         // pdf (M - 1 of the M)
  float* gc = pdf + M;                         // sums of the cdf entries, then grad of w
  float* gb = gc + M;                          // sums of the bins
  int* start = reinterpret_cast<int*>(gb + M);               // counts, then list starts
  float* tc = reinterpret_cast<float*>(start + M + 1);       // sorted cdf terms
  float* tb = tc + 2 * TILE;                                 // sorted bin terms
  const bool want_bins = grad_bins != nullptr;
  const unsigned lower = (1u << lane) - 1u;  // the lanes below this one
  const float* ur = u + r * u_stride;
  const float* gr = g + r * g_stride;
  float uu[GROUPS], gg[GROUPS];
  auto load = [&](int t0) {
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const int j = t0 + 32 * i + lane;
      uu[i] = j < S ? ur[j] : 0.f;
      gg[i] = j < S ? gr[j] : 0.f;
    }
  };
  load(0);
  for (int i = lane; i < M; i += 32) {
    gc[i] = 0.f;
    if (want_bins) gb[i] = 0.f;
  }
  const float s = build_cdf(weights + r * weights_stride, bins + r * bins_stride, cs, bs, pdf,
                            M, lane);

  for (int t0 = 0; t0 < S; t0 += TILE) {
    for (int i = lane; i <= M; i += 32) start[i] = 0;
    // the terms of draws t0 + 32 i + lane; entry -1 past S
    int below[GROUPS], above[GROUPS];
    float g_cb[GROUPS], g_ca[GROUPS], g_bb[GROUPS], g_ba[GROUPS];
#pragma unroll
    for (int i = 0; i < GROUPS; ++i) {
      const int j = t0 + 32 * i + lane;
      below[i] = above[i] = -1;
      g_cb[i] = g_ca[i] = g_bb[i] = g_ba[i] = 0.f;
      if (j < S) {
        const int k = count_le(cs, M, uu[i]);
        below[i] = max(k - 1, 0);
        above[i] = min(k, M - 1);
        const float cb = cs[below[i]];
        float denom = __fsub_rn(cs[above[i]], cb);
        const bool guard = denom < 1e-5f;
        if (guard) denom = 1.f;
        const float t = __fdiv_rn(__fsub_rn(uu[i], cb), denom);
        const float gu =
            __fdiv_rn(__fmul_rn(gg[i], __fsub_rn(bs[above[i]], bs[below[i]])), denom);
        const float q = __fmul_rn(gu, t);
        g_cb[i] = guard ? -gu : __fsub_rn(q, gu);
        g_ca[i] = guard ? 0.f : -q;
        if (want_bins) {
          g_ba[i] = __fmul_rn(gg[i], t);
          g_bb[i] = __fsub_rn(gg[i], g_ba[i]);
        }
        if (grad_u) grad_u[(size_t)r * S + j] = gu;
      }
    }
    if (t0 + TILE < S) load(t0 + TILE);
    // round i holds terms 32 i + lane: draw 16 i + lane / 2 of the tile, its
    // above where lane is odd
    int ent[ROUNDS];
    unsigned same[ROUNDS];
    float vc[ROUNDS], vb[ROUNDS];
    const int src = lane >> 1;
    const bool odd = lane & 1;
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      const int d = i >> 1, from = 16 * (i & 1) + src;
      const int kb = __shfl_sync(FULL, below[d], from);
      const int ka = __shfl_sync(FULL, above[d], from);
      const float cb = __shfl_sync(FULL, g_cb[d], from);
      const float ca = __shfl_sync(FULL, g_ca[d], from);
      ent[i] = odd ? ka : kb;
      vc[i] = odd ? ca : cb;
      if (want_bins) {
        const float bb = __shfl_sync(FULL, g_bb[d], from);
        const float ba = __shfl_sync(FULL, g_ba[d], from);
        vb[i] = odd ? ba : bb;
      }
      same[i] = __match_any_sync(FULL, ent[i]);  // the lanes with this lane's entry
    }
    __syncwarp();  // start[] zeroed
    // ranks: the earlier terms on the same entry, this round's and the
    // earlier rounds' (the count); the last lane of a match group bumps it
    int rank[ROUNDS];
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      const int e = ent[i];
      const int base = e >= 0 ? start[e] : 0;
      rank[i] = base + __popc(same[i] & lower);
      __syncwarp();
      if (e >= 0 && (same[i] >> lane) == 1u) start[e] = base + __popc(same[i]);
      __syncwarp();
    }
    {  // exclusive scan of the counts start[0, M] (start[M] is 0) → list starts
      const int n1 = M + 1;
      const int len = (n1 + 31) / 32;
      const int lo = min(lane * len, n1);
      const int hi = min(lo + len, n1);
      int c = 0;
      for (int i = lo; i < hi; ++i) c += start[i];
      for (int off = 1; off < 32; off <<= 1) {
        const int y = __shfl_up_sync(FULL, c, off);
        if (lane >= off) c += y;
      }
      int o = __shfl_up_sync(FULL, c, 1);
      if (lane == 0) o = 0;
      for (int i = lo; i < hi; ++i) {
        const int k = start[i];
        start[i] = o;
        o += k;
      }
    }
    __syncwarp();
#pragma unroll
    for (int i = 0; i < ROUNDS; ++i) {
      if (ent[i] < 0) continue;
      const int slot = start[ent[i]] + rank[i];
      tc[slot] = vc[i];
      if (want_bins) tb[slot] = vb[i];
    }
    __syncwarp();
    // the owners' serial sums, entry by entry, onto the running sums
    for (int e = lane; e < M; e += 32) {
      const int a = start[e], b = start[e + 1];
      if (a == b) continue;
      if (e > 0) {
        float acc = gc[e];
        for (int i = a; i < b; ++i) acc = __fadd_rn(acc, tc[i]);
        gc[e] = acc;
      }
      if (want_bins) {
        float acc = gb[e];
        for (int i = a; i < b; ++i) acc = __fadd_rn(acc, tb[i]);
        gb[e] = acc;
      }
    }
    __syncwarp();  // start[] and the terms are read before the next tile
  }

  // grad_pdf[i] = sum of gc[k] for k > i, on the lane segments
  const int n = M - 1;
  const int len = (n + 31) / 32;
  const int lo = min(lane * len, n);
  const int hi = min(lo + len, n);
  float tot = 0.f;
  for (int i = hi - 1; i >= lo; --i) tot = __fadd_rn(tot, gc[i + 1]);
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_down_sync(FULL, tot, off);
    if (lane + off < 32) tot = __fadd_rn(tot, y);
  }
  float c = __shfl_down_sync(FULL, tot, 1);
  if (lane == 31) c = 0.f;
  float d = 0.f;
  for (int i = hi - 1; i >= lo; --i) {
    c = __fadd_rn(c, gc[i + 1]);
    gc[i + 1] = c;  // grad_pdf[i]
    d = __fadd_rn(d, __fmul_rn(c, pdf[i]));
  }
  for (int off = 16; off > 0; off >>= 1) d = __fadd_rn(d, __shfl_xor_sync(FULL, d, off));
  for (int i = lo; i < hi; ++i) gc[i + 1] = __fdiv_rn(__fsub_rn(gc[i + 1], d), s);
  __syncwarp();
  for (int i = lane; i < n; i += 32) grad_w[(size_t)r * n + i] = gc[i + 1];
  if (want_bins)
    for (int i = lane; i < M; i += 32) grad_bins[(size_t)r * M + i] = gb[i];
}

}  // namespace

// bins (R, M), weights (R, M-1), u (R, S): f32, inner stride 1, row strides
// in elements (any, 0 included). out (R, S) f32 contiguous. Returns a
// cudaError_t; 0 is success. Above M = 1,536 the rows need more than 48 KB
// of shared memory a block, and the kernel is opted in to it on each call.
extern "C" int sample_pdf_fused(const float* bins, long long bins_stride, const float* weights,
                                long long weights_stride, const float* u, long long u_stride,
                                float* out, int R, int M, int S, void* stream) {
  if (R <= 0 || S <= 0) return 0;
  if (M < 2) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * 2 * M * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sample_pdf_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (R + WARPS - 1) / WARPS;
  sample_pdf_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      bins, bins_stride, weights, weights_stride, u, u_stride, out, R, M, S);
  return (int)cudaGetLastError();
}

// bins (R, M), weights (R, M-1), u and g (R, S): f32, inner stride 1, row
// strides in elements (any, 0 included). grad_w (R, M-1), grad_bins (R, M)
// and grad_u (R, S): f32 contiguous; grad_bins and grad_u may be null (not
// asked for). Returns a cudaError_t; 0 is success. Above M = 426 a block
// needs more than 48 KB of shared memory, and the kernel is opted in to it
// on each call.
extern "C" int sample_pdf_backward(const float* bins, long long bins_stride,
                                   const float* weights, long long weights_stride,
                                   const float* u, long long u_stride, const float* g,
                                   long long g_stride, float* grad_w, float* grad_bins,
                                   float* grad_u, int R, int M, int S, void* stream) {
  if (R <= 0) return 0;
  if (M < 2 || S < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = WARPS * backward_words(M) * sizeof(float);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sample_pdf_backward_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const int blocks = (R + WARPS - 1) / WARPS;
  sample_pdf_backward_kernel<<<blocks, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      bins, bins_stride, weights, weights_stride, u, u_stride, g, g_stride, grad_w, grad_bins,
      grad_u, R, M, S);
  return (int)cudaGetLastError();
}
