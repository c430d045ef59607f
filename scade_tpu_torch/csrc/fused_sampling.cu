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
// gradients where they are asked for): (2M - 1 + 2S + M - 1) * 4 bytes.
//
// Design of the backward: one warp per ray again, and the same CDF build,
// so that below/above are the forward's. Several draws of a ray land on one
// bin (the P_depth draws are iid, not sorted), and the sums must come out
// the same on every run: there is no floating-point atomic. A lane owns the
// CDF entries and bins 1 + [l L, (l + 1) L) (lane 0 also bins[0]) and keeps
// their sums in shared memory. The warp takes 32 draws at a time, a draw a
// lane; then for each of the 32 in index order the draw's indices and
// terms are broadcast by shuffles and the owning lane adds them (a draw's
// below before its above). The reverse scan to grad_pdf and the sum of
// grad_pdf pdf reuse the lane segments: segment sums from the top down, a
// Kogge-Stone suffix scan over the lanes, serial sums from each lane's
// offset; a butterfly for the dot product. Every operation is an explicit
// round-to-nearest intrinsic, so the order is fixed and
// ops/fused_sampling.py::sample_pdf_backward_kernel_order repeats it with
// torch ops bit for bit. The gradients are written coalesced from shared
// memory.

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

constexpr int BWD_ROWS = 5;  // rows of M floats a warp keeps in shared memory

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
  float* cs = sm + (size_t)warp * BWD_ROWS * M;  // cdf row
  float* bs = cs + M;                            // bins row
  float* pdf = bs + M;                           // pdf (M - 1 of the M)
  float* gc = pdf + M;                           // grad of the cdf, then of w
  float* gb = gc + M;                            // grad of the bins
  for (int i = lane; i < M; i += 32) {
    gc[i] = 0.f;
    gb[i] = 0.f;
  }
  const float s = build_cdf(weights + r * weights_stride, bins + r * bins_stride, cs, bs, pdf,
                            M, lane);

  const int n = M - 1;
  const int len = (n + 31) / 32;
  const int lo = min(lane * len, n);
  const int hi = min(lo + len, n);
  // this lane's entries of gc and gb: (lo, hi], and gb[0] in lane 0
  const int own_lo = lane == 0 ? -1 : lo;
  const float* ur = u + r * u_stride;
  const float* gr = g + r * g_stride;
  for (int j0 = 0; j0 < S; j0 += 32) {
    const int j = j0 + lane;
    int below = -1, above = -1;
    float g_cb = 0.f, g_ca = 0.f, g_bb = 0.f, g_ba = 0.f;
    if (j < S) {
      const float uu = ur[j];
      const float gj = gr[j];
      const int k = count_le(cs, M, uu);
      below = max(k - 1, 0);
      above = min(k, M - 1);
      const float cb = cs[below];
      float denom = __fsub_rn(cs[above], cb);
      const bool guard = denom < 1e-5f;
      if (guard) denom = 1.f;
      const float t = __fdiv_rn(__fsub_rn(uu, cb), denom);
      const float gu = __fdiv_rn(__fmul_rn(gj, __fsub_rn(bs[above], bs[below])), denom);
      const float q = __fmul_rn(gu, t);
      g_cb = guard ? -gu : __fsub_rn(q, gu);
      g_ca = guard ? 0.f : -q;
      g_ba = __fmul_rn(gj, t);
      g_bb = __fsub_rn(gj, g_ba);
      if (grad_u) grad_u[(size_t)r * S + j] = gu;
    }
    const int m = min(32, S - j0);
    for (int k = 0; k < m; ++k) {  // the draws j0 + k in index order
      const int kb = __shfl_sync(FULL, below, k);
      const int ka = __shfl_sync(FULL, above, k);
      const float vcb = __shfl_sync(FULL, g_cb, k);
      const float vca = __shfl_sync(FULL, g_ca, k);
      const float vbb = __shfl_sync(FULL, g_bb, k);
      const float vba = __shfl_sync(FULL, g_ba, k);
      if (kb > lo && kb <= hi) gc[kb] = __fadd_rn(gc[kb], vcb);
      if (ka > lo && ka <= hi) gc[ka] = __fadd_rn(gc[ka], vca);
      if (kb > own_lo && kb <= hi) gb[kb] = __fadd_rn(gb[kb], vbb);
      if (ka > own_lo && ka <= hi) gb[ka] = __fadd_rn(gb[ka], vba);
    }
  }

  // grad_pdf[i] = sum of gc[k] for k > i, on the lane segments
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
  if (grad_bins)
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
// asked for). Returns a cudaError_t; 0 is success. Above M = 614 the rows
// need more than 48 KB of shared memory a block, and the kernel is opted in
// to it on each call.
extern "C" int sample_pdf_backward(const float* bins, long long bins_stride,
                                   const float* weights, long long weights_stride,
                                   const float* u, long long u_stride, const float* g,
                                   long long g_stride, float* grad_w, float* grad_bins,
                                   float* grad_u, int R, int M, int S, void* stream) {
  if (R <= 0) return 0;
  if (M < 2 || S < 0) return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)WARPS * BWD_ROWS * M * sizeof(float);
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
