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

#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr unsigned FULL = 0xffffffffu;

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
  float* seg = cs + 1;                    // w', then pdf, then cdf[1:]

  const int n = M - 1;
  const float* w = weights + r * weights_stride;
  const float* b = bins + r * bins_stride;
  for (int i = lane; i < n; i += 32) seg[i] = __fadd_rn(w[i], 1e-5f);
  for (int i = lane; i < M; i += 32) bs[i] = b[i];
  if (lane == 0) cs[0] = 0.f;
  __syncwarp();

  const int len = (n + 31) / 32;
  const int lo = min(lane * len, n);
  const int hi = min(lo + len, n);
  float s = 0.f;
  for (int i = lo; i < hi; ++i) s = __fadd_rn(s, seg[i]);
  for (int off = 16; off > 0; off >>= 1) s = __fadd_rn(s, __shfl_xor_sync(FULL, s, off));
  float t = 0.f;  // s is now the row's total in every lane
  for (int i = lo; i < hi; ++i) {
    const float p = __fdiv_rn(seg[i], s);
    seg[i] = p;
    t = __fadd_rn(t, p);
  }
  for (int off = 1; off < 32; off <<= 1) {
    const float y = __shfl_up_sync(FULL, t, off);
    if (lane >= off) t = __fadd_rn(y, t);
  }
  float c = __shfl_up_sync(FULL, t, 1);
  if (lane == 0) c = 0.f;
  for (int i = lo; i < hi; ++i) {
    c = __fadd_rn(c, seg[i]);
    seg[i] = c;
  }
  __syncwarp();

  const float* ur = u + r * u_stride;
  float* o = out + (size_t)r * S;
  for (int j = lane; j < S; j += 32) {
    const float uu = ur[j];
    int lo_ = 0;
    int hi_ = M;  // lo_ ends as the count of entries <= uu
    while (lo_ < hi_) {
      const int mid = (lo_ + hi_) >> 1;
      if (cs[mid] <= uu) {
        lo_ = mid + 1;
      } else {
        hi_ = mid;
      }
    }
    const int below = max(lo_ - 1, 0);
    const int above = min(lo_, M - 1);
    const float cb = cs[below];
    const float bb = bs[below];
    float denom = __fsub_rn(cs[above], cb);
    if (denom < 1e-5f) denom = 1.f;
    const float f = __fdiv_rn(__fsub_rn(uu, cb), denom);
    o[j] = __fadd_rn(bb, __fmul_rn(f, __fsub_rn(bs[above], bb)));
  }
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
