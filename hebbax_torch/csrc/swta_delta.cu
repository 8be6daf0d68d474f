// SWTA Hebbian delta of a 2D stride-1 forward convolution, float32.
//
// Replaces the Pallas TPU kernel hebbax/hebb/pallas_kernels.py
// `swta_delta_pallas` (body `_swta_kernel`), which carries every Hebbian
// update of the swta_t pretraining on UNet2D (22 sites per step).
//
// Function, in the port's layout (no transposes on the path):
//   x (N, I, H, W) unpadded layer input, taps outside the image are zero
//   y (N, O, H, W) conv output including bias
//   w (O, I, kh, kw) raw (unnormalised) weight
//   r[p, o]     = softmax_o(k * y[p, o])                 (per pixel p)
//   pos[o, m]   = sum_p r[p, o] * xpatch[p, m],  m = (i, di, dj)
//   r_sum[o]    = sum_p r[p, o]
//   delta[o, m] = pos[o, m] - r_sum[o] * w[o, m]
// r never reaches device memory.  Plain version: hebbax_torch/hebb/rules.py
// `swta_conv_delta`.
//
// Bound on the H100 (per site): bytes ~ 4 * (N*H*W*(I + O) + 2*M*O) over
// 3.35 TB/s, FLOPs ~ 2 * N*H*W * M * O over 67 TFLOP/s (float32 without
// tensor cores), M = I*kh*kw.  E.g. encoder.in_conv.conv2 at batch 32,
// 128x128: ~67 MB and ~2.4 GFLOP, so ~0.036 ms FLOP-bound.  Every
// UNet2D site is FLOP-bound in float32.
//
// Design (simple first version; tensor cores, TMA and one softmax per
// pixel are later work):
//  * grid = (pixel ranges) x (M tiles of 64) x (O tiles of BO = 16/32/64,
//    picked from O so the 16-channel sites waste no lanes);
//  * per stage of TP = 16 pixels a block stages k*y for ALL O channels in
//    shared memory, takes the max-subtracted softmax there (K = 50 makes
//    exp overflow real without it) and keeps r only for its O tile;
//  * it gathers the 16 x 64 patch tile of x with the zero padding applied
//    by bounds checks, and each thread accumulates a 4 x 4 (m, o) register
//    tile over the block's whole pixel range;
//  * the number of pixel ranges is chosen by the caller to give a few
//    blocks per SM, not one per stage, which bounds the workspace of
//    partials (ranges x O x M floats; ~19 MB at the 256-channel sites);
//  * a second kernel sums the partials in a fixed order (deterministic)
//    and applies pos - r_sum * w; r_sum comes from the M-tile-0 blocks.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int TP = 16;    // pixels per shared-memory stage
constexpr int BM = 64;    // rows of M per block tile
constexpr int PAD = 4;    // row padding of the smem tiles (keeps float4
                          // alignment, breaks the bank stride)
constexpr int MAX_O = 512;  // TP * MAX_O floats of dynamic smem = 32 KB

struct Shape {
  int N, I, H, W, O, kh, kw, ph, pw, M;
  long long HW, P;
};

template <int BO>
__global__ void __launch_bounds__(4 * BO)
swta_partial_kernel(const float* __restrict__ x, const float* __restrict__ y,
                    float* __restrict__ part, float* __restrict__ rsum_part,
                    Shape s, float k_temp, long long range_len) {
  constexpr int NT = 4 * BO;        // threads: 16 along m x BO/4 along o
  constexpr int TO = BO / 4;
  constexpr int G = NT / TP;        // threads per pixel for the softmax
  extern __shared__ float zs[];     // [O][TP]: k * y of the stage
  __shared__ __align__(16) float xs[TP][BM + PAD];
  __shared__ __align__(16) float rs[TP][BO + PAD];
  __shared__ float pmax[TP];
  __shared__ float psum[TP];

  const int tid = threadIdx.x;
  const int range = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int o0 = blockIdx.z * BO;
  const long long p_begin = (long long)range * range_len;
  const long long p_end =
      p_begin + range_len < s.P ? p_begin + range_len : s.P;
  const int to = tid % TO;
  const int tm = tid / TO;
  const int khw = s.kh * s.kw;

  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;
  float rsum = 0.f;

  for (long long p0 = p_begin; p0 < p_end; p0 += TP) {
    // k*y for every O channel of the stage's pixels
    for (int idx = tid; idx < s.O * TP; idx += NT) {
      const int p = idx % TP, o = idx / TP;
      const long long gp = p0 + p;
      float v = 0.f;
      if (gp < p_end) {
        const long long n = gp / s.HW, hw = gp - n * s.HW;
        v = y[((long long)n * s.O + o) * s.HW + hw];
      }
      zs[o * TP + p] = k_temp * v;
    }
    // patch tile of x, zero outside the image
    for (int idx = tid; idx < BM * TP; idx += NT) {
      const int p = idx % TP, mm = idx / TP;
      const int m = m0 + mm;
      const long long gp = p0 + p;
      float v = 0.f;
      if (m < s.M && gp < p_end) {
        const int i = m / khw, rem = m - i * khw;
        const int di = rem / s.kw, dj = rem - di * s.kw;
        const long long n = gp / s.HW;
        const int hw = (int)(gp - n * s.HW);
        const int h = hw / s.W, w = hw - h * s.W;
        const int hh = h + di - s.ph, ww = w + dj - s.pw;
        if (hh >= 0 && hh < s.H && ww >= 0 && ww < s.W)
          v = x[(((long long)n * s.I + i) * s.H + hh) * s.W + ww];
      }
      xs[p][mm] = v;
    }
    __syncthreads();

    // per-pixel max and sum of exp over all O (G lanes per pixel)
    {
      const int p = tid / G, lane = tid % G;
      float mx = -INFINITY;
      for (int o = lane; o < s.O; o += G) mx = fmaxf(mx, zs[o * TP + p]);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, G));
      float sm = 0.f;
      for (int o = lane; o < s.O; o += G) sm += expf(zs[o * TP + p] - mx);
#pragma unroll
      for (int off = G / 2; off > 0; off >>= 1)
        sm += __shfl_xor_sync(0xffffffffu, sm, off, G);
      if (lane == 0) {
        pmax[p] = mx;
        psum[p] = sm;
      }
    }
    __syncthreads();

    // r for this block's O tile; pixels past the range get r = 0
    for (int idx = tid; idx < TP * BO; idx += NT) {
      const int j = idx % BO, p = idx / BO;
      const int o = o0 + j;
      float r = 0.f;
      if (o < s.O && p0 + p < p_end)
        r = expf(zs[o * TP + p] - pmax[p]) / psum[p];
      rs[p][j] = r;
    }
    __syncthreads();

    if (blockIdx.y == 0 && tid < BO) {
#pragma unroll
      for (int p = 0; p < TP; ++p) rsum += rs[p][tid];
    }
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      const float4 a = *reinterpret_cast<const float4*>(&xs[p][tm * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&rs[p][to * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[u][v] = fmaf(av[u], bv[v], acc[u][v]);
    }
    __syncthreads();
  }

  // partial[range][o][m]
  float* out = part + (long long)range * s.O * s.M;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int m = m0 + tm * 4 + u;
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const int o = o0 + to * 4 + v;
      if (m < s.M && o < s.O) out[(long long)o * s.M + m] = acc[u][v];
    }
  }
  if (blockIdx.y == 0 && tid < BO && o0 + tid < s.O)
    rsum_part[(long long)range * s.O + o0 + tid] = rsum;
}

// delta[o, m] = sum_ranges part - (sum_ranges rsum_part[o]) * w[o, m],
// summed in range order.
__global__ void swta_reduce_kernel(const float* __restrict__ part,
                                   const float* __restrict__ rsum_part,
                                   const float* __restrict__ w,
                                   float* __restrict__ delta, int ranges,
                                   int O, int M) {
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long om = (long long)O * M;
  if (idx >= om) return;
  const int o = (int)(idx / M);
  float pos = 0.f, rsum = 0.f;
  for (int c = 0; c < ranges; ++c) {
    pos += part[(long long)c * om + idx];
    rsum += rsum_part[(long long)c * O + o];
  }
  delta[idx] = pos - rsum * w[idx];
}

template <int BO>
cudaError_t launch_partial(const float* x, const float* y, float* part,
                           float* rsum_part, const Shape& s, float k_temp,
                           int ranges, long long range_len,
                           cudaStream_t stream) {
  const dim3 grid(ranges, (s.M + BM - 1) / BM, (s.O + BO - 1) / BO);
  const size_t smem = (size_t)s.O * TP * sizeof(float);
  swta_partial_kernel<BO><<<grid, 4 * BO, smem, stream>>>(
      x, y, part, rsum_part, s, k_temp, range_len);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  The caller allocates `part`
// (ranges * O * M floats) and `rsum_part` (ranges * O floats) and picks
// `ranges` and `range_len` (a multiple of 16, ranges * range_len >=
// N*H*W, every range non-empty).
extern "C" int hebbax_swta_delta_f32(
    const float* x, const float* y, const float* w, float* delta,
    float* part, float* rsum_part, int N, int I, int H, int W, int O,
    int kh, int kw, int ph, int pw, float k_temp, int ranges,
    long long range_len, void* stream) {
  if (N <= 0 || I <= 0 || H <= 0 || W <= 0 || O <= 0 || O > MAX_O ||
      kh <= 0 || kw <= 0 || ph < 0 || pw < 0 || ranges <= 0 ||
      ranges > 65535 || range_len <= 0 || range_len % TP != 0 ||
      H + 2 * ph - kh + 1 != H || W + 2 * pw - kw + 1 != W)
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = N; s.I = I; s.H = H; s.W = W; s.O = O; s.kh = kh; s.kw = kw;
  s.ph = ph; s.pw = pw; s.M = I * kh * kw;
  s.HW = (long long)H * W;
  s.P = (long long)N * s.HW;
  if ((s.M + BM - 1) / BM > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (O <= 16)
    err = launch_partial<16>(x, y, part, rsum_part, s, k_temp, ranges,
                             range_len, st);
  else if (O <= 32)
    err = launch_partial<32>(x, y, part, rsum_part, s, k_temp, ranges,
                             range_len, st);
  else
    err = launch_partial<64>(x, y, part, rsum_part, s, k_temp, ranges,
                             range_len, st);
  if (err != cudaSuccess) return (int)err;
  const long long om = (long long)O * s.M;
  const int threads = 256;
  const unsigned blocks = (unsigned)((om + threads - 1) / threads);
  swta_reduce_kernel<<<blocks, threads, 0, st>>>(part, rsum_part, w, delta,
                                                 ranges, O, s.M);
  return (int)cudaGetLastError();
}
