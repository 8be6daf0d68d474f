// Backward of the folded 3D max pool (hebbax_torch/ops/s2d3d.py
// `subpixel_max3`): the pooled cotangent g goes to the FIRST maximum of
// each 2x2x2 window of the unfolded tensor in (z, y, x) row-major order,
// exact zero to the window's other seven voxels, written in the folded
// layout of x.  float32 and bfloat16.
//
// Replaces no TPU kernel: hebbax's `subpixel_max3` (hebbax/ops/s2d3d.py)
// is a jax.custom_vjp composed of jnp ops.  The port's plain version
// (`first_max_grad` in s2d3d.py, the CPU path and the tests' reference)
// unfolds x, copies it into (..., 8) windows, compares with the window's
// max, takes an int64 inclusive scan of the mask to keep its first 1,
// and folds back: a dozen passes over the level's tensor.
//
// Layout.  x (N, pf*C, P, Q, R) contiguous, folded by f = (fz, fy, fx),
// each f_a in {1, 2}, pf = fz*fy*fx, channel (subpixel-major) s*C + c
// with s = (dz*fy + dy)*fx + dx; the unfolded tensor is (N, C, P*fz,
// Q*fy, R*fx).  g (N, C, D2, H2, W2) contiguous, D2 = P*fz/2 and so on.
// Window voxel (wz, wy, wx) of pooled voxel (oz, oy, ox): along an axis
// with f = 2 it lies in subpixel block d = w at folded position o; along
// an axis with f = 1 at folded position 2*o + w.
//
// First maximum: the running best starts at voxel 0 and moves only to a
// value strictly greater, so ties (-0 and +0 among them) keep the first,
// as `==` against the window's amax does.  A window holding a NaN routes
// nothing (amax is NaN and compares unequal to everything).  Values are
// moved as bits, never through arithmetic, so the gradient is the plain
// version's to the bit.
//
// Bound on the H100: read x and g once and write the folded gradient
// once.  At unet3d_s2d's folded level (x 1x128x48x96x80 float32, f =
// (2,1,1)) that is 188.7 + 23.6 + 188.7 = 401 MB, 0.120 ms at 3.35 TB/s.
//
// Design for that bound: one pass, no shared memory, no atomics, no
// memset (each window writes all 8 of its voxels once).  A thread owns V
// pooled voxels along W of one output row.  With fx = 1 the window's
// x-pair is adjacent in one row, so a thread reads 2V elements of each of
// its 4 (wz, wy) source rows; with fx = 2 it reads V elements of each of
// 8 source rows.  V is chosen so that every such row segment is one
// 16-byte vector (float32: V = 2 or 4; bfloat16: V = 4 or 8), and the
// gradient is written back in the same vectors.  Neighbouring threads
// take neighbouring segments of a row, then the next row, so each of the
// warp's loads and stores covers whole sectors.  Where W2 is not a
// multiple of V or a pointer is not 16-byte aligned, a thread owns one
// voxel and moves elements one by one.  Offsets are 64-bit; the thread
// index is 32-bit (the wrapper refuses g with 2^31 elements or more).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename U, int N, size_t ALIGN>
struct alignas(ALIGN) Pack {
  U v[N];
};

__device__ __forceinline__ float value(uint32_t u) {
  return __uint_as_float(u);
}

__device__ __forceinline__ float value(uint16_t u) {
  return __uint_as_float(static_cast<uint32_t>(u) << 16);
}

// U: one element's bits (uint32_t: float32, uint16_t: bfloat16).  FX: the
// fold along x.  V: pooled voxels per thread.  VEC: whole-pack vectors
// (16 bytes for a source row) rather than element by element.
template <typename U, int FX, int V, bool VEC>
__global__ void __launch_bounds__(256)
first_max_grad(const U* __restrict__ x, const U* __restrict__ g,
               U* __restrict__ gx, int C, int fz, int fy, int P, int Q,
               int R, int D2, int H2, int W2, unsigned int threads) {
  constexpr int NR = 2 * V / FX;  // elements of one source row segment
  using Row = Pack<U, NR, VEC ? NR * sizeof(U) : sizeof(U)>;
  using Out = Pack<U, V, VEC ? V * sizeof(U) : sizeof(U)>;

  const unsigned int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= threads) return;
  const unsigned int nj = W2 / V;
  const unsigned int row = t / nj;   // ((n*C + c)*D2 + oz)*H2 + oy
  const int ox0 = (t - row * nj) * V;
  unsigned int rest = row;
  const int oy = rest % H2;
  rest /= H2;
  const int oz = rest % D2;
  rest /= D2;
  const int c = rest % C;
  const long long n = rest / C;
  const int pf = fz * fy * FX;

  // the source rows' offsets, in window order (wz, wy, dx)
  long long src[4 * FX];
#pragma unroll
  for (int wz = 0; wz < 2; ++wz) {
#pragma unroll
    for (int wy = 0; wy < 2; ++wy) {
      const int dz = fz == 2 ? wz : 0, dy = fy == 2 ? wy : 0;
      const int p = fz == 2 ? oz : 2 * oz + wz;
      const int q = fy == 2 ? oy : 2 * oy + wy;
#pragma unroll
      for (int dx = 0; dx < FX; ++dx) {
        const int s = (dz * fy + dy) * FX + dx;
        const long long ch = n * pf * C + static_cast<long long>(s) * C + c;
        src[(wz * 2 + wy) * FX + dx] =
            ((ch * P + p) * Q + q) * R + (FX == 2 ? ox0 : 2 * ox0);
      }
    }
  }

  // every load first, then the routing
  Row rows[4 * FX];
#pragma unroll
  for (int i = 0; i < 4 * FX; ++i)
    rows[i] = *reinterpret_cast<const Row*>(x + src[i]);
  const Out gv = *reinterpret_cast<const Out*>(
      g + static_cast<long long>(row) * W2 + ox0);

  Row outs[4 * FX];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    // voxel v's window in (z, y, x) order: k = (wz*2 + wy)*2 + wx
    U w[8];
#pragma unroll
    for (int zy = 0; zy < 4; ++zy) {
#pragma unroll
      for (int wx = 0; wx < 2; ++wx) {
        if constexpr (FX == 2)
          w[zy * 2 + wx] = rows[zy * 2 + wx].v[v];
        else
          w[zy * 2 + wx] = rows[zy].v[2 * v + wx];
      }
    }
    float best = value(w[0]);
    bool nan = best != best;
    int first = 0;
#pragma unroll
    for (int k = 1; k < 8; ++k) {
      const float a = value(w[k]);
      nan |= a != a;
      if (a > best) {
        best = a;
        first = k;
      }
    }
    if (nan) first = 8;
#pragma unroll
    for (int zy = 0; zy < 4; ++zy) {
#pragma unroll
      for (int wx = 0; wx < 2; ++wx) {
        const U o = zy * 2 + wx == first ? gv.v[v] : U(0);
        if constexpr (FX == 2)
          outs[zy * 2 + wx].v[v] = o;
        else
          outs[zy].v[2 * v + wx] = o;
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4 * FX; ++i)
    *reinterpret_cast<Row*>(gx + src[i]) = outs[i];
}

template <typename U, int FX, int V>
int launch(const void* x, const void* g, void* gx, int N, int C, int fz,
           int fy, int P, int Q, int R, cudaStream_t stream) {
  const int D2 = P * fz / 2, H2 = Q * fy / 2, W2 = R * FX / 2;
  const bool vec = W2 % V == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0
                   && reinterpret_cast<uintptr_t>(g) % 16 == 0
                   && reinterpret_cast<uintptr_t>(gx) % 16 == 0;
  const long long rows = static_cast<long long>(N) * C * D2 * H2;
  const long long threads = rows * (vec ? W2 / V : W2);
  if (threads <= 0 || threads >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  const unsigned int blocks = static_cast<unsigned int>((threads + 255) / 256);
  const U* xs = static_cast<const U*>(x);
  const U* gs = static_cast<const U*>(g);
  U* out = static_cast<U*>(gx);
  if (vec)
    first_max_grad<U, FX, V, true><<<blocks, 256, 0, stream>>>(
        xs, gs, out, C, fz, fy, P, Q, R, D2, H2, W2,
        static_cast<unsigned int>(threads));
  else
    first_max_grad<U, FX, 1, false><<<blocks, 256, 0, stream>>>(
        xs, gs, out, C, fz, fy, P, Q, R, D2, H2, W2,
        static_cast<unsigned int>(threads));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, g, gx: device pointers (layouts above); dtype 0 float32, 1 bfloat16;
// N, C (channels per subpixel block), the folds and the folded spatial
// sizes.  Launches on `stream` without synchronising; returns the launch's
// CUDA error (0 on success).
extern "C" int hebbax_subpixel_max3_bwd(const void* x, const void* g,
                                        void* gx, int dtype, int N, int C,
                                        int fz, int fy, int fx, int P, int Q,
                                        int R, void* stream) {
  const bool fold_ok = (fz == 1 || fz == 2) && (fy == 1 || fy == 2) &&
                       (fx == 1 || fx == 2);
  if (!fold_ok || N <= 0 || C <= 0 || P <= 0 || Q <= 0 || R <= 0 ||
      (P * fz) % 2 || (Q * fy) % 2 || (R * fx) % 2 || (dtype != 0 &&
                                                       dtype != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return fx == 2 ? launch<uint32_t, 2, 4>(x, g, gx, N, C, fz, fy, P, Q, R, s)
                   : launch<uint32_t, 1, 2>(x, g, gx, N, C, fz, fy, P, Q, R, s);
  return fx == 2 ? launch<uint16_t, 2, 8>(x, g, gx, N, C, fz, fy, P, Q, R, s)
                 : launch<uint16_t, 1, 4>(x, g, gx, N, C, fz, fy, P, Q, R, s);
}
