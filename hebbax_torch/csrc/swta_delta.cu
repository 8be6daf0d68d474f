// SWTA Hebbian delta of a 2D stride-1 forward convolution, float32, on
// Hopper tensor cores (sm_90a) in 3xTF32.
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
// Bound on the H100 (per site): bytes 4 * (N*H*W*(I + O) + 2*M*O) over
// 3.35 TB/s; operations 2 * N*H*W * M * O, which the kernel does three
// times on the TF32 tensor cores (495 TFLOP/s), M = I*kh*kw.  Summed over
// UNet2D's 22 sites at batch 32, 128x128 that is 0.28 ms of tensor-core
// time and 0.18 ms of bytes; what bounds it in practice is the work
// around each product: staging x, the softmax and the hi/lo split, each
// a phase of a stage that the block runs in turn.
//
// Design:
//  * GEMM pos^T[m, o] = Xpatch^T[m, p] . R[p, o] with K = pixels, by
//    `wgmma.m64nNk8.f32.tf32.tf32`.  A (the patch rows) comes from
//    registers: each thread reads its fragment from the staged x and
//    splits it there, so A never passes through shared memory again.  B
//    (r) is K-major in shared memory (a row of pixels per channel), as
//    wgmma wants for TF32.
//  * 3xTF32: each operand element v is split once per stage into
//    hi = tf32(v) and lo = tf32(v - hi); every k-step issues lo*hi and
//    hi*lo into one float32 accumulator and hi*hi into another, added at
//    the end (the tensor cores' own adds lose the small products' bits
//    otherwise).  Plain TF32 misses the 1e-4 * max|delta| gate at five
//    UNet2D sites; 3xTF32 matches float32.
//  * One block tile covers BM = 64 or 128 rows of M (one warpgroup per 64
//    rows) and every O channel (N = O rounded up to 8, one wgmma up to
//    128 wide; 128 < O <= 256 takes two warpgroups side by side along N).
//    So the softmax of a pixel is taken once per M tile.  For O > 256 the
//    grid splits O in chunks of 128 and each chunk's block computes the
//    statistics over all O itself.
//  * Loads are `cp.async` into a ring of two stages of KP = 32 pixels:
//    the next stage's copies are in flight while a stage is computed, and
//    a stage's tensor-core products run while the next one's copies are
//    issued.  Where W is a multiple of 4 and a stage's pixels are one
//    row's aligned segment or whole rows of one image (every UNet2D site),
//    y and the x rows the block's taps touch (with 4 columns of margin)
//    come as 16-byte copies, and the A fragments read each tap shifted in
//    shared memory.  Any other shape takes 4-byte copies per patch
//    element from a per-block table of tap offsets.  Zero fill supplies
//    the padding either way.
//  * The max-subtracted softmax (K = 50 overflows exp without it) runs in
//    shared memory with NW lanes of a warp per pixel, so its reductions
//    are shuffles; k*y is rounded before the max is subtracted, as in the
//    plain version.  It writes r as hi/lo B operands; padded channels and
//    pixels past the range get r = 0.  r_sum is summed in registers and
//    reduced once at the end.
//  * B sits in wgmma's no-swizzle K-major layout (8x16-byte core
//    matrices) with the K-chunk stride padded by 16 bytes, so the
//    softmax's writes spread over the banks.
//  * Split-K over pixel ranges: each range writes a partial [O, M] and
//    its r_sum; `swta_reduce_kernel` adds them in range order and applies
//    pos - r_sum * w.  No atomics: two launches give equal bits.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int KP = 32;            // pixels per stage: the K depth of a stage
constexpr int RING = 2;           // stages in the cp.async ring
constexpr int MAX_O = 512;
constexpr int MAX_SMEM = 232448;  // dynamic shared memory a block may use

struct Shape {
  int N, I, H, W, O, kh, kw, ph, pw, M, HW, P;
  // halo staging: on or off, the stage's tile width in pixels, the
  // length of a staged row, rows and channels staged per block, floats of
  // one stage of x
  int halo, wt, row_len, rows_r, n_ch, x_slot;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 4-byte async copy global -> shared; zero fill when !valid
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// 16-byte async copy global -> shared; zero fill when !valid
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// waits for all but the last committed group of copies
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// round to TF32 (10 mantissa bits), nearest, ties away from zero: the
// bits of cvt.rna.tf32.f32, in two integer operations at full rate
__device__ __forceinline__ float tf32_rna(float v) {
  return __uint_as_float((__float_as_uint(v) + 0x1000u) & 0xFFFFE000u);
}

// wgmma shared-memory descriptor, no swizzle: start address, K-direction
// core-matrix stride (LBO) and 8-row-group stride (SBO), all in bytes
__device__ __forceinline__ uint64_t gmma_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// keeps the compiler from moving accumulator reads or writes across the
// asynchronous products
template <int R>
__device__ __forceinline__ void fence_regs(float* d) {
#pragma unroll
  for (int q = 0; q < R; ++q) asm volatile("" : "+f"(d[q])::"memory");
}

// D[64 x N] += A[64 x 8] * B[8 x N]: A from registers (thread t holds
// rows t/4 and t/4 + 8 of its warp's 16, columns t%4 and t%4 + 4), B
// K-major in shared memory
template <int N>
struct Wgmma;

template <> struct Wgmma<8> {
  static __device__ __forceinline__ void mma_rs(float* d,
                                                const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %9, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n8k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3"
        "}, {%4, %5, %6, %7}, %8, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<16> {
  static __device__ __forceinline__ void mma_rs(float* d,
                                                const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7"
        "}, {%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<32> {
  static __device__ __forceinline__ void mma_rs(float* d,
                                                const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15"
        "}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<64> {
  static __device__ __forceinline__ void mma_rs(float* d,
                                                const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

template <> struct Wgmma<128> {
  static __device__ __forceinline__ void mma_rs(float* d,
                                                const uint32_t* a,
                                                uint64_t b) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7,"
        "%8, %9, %10, %11, %12, %13, %14, %15,"
        "%16, %17, %18, %19, %20, %21, %22, %23,"
        "%24, %25, %26, %27, %28, %29, %30, %31,"
        "%32, %33, %34, %35, %36, %37, %38, %39,"
        "%40, %41, %42, %43, %44, %45, %46, %47,"
        "%48, %49, %50, %51, %52, %53, %54, %55,"
        "%56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
          "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
          "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
          "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
          "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
          "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
          "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
          "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
          "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
  }
};

// word offset of element (row, k) in an operand tile of `ld`-word K-chunks
__device__ __forceinline__ int op_index(int row, int k, int ld) {
  return (k >> 2) * ld + (row >> 3) * 32 + (row & 7) * 4 + (k & 3);
}

template <int NWG, int WM, int WN>
struct Tile {
  static constexpr int NT = 128 * WM * WN;  // threads
  static constexpr int NW = NT / 32;        // warps = threads per pixel
  static constexpr int PPW = 32 / NW;       // pixels per warp (softmax)
  static constexpr int YS = KP + PPW;       // words per channel row of y
  static constexpr int BM = 64 * WM;        // rows of M per block
  static constexpr int NB = NWG * WN;       // channels of O per block
  static constexpr int LDB = NB * 4 + 4;    // words per K-chunk of B
  static constexpr int OPB = KP / 4 * LDB;  // words of one B operand
  static size_t smem_bytes(int O, int x_slot) {
    return 4 * ((size_t)RING * (O * YS + x_slot) + 2 * OPB + 4 * BM);
  }
};

template <int NWG, int WM, int WN>
__global__ void __launch_bounds__(128 * WM * WN)
swta_wgmma_kernel(const float* __restrict__ x, const float* __restrict__ y,
                  float* __restrict__ part, float* __restrict__ rsum_part,
                  Shape s, float k_temp, int range_len) {
  using T = Tile<NWG, WM, WN>;
  constexpr int NT = T::NT, NW = T::NW, PPW = T::PPW, YS = T::YS;
  constexpr int BM = T::BM, NB = T::NB, LDB = T::LDB;
  constexpr int RJ = NB / NW;  // channels of the block per thread
  constexpr int XJ = BM / NW;  // rows of the block per thread (loads)
  constexpr int KS = KP / 8;   // wgmma k-steps per stage
  constexpr int ACC = NWG / 2;
  extern __shared__ __align__(128) float smem[];
  float* ys = smem;                       // [RING][O][YS] raw y
  float* xs = ys + RING * s.O * YS;       // [RING][x_slot] x, see load
  float* b_hi = xs + RING * s.x_slot;     // B operands (r), wgmma layout
  float* b_lo = b_hi + T::OPB;
  int4* rows = reinterpret_cast<int4*>(b_lo + T::OPB);  // [BM]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int range = blockIdx.x;
  const int m0 = blockIdx.y * BM;
  const int o0 = blockIdx.z * NB;
  const int p_begin = range * range_len;  // pixel indices fit an int
  const int p_end = min(p_begin + range_len, s.P);
  const int n_stages = (p_end - p_begin + KP - 1) / KP;

  // patch row m = (i, di, dj): offset from the pixel's own address of x,
  // the tap's shift (di - ph, dj - pw), and where the row starts in a
  // halo slot
  const int khw = s.kh * s.kw;
  const int i0 = m0 / khw;  // first channel of the block's rows
  for (int r = tid; r < BM; r += NT) {
    const int m = m0 + r;
    if (m < s.M) {
      const int i = m / khw, tap = m - i * khw;
      const int di = tap / s.kw, dj = tap - di * s.kw;
      const int dh = di - s.ph, dw = dj - s.pw;
      rows[r] = make_int4(i * s.HW + dh * s.W + dw, dh, dw,
                          ((i - i0) * s.rows_r + di) * s.row_len + dj -
                              s.pw + 4);
    } else {  // rows past M: every tap falls outside the image
      rows[r] = make_int4(0, -(1 << 28), 0, 0);
    }
  }
  __syncthreads();

  // copies of one stage.  Halo staging (W a multiple of 4, a stage's 32
  // pixels whole rows of one image or one row's aligned segment): y and
  // the x rows the block's taps touch, with 4 columns of margin, as
  // 16-byte copies; the A fragments read each tap shifted.  Otherwise a
  // 4-byte copy per patch element: lane = pixel, warps over rows.
  // A thread's first halo chunk (tid) and the step NT in the mixed radix
  // (channel, row, column) of a slot: cpr 16-byte columns per row, cpc
  // per channel.
  const int cpr = s.row_len / 4, cpc = s.rows_r * cpr;
  const int q0_ch = tid / cpc, q0_rr = tid % cpc / cpr, q0_cc = tid % cpr;
  const int d_ch = NT / cpc, d_rr = NT % cpc / cpr, d_cc = NT % cpr;
  auto load_halo = [&](int st) {
    const int slot = st % RING;
    const int g0 = p_begin + st * KP;  // a whole stage: P % 32 == 0
    const int n = g0 / s.HW, hw0 = g0 - n * s.HW;
    const int h0 = hw0 / s.W, w0 = hw0 - h0 * s.W;
    const float* yb = y + (long long)n * s.O * s.HW + hw0;
    float* yd = ys + slot * s.O * YS;
    for (int q = tid; q < s.O * (KP / 4); q += NT) {
      const int o = q / (KP / 4), c = q % (KP / 4);
      cp_async16(yd + o * YS + 4 * c, yb + (long long)o * s.HW + 4 * c,
                 true);
    }
    const float* xb = x + (long long)n * s.I * s.HW;
    float* xd = xs + slot * s.x_slot;
    // chunk q = (channel, row, 16-byte column) in mixed radix, stepped by
    // NT without dividing
    int ch = q0_ch, rr = q0_rr, cc = q0_cc;
    for (int q = tid; q < s.n_ch * cpc; q += NT) {
      const int i = i0 + ch, hh = h0 - s.ph + rr, ww = w0 - 4 + 4 * cc;
      const bool v = i < s.I && (unsigned)hh < (unsigned)s.H &&
                     (unsigned)ww < (unsigned)s.W;
      cp_async16(xd + q * 4,
                 v ? xb + (long long)i * s.HW + hh * s.W + ww : x, v);
      cc += d_cc;
      if (cc >= cpr) {
        cc -= cpr;
        ++rr;
      }
      rr += d_rr;
      if (rr >= s.rows_r) {
        rr -= s.rows_r;
        ++ch;
      }
      ch += d_ch;
    }
  };
  auto load_stage = [&](int st) {
    if (s.halo) {
      load_halo(st);
      return;
    }
    const int slot = st % RING;
    const int gp = p_begin + st * KP + lane;
    const bool pv = gp < p_end;
    const int g = pv ? gp : p_begin;
    const int n = g / s.HW, hw = g - n * s.HW;
    const int h = pv ? hw / s.W : -(1 << 28);
    const int w = hw - (hw / s.W) * s.W;
    const float* yb = y + (long long)n * s.O * s.HW + hw;
    float* yd = ys + slot * s.O * YS + lane;
    for (int o = warp; o < s.O; o += NW)
      cp_async4(yd + o * YS, yb + (long long)o * s.HW, pv);
    const float* xb = x + (long long)n * s.I * s.HW + hw;
    float* xd = xs + slot * s.x_slot + lane;
#pragma unroll
    for (int j = 0; j < XJ; ++j) {
      const int r = warp + j * NW;
      const int4 t = rows[r];
      const bool v = (unsigned)(h + t.y) < (unsigned)s.H &&
                     (unsigned)(w + t.z) < (unsigned)s.W;
      cp_async4(xd + r * KP, v ? xb + t.x : x, v);
    }
  };

  // acc sums the hi*hi products, acc_lo the hi*lo and lo*hi ones: added
  // into acc inside the tensor cores, whose adds do not round to nearest,
  // the small products lose enough bits to miss the card test's tolerance
  // against the plain version at one of its shapes
  float acc[ACC], acc_lo[ACC];
#pragma unroll
  for (int q = 0; q < ACC; ++q) acc[q] = acc_lo[q] = 0.f;
  float rs[RJ];
#pragma unroll
  for (int j = 0; j < RJ; ++j) rs[j] = 0.f;

  const int wg = warp >> 2;
  const uint32_t b_off = (WN == 2 ? wg : 0) * (NWG / 8) * 128;
  const uint32_t bhi_s = smem_u32(b_hi) + b_off;
  const uint32_t blo_s = smem_u32(b_lo) + b_off;
  // softmax: NW threads per pixel, pixel sp, channels sg + NW * j
  const int sp = warp * PPW + lane / NW, sg = lane % NW;
  // this thread's A fragment: rows a_row0 and a_row0 + 8 of the block,
  // pixels lane%4 + 4j of the stage; their offsets in an x slot
  const int a_row0 = (WM == 2 ? wg : 0) * 64 + (warp & 3) * 16 + lane / 4;
  int a_row[2], a_pix[2 * KS];
#pragma unroll
  for (int v = 0; v < 2; ++v) {
    const int r = a_row0 + 8 * v;
    a_row[v] = s.halo ? rows[r].w : r * KP;
  }
#pragma unroll
  for (int j = 0; j < 2 * KS; ++j) {
    const int k = lane % 4 + 4 * j;
    a_pix[j] = s.halo ? k / s.wt * s.row_len + k % s.wt : k;
  }

  load_stage(0);
  cp_async_commit();
  for (int st = 0; st < n_stages; ++st) {
    if (st + 1 < n_stages) load_stage(st + 1);
    cp_async_commit();
    cp_async_wait_prior();
    wgmma_wait_all();  // the previous stage's products are done
    fence_regs<ACC>(acc);
    fence_regs<ACC>(acc_lo);
    __syncthreads();   // in every warpgroup, and stage st has landed

    // max-subtracted softmax of pixel sp over all O: NW lanes of one warp
    // share the pixel, so the reductions are shuffles; exp(z - max) is
    // kept in place for the B operand.  z = k*y is rounded before the
    // subtraction (no fused multiply-add), as the plain version rounds it
    float* yp = ys + (st % RING) * s.O * YS + sp;
    float mx = -INFINITY;
#pragma unroll 4
    for (int o = sg; o < s.O; o += NW)
      mx = fmaxf(mx, __fmul_rn(k_temp, yp[o * YS]));
#pragma unroll
    for (int off = NW / 2; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    float sm = 0.f;
#pragma unroll 4
    for (int o = sg; o < s.O; o += NW) {
      const float e = expf(__fmul_rn(k_temp, yp[o * YS]) - mx);
      yp[o * YS] = e;
      sm += e;
    }
#pragma unroll
    for (int off = NW / 2; off > 0; off >>= 1)
      sm += __shfl_xor_sync(0xffffffffu, sm, off);
    const bool pv = p_begin + st * KP + sp < p_end;
    const float inv = 1.f / sm;

    // B = r of the block's channels (o0 is a multiple of NW, so this
    // thread holds their e), split hi/lo
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
      const int ol = sg + j * NW, o = o0 + ol;
      const float r = (pv && o < s.O) ? yp[o * YS] * inv : 0.f;
      rs[j] += r;
      const float hi = tf32_rna(r);
      const int idx = op_index(ol, sp, LDB);
      b_hi[idx] = hi;
      b_lo[idx] = tf32_rna(r - hi);
    }
    // A = this thread's fragment of the patch rows, split hi/lo in
    // registers
    const float* xst = xs + (st % RING) * s.x_slot;
    uint32_t a_hi[KS][4], a_lo[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const float val = xst[a_row[v & 1] + a_pix[2 * ks + (v >> 1)]];
        const float hi = tf32_rna(val);
        a_hi[ks][v] = __float_as_uint(hi);
        a_lo[ks][v] = __float_as_uint(tf32_rna(val - hi));
      }
    }
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();  // B written, visible to the tensor cores

    fence_regs<ACC>(acc);
    fence_regs<ACC>(acc_lo);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t kb = ks * 2 * LDB * 4;
      Wgmma<NWG>::mma_rs(acc_lo, a_lo[ks],
                         gmma_desc(bhi_s + kb, LDB * 4, 128));
      Wgmma<NWG>::mma_rs(acc_lo, a_hi[ks],
                         gmma_desc(blo_s + kb, LDB * 4, 128));
      Wgmma<NWG>::mma_rs(acc, a_hi[ks],
                         gmma_desc(bhi_s + kb, LDB * 4, 128));
    }
    wgmma_commit();
  }
  wgmma_wait_all();
  fence_regs<ACC>(acc);
  fence_regs<ACC>(acc_lo);

  // partial[range][o][m]; accumulator q of a thread sits at row
  // a_row0 (+8) and column 8*(q/4) + 2*(lane%4) (+1)
  float* out = part + (long long)range * s.O * s.M;
  const int col0 = o0 + (WN == 2 ? wg : 0) * NWG + (lane & 3) * 2;
#pragma unroll
  for (int q = 0; q < ACC; ++q) {
    const int m = m0 + a_row0 + ((q >> 1) & 1) * 8;
    const int o = col0 + (q >> 2) * 8 + (q & 1);
    if (m < s.M && o < s.O)
      out[(long long)o * s.M + m] = acc[q] + acc_lo[q];
  }
  if (blockIdx.y == 0) {  // r_sum: over the lanes of a channel, then warps
#pragma unroll
    for (int j = 0; j < RJ; ++j) {
#pragma unroll
      for (int off = 16; off >= NW; off >>= 1)
        rs[j] += __shfl_xor_sync(0xffffffffu, rs[j], off);
    }
    __syncthreads();  // every stage is read: ys is free
    if (lane < NW) {
#pragma unroll
      for (int j = 0; j < RJ; ++j) ys[warp * NB + lane + j * NW] = rs[j];
    }
    __syncthreads();
    for (int ol = tid; ol < NB; ol += NT) {
      float v = 0.f;
      for (int q = 0; q < NW; ++q) v += ys[q * NB + ol];
      if (o0 + ol < s.O) rsum_part[(long long)range * s.O + o0 + ol] = v;
    }
  }
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

template <int NWG, int WM, int WN>
cudaError_t launch_partial(const float* x, const float* y, float* part,
                           float* rsum_part, const Shape& s0, float k_temp,
                           int ranges, long long range_len,
                           cudaStream_t stream) {
  using T = Tile<NWG, WM, WN>;
  Shape s = s0;
  const int khw = s.kh * s.kw;
  s.n_ch = (T::BM - 1) / khw + 2 < s.I ? (T::BM - 1) / khw + 2 : s.I;
  s.x_slot = s.halo ? s.n_ch * s.rows_r * s.row_len : T::BM * KP;
  const size_t smem = T::smem_bytes(s.O, s.x_slot);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  auto kernel = swta_wgmma_kernel<NWG, WM, WN>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid(ranges, (s.M + T::BM - 1) / T::BM,
                  (s.O + T::NB - 1) / T::NB);
  if (grid.y > 65535) return cudaErrorInvalidValue;
  kernel<<<grid, T::NT, smem, stream>>>(x, y, part, rsum_part, s, k_temp,
                                        (int)range_len);
  return cudaGetLastError();
}

}  // namespace

// Returns a cudaError_t (0 = launched).  The caller picks the tile
// (nwg = wgmma width 8..128, wm = warpgroups along M, wn = along N),
// whether x is staged with halos (`halo`, where the shape allows) and the
// pixel ranges (`range_len` a multiple of 32, ranges * range_len >=
// N*H*W, every range non-empty); it allocates `part` (ranges * O * M
// floats) and `rsum_part` (ranges * O floats).
// hebbax_torch/hebb/kernels.py `SwtaDeltaKernel.plan` mirrors the shared
// memory arithmetic of `Tile`.
extern "C" int hebbax_swta_delta_f32(
    const float* x, const float* y, const float* w, float* delta,
    float* part, float* rsum_part, int N, int I, int H, int W, int O,
    int kh, int kw, int ph, int pw, float k_temp, int ranges,
    long long range_len, int nwg, int wm, int wn, int halo,
    void* stream) {
  if (N <= 0 || I <= 0 || H <= 0 || W <= 0 || O <= 0 || O > MAX_O ||
      kh <= 0 || kw <= 0 || ph < 0 || pw < 0 || ranges <= 0 ||
      range_len <= 0 || range_len % KP != 0 ||
      H + 2 * ph - kh + 1 != H || W + 2 * pw - kw + 1 != W ||
      (long long)N * H * W >= (1LL << 31) ||
      (long long)I * H * W >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  Shape s;
  s.N = N; s.I = I; s.H = H; s.W = W; s.O = O; s.kh = kh; s.kw = kw;
  s.ph = ph; s.pw = pw; s.M = I * kh * kw;
  s.HW = H * W;
  s.P = N * s.HW;
  // halo staging: W % 4 == 0, taps at most 4 columns off, a stage of 32
  // pixels the aligned segment of one row or whole rows of one image, and
  // 16-byte aligned x and y
  s.halo = halo != 0;
  s.wt = W < KP ? W : KP;
  s.row_len = s.wt + 8;
  s.rows_r = KP / s.wt + kh - 1;
  if (s.halo && !(W % 4 == 0 && pw <= 4 &&
                  (W % KP == 0 || (KP % W == 0 && s.HW % KP == 0)) &&
                  (uintptr_t)x % 16 == 0 && (uintptr_t)y % 16 == 0))
    return (int)cudaErrorInvalidValue;
  if ((long long)(ranges - 1) * range_len >= s.P ||
      (long long)ranges * range_len < s.P ||
      (long long)ranges * range_len >= (1LL << 31))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
#define SWTA_TILE(NWG_, WM_, WN_)                                        \
  else if (nwg == NWG_ && wm == WM_ && wn == WN_) err =                  \
      launch_partial<NWG_, WM_, WN_>(x, y, part, rsum_part, s, k_temp,   \
                                     ranges, range_len, st);
  if (false) {
  }
  SWTA_TILE(8, 1, 1) SWTA_TILE(8, 2, 1)
  SWTA_TILE(16, 1, 1) SWTA_TILE(16, 2, 1)
  SWTA_TILE(32, 1, 1) SWTA_TILE(32, 2, 1)
  SWTA_TILE(64, 1, 1) SWTA_TILE(64, 2, 1)
  SWTA_TILE(128, 1, 1) SWTA_TILE(128, 2, 1) SWTA_TILE(128, 1, 2)
#undef SWTA_TILE
  if (err != cudaSuccess) return (int)err;
  const long long om = (long long)O * s.M;
  const int threads = 256;
  const unsigned blocks = (unsigned)((om + threads - 1) / threads);
  swta_reduce_kernel<<<blocks, threads, 0, st>>>(part, rsum_part, w, delta,
                                                 ranges, O, s.M);
  return (int)cudaGetLastError();
}
