// Hopper (sm_90a) kernels for the StyleGAN >=512^2 synthesis tail in chain
// mode: every layer writes its activation t RAW together with per-(channel,
// sample) sums of t and t^2; the instance-norm + AdaIN affine that those sums
// define is applied by the NEXT layer as it reads its input.
//
// Replaces the Pallas kernels of certifyingfacerecognition_tpu/ops/
// synthesis_tail_bc.py:
//   cfr_up_fused       <- _up_fused    -> _up_stream_kernel        (l.1205/931)
//   cfr_conv_fused     <- _conv_fused  -> _conv_stream_kernel      (l.1243/1115)
//   cfr_final_stats    <- _final_stats -> _conv_stats_stream_kernel(l.1279/1145)
//   cfr_final_apply    <- _final_apply -> _conv_rgb_stream_kernel  (l.1312/1172)
// and the two passes of the standalone half-layers (the layer's own
// instnorm + AdaIN applied by the producer, no input affine):
//   cfr_conv_stats     <- _conv_impl -> _conv_stats_kernel         (l.501/413)
//   cfr_conv_apply     <- _conv_impl -> _conv_apply_kernel         (l.501/435)
//   cfr_conv_rgb_apply <- _conv_impl -> _conv_rgb_apply_kernel     (l.501/453)
//   cfr_up_stats       <- _up_impl   -> _up_stats_kernel           (l.625/577)
//   cfr_up_apply       <- _up_impl   -> _up_apply_kernel           (l.625/594)
// The standalone passes are the chain kernels' device code in other modes
// (MODE_STATS / MODE_APPLY / MODE_RGB with apply_aff = 0).
//
// Layout (as in the JAX package): activations [H, W, C, B] with the sample
// axis B innermost, image [3, H, W, B], affines [2, C, B] in f32, sums
// [2, C, B] in int64 fixed point (below), weights HWIO [kh, kw, Ci, Co]
// (the f32 kernels take them as f32 holding values already rounded to the
// activation type, the bf16 kernels packed: pack_mma_weights for the conv
// kernel, pack_up_weights for the up kernel), noise+bias nb [H, W, Co] in
// the activation type.
//
// Design of the conv kernels and the f32 up kernel. One block holds 32
// consecutive samples on threadIdx.x (one warp spans the samples of one
// pixel, so activation loads and stores coalesce and every lane of a warp
// reads the same weight address) and NY workers on threadIdx.y that split
// the pixels of a tile. Blocks stride over tiles, so the per-block sums live
// in shared memory for the whole kernel and reach the [2, C, B] output with
// one atomicAdd per (channel, sample) per block.
//
// Sums. They are deterministic: every sum whose order depends on scheduling
// (adds into shared memory or into the output) is fixed point (int64, units
// of 2^-20), where addition is associative; each thread first adds its own
// terms in f32, in order. Each fixed-point term rounds by at most 2^-21, and
// the range holds |sum t^2| < 2^43, i.e. an rms |t| below ~2900 over 1024^2
// pixels.
//
// What bounds these kernels on an H100: the bytes they must move are
// 3.2-6.4 GB per layer at B = 128 (~1-2 ms at 3.35 TB/s) and their MACs fit
// the bf16 tensor cores in well under that, so the roofline bound is bytes
// for every launch but one: the up layer's stats pass at 512^2 writes only
// its sums, so its 0.55 TFLOP of MACs (0.56 ms) outweigh its 1.07 GB read.
//
// The up kernel (up_wgmma_kernel, bf16; design note above it; replaces the
// Pallas _up_stream_kernel, l.931, and _up_stats_kernel / _up_apply_kernel,
// l.577 / 594) is built for Hopper: a producer warpgroup stages the input
// region by TMA (cp.async.bulk.tensor with an mbarrier) into a three-stage
// shared-memory ring, a consumer warpgroup runs the deconvolution on wgmma
// (m64n16k16: the 64 samples as M, 16 output channels as N, 16 input
// channels per k step, both operands read from shared memory through
// descriptors that match the 128-byte swizzle TMA writes) while the
// producer keeps up to three stages in flight, and each output is
// deconvolved once except a strip's side columns (1.33x; the 8x8 tile with
// its 10x10 halo was 1.56x): the blur reads the deconvolved rows from
// registers, and each output row leaves by one TMA store. 256 threads,
// 128 registers at entry, then setmaxnreg 32 (producer) / 224 (consumer);
// shared memory 112,688 B at Ci = 64 with the input affine, 96,304 B
// without: two blocks per SM (chip_smoke.py phase 2 prints these). What
// bounds it now (measured on an H100 by switching parts off): not the
// MMAs, which hide behind the staging; the consumer's blur and epilogue,
// which follow each row's MMAs; the shared-memory bandwidth, which the A
// tile of every wgmma (2 KB per 16k MACs at N = 16), the staging and the
// in-place affine share; and the L2 reads of the staging, since each
// (deconvolved row, k step) stage re-reads the two input rows it needs
// (four deconvolved rows read each input row, 5 input columns per 3).

// The conv kernel (conv_tc, bf16) runs its 3x3 conv on the tensor cores
// with mma.sync.m16n8k16 (f32 accumulation), one block of 8 warps per SM
// (225 KB of shared memory at 512^2, Ci = Co = 32; 110-126 KB at 1024^2,
// Ci = Co = 16), 64 f32 accumulators per thread; it stages the input region
// of an 8x8 tile once in shared memory with the bf16 input affine applied
// there, so each input element is read about 1.56x (the tile halo) and
// normalised once per tile. Its sums are per-thread f32 sums over the tile,
// one fixed-point add per (channel, sample) and tile. What bounds it: the
// phases that run between block barriers with nothing to overlap them at
// one block per SM (the staging loads, the MMAs, the CUDA-core epilogue).
// The f32 kernels run their MACs as f32 FMAs on the CUDA cores (about 15x
// below the tensor-core rate), bound by instruction issue; the pipeline
// runs them only as checks. Every kernel keeps every intermediate (the
// un-blurred deconv, the 1024^2 16-channel activation of the last layer)
// out of device memory, which is what the chain design is for. Later work:
// the conv kernel on the same Hopper pipeline.
// Bounds of one launch at B = 128 on an H100 SXM (3.35 TB/s, 989 TFLOP/s
// bf16; chip_smoke.py bound()), at the 1024^2 FFHQ tail's shapes:
//   cfr_up_fused        up512 0.97 ms, up1024 1.93 ms (bytes)
//   cfr_conv_fused      conv512 1.29 ms (bytes)
//   cfr_final_stats     conv1024 1.29 ms (bytes)
//   cfr_final_apply     conv1024 1.53 ms (bytes)
//   cfr_conv_stats      conv512 0.65 ms, conv1024 1.29 ms (bytes)
//   cfr_conv_apply      conv512 1.29 ms (bytes)
//   cfr_conv_rgb_apply  conv1024 1.53 ms (bytes)
//   cfr_up_stats        up512 0.56 ms (operations), up1024 0.65 ms (bytes)
//   cfr_up_apply        up512 0.97 ms, up1024 1.93 ms (bytes)
//
// Rounding points reproduce the Pallas kernels in bf16: the input affine
// x*a+off is evaluated in the activation type, the deconv accumulates in
// f32 and rounds to the activation type, the blur runs in the activation
// type ((top+bottom)/4 + mid/2, vertical then horizontal), +nb and lrelu run
// in f32, t is stored in the activation type while the sums use the f32 t.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <type_traits>

namespace {

constexpr int LANES = 32;   // samples per block (threadIdx.x)
constexpr int NY = 8;       // pixel workers per block (threadIdx.y)
constexpr int UT = 8;       // f32 up kernel: output tile edge
constexpr int UCC = 8;      // up kernels: Co is a multiple of UCC
constexpr int CC = 16;      // conv kernels: output channels per pass
constexpr int MAX_BLOCKS = 2048;
constexpr float SUM_SCALE = 1048576.f;   // 2^20 fixed-point units per 1.0
typedef unsigned long long acc_t;        // two's-complement int64 sums

// One fixed-point term of the sums.
__device__ __forceinline__ acc_t to_fixed(float v) {
  return (acc_t)__float2ll_rn(v * SUM_SCALE);
}

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// One arithmetic result "in T": round an f32 value to T and back.
template <typename T> __device__ __forceinline__ float rnd(float v) {
  return to_f(from_f<T>(v));
}

// x * a + off evaluated in T (a, off already rounded to T).
template <typename T>
__device__ __forceinline__ float affine(float v, float a, float off) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(v, a)), off));
}

// (p + q) * 1/4 + m * 1/2 evaluated in T: one blur tap triple.
template <typename T>
__device__ __forceinline__ float blur3(float p, float m, float q) {
  return rnd<T>(__fadd_rn(rnd<T>(__fmul_rn(rnd<T>(__fadd_rn(p, q)), 0.25f)),
                          rnd<T>(__fmul_rn(m, 0.5f))));
}

__device__ __forceinline__ float lrelu(float t) {
  return t >= 0.f ? t : 0.2f * t;
}

template <int N>
__device__ __forceinline__ void load_w(const float* __restrict__ p,
                                       float (&w)[N]) {
#pragma unroll
  for (int i = 0; i < N; i += 4) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    w[i] = v.x;
    w[i + 1] = v.y;
    w[i + 2] = v.z;
    w[i + 3] = v.w;
  }
}

// Stage the input affine of this block's 32 samples ([2][Ci][LANES], values
// rounded to T; identity when apply_aff == 0) and zero the block's sums
// [2][Co][LANES]; then synchronise.
template <typename T>
__device__ void setup_shared(const float* __restrict__ aff, T* aff_s,
                             acc_t* red_s, int Ci, int Co, int B,
                             int apply_aff) {
  const int tid = threadIdx.y * LANES + threadIdx.x;
  for (int i = tid; i < 2 * Ci * LANES; i += LANES * NY) {
    const int which = i / (Ci * LANES);
    const int c = (i / LANES) % Ci;
    const int bb = blockIdx.x * LANES + i % LANES;
    float v = which == 0 ? 1.f : 0.f;
    if (apply_aff && bb < B) v = aff[(which * Ci + c) * B + bb];
    aff_s[i] = from_f<T>(v);
  }
  for (int i = tid; i < 2 * Co * LANES; i += LANES * NY) red_s[i] = 0;
  __syncthreads();
}

__device__ void flush_sums(const acc_t* red_s, acc_t* __restrict__ sums,
                           int Co, int B) {
  __syncthreads();
  const int tid = threadIdx.y * LANES + threadIdx.x;
  for (int i = tid; i < 2 * Co * LANES; i += LANES * NY) {
    const int which = i / (Co * LANES);
    const int co = (i / LANES) % Co;
    const int bb = blockIdx.x * LANES + i % LANES;
    if (bb < B) atomicAdd(&sums[(which * Co + co) * B + bb], red_s[i]);
  }
}

enum { MODE_T = 0, MODE_STATS = 1, MODE_RGB = 2, MODE_APPLY = 3 };

// The layer's own affine on t: rnd_T(t * a_c + off_c) (two f32 roundings,
// no FMA contraction, as the plain version computes it).
template <typename T>
__device__ __forceinline__ float own_affine(float t, const float* coefs,
                                            int co, int Co, int B, int b) {
  return rnd<T>(__fadd_rn(__fmul_rn(t, coefs[co * B + b]),
                          coefs[(Co + co) * B + b]));
}

// ---------------------------------------------------------------------------
// Tensor-core building blocks of the bf16 conv kernel (mma.sync.m16n8k16,
// bf16 in, f32 accumulation): M = the block's 32 samples (two m16 tiles),
// N = output channels (n8 tiles), K = input channels (k16 steps).
//
// Staging. The kernel stages the R x R input region of a tile in shared
// memory, xs [ck/16][R * R][16][32 samples] bf16, in chunks of ck input
// channels, with the input affine applied in bf16 (in-image pixels only:
// pixels outside the image and samples >= B stay 0, which is the zero
// padding that follows the affine). A staged pixel's 16 channels of one
// k16 step are 1 KB, so the ldmatrix address of a pixel is a constant
// offset from the warp's base (with a [pixel][ck] order it depended on ck
// and ptxas kept ~40 addresses in registers). The 16-byte chunk c of row
// (pixel, ci) is stored at c ^ ((ci >> 1) & 3), so that the eight rows of
// one ldmatrix phase hit distinct banks. A warp loads the A fragment of
// one staged pixel and k16 step with one ldmatrix .x4 .trans from the
// [ci][sample] rows.
//
// Weights. pack_mma_weights (ops/synthesis_tail_bc.py) lays [kh, kw, Ci, Co]
// out as the B fragments [kh][kw][Co/8][Ci/16][32 lanes][4 bf16]: one
// 8-byte load per lane per (tap, n8 tile, k16 step), read through L1/L2.
// ---------------------------------------------------------------------------

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ void ldsm_x4_trans(unsigned addr,
                                              unsigned (&r)[4]) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void mma_bf16(float (&d)[4],
                                         const unsigned (&a)[4], uint2 b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// Two bf16 in one 32-bit word (low half first) to f32 and back.
__device__ __forceinline__ float bf_lo(unsigned w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float bf_hi(unsigned w) {
  return __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ unsigned bf_pack(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

// affine<bf16> of two packed bf16 values.
__device__ __forceinline__ unsigned affine2(unsigned v, unsigned a,
                                            unsigned o) {
  return bf_pack(affine<bf16>(bf_lo(v), bf_lo(a), bf_lo(o)),
                 affine<bf16>(bf_hi(v), bf_hi(a), bf_hi(o)));
}

// Stage input channels [ci0, ci0 + ck) of the R x R input region whose
// top-left pixel is (m0, n0) into xs (layout above). Each thread moves 8
// samples per 16-byte chunk, with SB chunks' loads in flight at a time.
template <int R, bool AFF>
__device__ void stage_x(const bf16* __restrict__ x, const bf16* aff_s,
                        bf16* xs, int m0, int n0, int ci0, int ck, int H,
                        int W, int Ci, int B) {
  constexpr int SB = 4;
  constexpr int STEP = LANES * NY;
  const int tid = threadIdx.y * LANES + threadIdx.x;
  const bool vec = B % 8 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  const int n_chunks = R * R * ck * 4;
  for (int i0 = tid; i0 < n_chunks; i0 += SB * STEP) {
    uint4 q[SB];
    bool live[SB];
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * STEP;
      // row i >> 2 = (k16 group * R * R + pixel) * 16 + channel in group
      const int c = i & 3, pix = (i >> 6) % (R * R);
      const int ci = (i >> 6) / (R * R) * 16 + ((i >> 2) & 15);
      const int m = m0 + pix / R, n = n0 + pix % R;
      const int b0 = blockIdx.x * LANES + c * 8;
      live[u] = i < n_chunks && m >= 0 && m < H && n >= 0 && n < W && b0 < B;
      q[u] = make_uint4(0, 0, 0, 0);
      if (live[u]) {
        const bf16* src = x + ((size_t)(m * W + n) * Ci + ci0 + ci) * B + b0;
        if (vec) {
          q[u] = *reinterpret_cast<const uint4*>(src);
        } else {
          unsigned short e[8];
#pragma unroll
          for (int k = 0; k < 8; ++k)
            e[k] = b0 + k < B ? __bfloat16_as_ushort(src[k]) : 0;
          q[u] = make_uint4(
              e[0] | (unsigned)e[1] << 16, e[2] | (unsigned)e[3] << 16,
              e[4] | (unsigned)e[5] << 16, e[6] | (unsigned)e[7] << 16);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < SB; ++u) {
      const int i = i0 + u * STEP;
      if (i >= n_chunks) break;
      const int c = i & 3, row = i >> 2;
      const int ci = (i >> 6) / (R * R) * 16 + (row & 15);
      uint4 v = q[u];
      if (AFF && live[u]) {
        // identity (1, 0) for samples >= B, whose staged value stays 0
        const uint4 a = *reinterpret_cast<const uint4*>(
            aff_s + (ci0 + ci) * LANES + c * 8);
        const uint4 o = *reinterpret_cast<const uint4*>(
            aff_s + (Ci + ci0 + ci) * LANES + c * 8);
        v = make_uint4(affine2(v.x, a.x, o.x), affine2(v.y, a.y, o.y),
                       affine2(v.z, a.z, o.z), affine2(v.w, a.w, o.w));
      }
      *reinterpret_cast<uint4*>(xs + row * LANES +
                                ((c ^ ((ci >> 1) & 3)) * 8)) = v;
    }
  }
}

// The ldmatrix address of this lane's row in the A fragment of staged
// pixel 0, k16 step 0, m16 tile mt: input channel ci_l of the step,
// samples of chunk 2 mt (matrices 0, 2) or 2 mt + 1 (matrices 1, 3).
// Staged pixel P of k16 step ks is (ks * R * R + P) KB further.
__device__ __forceinline__ unsigned a_frag_base(const bf16* xs, int mt) {
  const int lane = threadIdx.x;
  const int ci_l = (lane & 7) + ((lane >> 4) << 3);
  const int chunk = (2 * mt + ((lane >> 3) & 1)) ^ ((ci_l >> 1) & 3);
  return (unsigned)__cvta_generic_to_shared(xs) +
         (unsigned)(ci_l * LANES + chunk * 8) * 2u;
}

// ---------------------------------------------------------------------------
// 3x3 conv (zero padding) of aff(x), then +nb and lrelu in f32.
//   MODE_T:     write t [H, W, Co, B], accumulate sums [2, Co, B]
//   MODE_STATS: accumulate sums only
//   MODE_APPLY: write out = own_affine(t) [H, W, Co, B] with this layer's
//               coefs [2, Co, B]; no sums
//   MODE_RGB:   out = own_affine(t); image[r] = sum_c out * wrgb[c, r] +
//               brgb[r], written [3, H, W, B]
// AFF: whether the input affine is applied (a template parameter, so that
// each variant gets its own code for the inner loop).
// ---------------------------------------------------------------------------

// The f32 kernel on the CUDA cores: one warp spans the samples of one pixel,
// NY workers split the pixels of a tile of TILE_PX, and each output is
// an f32 FMA loop over taps and input channels, CC output channels per
// pass (k f32 [3, 3, Ci, Co]).
constexpr int TILE_PX = NY * 8;
template <typename T, int MODE, bool AFF>
__device__ void conv_fma(const T* __restrict__ x, const float* __restrict__ k,
                         const T* __restrict__ nb,
                         const float* __restrict__ aff,
                         const float* __restrict__ coefs,
                         const float* __restrict__ wrgb,
                         const float* __restrict__ brgb, T* __restrict__ out,
                         acc_t* __restrict__ sums, int H, int W, int Ci,
                         int Co, int B, int ntiles) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  acc_t* red_s = reinterpret_cast<acc_t*>(smem_raw);     // [2][Co][LANES]
  T* aff_s = reinterpret_cast<T*>(red_s + 2 * Co * LANES);  // [2][Ci][LANES]
  setup_shared<T>(aff, aff_s, red_s, Ci, Co, B, AFF);

  const int lane = threadIdx.x;
  const int b = blockIdx.x * LANES + lane;
  const bool active = b < B;
  const int npix = H * W;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int p_end = min(npix, (tile + 1) * TILE_PX);
    for (int p = tile * TILE_PX + threadIdx.y; p < p_end; p += NY) {
      if (!active) continue;
      const int h = p / W, w = p % W;
      float rgb[3] = {0.f, 0.f, 0.f};
      for (int c0 = 0; c0 < Co; c0 += CC) {
        float acc[CC];
#pragma unroll
        for (int j = 0; j < CC; ++j) acc[j] = 0.f;
        for (int dy = 0; dy < 3; ++dy) {
          const int hh = h + dy - 1;
          if (hh < 0 || hh >= H) continue;
          for (int dx = 0; dx < 3; ++dx) {
            const int ww = w + dx - 1;
            if (ww < 0 || ww >= W) continue;
            const T* xp = x + (size_t)(hh * W + ww) * Ci * B + b;
            const float* kp = k + (size_t)(dy * 3 + dx) * Ci * Co + c0;
            for (int ci = 0; ci < Ci; ++ci) {
              float v = to_f(xp[(size_t)ci * B]);
              if (AFF)
                v = affine<T>(v, to_f(aff_s[ci * LANES + lane]),
                              to_f(aff_s[(Ci + ci) * LANES + lane]));
              float wv[CC];
              load_w<CC>(kp + (size_t)ci * Co, wv);
#pragma unroll
              for (int j = 0; j < CC; ++j) acc[j] = fmaf(v, wv[j], acc[j]);
            }
          }
        }
#pragma unroll
        for (int j = 0; j < CC; ++j) {
          const int co = c0 + j;
          const float t =
              lrelu(__fadd_rn(acc[j], to_f(nb[(size_t)p * Co + co])));
          if (MODE == MODE_RGB) {
            const float o = own_affine<T>(t, coefs, co, Co, B, b);
#pragma unroll
            for (int r = 0; r < 3; ++r) rgb[r] = fmaf(o, wrgb[co * 3 + r], rgb[r]);
          } else if (MODE == MODE_APPLY) {
            out[((size_t)p * Co + co) * B + b] =
                from_f<T>(own_affine<T>(t, coefs, co, Co, B, b));
          } else {
            if (MODE == MODE_T)
              out[((size_t)p * Co + co) * B + b] = from_f<T>(t);
            atomicAdd(&red_s[co * LANES + lane], to_fixed(t));
            atomicAdd(&red_s[(Co + co) * LANES + lane],
                      to_fixed(__fmul_rn(t, t)));
          }
        }
      }
      if (MODE == MODE_RGB) {
#pragma unroll
        for (int r = 0; r < 3; ++r)
          out[((size_t)r * npix + p) * B + b] =
              from_f<T>(__fadd_rn(rgb[r], brgb[r]));
      }
    }
  }
  if (MODE == MODE_T || MODE == MODE_STATS) flush_sums(red_s, sums, Co, B);
}

// The bf16 kernel on the tensor cores.
//
// Per output pixel p and tap (dy, dx) the conv is the GEMM
// D[b, co] += X[pix(p) + (dy - 1, dx - 1)][b, ci] * W[dy, dx][ci, co]. A
// tile of CT x CT outputs at (r0, q0) reads the CR x CR = 10 x 10 input
// region from (r0 - 1, q0 - 1): output (i, j) takes tap (dy, dx) from
// staged pixel (i + dy, j + dx). Warp w takes the m16 sample tile w & 1
// and the 16 outputs of tile rows 2 (w >> 1) and 2 (w >> 1) + 1, for TCC =
// 8 output channels (one n8 tile) per pass: 2 x 8 x 4 = 64 f32
// accumulators per thread (with two n8 tiles per pass, 128 of them, ptxas
// spilled at 255 registers). Per k16 step and kernel row dy it loads the
// B fragments of the three taps (dy, 0..2), then each staged pixel of the
// two rows it reads once with ldmatrix, and feeds it to the up to three
// outputs of that row that read it: 60 ldmatrix and 144 mma per k16 step.
//
// The region is staged once per tile for all Co/TCC passes when all of Ci
// fits the block's shared memory (ck = Ci: Ci <= 32 at Co <= 32), else in
// chunks of 32 or 16 channels, restaged for every pass.
//
// Epilogue from the accumulators: +nb and lrelu in f32. MODE_T writes t
// in bf16 straight from the fragments (lanes 4g + t hold samples g, g + 8
// and channels 2t, 2t + 1, so a store of the warp covers 8 consecutive
// samples of 4 channels); MODE_APPLY writes own_affine(t); MODE_RGB takes
// own_affine(t) into the ToRGB, sums it over the thread's 2 channels, then
// over the quad (__shfl_xor_sync 1 then 2: every lane of the quad adds the
// same two values, in either order, so all four hold the same bits) and
// lane t < 3 keeps colour t across the passes in rgb_s, a slot that no
// other thread touches. MODE_T and MODE_STATS add each thread's t and t^2
// over its 16 outputs in f32 in order, then make one fixed-point add per
// (channel, sample) into red_s: 8 shared atomics per thread and pass,
// where the CUDA-core kernel made two per output element.
//
// Shared memory per block: sums 2*Co*32*8 B (MODE_T, MODE_STATS) + staged
// affine 2*Ci*32*2 B + staged input 100*ck*32*2 B + rgb_s 24,576 B
// (MODE_RGB); 225,280 B at 512^2 (Ci = Co = 32, ck = 32), 112,640 B
// (sums) and 129,024 B (ToRGB) at 1024^2 (Ci = Co = 16): one block (8
// warps) per SM.
constexpr int CT = 8;           // output tile edge
constexpr int CR = CT + 2;      // staged input region edge
constexpr int TCC = 8;          // output channels per pass (one n8 tile)
static_assert(NY == 8, "conv_mma maps 2 m16 tiles x 4 row pairs onto the "
                       "8 warps");

// One chunk of staged input channels (k16 steps s0 .. s0 + ck/16 of the
// packed weights) into this warp's accumulators, for output channels
// 8 * cc .. 8 * cc + 7.
__device__ __forceinline__ void conv_mma(const bf16* xs,
                                         const uint2* __restrict__ wp,
                                         float (&acc)[2][CT][4], int ck,
                                         int s0, int S, int cc, int CC8) {
  const int lane = threadIdx.x, mt = threadIdx.y & 1, pg = threadIdx.y >> 1;
  // staged row 2 pg of k16 step 0
  const unsigned base = a_frag_base(xs, mt) + 2 * pg * CR * 1024;
  for (int ks = 0; ks < ck / 16; ++ks) {
    const unsigned kbase = base + ks * CR * CR * 1024;
    // not unrolled: ptxas would prefetch the next kernel rows' ldmatrix
    // results across the whole step and spill at 255 registers
#pragma unroll 1
    for (int dy = 0; dy < 3; ++dy) {
      uint2 bw[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        bw[dx] = wp[(((dy * 3 + dx) * CC8 + cc) * S + s0 + ks) * LANES + lane];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int sx = 0; sx < CR; ++sx) {
          unsigned af[4];
          ldsm_x4_trans(kbase + dy * CR * 1024 + (r * CR + sx) * 1024, af);
#pragma unroll
          for (int dx = 0; dx < 3; ++dx) {
            const int j = sx - dx;
            if (j >= 0 && j < CT) mma_bf16(acc[r][j], af, bw[dx]);
          }
        }
    }
  }
}

template <int MODE, bool AFF>
__device__ void conv_tc(const bf16* __restrict__ x,
                        const uint2* __restrict__ wp,
                        const bf16* __restrict__ nb,
                        const float* __restrict__ aff,
                        const float* __restrict__ coefs,
                        const float* __restrict__ wrgb,
                        const float* __restrict__ brgb, bf16* __restrict__ out,
                        acc_t* __restrict__ sums, int H, int W, int Ci,
                        int Co, int B, int ntw, int ntiles, int ck) {
  constexpr bool SUMS = MODE == MODE_T || MODE == MODE_STATS;
  constexpr bool OWN = MODE == MODE_APPLY || MODE == MODE_RGB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int nred = SUMS ? Co : 0;
  acc_t* red_s = reinterpret_cast<acc_t*>(smem_raw);         // [2][Co][LANES]
  bf16* aff_s = reinterpret_cast<bf16*>(red_s + 2 * nred * LANES);
  bf16* xs = aff_s + 2 * Ci * LANES;                     // [CR*CR][ck][LANES]
  float* rgb_s = reinterpret_cast<float*>(xs + CR * CR * ck * LANES);
  setup_shared<bf16>(aff, aff_s, red_s, Ci, nred, B, AFF);

  const int lane = threadIdx.x, mt = threadIdx.y & 1, pg = threadIdx.y >> 1;
  const int g = lane >> 2, tq = lane & 3;
  const int sb = 16 * mt + g;                  // block sample of d[0], d[1]
  const int bs = blockIdx.x * LANES + sb;      // + 8 for d[2], d[3]

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int r0 = (tile / ntw) * CT, q0 = (tile % ntw) * CT;
    if (ck == Ci) {   // the whole region, once for every pass
      stage_x<CR, AFF>(x, aff_s, xs, r0 - 1, q0 - 1, 0, Ci, H, W, Ci, B);
      __syncthreads();
    }
    for (int c0 = 0; c0 < Co; c0 += TCC) {
      float acc[2][CT][4];
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < CT; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[r][j][e] = 0.f;
      for (int ci0 = 0; ci0 < Ci; ci0 += ck) {
        if (ck != Ci) {
          stage_x<CR, AFF>(x, aff_s, xs, r0 - 1, q0 - 1, ci0, ck, H, W, Ci,
                           B);
          __syncthreads();
        }
        conv_mma(xs, wp, acc, ck, ci0 / 16, Ci / 16, c0 / TCC, Co / TCC);
        if (ck != Ci) __syncthreads();
      }

      // [q][h]: channel c0 + 2tq + q, sample bs + 8h
      float s1[2][2], s2[2][2], ca[2][2], cb[2][2], wr[2][3];
#pragma unroll
      for (int q = 0; q < 2; ++q) {
        const int co = c0 + 2 * tq + q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int b = bs + 8 * h;
          s1[q][h] = s2[q][h] = 0.f;
          if (OWN) {
            ca[q][h] = b < B ? coefs[co * B + b] : 0.f;
            cb[q][h] = b < B ? coefs[(Co + co) * B + b] : 0.f;
          }
        }
        if (MODE == MODE_RGB)
#pragma unroll
          for (int c = 0; c < 3; ++c) wr[q][c] = wrgb[co * 3 + c];
      }
#pragma unroll
      for (int r = 0; r < 2; ++r)
#pragma unroll
        for (int j = 0; j < CT; ++j) {
          const int oh = r0 + 2 * pg + r, ow = q0 + j;
          if (oh >= H || ow >= W) continue;   // uniform across the warp
          const size_t p = (size_t)oh * W + ow;
          float rgb[2][3] = {{0.f, 0.f, 0.f}, {0.f, 0.f, 0.f}};
#pragma unroll
          for (int q = 0; q < 2; ++q) {
            const int co = c0 + 2 * tq + q;
            const float nbv = to_f(nb[p * Co + co]);
#pragma unroll
            for (int h = 0; h < 2; ++h) {
              const int b = bs + 8 * h;
              const float t = lrelu(__fadd_rn(acc[r][j][2 * h + q], nbv));
              if (SUMS) {
                if (MODE == MODE_T && b < B)
                  out[(p * Co + co) * B + b] = __float2bfloat16_rn(t);
                s1[q][h] = __fadd_rn(s1[q][h], t);
                s2[q][h] = __fadd_rn(s2[q][h], __fmul_rn(t, t));
              } else {
                const float o = rnd<bf16>(
                    __fadd_rn(__fmul_rn(t, ca[q][h]), cb[q][h]));
                if (MODE == MODE_APPLY) {
                  if (b < B)
                    out[(p * Co + co) * B + b] = __float2bfloat16_rn(o);
                } else {
#pragma unroll
                  for (int c = 0; c < 3; ++c)
                    rgb[h][c] = fmaf(o, wr[q][c], rgb[h][c]);
                }
              }
            }
          }
          if (MODE == MODE_RGB) {
#pragma unroll
            for (int h = 0; h < 2; ++h)
#pragma unroll
              for (int c = 0; c < 3; ++c) {
                float v = rgb[h][c];
                v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 1));
                rgb[h][c] = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, 2));
              }
            if (tq < 3) {
#pragma unroll
              for (int h = 0; h < 2; ++h) {
                float v = tq == 0 ? rgb[h][0] : tq == 1 ? rgb[h][1] : rgb[h][2];
                const int idx =
                    ((tq * CT + 2 * pg + r) * CT + j) * LANES + sb + 8 * h;
                if (c0 > 0) v = __fadd_rn(rgb_s[idx], v);
                if (c0 + TCC < Co) {
                  rgb_s[idx] = v;
                } else if (bs + 8 * h < B) {
                  out[((size_t)tq * H * W + p) * B + bs + 8 * h] =
                      __float2bfloat16_rn(__fadd_rn(v, brgb[tq]));
                }
              }
            }
          }
        }
      if (SUMS) {
#pragma unroll
        for (int q = 0; q < 2; ++q)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int co = c0 + 2 * tq + q, sm = sb + 8 * h;
            atomicAdd(&red_s[co * LANES + sm], to_fixed(s1[q][h]));
            atomicAdd(&red_s[(Co + co) * LANES + sm], to_fixed(s2[q][h]));
          }
      }
    }
    if (ck == Ci) __syncthreads();   // xs is restaged for the next tile
  }
  if (SUMS) flush_sums(red_s, sums, Co, B);
}

// The conv kernel: the bf16 variant on the tensor cores (conv_tc, k the
// packed weights, ntiles tiles of CT x CT outputs, ntw of them per row, ck
// the staging chunk; one block per SM, up to 255 registers), the f32
// variant on the CUDA cores (conv_fma, k f32 [3, 3, Ci, Co], ntiles tiles
// of TILE_PX pixels; at least 3 blocks per SM, up to 80 registers, since
// one variant spilled at 64 without the hint). The tile counts come from
// the launcher, so that they are kernel parameters and take no register.
template <typename T, int MODE, bool AFF>
__global__ void __launch_bounds__(LANES* NY,
                                  std::is_same<T, bf16>::value ? 1 : 3)
    conv3x3_kernel(const T* __restrict__ x, const void* __restrict__ k,
                   const T* __restrict__ nb, const float* __restrict__ aff,
                   const float* __restrict__ coefs,
                   const float* __restrict__ wrgb,
                   const float* __restrict__ brgb, T* __restrict__ out,
                   acc_t* __restrict__ sums, int H, int W, int Ci, int Co,
                   int B, int ntw, int ntiles, int ck) {
  if constexpr (std::is_same<T, bf16>::value)
    conv_tc<MODE, AFF>(x, static_cast<const uint2*>(k), nb, aff, coefs, wrgb,
                       brgb, out, sums, H, W, Ci, Co, B, ntw, ntiles, ck);
  else
    conv_fma<T, MODE, AFF>(x, static_cast<const float*>(k), nb, aff, coefs,
                           wrgb, brgb, out, sums, H, W, Ci, Co, B, ntiles);
}

// ---------------------------------------------------------------------------
// Up layer: t = lrelu(blur3x3(convT4x4,s2(aff(x))) + nb) on the 2H x 2W
// grid.
//   MODE_T:     write t raw [2H, 2W, Co, B], accumulate sums [2, Co, B]
//   MODE_STATS: accumulate sums only
//   MODE_APPLY: write own_affine(t) with this layer's coefs; no sums
// The transposed conv is the lhs-dilated forward conv of the JAX package
// (pad 2, dilation 2): output row o reads input row m = (o + kh - 2) / 2
// for the two kh with o + kh even (kh = (o & 1) + 2a, a = 0, 1), and so
// output rows 2j and 2j + 1 read input rows j - 1, j and j, j + 1. Columns
// alike. AFF as in conv3x3_kernel.
// ---------------------------------------------------------------------------

// The f32 up layer on the CUDA cores (kept as a check): each tile of UT x UT
// outputs first deconvolves its (UT+2)^2 halo region for UP = 4 channels
// per pass into shared memory (zero outside the 2H x 2W grid: the blur sees
// zero padding there), one position per thread at a time as f32 FMAs (k4
// f32 [4, 4, Ci, Co]), then blurs from it. Shared memory per block: sums
// 2*Co*32*8 B + staged affine 2*Ci*32*4 B + yb_s 51,200 B; 182,272 B at
// Ci = 256, Co = 128.
constexpr int UP = UCC / 2;   // output channels per pass of the f32 up kernel

template <typename T, bool AFF>
__device__ void deconv_fma(const T* __restrict__ x,
                           const float* __restrict__ k4, const T* aff_s,
                           T* yb_s, int r0, int q0, int c0, int H, int W,
                           int Ci, int Co, int B) {
  constexpr int YR = UT + 2;
  constexpr int NPOS = YR * YR;
  const int lane = threadIdx.x;
  const int b = blockIdx.x * LANES + lane;
  const bool active = b < B;
  const int OH = 2 * H, OW = 2 * W;
  for (int pos = threadIdx.y; pos < NPOS; pos += NY) {
    const int orow = r0 - 1 + pos / YR, ocol = q0 - 1 + pos % YR;
    float acc[UP];
#pragma unroll
    for (int j = 0; j < UP; ++j) acc[j] = 0.f;
    if (active && orow >= 0 && orow < OH && ocol >= 0 && ocol < OW) {
      for (int a = 0; a < 2; ++a) {
        const int kh = (orow & 1) + 2 * a;
        const int m = (orow + kh - 2) / 2;   // orow + kh is even
        if (m < 0 || m >= H) continue;
        for (int e = 0; e < 2; ++e) {
          const int kw = (ocol & 1) + 2 * e;
          const int n = (ocol + kw - 2) / 2;
          if (n < 0 || n >= W) continue;
          const T* xp = x + (size_t)(m * W + n) * Ci * B + b;
          const float* kp = k4 + (size_t)(kh * 4 + kw) * Ci * Co + c0;
          for (int ci = 0; ci < Ci; ++ci) {
            float v = to_f(xp[(size_t)ci * B]);
            if (AFF)
              v = affine<T>(v, to_f(aff_s[ci * LANES + lane]),
                            to_f(aff_s[(Ci + ci) * LANES + lane]));
            float wv[UP];
            load_w<UP>(kp + (size_t)ci * Co, wv);
#pragma unroll
            for (int j = 0; j < UP; ++j) acc[j] = fmaf(v, wv[j], acc[j]);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < UP; ++j)
      yb_s[(pos * UP + j) * LANES + lane] = from_f<T>(acc[j]);
  }
}

template <typename T, int MODE, bool AFF>
__global__ void __launch_bounds__(LANES* NY)
    up_kernel(const T* __restrict__ x, const float* __restrict__ k4,
              const T* __restrict__ nb, const float* __restrict__ aff,
              const float* __restrict__ coefs, T* __restrict__ out,
              acc_t* __restrict__ sums, int H, int W, int Ci, int Co,
              int B) {
  constexpr int YR = UT + 2;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  acc_t* red_s = reinterpret_cast<acc_t*>(smem_raw);      // [2][Co][LANES]
  T* aff_s = reinterpret_cast<T*>(red_s + 2 * Co * LANES);  // [2][Ci][LANES]
  T* yb_s = aff_s + 2 * Ci * LANES;                        // [YR*YR][UP][LANES]
  setup_shared<T>(aff, aff_s, red_s, Ci, Co, B, AFF);

  const int lane = threadIdx.x;
  const int b = blockIdx.x * LANES + lane;
  const bool active = b < B;
  const int OH = 2 * H, OW = 2 * W;
  const int ntw = (OW + UT - 1) / UT;
  const int ntiles = ((OH + UT - 1) / UT) * ntw;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int r0 = (tile / ntw) * UT, q0 = (tile % ntw) * UT;
    for (int c0 = 0; c0 < Co; c0 += UP) {
      deconv_fma<T, AFF>(x, k4, aff_s, yb_s, r0, q0, c0, H, W, Ci, Co, B);
      __syncthreads();
      // this thread's sums over its pixels of the tile, in order
      float s1[UP], s2[UP];
#pragma unroll
      for (int j = 0; j < UP; ++j) s1[j] = s2[j] = 0.f;
      for (int q = threadIdx.y; q < UT * UT; q += NY) {
        const int lr = q / UT, lc = q % UT;
        const int orow = r0 + lr, ocol = q0 + lc;
        if (!active || orow >= OH || ocol >= OW) continue;
        const size_t op = (size_t)orow * OW + ocol;
#pragma unroll
        for (int j = 0; j < UP; ++j) {
          float v[3];
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const int base = (lr * YR + lc + dc) * UP + j;
            v[dc] = blur3<T>(to_f(yb_s[base * LANES + lane]),
                             to_f(yb_s[(base + YR * UP) * LANES + lane]),
                             to_f(yb_s[(base + 2 * YR * UP) * LANES + lane]));
          }
          const float hb = blur3<T>(v[0], v[1], v[2]);
          const int co = c0 + j;
          const float t = lrelu(__fadd_rn(hb, to_f(nb[op * Co + co])));
          if (MODE == MODE_APPLY) {
            out[(op * Co + co) * B + b] =
                from_f<T>(own_affine<T>(t, coefs, co, Co, B, b));
            continue;
          }
          if (MODE == MODE_T) out[(op * Co + co) * B + b] = from_f<T>(t);
          s1[j] = __fadd_rn(s1[j], t);
          s2[j] = __fadd_rn(s2[j], __fmul_rn(t, t));
        }
      }
      if (MODE != MODE_APPLY && active) {
#pragma unroll
        for (int j = 0; j < UP; ++j) {
          atomicAdd(&red_s[(c0 + j) * LANES + lane], to_fixed(s1[j]));
          atomicAdd(&red_s[(Co + c0 + j) * LANES + lane], to_fixed(s2[j]));
        }
      }
      __syncthreads();
    }
  }
  if (MODE != MODE_APPLY) flush_sums(red_s, sums, Co, B);
}

// ---------------------------------------------------------------------------
// The bf16 up layer on Hopper (up_wgmma_kernel): TMA staging into a ring of
// shared-memory stages, the deconvolution on wgmma, warp specialisation.
//
// Work unit. A block takes UM = 64 samples (the wgmma M), UN = 16 output
// channels (the wgmma N) and a strip of UW = 6 output columns, and walks
// down UROWS = 64 output rows of it. It deconvolves UDC = 8 columns of
// each row (the strip and the blur's halo column on either side), so only
// the strip's side edges recompute (1.33x); each row is deconvolved once
// and the blur reads it from registers. (A strip of 8 columns, 1.25x, needs
// 80 accumulators and two rows of 40 registers, and spilled at 216.)
//
// GEMM. Per deconvolved row d (parity pr = d & 1) and column i (parity
// pc = (i + 1) & 1 of column q0 - 1 + i) the deconv is
// D_i[b, co] = sum over a, e of X[row ma + a, col (i >> 1) + e][b, ci] *
// W[kh = pr + 2a, kw = pc + 2e][ci, co], ma = (d + pr - 2) / 2, the input
// columns counted from the strip's first, q0 / 2 - 1. One k16 step of it is
// 4 wgmma.m64n16k16 per column, 32 per row, with 8 accumulators of 8 f32
// per thread.
//
// Stages. A stage holds one (deconvolved row, k16 step): the two input rows
// ma, ma + 1, UIC = 5 columns, 16 input channels and the 64 samples, 20 KB
// as TMA writes it ([2][5][16 ci][64 samples], 128-byte rows with the
// 128-byte swizzle), and the 8 taps of the row's parity, 4 KB
// (pack_up_weights: per tap [2 n8 groups][2 k8 chunks][8][8], the K-major
// layout without swizzle). A (MN-major: the samples are contiguous in
// [H, W, Ci, B]) is the 2 KB of one staged pixel (descriptor: 128-byte
// swizzle, the two k8 row groups 1024 B apart), B is one tap's 512 B
// (k8 chunks 128 B apart, n8 groups 256 B apart). Three stages rotate
// through a ring; each has a full and an empty mbarrier.
//
// Roles (256 threads; setmaxnreg gives the producer warpgroup 32 registers
// and the consumer warpgroup 224). Warps 4-7 are the producer: per stage
// thread 128 waits for the slot to be empty, then issues the TMA load of
// the input box (cp.async.bulk.tensor.4d; the box runs past the image and
// past B where the strip or the group does, and TMA fills 0 there) and the
// bulk copy of the weights, with a row's first stage also the TMA load of
// the nb its epilogue adds (into a ring of UNB rows), all completing on the
// full barrier, up to three stages ahead of the consumers. When
// B % 8 != 0 TMA cannot describe x (its strides must be multiples of 16
// bytes), and the whole warpgroup stages the box: cp.async of 8 or 4
// bytes (2 if B is odd: loads and stores through registers) with zero
// fill outside the image, samples >= B left at the 0 the ring starts
// with; each thread's arrival on the full
// barrier follows its copies (cp.async.mbarrier.arrive.noinc). Warps 0-3
// are the consumer warpgroup. Per stage they wait for it to be full, apply
// the input affine in place (bf16, in-image pixels only: the zero padding
// follows the affine) while the previous stage's wgmma group runs, fence
// the generic proxy's writes for wgmma, issue the stage's 32 wgmma and
// commit them, and release the previous stage once its group has
// completed (wgmma.wait_group 1). After the row's last stage they round
// the accumulators to bf16 pairs (zero outside the 2H x 2W grid) and run
// the blur and epilogue of the row above it from the last three rows held
// in registers (the row loop is unrolled by three so that the three row
// buffers rotate by name: copying them spilled): vertical then horizontal
// blur as bf16x2 arithmetic, +nb and
// lrelu in f32, t or own_affine(t) into a swizzled tile that one thread
// stores with TMA (each thread stores its own when B % 8 != 0), the f32
// sums in order. Two blocks fit an SM, so one block's blur and epilogue
// run beside the other's wgmma, and the producers keep loads in flight
// under both.
//
// Sums: each consumer thread owns 8 (sample, channel) pairs of the block;
// per output row it adds its t and t^2 in f32 in a fixed order and then
// adds the row's sums to its running sums, which it keeps in shared memory
// (16 floats, as MODE_APPLY keeps its coefficients there), out of the
// registers the MMAs need; at the end it makes one fixed-point atomicAdd
// per pair and sum into the output.
// ---------------------------------------------------------------------------

constexpr int UM = 64;             // samples per block (wgmma M)
constexpr int UN = 16;             // output channels per block (wgmma N)
constexpr int UW = 6;              // output columns per strip
constexpr int UDC = UW + 2;        // deconvolved columns of a strip
constexpr int UIC = UW / 2 + 2;    // input columns a strip reads
constexpr int UROWS = 64;          // output rows per block
constexpr int USTAGES = 3;         // ring depth
constexpr int U_PIX_BYTES = 16 * UM * 2;              // one staged pixel
constexpr int U_IN_BYTES = 2 * UIC * U_PIX_BYTES;     // 20,480
constexpr int U_TAP_BYTES = 16 * UN * 2;              // one tap's B
constexpr int U_W_BYTES = 8 * U_TAP_BYTES;            // 4,096
constexpr int U_STAGE_BYTES = U_IN_BYTES + U_W_BYTES;  // 24,576
constexpr int U_TILE_BYTES = UW * 16 * UM * 2;        // 12,288: one row out
constexpr int UNB = 4;                                // nb ring: rows
constexpr int UNB_SLOT = 256;                         // UW * 16 bf16, padded
constexpr int U_THREADS = 256;     // consumer and producer warpgroups
static_assert(U_STAGE_BYTES % 1024 == 0, "stages stay 1024-byte aligned");

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(unsigned bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(unsigned bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

// Wait for the phase of parity `parity` to complete. A wait of more than
// ~2^35 cycles (about 20 s) traps, so that a fault in the pipeline ends the
// launch with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done = 0;
  long long t0 = 0;
  for (int polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == 0) t0 = clock64();
    else if (clock64() - t0 > (1ll << 35)) __trap();
  }
}

__device__ __forceinline__ void tma_load_3d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(unsigned dst,
                                            const CUtensorMap* map,
                                            unsigned bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<unsigned long long>(map)), "r"(bar), "r"(c0),
      "r"(c1), "r"(c2), "r"(c3)
      : "memory");
}

// The shared-memory box at src to the tensor map's box at (c0, .., c3);
// completion is tracked as a bulk group of the issuing thread.
__device__ __forceinline__ void tma_store_4d(const CUtensorMap* map,
                                             unsigned src, int c0, int c1,
                                             int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4, %5}], [%1];" ::"l"(
          reinterpret_cast<unsigned long long>(map)),
      "r"(src), "r"(c0), "r"(c1), "r"(c2), "r"(c3)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
}

// lrelu as max(t, 0.2 t): the same bits as lrelu() in two instructions.
__device__ __forceinline__ float lrelu_max(float t) {
  return fmaxf(t, 0.2f * t);
}

__device__ __forceinline__ void bulk_load(unsigned dst, const void* src,
                                          unsigned bytes, unsigned bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// cp.async of BYTES bytes, zero fill when !valid.
template <int BYTES>
__device__ __forceinline__ void cp_async_zfill(unsigned dst, const void* src,
                                               bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(dst),
               "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// wgmma shared-memory matrix descriptor: address, leading and stride byte
// offsets (16-byte units), layout (0: no swizzle, 1: 128-byte swizzle).
__device__ __forceinline__ unsigned long long gmma_desc(unsigned addr,
                                                        unsigned lbo,
                                                        unsigned sbo,
                                                        unsigned layout) {
  return (unsigned long long)((addr >> 4) & 0x3fff) |
         (unsigned long long)((lbo >> 4) & 0x3fff) << 16 |
         (unsigned long long)((sbo >> 4) & 0x3fff) << 32 |
         (unsigned long long)layout << 62;
}

// d += A * B (scale_d = 0: d = A * B), m64n16k16, A MN-major (transposed)
// and B K-major, both in shared memory.
__device__ __forceinline__ void wgmma_m64n16(float (&d)[8],
                                             unsigned long long da,
                                             unsigned long long db,
                                             int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d));
}

// Keep the compiler from moving accesses of d across a wgmma wait.
__device__ __forceinline__ void reg_fence(float (&d)[8]) {
#pragma unroll
  for (int k = 0; k < 8; ++k) asm volatile("" : "+f"(d[k])::"memory");
}

// bf16x2 arithmetic with every result rounded (.rn: ptxas may contract a
// mul and an add without it into one fma, which rounds once).
__device__ __forceinline__ unsigned add2_rn(unsigned a, unsigned b) {
  unsigned d;
  asm("add.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned mul2_rn(unsigned a, unsigned b) {
  unsigned d;
  asm("mul.rn.bf16x2 %0, %1, %2;" : "=r"(d) : "r"(a), "r"(b));
  return d;
}
__device__ __forceinline__ unsigned fma2_rn(unsigned a, unsigned b,
                                            unsigned c) {
  unsigned d;
  asm("fma.rn.bf16x2 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// blur3<bf16> of two packed pairs: (p + q) * 1/4 + m * 1/2 with every step
// rounded to bf16. The products by 1/4 and 1/2 are exact, so one fma of the
// rounded p + q gives the same bits as rounding the product and the sum.
__device__ __forceinline__ unsigned blur3x2(unsigned p, unsigned m,
                                            unsigned q) {
  constexpr unsigned QUARTER = 0x3e803e80u, HALF = 0x3f003f00u;
  return fma2_rn(add2_rn(p, q), QUARTER, mul2_rn(m, HALF));
}

// affine<bf16> of two packed pairs: rnd(rnd(v * a) + off).
__device__ __forceinline__ unsigned affine2x(unsigned v, unsigned a,
                                             unsigned o) {
  return add2_rn(mul2_rn(v, a), o);
}

// The producer's staging when TMA cannot describe x: input rows ma, ma + 1,
// columns n0 .. n0 + UIC - 1, channels ci0 .. ci0 + 15 and this block's
// samples below B into the layout TMA writes (16-byte chunk c of 128-byte
// row R at c ^ (R & 7)), in granules of `gran` samples (4: cp.async 8 B,
// 2: cp.async 4 B, 1: through registers); zero outside the image. Then each
// of the warpgroup's threads (ptid) arrives on `bar` once its copies have
// landed.
__device__ void stage_ragged(const bf16* __restrict__ x, unsigned dst,
                             unsigned bar, int ma, int n0, int ci0, int b0,
                             int H, int W, int Ci, int B, int gran,
                             int ptid) {
  const int per_row = (min(UM, B - b0) + gran - 1) / gran;
  const int n = 2 * UIC * 16 * per_row;
  for (int i = ptid; i < n; i += 128) {
    const int R = i / per_row, k = (i % per_row) * gran;
    const int m = ma + R / (UIC * 16), nn = n0 + (R >> 4) % UIC;
    const bool in = m >= 0 && m < H && nn >= 0 && nn < W;
    const bf16* src =
        x + ((size_t)((in ? m : 0) * W + (in ? nn : 0)) * Ci + ci0 +
             (R & 15)) * B + b0 + k;
    const unsigned d =
        dst + R * 128 + ((((k >> 3) ^ (R & 7)) << 4) | ((k & 7) * 2));
    if (gran == 4) {
      cp_async_zfill<8>(d, src, in);
    } else if (gran == 2) {
      cp_async_zfill<4>(d, src, in);
    } else {
      const unsigned short v = in ? __bfloat16_as_ushort(src[0]) : 0;
      asm volatile("st.shared.u16 [%0], %1;" ::"r"(d), "h"(v) : "memory");
    }
  }
  if (gran == 1)
    mbar_arrive(bar);
  else
    asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(
                     bar)
                 : "memory");
}

// The consumers' input affine on one stage, in place: thread ptid (0..127)
// takes the 16-byte chunk ptid % 8 of row ptid / 8 of every staged pixel
// (the rows of a pixel are its 16 channels), so its channel ci0 + ptid / 8
// and its samples 8 lc .. 8 lc + 7 (lc = (ptid % 8) ^ (ptid / 8 % 8), the
// swizzle) are the same in every pixel. Pixels outside the image keep
// their 0.
__device__ __forceinline__ void affine_stage(unsigned char* st,
                                             const bf16* aff_s, int ma,
                                             int n0, int ci0, int H, int W,
                                             int Ci, int ptid) {
  const int row = ptid >> 3, ci = ci0 + row, lc = (ptid & 7) ^ (row & 7);
  const uint4 a = *reinterpret_cast<const uint4*>(aff_s + ci * UM + lc * 8);
  const uint4 o =
      *reinterpret_cast<const uint4*>(aff_s + (Ci + ci) * UM + lc * 8);
  // unrolled by 5: fully unrolled, ptxas loads all ten chunks at once and
  // the consumer, which holds its accumulators here, spilled (by 2 it did
  // not, but ran the chain's up1024 layer 1.06x slower on an H100)
#pragma unroll 5
  for (int k = 0; k < 2 * UIC; ++k) {   // staged pixel (input row, column)
    const int m = ma + k / UIC, nn = n0 + k % UIC;
    if (m < 0 || m >= H || nn < 0 || nn >= W) continue;
    uint4* p = reinterpret_cast<uint4*>(st + k * U_PIX_BYTES + ptid * 16);
    const uint4 v = *p;
    *p = make_uint4(affine2x(v.x, a.x, o.x), affine2x(v.y, a.y, o.y),
                    affine2x(v.z, a.z, o.z), affine2x(v.w, a.w, o.w));
  }
}

// The blur and epilogue of output row o of the strip from the deconvolved
// rows o - 1, o, o + 1 (D0, D1, D2: per column i, the packed pairs k of the
// accumulator layout: k = 0, 1 channels c0 + 2tq (+1) at samples bl,
// bl + 8, k = 2, 3 channels c0 + 8 + 2tq (+1)). priv: this thread's 16
// floats in shared memory (stride 128), its sums of t and t^2 (MODE_T,
// MODE_STATS), to which the row's sums are added in order, or its own
// affine coefficients (MODE_APPLY); pair idx = 4 hc + 2 hr + e. With a
// tile (TMA stores, B % 8 == 0) the row's outputs go to the tile, the box
// [UW columns][16 channels][64 samples] with the 128-byte swizzle, and one
// thread stores it with TMA; else each thread stores its own.
// nbs: the row's nb as the producer's TMA wrote it, [UW columns][16
// channels] (0 outside).
template <int MODE>
__device__ __forceinline__ void up_epilogue(
    const unsigned (&D0)[UDC][4], const unsigned (&D1)[UDC][4],
    const unsigned (&D2)[UDC][4], const unsigned char* nbs, int o, int q0,
    int OW, int Co, int B, int c0, int bl, int tq, bf16* __restrict__ out,
    float* priv, unsigned char* tile, const CUtensorMap* omap, int b0) {
  constexpr bool STORE = MODE != MODE_STATS;
  const int ltid = threadIdx.x;   // 0..127: the consumer warpgroup
  if (STORE && tile != nullptr) {
    // the previous row's store has read the tile
    if (ltid == 0)
      asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
    asm volatile("bar.sync 1, 128;" ::: "memory");
  }
  float s1[8], s2[8];
#pragma unroll
  for (int idx = 0; idx < 8; ++idx) s1[idx] = s2[idx] = 0.f;
  unsigned v0[4], v1[4], v2[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    v0[k] = blur3x2(D0[0][k], D1[0][k], D2[0][k]);
    v1[k] = blur3x2(D0[1][k], D1[1][k], D2[1][k]);
  }
#pragma unroll
  for (int j = 0; j < UW; ++j) {
#pragma unroll
    for (int k = 0; k < 4; ++k) v2[k] = blur3x2(D0[j + 2][k], D1[j + 2][k],
                                                D2[j + 2][k]);
    const int oc = q0 + j;
    if (oc < OW) {
      const size_t p = (size_t)o * OW + oc;
#pragma unroll
      for (int hc = 0; hc < 2; ++hc) {   // channel pair c0 + 8 hc + 2tq
        const int co = c0 + 8 * hc + 2 * tq;
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {   // sample bl + 8 hr
          const int k = 2 * hc + hr;
          const unsigned hb = blur3x2(v0[k], v1[k], v2[k]);
          const int b = bl + 8 * hr;
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int idx = 4 * hc + 2 * hr + e;
            const unsigned n = *reinterpret_cast<const unsigned*>(
                nbs + (j * 16 + 8 * hc + 2 * tq) * 2);
            const float t = lrelu_max(__fadd_rn(e ? bf_hi(hb) : bf_lo(hb),
                                                e ? bf_hi(n) : bf_lo(n)));
            if (STORE) {
              const bf16 v = __float2bfloat16_rn(
                  MODE == MODE_APPLY
                      ? __fadd_rn(__fmul_rn(t, priv[idx * 128]),
                                  priv[(8 + idx) * 128])
                      : t);
              if (tile != nullptr) {
                // (column j, channel 8 hc + 2tq + e, sample b - b0): row
                // 16 j + 8 hc + 2tq + e of 128 bytes, its 16-byte chunk
                // (b - b0) / 8 = 2w + hr swizzled with the row's low bits
                // 2tq + e, a per-thread offset for each (hr, e)
                const int w = (bl - b0) >> 4, g = (bl - b0) & 7;
                const int r7 = 2 * tq + e;
                *reinterpret_cast<bf16*>(
                    tile + j * 2048 + hc * 1024 + r7 * 128 +
                    (((2 * w + hr) ^ r7) << 4) + 2 * g) = v;
              } else if (b < B && co + e < Co) {
                out[(p * Co + co + e) * B + b] = v;
              }
            }
            if (MODE != MODE_APPLY) {
              s1[idx] = __fadd_rn(s1[idx], t);
              s2[idx] = fmaf(t, t, s2[idx]);
            }
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      v0[k] = v1[k];
      v1[k] = v2[k];
    }
  }
  if (MODE != MODE_APPLY)
#pragma unroll
    for (int idx = 0; idx < 8; ++idx) {
      priv[idx * 128] = __fadd_rn(priv[idx * 128], s1[idx]);
      priv[(8 + idx) * 128] = __fadd_rn(priv[(8 + idx) * 128], s2[idx]);
    }
  if (STORE && tile != nullptr) {
    // the tile's writes (generic proxy) before the TMA store reads it
    asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
    asm volatile("bar.sync 1, 128;" ::: "memory");
    if (ltid == 0) tma_store_4d(omap, smem_u32(tile), b0, c0, q0, o);
  }
}

// A block's unit: sample group b0, channel slice cs (c0 = 16 cs), strip q0
// (input columns from n0), output rows r0 .. r1 - 1 (deconvolved rows
// r0 - 1 .. r1, nrows of them). Each role decodes it for itself from a
// volatile read of the block index, so that ptxas does not carry the
// values across the setmaxnreg of the producer (where they spilled).
struct UpUnit {
  int cs, b0, c0, q0, n0, r0, r1, nrows;
};

__device__ __forceinline__ UpUnit up_unit(int H, int W, int Co) {
  unsigned bx, by;
  asm volatile("mov.u32 %0, %%ctaid.x;" : "=r"(bx));
  asm volatile("mov.u32 %0, %%ctaid.y;" : "=r"(by));
  const int nslices = (Co + UN - 1) / UN, nstrips = (2 * W + UW - 1) / UW;
  UpUnit u;
  u.cs = bx % nslices;
  u.c0 = u.cs * UN;
  u.q0 = bx / nslices % nstrips * UW;
  u.n0 = u.q0 / 2 - 1;
  u.b0 = bx / nslices / nstrips * UM;
  u.r0 = by * UROWS;
  u.r1 = min(2 * H, u.r0 + UROWS);
  u.nrows = u.r1 - u.r0 + 2;
  return u;
}

// A consumer thread's sums into the output: one fixed-point atomicAdd per
// (sample, channel) pair and sum. Its pairs are decoded here again (from
// volatile reads of the thread and block index, of W and Co and of the
// ring's offset), not kept from the start of the kernel, where they
// spilled.
__device__ __forceinline__ void flush_up_sums(acc_t* __restrict__ sums, int H,
                                              int W, int Co, int B) {
  extern __shared__ unsigned char smem_raw[];
  unsigned tid, off;
  int w, co_n;   // W, Co and the ring's offset through volatile moves
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(tid));
  asm volatile("mov.b32 %0, %1;" : "=r"(w) : "r"(W));
  asm volatile("mov.b32 %0, %1;" : "=r"(co_n) : "r"(Co));
  asm volatile("mov.b32 %0, %1;"
               : "=r"(off)
               : "r"((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u));
  const UpUnit u = up_unit(H, w, co_n);
  const int tq = tid & 3, bl = u.b0 + 16 * (tid >> 5) + ((tid & 31) >> 2);
  const float* priv =
      reinterpret_cast<const float*>(smem_raw + off + USTAGES * U_STAGE_BYTES +
                                     U_TILE_BYTES) + tid;
#pragma unroll
  for (int idx = 0; idx < 8; ++idx) {
    const int b = bl + 8 * ((idx >> 1) & 1);
    const int co = u.c0 + 8 * (idx >> 2) + 2 * tq + (idx & 1);
    if (b < B && co < Co) {
      atomicAdd(&sums[co * B + b], to_fixed(priv[idx * 128]));
      atomicAdd(&sums[(Co + co) * B + b], to_fixed(priv[(8 + idx) * 128]));
    }
  }
}

// Grid: blockIdx.x = (sample group, strip, channel slice), the slice
// fastest; blockIdx.y = the block's UROWS output rows. wp: pack_up_weights.
// stage: 0 = TMA (xmap), else the ragged staging granule in samples;
// tma_out: the outputs go out by TMA (omap) from a tile.
template <int MODE, bool AFF>
__global__ void __launch_bounds__(U_THREADS, 2)
    up_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap omap,
                    const __grid_constant__ CUtensorMap nbmap,
                    const bf16* __restrict__ x, const bf16* __restrict__ wp,
                    const float* __restrict__ aff,
                    const float* __restrict__ coefs, bf16* __restrict__ out,
                    acc_t* __restrict__ sums, int H, int W, int Ci, int Co,
                    int B, int stage, int tma_out) {
  extern __shared__ unsigned char smem_raw[];
  // the stage ring and the output tile (1024-byte aligned, for the 128-byte
  // swizzle; aligned by an offset from smem_raw, not an integer round trip,
  // so that the compiler keeps the accesses in the shared space), the
  // consumers' private floats [16][128], the nb ring [UNB][UW][16] bf16,
  // the staged input affine [2][Ci][UM] bf16, the full and empty barriers
  // of each stage
  unsigned char* ring =
      smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  unsigned char* tile = ring + USTAGES * U_STAGE_BYTES;
  float* priv_s = reinterpret_cast<float*>(tile + U_TILE_BYTES);
  unsigned char* nb_s = reinterpret_cast<unsigned char*>(priv_s + 16 * 128);
  bf16* aff_s = reinterpret_cast<bf16*>(nb_s + UNB * UNB_SLOT);
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(
      aff_s + (AFF ? 2 * Ci * UM : 0));
  const unsigned full0 = smem_u32(bars), empty0 = full0 + 8 * USTAGES;

  const int S = Ci / 16;
  const int tid = threadIdx.x, warp = tid / LANES, lane = tid % LANES;

  if (AFF) {
    const int b0 = up_unit(H, W, Co).b0;
    for (int i = tid; i < 2 * Ci * UM; i += U_THREADS) {
      const int which = i / (Ci * UM), c = i / UM % Ci, b = b0 + i % UM;
      float v = which == 0 ? 1.f : 0.f;
      if (b < B) v = aff[(which * Ci + c) * B + b];
      aff_s[i] = __float2bfloat16_rn(v);
    }
  }
  if (stage != 0)   // the ragged staging writes only samples < B
    for (int i = tid; i < USTAGES * U_STAGE_BYTES / 16; i += U_THREADS)
      reinterpret_cast<uint4*>(ring)[i] = make_uint4(0, 0, 0, 0);
  // the zeros (generic proxy) before any TMA or bulk copy (async proxy)
  if (stage != 0) asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  if (tid == 0) {
    for (int i = 0; i < USTAGES; ++i) {
      mbar_init(full0 + 8 * i, stage == 0 ? 1 : 1 + 128);
      mbar_init(empty0 + 8 * i, 4);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4) {
    // ---- producer warpgroup ----
    // Stage j: thread 128 issues its copies into slot j % USTAGES once the
    // consumers have released it (the whole warpgroup copies on the ragged
    // path); they complete on the stage's full barrier.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 32;" ::: "memory");
    const UpUnit u = up_unit(H, W, Co);
    const int cs = u.cs, b0 = u.b0, c0 = u.c0, q0 = u.q0, n0 = u.n0;
    const int r0 = u.r0, nrows = u.nrows;
    const int ptid = tid - 128;
    if (ptid == 0 || stage != 0)
      for (int j = 0, J = nrows * S; j < J; ++j) {
        const int slot = j % USTAGES, rr = j / S, s = j % S;
        const int d = r0 - 1 + rr, pr = d & 1, ma = (d + pr - 2) / 2;
        const unsigned full = full0 + 8 * slot;
        const unsigned dst = smem_u32(ring + slot * U_STAGE_BYTES);
        mbar_wait(empty0 + 8 * slot, ((j / USTAGES) & 1) ^ 1);
        // with a row's first stage, the nb of the row its epilogue writes
        const bool nbrow = s == 0 && rr >= 2;
        if (ptid == 0) {
          mbar_expect_tx(full, (stage == 0 ? U_STAGE_BYTES : U_W_BYTES) +
                                   (nbrow ? UW * 16 * 2 : 0));
          if (stage == 0) tma_load_4d(dst, &xmap, full, b0, 16 * s, n0, ma);
          bulk_load(dst + U_IN_BYTES,
                    wp + ((size_t)(cs * 2 + pr) * S + s) * (U_W_BYTES / 2),
                    U_W_BYTES, full);
          if (nbrow)
            tma_load_3d(smem_u32(nb_s + (rr % UNB) * UNB_SLOT), &nbmap, full,
                        c0, q0, d - 1);
        }
        if (stage != 0)
          stage_ragged(x, dst, full, ma, n0, 16 * s, b0, H, W, Ci, B, stage,
                       ptid);
      }
  } else {
    // ---- consumer warpgroup ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 224;" ::: "memory");
    const UpUnit u = up_unit(H, W, Co);
    const int b0 = u.b0, c0 = u.c0, q0 = u.q0, n0 = u.n0, r0 = u.r0;
    const int nrows = u.nrows, OH = 2 * H, OW = 2 * W;
    const int tq = lane & 3;
    const int bl = b0 + 16 * warp + (lane >> 2);   // + 8: the other half
    float* priv = priv_s + tid;
#pragma unroll
    for (int idx = 0; idx < 8; ++idx) {
      const int b = bl + 8 * ((idx >> 1) & 1);
      const int co = c0 + 8 * (idx >> 2) + 2 * tq + (idx & 1);
      const bool live = b < B && co < Co;
      priv[idx * 128] = MODE == MODE_APPLY && live ? coefs[co * B + b] : 0.f;
      priv[(8 + idx) * 128] =
          MODE == MODE_APPLY && live ? coefs[(Co + co) * B + b] : 0.f;
    }
    unsigned D0[UDC][4], D1[UDC][4], D2[UDC][4];
    float acc[UDC][8];
    int slot = 0, prev = 0;
    unsigned phase = 0;
    // Deconvolved row d = r0 - 1 + rr into Dc, then the epilogue of row
    // d - 1 from Da (row d - 2), Db, Dc. The loop below rotates the three
    // buffers by name, so no row is copied.
    auto row = [&](int rr, const unsigned (&Da)[UDC][4],
                   const unsigned (&Db)[UDC][4], unsigned (&Dc)[UDC][4]) {
      const int d = r0 - 1 + rr;
      for (int s = 0; s < S; ++s) {
        mbar_wait(full0 + 8 * slot, phase);
        unsigned char* stp = ring + slot * U_STAGE_BYTES;
        if (AFF || stage != 0) {
          // the affine runs while the previous stage's wgmma group does;
          // then the generic proxy's writes (and the ragged path's copies)
          // are made visible to wgmma
          if (AFF)
            affine_stage(stp, aff_s, (d + (d & 1) - 2) / 2, n0, 16 * s, H, W,
                         Ci, tid);
          asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
          asm volatile("bar.sync 1, 128;" ::: "memory");
        }
        const unsigned sa = smem_u32(stp);
        // A: one staged pixel, 128-byte swizzle, k8 groups 1024 B apart;
        // B: one tap, k8 chunks 128 B apart, n8 groups 256 B apart
        const unsigned long long da = gmma_desc(sa, 16, 1024, 1);
        const unsigned long long db = gmma_desc(sa + U_IN_BYTES, 128, 256, 0);
        wgmma_fence();
#pragma unroll
        for (int i = 0; i < UDC; ++i)
#pragma unroll
          for (int a = 0; a < 2; ++a)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int kw = ((i + 1) & 1) + 2 * e;
              wgmma_m64n16(
                  acc[i], da + ((a * UIC + (i >> 1) + e) * U_PIX_BYTES >> 4),
                  db + ((a * 4 + kw) * U_TAP_BYTES >> 4),
                  s > 0 || a > 0 || e > 0);
            }
        wgmma_commit();
        if (s > 0) {
          wgmma_wait<1>();
          if (lane == 0) mbar_arrive(empty0 + 8 * prev);
        }
        prev = slot;
        if (++slot == USTAGES) {
          slot = 0;
          phase ^= 1;
        }
      }
      wgmma_wait<0>();
      if (lane == 0) mbar_arrive(empty0 + 8 * prev);
      const bool row_in = d >= 0 && d < OH;
#pragma unroll
      for (int i = 0; i < UDC; ++i) {
        reg_fence(acc[i]);
        const int c = q0 - 1 + i;
        const bool in = row_in && c >= 0 && c < OW;
#pragma unroll
        for (int k = 0; k < 4; ++k)
          Dc[i][k] = in ? bf_pack(acc[i][2 * k], acc[i][2 * k + 1]) : 0u;
      }
      if (rr >= 2)
        up_epilogue<MODE>(Da, Db, Dc, nb_s + (rr % UNB) * UNB_SLOT, d - 1, q0,
                          OW, Co, B, c0, bl, tq, out, priv,
                          tma_out ? tile : nullptr, &omap, b0);
    };
    for (int rr = 0; rr < nrows; rr += 3) {
      row(rr, D0, D1, D2);
      if (rr + 1 < nrows) row(rr + 1, D1, D2, D0);
      if (rr + 2 < nrows) row(rr + 2, D2, D0, D1);
    }
    // the last row's store has read the tile before the block exits
    if (MODE != MODE_STATS && tma_out && tid == 0)
      asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
    if (MODE != MODE_APPLY) flush_up_sums(sums, H, W, Co, B);
  }
}

int grid_y(int ntiles, int groups) {
  return std::max(1, std::min(ntiles, std::max(1, MAX_BLOCKS / groups)));
}

// The staging chunk of a bf16 kernel whose other shared memory takes
// `smem` bytes and whose input region has `npix` pixels: all of Ci if the
// region fits the block's shared memory, else 32 or 16 channels; 0 if
// none fits.
int staging_chunk(int smem, int npix, int Ci) {
  int dev = 0, max_smem = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin,
                         dev);
  const int chunks[3] = {Ci, 32, 16};
  for (int c : chunks)
    if (Ci % c == 0 && smem + npix * c * LANES * 2 <= max_smem) return c;
  return 0;
}

template <typename T, int MODE>
int launch_conv(const void* x, const void* k, const void* nb,
                const float* aff, const float* coefs, const float* wrgb,
                const float* brgb, void* out, acc_t* sums, int H, int W,
                int Ci, int Co, int B, int apply_aff, cudaStream_t stream) {
  // the standalone apply pass never takes an input affine
  auto kern = apply_aff ? conv3x3_kernel<T, MODE, MODE != MODE_APPLY>
                        : conv3x3_kernel<T, MODE, false>;
  constexpr bool SUMS = MODE == MODE_T || MODE == MODE_STATS;
  const int groups = (B + LANES - 1) / LANES;
  int smem = 2 * Ci * LANES * (int)sizeof(T);
  int ntw = 0, ntiles = 0, ck = 0, blocks_y = 0;
  if (std::is_same<T, bf16>::value) {
    if (SUMS) smem += 2 * Co * LANES * (int)sizeof(acc_t);
    if (MODE == MODE_RGB) smem += 3 * CT * CT * LANES * 4;
    ck = staging_chunk(smem, CR * CR, Ci);
    if (ck == 0) return -3;
    smem += CR * CR * ck * LANES * 2;
  } else {
    smem += 2 * Co * LANES * (int)sizeof(acc_t);
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  if (std::is_same<T, bf16>::value) {
    // one wave of resident blocks, each striding over the tiles
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern,
                                                      LANES * NY, smem);
    if (e != cudaSuccess) return (int)e;
    ntw = (W + CT - 1) / CT;
    ntiles = ((H + CT - 1) / CT) * ntw;
    blocks_y = std::max(1, std::min(ntiles, per_sm * sms / groups));
  } else {
    ntiles = (H * W + TILE_PX - 1) / TILE_PX;
    blocks_y = grid_y(ntiles, groups);
  }
  dim3 grid(groups, blocks_y);
  dim3 block(LANES, NY);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), k, static_cast<const T*>(nb), aff, coefs,
      wrgb, brgb, static_cast<T*>(out), sums, H, W, Ci, Co, B, ntw, ntiles,
      ck);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_conv(int dtype, const void* x, const void* k, const void* nb,
                  const float* aff, const float* coefs, const float* wrgb,
                  const float* brgb, void* out, acc_t* sums, int H, int W,
                  int Ci, int Co, int B, int apply_aff, void* stream) {
  if (Co % CC != 0 || (dtype == 1 && Ci % 16 != 0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_conv<bf16, MODE>(x, k, nb, aff, coefs, wrgb, brgb, out,
                                   sums, H, W, Ci, Co, B, apply_aff, s);
  if (dtype == 0)
    return launch_conv<float, MODE>(x, k, nb, aff, coefs, wrgb, brgb, out,
                                    sums, H, W, Ci, Co, B, apply_aff, s);
  return -2;
}

// cuTensorMapEncodeTiled (CUDA driver API), looked up at run time: the
// library links no libcuda.
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p,
                                cudaEnableDefault, &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// The f32 up kernel (k4 f32 [4, 4, Ci, Co]).
template <int MODE>
int launch_up_f32(const void* x, const void* k4, const void* nb,
                  const float* aff, const float* coefs, void* out,
                  acc_t* sums, int H, int W, int Ci, int Co, int B,
                  int apply_aff, cudaStream_t stream) {
  // only the chain's up layer (MODE_T) takes an input affine
  auto kern = apply_aff ? up_kernel<float, MODE, MODE == MODE_T>
                        : up_kernel<float, MODE, false>;
  const int smem = 2 * Co * LANES * (int)sizeof(acc_t) +
                   (2 * Ci + (UT + 2) * (UT + 2) * UP) * LANES * 4;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (B + LANES - 1) / LANES;
  const int ntiles = ((2 * H + UT - 1) / UT) * ((2 * W + UT - 1) / UT);
  dim3 grid(groups, grid_y(ntiles, groups));
  dim3 block(LANES, NY);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(k4),
      static_cast<const float*>(nb), aff, coefs, static_cast<float*>(out),
      sums, H, W, Ci, Co, B);
  return (int)cudaGetLastError();
}

// Dynamic shared memory of the bf16 up kernel: 1024-byte alignment slack,
// the stage ring, the output tile, the consumers' private floats, the
// staged affine, the barriers.
int up_smem(int Ci, bool aff_on) {
  return 1024 + USTAGES * U_STAGE_BYTES + U_TILE_BYTES + 16 * 128 * 4 +
         UNB * UNB_SLOT + (aff_on ? 2 * Ci * UM * 2 : 0) + 2 * USTAGES * 8;
}

// The tensor map of a bf16 tensor of `rank` dimensions dims (innermost
// first, densely packed) with boxes of `box` elements, the 128-byte swizzle
// or none; false when cuTensorMapEncodeTiled is missing or refuses it.
bool tensor_map(CUtensorMap* map, const void* p, int rank, const int* dims,
                const int* box, bool swizzle) {
  EncodeTiledFn enc = encode_tiled();
  if (enc == nullptr) return false;
  cuuint64_t gdim[4], stride[3];
  cuuint32_t bdim[4], estr[4];
  cuuint64_t s = 2;
  for (int i = 0; i < rank; ++i) {
    gdim[i] = (cuuint64_t)dims[i];
    bdim[i] = (cuuint32_t)box[i];
    estr[i] = 1;
    if (i > 0) stride[i - 1] = s;
    s *= (cuuint64_t)dims[i];
  }
  return enc(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(p),
             gdim, stride, bdim, estr, CU_TENSOR_MAP_INTERLEAVE_NONE,
             swizzle ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_NONE,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The bf16 up kernel (wp: pack_up_weights). TMA stages x when its strides
// allow (B % 8 == 0, a 16-byte aligned base), else the producer warp copies
// granules of 4, 2 or 1 samples.
template <int MODE>
int launch_up_tc(const void* x, const void* wp, const void* nb,
                 const float* aff, const float* coefs, void* out,
                 acc_t* sums, int H, int W, int Ci, int Co, int B,
                 int apply_aff, cudaStream_t stream) {
  const bool aff_on = apply_aff && MODE == MODE_T;
  auto kern = aff_on ? up_wgmma_kernel<MODE, MODE == MODE_T>
                     : up_wgmma_kernel<MODE, false>;
  const uintptr_t xa = reinterpret_cast<uintptr_t>(x);
  int stage = 1;
  if (B % 8 == 0 && xa % 16 == 0)
    stage = 0;
  else if (B % 4 == 0 && xa % 8 == 0)
    stage = 4;
  else if (B % 2 == 0 && xa % 4 == 0)
    stage = 2;
  // TMA stores of the output when its strides allow (B % 8 == 0)
  const int tma_out = MODE != MODE_STATS && B % 8 == 0 &&
                      reinterpret_cast<uintptr_t>(out) % 16 == 0;
  CUtensorMap xmap, omap, nbmap;
  memset(&xmap, 0, sizeof xmap);
  memset(&omap, 0, sizeof omap);
  const int xdims[4] = {B, Ci, W, H}, xbox[4] = {UM, 16, UIC, 2};
  const int odims[4] = {B, Co, 2 * W, 2 * H}, obox[4] = {UM, 16, UW, 1};
  const int ndims[3] = {Co, 2 * W, 2 * H}, nbox[3] = {16, UW, 1};
  if (stage == 0 && !tensor_map(&xmap, x, 4, xdims, xbox, true)) return -5;
  if (tma_out && !tensor_map(&omap, out, 4, odims, obox, true)) return -5;
  if (!tensor_map(&nbmap, nb, 3, ndims, nbox, false)) return -5;
  const int smem = up_smem(Ci, aff_on);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int units = (B + UM - 1) / UM * ((Co + UN - 1) / UN) *
                    ((2 * W + UW - 1) / UW);
  dim3 grid(units, (2 * H + UROWS - 1) / UROWS);
  kern<<<grid, U_THREADS, smem, stream>>>(
      xmap, omap, nbmap, static_cast<const bf16*>(x),
      static_cast<const bf16*>(wp), aff, coefs, static_cast<bf16*>(out), sums,
      H, W, Ci, Co, B, stage, tma_out);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_up(int dtype, const void* x, const void* k4, const void* nb,
                const float* aff, const float* coefs, void* out, acc_t* sums,
                int H, int W, int Ci, int Co, int B, int apply_aff,
                void* stream) {
  if (Co % UCC != 0 || (dtype == 1 && Ci % 16 != 0)) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_up_tc<MODE>(x, k4, nb, aff, coefs, out, sums, H, W, Ci, Co,
                              B, apply_aff, s);
  if (dtype == 0)
    return launch_up_f32<MODE>(x, k4, nb, aff, coefs, out, sums, H, W, Ci,
                               Co, B, apply_aff, s);
  return -2;
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Each function launches on `stream`, does not synchronise, and returns the
// cudaGetLastError() code of the launch (0 on success; -1 for Co not a
// multiple of 8 (up) or 16 (conv), or a bf16 layer's Ci not a multiple of
// 16; -2 for an unknown dtype; -3 for a bf16 layer whose shared memory
// does not fit a block; -5 when cuTensorMapEncodeTiled is missing or
// refuses a tensor map of x, of the output or of nb). `sums` is int64
// [2, Co, B] in units of 2^-20 (see the design note), zeroed by the
// caller. The weights
// (k4 [4, 4, Ci, Co] of an up layer, k [3, 3, Ci, Co] of a conv layer) are
// f32 for dtype 0 and packed bf16 for dtype 1 (ops/synthesis_tail_bc.py:
// pack_up_weights, pack_mma_weights). The bf16 kernels run their
// convolutions on the tensor cores (what bounds them: the design note);
// the f32 kernels are CUDA-core FMA loops, kept as checks.
extern "C" {

int cfr_up_fused(int dtype, const void* x, const void* k4, const void* nb,
                 const float* aff, void* out, acc_t* sums, int H, int W,
                 int Ci, int Co, int B, int apply_aff, void* stream) {
  return dispatch_up<MODE_T>(dtype, x, k4, nb, aff, nullptr, out, sums, H, W,
                             Ci, Co, B, apply_aff, stream);
}

int cfr_conv_fused(int dtype, const void* x, const void* k, const void* nb,
                   const float* aff, void* out, acc_t* sums, int H, int W,
                   int Ci, int Co, int B, int apply_aff, void* stream) {
  return dispatch_conv<MODE_T>(dtype, x, k, nb, aff, nullptr, nullptr,
                               nullptr, out, sums, H, W, Ci, Co, B,
                               apply_aff, stream);
}

int cfr_final_stats(int dtype, const void* x, const void* k, const void* nb,
                    const float* aff, acc_t* sums, int H, int W, int Ci,
                    int Co, int B, int apply_aff, void* stream) {
  return dispatch_conv<MODE_STATS>(dtype, x, k, nb, aff, nullptr, nullptr,
                                   nullptr, nullptr, sums, H, W, Ci, Co, B,
                                   apply_aff, stream);
}

int cfr_final_apply(int dtype, const void* x, const void* k, const void* nb,
                    const float* aff, const float* coefs, const float* wrgb,
                    const float* brgb, void* out, int H, int W, int Ci,
                    int Co, int B, int apply_aff, void* stream) {
  return dispatch_conv<MODE_RGB>(dtype, x, k, nb, aff, coefs, wrgb, brgb,
                                 out, nullptr, H, W, Ci, Co, B, apply_aff,
                                 stream);
}

// The standalone half-layers: no input affine (apply_aff = 0).

int cfr_conv_stats(int dtype, const void* x, const void* k, const void* nb,
                   acc_t* sums, int H, int W, int Ci, int Co, int B,
                   void* stream) {
  return dispatch_conv<MODE_STATS>(dtype, x, k, nb, nullptr, nullptr,
                                   nullptr, nullptr, nullptr, sums, H, W, Ci,
                                   Co, B, 0, stream);
}

int cfr_conv_apply(int dtype, const void* x, const void* k, const void* nb,
                   const float* coefs, void* out, int H, int W, int Ci,
                   int Co, int B, void* stream) {
  return dispatch_conv<MODE_APPLY>(dtype, x, k, nb, nullptr, coefs, nullptr,
                                   nullptr, out, nullptr, H, W, Ci, Co, B, 0,
                                   stream);
}

int cfr_conv_rgb_apply(int dtype, const void* x, const void* k,
                       const void* nb, const float* coefs, const float* wrgb,
                       const float* brgb, void* out, int H, int W, int Ci,
                       int Co, int B, void* stream) {
  return dispatch_conv<MODE_RGB>(dtype, x, k, nb, nullptr, coefs, wrgb, brgb,
                                 out, nullptr, H, W, Ci, Co, B, 0, stream);
}

int cfr_up_stats(int dtype, const void* x, const void* k4, const void* nb,
                 acc_t* sums, int H, int W, int Ci, int Co, int B,
                 void* stream) {
  return dispatch_up<MODE_STATS>(dtype, x, k4, nb, nullptr, nullptr, nullptr,
                                 sums, H, W, Ci, Co, B, 0, stream);
}

// The bf16 up kernel's instantiation up_wgmma_kernel<mode, apply_aff> at
// Ci input channels: its dynamic shared memory (bytes) and how many of its
// blocks an SM holds; returns the CUDA error code.
int cfr_up_occupancy(int mode, int apply_aff, int Ci, int* smem,
                     int* blocks) {
  const void* kern =
      mode == MODE_T
          ? (apply_aff ? (const void*)up_wgmma_kernel<MODE_T, true>
                       : (const void*)up_wgmma_kernel<MODE_T, false>)
      : mode == MODE_STATS ? (const void*)up_wgmma_kernel<MODE_STATS, false>
                           : (const void*)up_wgmma_kernel<MODE_APPLY, false>;
  *smem = up_smem(Ci, mode == MODE_T && apply_aff);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, *smem);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, kern,
                                                            U_THREADS, *smem);
}

int cfr_up_apply(int dtype, const void* x, const void* k4, const void* nb,
                 const float* coefs, void* out, int H, int W, int Ci, int Co,
                 int B, void* stream) {
  return dispatch_up<MODE_APPLY>(dtype, x, k4, nb, nullptr, coefs, out,
                                 nullptr, H, W, Ci, Co, B, 0, stream);
}

}  // extern "C"
