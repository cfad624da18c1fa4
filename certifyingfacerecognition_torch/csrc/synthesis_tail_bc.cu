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
// activation type, the bf16 kernels packed in mma fragment order),
// noise+bias nb [H, W, Co] in the activation type.
//
// Design. One block holds 32 consecutive samples on threadIdx.x (one warp
// spans the samples of one pixel, so activation loads and stores coalesce
// and every lane of a warp reads the same weight address) and NY workers on
// threadIdx.y that split the pixels of a tile. Blocks stride over tiles, so
// the per-block sums live in shared memory for the whole kernel and reach
// the [2, C, B] output with one atomicAdd per (channel, sample) per block.
// The sums are deterministic: every sum whose order depends on scheduling
// (the workers' adds into shared memory, the blocks' into the output) is
// fixed point (int64, units of 2^-20), where addition is associative; the
// up kernel and the bf16 conv kernel first add each thread's terms of a
// tile in f32, in order.
// Each fixed-point term rounds by at most 2^-21, and the range holds
// |sum t^2| < 2^43, i.e. an rms |t| below ~2900 over 1024^2 pixels. The
// staged input affine is held in T (its values are rounded to T), which
// keeps the up kernel's shared memory (bf16, Ci = 64) within three
// blocks per SM.
//
// What bounds these kernels on an H100: the bytes they must move are
// 3.2-6.4 GB per layer at B = 128 (~1-2 ms at 3.35 TB/s) and their MACs fit
// the bf16 tensor cores in well under that, so the roofline bound is bytes
// for every launch but one: the up layer's stats pass at 512^2 writes only
// its sums, so its 0.55 TFLOP of MACs (0.56 ms) outweigh its 1.07 GB read.
// The bf16 kernels run their convolutions on the tensor cores
// (mma.sync.m16n8k16, f32 accumulation; conv_mma and deconv_mma below),
// with one block of 8 warps per SM: the up kernel takes 223 KB of shared
// memory at Ci = 64 and at Ci = 256, the conv kernel 225 KB at 512^2
// (Ci = Co = 32) and 110-126 KB at 1024^2 (Ci = Co = 16), and they hold
// 100 and 64 f32 accumulators per thread. Both stage the input region of a
// tile once in shared memory with the bf16 input affine applied there, so
// each input element is read about 1.56x (the tile halo) and normalised
// once per tile, not once per tap and pass. The conv kernel's sums are
// per-thread f32 sums over the tile, one fixed-point add per (channel,
// sample) and tile, where the CUDA-core version made two shared-memory
// atomics per output element. What bounds them now is the phases that
// run between block barriers with nothing to overlap them at one block
// per SM: the staging loads (device memory latency with four 16-byte
// loads in flight per thread), the MMAs, and the CUDA-core epilogue (the
// up kernel's blur, +nb, lrelu, stores and sums). The f32 kernels still
// run their MACs as f32 FMAs on the CUDA cores (about 15x below the
// tensor-core rate), bound by instruction issue; the pipeline runs them
// only as checks. Every kernel keeps every intermediate (the un-blurred
// deconv, the 1024^2 16-channel activation of the last layer) out of
// device memory, which is what the chain design is for. Later work: a
// Hopper pipeline (wgmma, TMA loads of the input region, warp
// specialisation so that staging overlaps the MMAs and the epilogue) and,
// for the up kernel, a deconv computed once per output instead of once
// per tile halo (1.56x).
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int LANES = 32;   // samples per block (threadIdx.x)
constexpr int NY = 8;       // pixel workers per block (threadIdx.y)
constexpr int UT = 8;       // up kernel: output tile edge
constexpr int UCC = 8;      // up kernel: output channels per deconv pass
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
// Tensor-core building blocks of the bf16 kernels (mma.sync.m16n8k16, bf16
// in, f32 accumulation): M = the block's 32 samples (two m16 tiles), N =
// output channels (n8 tiles), K = input channels (k16 steps).
//
// Staging. A kernel stages the R x R input region of a tile in shared
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
// The bf16 up layer's deconvolution on the tensor cores (mma.sync).
//
// Per output position and live tap the deconv is a GEMM
// D[b, co] += X[b, ci] * W_tap[ci, co]: M = the block's 32 samples (two
// m16 tiles), N = the UCC = 8 output channels of one pass (one n8 tile),
// K = Ci in steps of 16, as mma.sync.m16n8k16 bf16 with f32 accumulation.
// (Samples as M and channels as N fit the pass of 8 channels exactly, and
// the accumulators land where the blur reads yb_s, [pos][channel][sample].)
//
// Index map. A tile's 10x10 halo of outputs (rows r0-1 .. r0+UT, r0 even)
// reads the XR x XR = 6x6 input pixels from (r0/2 - 1, q0/2 - 1). An
// output of row parity pr = orow & 1 takes the taps kh = pr + 2a (a = 0, 1)
// at input row m = (orow + kh - 2) / 2; the halo rows of parity pr are
// i = 2u + 1 - pr (u = 0..4), and with orow = r0 - 1 + i that input row is
// the staged row u + a. Columns alike. So each of the four parity classes
// (pr, pc) is a 5x5 grid of outputs whose tap (a, e) reads staged pixel
// (u + a, v + e): warp w takes class w >> 1 and m16 tile w & 1, holds its
// 25 outputs' accumulators (100 f32 registers), loads each staged pixel's
// A fragment once per k16 step (ldmatrix .trans from the [ci][sample]
// staging) and feeds it to the up to four outputs that read it.
//
// Staging (stage_x above). The input region goes to xs [ck/16][36][16][32]
// bf16 in chunks of ck input channels. ck = Ci when the whole region fits
// the block's shared memory (Ci <= 64 with Co <= 32), and the region is
// then staged once per tile for all Co/UCC passes; otherwise 32 or 16
// channels per chunk, restaged for every pass.
//
// Weights. pack_up_weights (ops/synthesis_tail_bc.py) lays them out as the
// B fragments [4][4][Co/8][Ci/16][32 lanes][4 bf16] (32 KB at Ci = 64,
// Co = 32, 16 KB of it per pass).
// ---------------------------------------------------------------------------

constexpr int XR = UT / 2 + 2;    // staged input region edge
constexpr int NPIX = XR * XR;
constexpr int NCLS = UT / 2 + 1;  // outputs per parity class and axis
// Output channels per pass of the up kernel (yb_s holds one pass).
template <typename T>
constexpr int up_pass = std::is_same<T, bf16>::value ? UCC : UCC / 2;
static_assert(NY == 8, "deconv_mma maps 4 parity classes x 2 m16 tiles "
                       "onto the 8 warps");

// One chunk of staged input channels (k16 steps s0 .. s0 + ck/16 of the
// packed weights) into this warp's accumulators, for output channels
// 8 * cc .. 8 * cc + 7.
__device__ __forceinline__ void mma_chunk(const bf16* xs,
                                          const uint2* __restrict__ wp,
                                          float (&acc)[NCLS][NCLS][4],
                                          int ck, int s0, int S, int cc,
                                          int CC) {
  const int lane = threadIdx.x, cls = threadIdx.y >> 1, mt = threadIdx.y & 1;
  const int pr = cls >> 1, pc = cls & 1;
  const unsigned base = a_frag_base(xs, mt);
  for (int ks = 0; ks < ck / 16; ++ks) {
    const unsigned kbase = base + ks * NPIX * 1024;
    uint2 bw[2][2];
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int e = 0; e < 2; ++e)
        bw[a][e] = wp[((((pr + 2 * a) * 4 + pc + 2 * e) * CC + cc) * S + s0 +
                       ks) * LANES + lane];
#pragma unroll
    for (int sy = 0; sy < XR; ++sy)
#pragma unroll
      for (int sx = 0; sx < XR; ++sx) {
        unsigned af[4];
        ldsm_x4_trans(kbase + (sy * XR + sx) * 1024, af);
#pragma unroll
        for (int a = 0; a < 2; ++a)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int u = sy - a, v = sx - e;
            if (u >= 0 && u < NCLS && v >= 0 && v < NCLS)
              mma_bf16(acc[u][v], af, bw[a][e]);
          }
      }
  }
}

// The deconv of one pass (output channels c0 .. c0 + 7) of the tile at
// (r0, q0) into yb_s, 0 outside the 2H x 2W grid. Stages the input region
// chunk by chunk unless it was staged for the whole tile (ck == Ci).
template <bool AFF>
__device__ void deconv_mma(const bf16* __restrict__ x,
                           const uint2* __restrict__ wp, const bf16* aff_s,
                           bf16* xs, bf16* yb_s, int r0, int q0, int c0,
                           int ck, int H, int W, int Ci, int Co, int B) {
  constexpr int YR = UT + 2;
  float acc[NCLS][NCLS][4];
#pragma unroll
  for (int u = 0; u < NCLS; ++u)
#pragma unroll
    for (int v = 0; v < NCLS; ++v)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[u][v][r] = 0.f;
  for (int ci0 = 0; ci0 < Ci; ci0 += ck) {
    if (ck != Ci) {
      stage_x<XR, AFF>(x, aff_s, xs, r0 / 2 - 1, q0 / 2 - 1, ci0, ck, H, W,
                       Ci, B);
      __syncthreads();
    }
    mma_chunk(xs, wp, acc, ck, ci0 / 16, Ci / 16, c0 / UCC, Co / UCC);
    if (ck != Ci) __syncthreads();
  }
  const int lane = threadIdx.x, cls = threadIdx.y >> 1, mt = threadIdx.y & 1;
  const int pr = cls >> 1, pc = cls & 1, g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int u = 0; u < NCLS; ++u)
#pragma unroll
    for (int v = 0; v < NCLS; ++v) {
      const int i = 2 * u + 1 - pr, j = 2 * v + 1 - pc;
      const int orow = r0 - 1 + i, ocol = q0 - 1 + j;
      const bool in = orow >= 0 && orow < 2 * H && ocol >= 0 && ocol < 2 * W;
      // D rows are samples 16 mt + g (+ 8), columns channels 2t (+ 1)
      bf16* yp = yb_s + ((i * YR + j) * UCC + 2 * t) * LANES + 16 * mt + g;
      yp[0] = __float2bfloat16_rn(in ? acc[u][v][0] : 0.f);
      yp[LANES] = __float2bfloat16_rn(in ? acc[u][v][1] : 0.f);
      yp[8] = __float2bfloat16_rn(in ? acc[u][v][2] : 0.f);
      yp[LANES + 8] = __float2bfloat16_rn(in ? acc[u][v][3] : 0.f);
    }
}

// The f32 up layer's deconv of one pass into yb_s on the CUDA cores: one
// halo position per thread at a time, f32 FMAs (k4 f32 [4, 4, Ci, Co]).
template <typename T, bool AFF>
__device__ void deconv_fma(const T* __restrict__ x,
                           const float* __restrict__ k4, const T* aff_s,
                           T* yb_s, int r0, int q0, int c0, int H, int W,
                           int Ci, int Co, int B) {
  constexpr int YR = UT + 2;
  constexpr int NPOS = YR * YR;
  constexpr int UP = up_pass<T>;
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

// Up layer: t = lrelu(blur3x3(convT4x4,s2(aff(x))) + nb) on the 2H x 2W
// grid.
//   MODE_T:     write t raw [2H, 2W, Co, B], accumulate sums [2, Co, B]
//   MODE_STATS: accumulate sums only
//   MODE_APPLY: write own_affine(t) with this layer's coefs; no sums
// The transposed conv is the lhs-dilated
// forward conv of the JAX package (pad 2, dilation 2): output row o reads
// input row m = (o + kh - 2) / 2 for the two kh with o + kh even. Each
// tile of UT x UT outputs first deconvolves its (UT+2)^2 halo region for
// UP channels into shared memory (zero outside the 2H x 2W grid: the blur
// sees zero padding there), then blurs from it. AFF as in conv3x3_kernel.
// bf16: the deconv runs on the tensor cores (deconv_mma above; k4 is the
// packed weights, ck the staging chunk). f32: on the CUDA cores as f32
// FMAs, one position per thread (k4 is f32 [4, 4, Ci, Co]; ck unused),
// UP = 4 channels per pass so that its f32 yb_s leaves room for the f32
// staged affine and the sums at Ci = 256, Co = 128 (182,272 B).
// Shared memory per block (bf16): sums 2*Co*32*8 B + staged affine
// 2*Ci*32*2 B + yb_s 51,200 B + staged input 36*ck*32*2 B; at Ci = 64,
// Co = 32 (ck = 64) 223,232 B, at Ci = 256, Co = 128 (ck = 32) 223,232 B:
// one block (8 warps) per SM.
template <typename T, int MODE, bool AFF>
__global__ void __launch_bounds__(LANES* NY)
    up_kernel(const T* __restrict__ x, const void* __restrict__ k4,
              const T* __restrict__ nb, const float* __restrict__ aff,
              const float* __restrict__ coefs, T* __restrict__ out,
              acc_t* __restrict__ sums, int H, int W, int Ci, int Co,
              int B, int ck) {
  constexpr int YR = UT + 2;
  constexpr int NPOS = YR * YR;
  constexpr bool TC = std::is_same<T, bf16>::value;
  constexpr int UP = up_pass<T>;   // output channels per pass
  extern __shared__ __align__(16) unsigned char smem_raw[];
  acc_t* red_s = reinterpret_cast<acc_t*>(smem_raw);      // [2][Co][LANES]
  T* aff_s = reinterpret_cast<T*>(red_s + 2 * Co * LANES);  // [2][Ci][LANES]
  T* yb_s = aff_s + 2 * Ci * LANES;                        // [NPOS][UP][LANES]
  T* xs = yb_s + NPOS * UP * LANES;                 // bf16: [NPIX][ck][LANES]
  setup_shared<T>(aff, aff_s, red_s, Ci, Co, B, AFF);

  const int lane = threadIdx.x;
  const int b = blockIdx.x * LANES + lane;
  const bool active = b < B;
  const int OH = 2 * H, OW = 2 * W;
  const int ntw = (OW + UT - 1) / UT;
  const int ntiles = ((OH + UT - 1) / UT) * ntw;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int r0 = (tile / ntw) * UT, q0 = (tile % ntw) * UT;
    if constexpr (TC) {
      if (ck == Ci) {   // the whole region, once for every pass
        stage_x<XR, AFF>(x, aff_s, xs, r0 / 2 - 1, q0 / 2 - 1, 0, Ci, H, W,
                         Ci, B);
        __syncthreads();
      }
    }
    for (int c0 = 0; c0 < Co; c0 += UP) {
      if constexpr (TC)
        deconv_mma<AFF>(x, static_cast<const uint2*>(k4), aff_s, xs, yb_s,
                        r0, q0, c0, ck, H, W, Ci, Co, B);
      else
        deconv_fma<T, AFF>(x, static_cast<const float*>(k4), aff_s, yb_s,
                           r0, q0, c0, H, W, Ci, Co, B);
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

template <typename T, int MODE>
int launch_up(const void* x, const void* k4, const void* nb,
              const float* aff, const float* coefs, void* out, acc_t* sums,
              int H, int W, int Ci, int Co, int B, int apply_aff,
              cudaStream_t stream) {
  // only the chain's up layer (MODE_T) takes an input affine
  auto kern = apply_aff ? up_kernel<T, MODE, MODE == MODE_T>
                        : up_kernel<T, MODE, false>;
  int smem = 2 * Co * LANES * (int)sizeof(acc_t) +
             (2 * Ci + (UT + 2) * (UT + 2) * up_pass<T>) * LANES *
                 (int)sizeof(T);
  int ck = 0;
  if (std::is_same<T, bf16>::value) {
    ck = staging_chunk(smem, NPIX, Ci);
    if (ck == 0) return -3;
    smem += NPIX * ck * LANES * 2;
  }
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (B + LANES - 1) / LANES;
  const int ntiles = ((2 * H + UT - 1) / UT) * ((2 * W + UT - 1) / UT);
  dim3 grid(groups, grid_y(ntiles, groups));
  dim3 block(LANES, NY);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), k4, static_cast<const T*>(nb), aff, coefs,
      static_cast<T*>(out), sums, H, W, Ci, Co, B, ck);
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
    return launch_up<bf16, MODE>(x, k4, nb, aff, coefs, out, sums, H, W, Ci,
                                 Co, B, apply_aff, s);
  if (dtype == 0)
    return launch_up<float, MODE>(x, k4, nb, aff, coefs, out, sums, H, W,
                                  Ci, Co, B, apply_aff, s);
  return -2;
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Each function launches on `stream`, does not synchronise, and returns the
// cudaGetLastError() code of the launch (0 on success; -1 for Co not a
// multiple of 8 (up) or 16 (conv), or a bf16 layer's Ci not a multiple of
// 16; -2 for an unknown dtype; -3 for a bf16 layer whose shared memory
// does not fit a block). `sums` is int64 [2, Co, B] in units of 2^-20 (see
// the design note), zeroed by the caller. The weights (k4 [4, 4, Ci, Co]
// of an up layer, k [3, 3, Ci, Co] of a conv layer) are f32 for dtype 0
// and the packed bf16 fragments of pack_mma_weights
// (ops/synthesis_tail_bc.py) for dtype 1. The bf16 kernels run their
// convolutions on the tensor cores with the input region of a tile staged
// once in shared memory (what bounds them: the design note); the f32
// kernels are CUDA-core FMA loops, kept as checks.
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

int cfr_up_apply(int dtype, const void* x, const void* k4, const void* nb,
                 const float* coefs, void* out, int H, int W, int Ci, int Co,
                 int B, void* stream) {
  return dispatch_up<MODE_APPLY>(dtype, x, k4, nb, nullptr, coefs, out,
                                 nullptr, H, W, Ci, Co, B, 0, stream);
}

}  // extern "C"
