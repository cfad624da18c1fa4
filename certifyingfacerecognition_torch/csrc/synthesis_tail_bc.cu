// Hopper (sm_90a) kernels for the StyleGAN >=512^2 synthesis tail in chain
// mode: every layer writes its activation t RAW together with per-(channel,
// sample) sums of t and t^2; the instance-norm + AdaIN affine that those sums
// define is applied by the NEXT layer as it reads its input.
//
// Replaces the Pallas kernels of certifyingfacerecognition_tpu/ops/
// synthesis_tail_bc.py:
//   cfr_up_fused     <- _up_fused    -> _up_stream_kernel        (l.1205/931)
//   cfr_conv_fused   <- _conv_fused  -> _conv_stream_kernel      (l.1243/1115)
//   cfr_final_stats  <- _final_stats -> _conv_stats_stream_kernel(l.1279/1145)
//   cfr_final_apply  <- _final_apply -> _conv_rgb_stream_kernel  (l.1312/1172)
//
// Layout (as in the JAX package): activations [H, W, C, B] with the sample
// axis B innermost, image [3, H, W, B], sums/affines [2, C, B] in f32,
// weights HWIO [kh, kw, Ci, Co] (passed as f32 holding values already
// rounded to the activation type), noise+bias nb [H, W, Co] in the
// activation type.
//
// Design. One block holds 32 consecutive samples on threadIdx.x (one warp
// spans the samples of one pixel, so activation loads and stores coalesce
// and every lane of a warp reads the same weight address) and NY workers on
// threadIdx.y that split the pixels of a tile. Blocks stride over tiles, so
// the per-block sums live in shared memory for the whole kernel and reach
// the [2, C, B] output with one atomicAdd per (channel, sample) per block;
// the atomics make the summation order differ from run to run.
//
// What bounds these kernels on an H100: the bytes they must move are
// 3.2-6.4 GB per layer at B = 128 (~1-2 ms at 3.35 TB/s) and their MACs fit
// the bf16 tensor cores in well under that, so the roofline bound is bytes.
// This first version runs the MACs as f32 FMAs on the CUDA cores (about 15x
// below the tensor-core rate), so it is bound by instruction issue, not by
// memory; it keeps every intermediate (the un-blurred deconv, the 1024^2
// 16-channel activation of the last layer) out of device memory, which is
// what the chain design is for. Moving the MACs to wgmma is later work.
//
// Rounding points reproduce the Pallas kernels in bf16: the input affine
// x*a+off is evaluated in the activation type, the deconv accumulates in
// f32 and rounds to the activation type, the blur runs in the activation
// type ((top+bottom)/4 + mid/2, vertical then horizontal), +nb and lrelu run
// in f32, t is stored in the activation type while the sums use the f32 t.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace {

constexpr int LANES = 32;   // samples per block (threadIdx.x)
constexpr int NY = 8;       // pixel workers per block (threadIdx.y)
constexpr int UT = 8;       // up kernel: output tile edge
constexpr int UCC = 8;      // up kernel: output channels per deconv pass
constexpr int CC = 16;      // conv kernels: output channels per pass
constexpr int MAX_BLOCKS = 2048;

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
// rounded to T; identity when apply_aff == 0) and zero the sums.
template <typename T>
__device__ void setup_shared(const float* __restrict__ aff, float* aff_s,
                             float* red_s, int Ci, int Co, int B,
                             int apply_aff) {
  const int tid = threadIdx.y * LANES + threadIdx.x;
  for (int i = tid; i < 2 * Ci * LANES; i += LANES * NY) {
    const int which = i / (Ci * LANES);
    const int c = (i / LANES) % Ci;
    const int bb = blockIdx.x * LANES + i % LANES;
    float v = which == 0 ? 1.f : 0.f;
    if (apply_aff && bb < B) v = rnd<T>(aff[(which * Ci + c) * B + bb]);
    aff_s[i] = v;
  }
  for (int i = tid; i < 2 * Co * LANES; i += LANES * NY) red_s[i] = 0.f;
  __syncthreads();
}

__device__ void flush_sums(const float* red_s, float* __restrict__ sums,
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

enum { MODE_T = 0, MODE_STATS = 1, MODE_RGB = 2 };

// 3x3 conv (zero padding) of aff(x), then +nb and lrelu in f32.
//   MODE_T:     write t [H, W, Co, B], accumulate sums [2, Co, B]
//   MODE_STATS: accumulate sums only
//   MODE_RGB:   out = rnd_T(t * a_c + off_c) with this layer's own affine
//               coefs [2, Co, B]; image[r] = sum_c out * wrgb[c, r] + brgb[r]
template <typename T, int MODE>
__global__ void __launch_bounds__(LANES* NY)
    conv3x3_kernel(const T* __restrict__ x, const float* __restrict__ k,
                   const T* __restrict__ nb, const float* __restrict__ aff,
                   const float* __restrict__ coefs,
                   const float* __restrict__ wrgb,
                   const float* __restrict__ brgb, T* __restrict__ out,
                   float* __restrict__ sums, int H, int W, int Ci, int Co,
                   int B, int apply_aff, int tile_px) {
  extern __shared__ float smem[];
  float* aff_s = smem;                    // [2][Ci][LANES]
  float* red_s = smem + 2 * Ci * LANES;   // [2][Co][LANES]
  setup_shared<T>(aff, aff_s, red_s, Ci, Co, B, apply_aff);

  const int lane = threadIdx.x;
  const int b = blockIdx.x * LANES + lane;
  const bool active = b < B;
  const int npix = H * W;
  const int ntiles = (npix + tile_px - 1) / tile_px;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int p_end = min(npix, (tile + 1) * tile_px);
    for (int p = tile * tile_px + threadIdx.y; p < p_end; p += NY) {
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
              if (apply_aff)
                v = affine<T>(v, aff_s[ci * LANES + lane],
                              aff_s[(Ci + ci) * LANES + lane]);
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
            const float o = rnd<T>(__fadd_rn(__fmul_rn(t, coefs[co * B + b]),
                                             coefs[(Co + co) * B + b]));
#pragma unroll
            for (int r = 0; r < 3; ++r) rgb[r] = fmaf(o, wrgb[co * 3 + r], rgb[r]);
          } else {
            if (MODE == MODE_T)
              out[((size_t)p * Co + co) * B + b] = from_f<T>(t);
            atomicAdd(&red_s[co * LANES + lane], t);
            atomicAdd(&red_s[(Co + co) * LANES + lane], __fmul_rn(t, t));
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
  if (MODE != MODE_RGB) flush_sums(red_s, sums, Co, B);
}

// Up layer: t = lrelu(blur3x3(convT4x4,s2(aff(x))) + nb) on the 2H x 2W
// grid, written raw, plus sums. The transposed conv is the lhs-dilated
// forward conv of the JAX package (pad 2, dilation 2): output row o reads
// input row m = (o + kh - 2) / 2 for the two kh with o + kh even. Each
// tile of UT x UT outputs first deconvolves its (UT+2)^2 halo region for
// UCC channels into shared memory (zero outside the 2H x 2W grid: the blur
// sees zero padding there), then blurs from it.
template <typename T>
__global__ void __launch_bounds__(LANES* NY)
    up_kernel(const T* __restrict__ x, const float* __restrict__ k4,
              const T* __restrict__ nb, const float* __restrict__ aff,
              T* __restrict__ out, float* __restrict__ sums, int H, int W,
              int Ci, int Co, int B, int apply_aff) {
  constexpr int YR = UT + 2;
  constexpr int NPOS = YR * YR;
  extern __shared__ float smem[];
  float* aff_s = smem;                     // [2][Ci][LANES]
  float* red_s = aff_s + 2 * Ci * LANES;   // [2][Co][LANES]
  T* yb_s = reinterpret_cast<T*>(red_s + 2 * Co * LANES);  // [NPOS][UCC][LANES]
  setup_shared<T>(aff, aff_s, red_s, Ci, Co, B, apply_aff);

  const int lane = threadIdx.x;
  const int b = blockIdx.x * LANES + lane;
  const bool active = b < B;
  const int OH = 2 * H, OW = 2 * W;
  const int ntw = (OW + UT - 1) / UT;
  const int ntiles = ((OH + UT - 1) / UT) * ntw;

  for (int tile = blockIdx.y; tile < ntiles; tile += gridDim.y) {
    const int r0 = (tile / ntw) * UT, q0 = (tile % ntw) * UT;
    for (int c0 = 0; c0 < Co; c0 += UCC) {
      for (int pos = threadIdx.y; pos < NPOS; pos += NY) {
        const int orow = r0 - 1 + pos / YR, ocol = q0 - 1 + pos % YR;
        float acc[UCC];
#pragma unroll
        for (int j = 0; j < UCC; ++j) acc[j] = 0.f;
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
                if (apply_aff)
                  v = affine<T>(v, aff_s[ci * LANES + lane],
                                aff_s[(Ci + ci) * LANES + lane]);
                float wv[UCC];
                load_w<UCC>(kp + (size_t)ci * Co, wv);
#pragma unroll
                for (int j = 0; j < UCC; ++j) acc[j] = fmaf(v, wv[j], acc[j]);
              }
            }
          }
        }
#pragma unroll
        for (int j = 0; j < UCC; ++j)
          yb_s[(pos * UCC + j) * LANES + lane] = from_f<T>(acc[j]);
      }
      __syncthreads();
      for (int q = threadIdx.y; q < UT * UT; q += NY) {
        const int lr = q / UT, lc = q % UT;
        const int orow = r0 + lr, ocol = q0 + lc;
        if (!active || orow >= OH || ocol >= OW) continue;
        const size_t op = (size_t)orow * OW + ocol;
#pragma unroll
        for (int j = 0; j < UCC; ++j) {
          float v[3];
#pragma unroll
          for (int dc = 0; dc < 3; ++dc) {
            const int base = (lr * YR + lc + dc) * UCC + j;
            v[dc] = blur3<T>(to_f(yb_s[base * LANES + lane]),
                             to_f(yb_s[(base + YR * UCC) * LANES + lane]),
                             to_f(yb_s[(base + 2 * YR * UCC) * LANES + lane]));
          }
          const float hb = blur3<T>(v[0], v[1], v[2]);
          const int co = c0 + j;
          const float t = lrelu(__fadd_rn(hb, to_f(nb[op * Co + co])));
          out[(op * Co + co) * B + b] = from_f<T>(t);
          atomicAdd(&red_s[co * LANES + lane], t);
          atomicAdd(&red_s[(Co + co) * LANES + lane], __fmul_rn(t, t));
        }
      }
      __syncthreads();
    }
  }
  flush_sums(red_s, sums, Co, B);
}

int grid_y(int ntiles, int groups) {
  return std::max(1, std::min(ntiles, std::max(1, MAX_BLOCKS / groups)));
}

template <typename T, int MODE>
int launch_conv(const void* x, const float* k, const void* nb,
                const float* aff, const float* coefs, const float* wrgb,
                const float* brgb, void* out, float* sums, int H, int W,
                int Ci, int Co, int B, int apply_aff, cudaStream_t stream) {
  auto kern = conv3x3_kernel<T, MODE>;
  const int smem = (2 * Ci + 2 * Co) * LANES * (int)sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int tile_px = NY * 8;
  const int groups = (B + LANES - 1) / LANES;
  const int ntiles = (H * W + tile_px - 1) / tile_px;
  dim3 grid(groups, grid_y(ntiles, groups));
  dim3 block(LANES, NY);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), k, static_cast<const T*>(nb), aff, coefs,
      wrgb, brgb, static_cast<T*>(out), sums, H, W, Ci, Co, B, apply_aff,
      tile_px);
  return (int)cudaGetLastError();
}

template <int MODE>
int dispatch_conv(int dtype, const void* x, const float* k, const void* nb,
                  const float* aff, const float* coefs, const float* wrgb,
                  const float* brgb, void* out, float* sums, int H, int W,
                  int Ci, int Co, int B, int apply_aff, void* stream) {
  if (Co % CC != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_conv<__nv_bfloat16, MODE>(x, k, nb, aff, coefs, wrgb, brgb,
                                            out, sums, H, W, Ci, Co, B,
                                            apply_aff, s);
  if (dtype == 0)
    return launch_conv<float, MODE>(x, k, nb, aff, coefs, wrgb, brgb, out,
                                    sums, H, W, Ci, Co, B, apply_aff, s);
  return -2;
}

template <typename T>
int launch_up(const void* x, const float* k4, const void* nb,
              const float* aff, void* out, float* sums, int H, int W,
              int Ci, int Co, int B, int apply_aff, cudaStream_t stream) {
  auto kern = up_kernel<T>;
  const int smem = (2 * Ci + 2 * Co) * LANES * (int)sizeof(float) +
                   (UT + 2) * (UT + 2) * UCC * LANES * (int)sizeof(T);
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  const int groups = (B + LANES - 1) / LANES;
  const int ntiles = ((2 * H + UT - 1) / UT) * ((2 * W + UT - 1) / UT);
  dim3 grid(groups, grid_y(ntiles, groups));
  dim3 block(LANES, NY);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(x), k4, static_cast<const T*>(nb), aff,
      static_cast<T*>(out), sums, H, W, Ci, Co, B, apply_aff);
  return (int)cudaGetLastError();
}

}  // namespace

// Plain C interface (loaded with ctypes). dtype: 0 = float32, 1 = bfloat16.
// Each function launches on `stream`, does not synchronise, and returns the
// cudaGetLastError() code of the launch (0 on success; -1 for Co not a
// multiple of 8 (up) or 16 (conv), -2 for an unknown dtype). `sums` must be
// zeroed by the caller.
extern "C" {

int cfr_up_fused(int dtype, const void* x, const float* k4, const void* nb,
                 const float* aff, void* out, float* sums, int H, int W,
                 int Ci, int Co, int B, int apply_aff, void* stream) {
  if (Co % UCC != 0) return -1;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return launch_up<__nv_bfloat16>(x, k4, nb, aff, out, sums, H, W, Ci, Co,
                                    B, apply_aff, s);
  if (dtype == 0)
    return launch_up<float>(x, k4, nb, aff, out, sums, H, W, Ci, Co, B,
                            apply_aff, s);
  return -2;
}

int cfr_conv_fused(int dtype, const void* x, const float* k, const void* nb,
                   const float* aff, void* out, float* sums, int H, int W,
                   int Ci, int Co, int B, int apply_aff, void* stream) {
  return dispatch_conv<MODE_T>(dtype, x, k, nb, aff, nullptr, nullptr,
                               nullptr, out, sums, H, W, Ci, Co, B,
                               apply_aff, stream);
}

int cfr_final_stats(int dtype, const void* x, const float* k, const void* nb,
                    const float* aff, float* sums, int H, int W, int Ci,
                    int Co, int B, int apply_aff, void* stream) {
  return dispatch_conv<MODE_STATS>(dtype, x, k, nb, aff, nullptr, nullptr,
                                   nullptr, nullptr, sums, H, W, Ci, Co, B,
                                   apply_aff, stream);
}

int cfr_final_apply(int dtype, const void* x, const float* k, const void* nb,
                    const float* aff, const float* coefs, const float* wrgb,
                    const float* brgb, void* out, int H, int W, int Ci,
                    int Co, int B, int apply_aff, void* stream) {
  return dispatch_conv<MODE_RGB>(dtype, x, k, nb, aff, coefs, wrgb, brgb,
                                 out, nullptr, H, W, Ci, Co, B, apply_aff,
                                 stream);
}

}  // extern "C"
