// Hopper (sm_90a) kernels for the epilogue of every StyleGAN synthesis layer
// the plain-ops prefix runs (models/stylegan._epilogue: layer0, then the two
// half-layers of each block from 4^2 up to the chain tail's boundary), on a
// bf16 activation with no autograd graph to record:
//
//   t   = lrelu(x + nb)                    nb = noise * noise_weight + bias
//   out = (t - mean(t)) * rsqrt(var(t) + 1e-8) * (s0 + 1) + s1
//
// with mean and var over each (sample, channel) plane, and (s0, s1) the AdaIN
// style of the sample and channel.
//
// Replace no kernel of the JAX package: there the chain is plain jnp code
// (certifyingfacerecognition_tpu/models/stylegan.py, _epilogue), which XLA
// fuses by itself on the TPU. Run eagerly by PyTorch, the same chain is some
// thirty kernels, most of them broadcast elementwise passes that each read and
// write the whole activation; these two kernels are that fusion, by hand.
//
// Inputs: x bf16 [B, C, H, W] in the channels-last layout (memory [B, H, W,
// C]: the layout in which cuDNN runs the prefix's convolutions and blur; with
// planes contiguous instead, cuDNN transposed around every convolution and
// the depthwise blur ran 5x slower); nb bf16 [H, W, C] (nb folded in f32 and
// cast, as the chain tail takes it); style bf16 [B, 2C] (s0 then s1, the
// dense layer's output). Output: a new bf16 tensor in x's layout. C / 8 must
// be a power of two up to 256, H W a power of two, C H W at least 2048.
// Arithmetic is f32 and rounds to bf16 once, at the store: the chain tail's
// rounding points (+nb and lrelu in f32, s0 + 1 in f32), and fewer roundings
// than the plain bf16 chain, which rounds after every op.
//
// Bound on an H100 (3.35 TB/s): bytes. The work is a few FLOPs per element;
// the least traffic is x read once and out written once, 4 B per element, plus
// nb once: at B = 100 the two 256^2 x 64 epilogues move 1.68 GB each
// (0.50 ms), the 14 of a synthesis up to 256^2 6.4 GB (1.9 ms).
//
// Design. In the channels-last layout a (sample, channel) plane is spread over
// the whole sample (8 MB at 256^2 x 64), beyond what a block or a cluster
// holds on chip, so the epilogue takes two passes over x, both coalesced: a
// warp moves whole rows of C channels (a thread 8 channels, one 16-byte
// vector), a block a chunk of a sample's rows.
//   prefix_moments_kernel: per chunk (16 a sample at B = 100: some 2,000
//     blocks), each channel's partial moments, from the last sample to the
//     first, so that its first reads find the end of x, which the layer
//     before has just written, in L2;
//   prefix_coef_kernel: per (sample, channel), the chunks' moments combined
//     and folded with the style into (mean, a, s1);
//   prefix_apply_kernel: per 64 KB of rows, out = (t - mean) a + s1, from
//     the first sample, so that its first reads find the moments kernel's
//     last in L2 (all of them up to 32^2, where x is 105 MB).
// That is x read twice, 6 B per element instead of 4, the price of keeping
// cuDNN's layout. (Up to 64^2, 2 MB a sample, a cluster of blocks could hold
// a sample on chip and read x once: later work.)
//
// Moments without atomics and in a fixed order, so a rerun gives the same
// bits (certification counts need that). Each thread runs Welford's update
// over its rows, in order; the threads of a block then combine partials of
// equal counts in a fixed tree (Chan et al.: mean = (ma + mb) / 2, M2 = M2a +
// M2b + (mb - ma)^2 n / 2), and the chunks of a sample in chunk order. var =
// M2 / (H W) has the two-pass variance's accuracy.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int CTA = 256;                  // threads of a block
constexpr int CH = 8;                     // channels of a thread: one vector
constexpr int CMAX = CTA * CH;            // channels at most
constexpr int MAX_CHUNKS = 32;            // moment chunks of a sample at most
constexpr int MOMENT_BLOCKS = 2048;       // moments blocks aimed at
constexpr int APPLY_BYTES = 64 * 1024;    // x bytes of an apply block
constexpr float SLOPE = 0.2f;             // lrelu
constexpr float EPS = 1e-8f;              // instance norm

__device__ __forceinline__ float lrelu(float v) {
  return v >= 0.f ? v : SLOPE * v;
}

__device__ __forceinline__ float lo_bf16(uint32_t w) {
  return __uint_as_float(w << 16);
}
__device__ __forceinline__ float hi_bf16(uint32_t w) {
  return __uint_as_float(w & 0xffff0000u);
}

// t = lrelu(x + nb) of one vector of 8 channels (bf16, element 2i in the low
// half of word i).
__device__ __forceinline__ void vec_t(const uint4& x, const uint4& nb,
                                      float t[CH]) {
  const uint32_t xw[4] = {x.x, x.y, x.z, x.w};
  const uint32_t nw[4] = {nb.x, nb.y, nb.z, nb.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    t[2 * i] = lrelu(lo_bf16(xw[i]) + lo_bf16(nw[i]));
    t[2 * i + 1] = lrelu(hi_bf16(xw[i]) + hi_bf16(nw[i]));
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&p);
}

// Two partial moments of n values each -> one of 2n values.
__device__ __forceinline__ float2 merge_equal(float2 a, float2 b, float n) {
  const float d = b.x - a.x;
  return make_float2((a.x + b.x) * 0.5f, (a.y + b.y) + d * d * (n * 0.5f));
}

// A block's threads: group gi = t % G (channels 8 gi .. 8 gi + 7) of row
// lane rl = t / G, for G = C / 8 groups and P = CTA / G row lanes.

// Block q of chunks * B, counted from the last (samples in reverse order):
// rows [k rows, (k + 1) rows) of sample b = q / chunks; part[b][k][c] =
// (mean, M2) of channel c over those rows.
__global__ void __launch_bounds__(CTA)
prefix_moments_kernel(const uint4* __restrict__ x,
                      const uint4* __restrict__ nb, float2* __restrict__ part,
                      int C, int HW, int rows, int chunks) {
  __shared__ float2 red[CH][CTA];   // channel-major: no bank conflicts
  const int G = C / CH, P = CTA / G;
  const int t = threadIdx.x, gi = t % G, rl = t / G;
  const int q = gridDim.x - 1 - blockIdx.x;
  const int b = q / chunks, k = q % chunks;
  const uint4* xs = x + (size_t)b * HW * G + gi;
  const uint4* ns = nb + gi;

  float n = 0.f, mean[CH], m2[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) mean[e] = m2[e] = 0.f;
#pragma unroll 4
  for (int r = k * rows + rl; r < (k + 1) * rows; r += P) {
    float v[CH];
    vec_t(__ldg(xs + (size_t)r * G), __ldg(ns + (size_t)r * G), v);
    n += 1.f;
    const float inv = 1.f / n;
#pragma unroll
    for (int e = 0; e < CH; ++e) {   // Welford's update by one row
      const float d = v[e] - mean[e];
      mean[e] += d * inv;
      m2[e] += d * (v[e] - mean[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < CH; ++e) red[e][t] = make_float2(mean[e], m2[e]);
  __syncthreads();
  for (int s = P / 2; s > 0; s >>= 1) {   // row lanes rl and rl + s
    if (rl < s) {
#pragma unroll
      for (int e = 0; e < CH; ++e)
        red[e][t] = merge_equal(red[e][t], red[e][t + s * G], n);
    }
    n *= 2.f;
    __syncthreads();
  }
  if (rl == 0) {
    float2* out = part + ((size_t)b * chunks + k) * C + gi * CH;
#pragma unroll
    for (int e = 0; e < CH; ++e) out[e] = red[e][t];
  }
}

// Thread (b, c): the moments of the sample's chunks, combined in chunk order
// (Chan's update, equal counts), into coef[b][c] = (mean, rsqrt(var + eps)
// (s0 + 1), s1).
__global__ void __launch_bounds__(CTA)
prefix_coef_kernel(const float2* __restrict__ part,
                   const uint16_t* __restrict__ style,
                   float4* __restrict__ coef, int B, int C, int HW,
                   int chunks) {
  const int i = blockIdx.x * CTA + threadIdx.x;
  if (i >= B * C) return;
  const int b = i / C, c = i - b * C;
  const float2* pc = part + (size_t)b * chunks * C + c;
  const float rows = (float)(HW / chunks);
  float2 m = pc[0];
  for (int k = 1; k < chunks; ++k) {
    const float2 o = pc[(size_t)k * C];
    const float n = k * rows, n2 = n + rows;
    const float d = o.x - m.x;
    m.x += d * (rows / n2);
    m.y += o.y + d * d * (n * rows / n2);
  }
  const uint16_t* sb = style + (size_t)b * 2 * C;
  const float s0p1 = __uint_as_float((uint32_t)sb[c] << 16) + 1.f;
  const float s1 = __uint_as_float((uint32_t)sb[C + c] << 16);
  coef[i] = make_float4(m.x, rsqrtf(m.y / (float)HW + EPS) * s0p1, s1, 0.f);
}

// Block q of blocks * B: rows [k rows, (k + 1) rows) of sample b = q /
// blocks.
__global__ void __launch_bounds__(CTA)
prefix_apply_kernel(const uint4* __restrict__ x, const uint4* __restrict__ nb,
                    const float4* __restrict__ coef, uint4* __restrict__ out,
                    int C, int HW, int rows, int blocks) {
  __shared__ float4 cs[CMAX];
  const int G = C / CH, P = CTA / G;
  const int t = threadIdx.x, gi = t % G, rl = t / G;
  const int q = blockIdx.x;
  const int b = q / blocks, k = q % blocks;
  for (int c = t; c < C; c += CTA) cs[c] = coef[(size_t)b * C + c];
  __syncthreads();
  float mean[CH], a[CH], sh[CH];
#pragma unroll
  for (int e = 0; e < CH; ++e) {
    const float4 f = cs[gi * CH + e];
    mean[e] = f.x;
    a[e] = f.y;
    sh[e] = f.z;
  }

  const uint4* xs = x + (size_t)b * HW * G + gi;
  uint4* os = out + (size_t)b * HW * G + gi;
  const uint4* ns = nb + gi;
#pragma unroll 4
  for (int r = k * rows + rl; r < (k + 1) * rows; r += P) {
    float v[CH];
    vec_t(__ldcs(xs + (size_t)r * G), __ldg(ns + (size_t)r * G), v);
    uint4 o;
    o.x = pack_bf16(fmaf(v[0] - mean[0], a[0], sh[0]),
                    fmaf(v[1] - mean[1], a[1], sh[1]));
    o.y = pack_bf16(fmaf(v[2] - mean[2], a[2], sh[2]),
                    fmaf(v[3] - mean[3], a[3], sh[3]));
    o.z = pack_bf16(fmaf(v[4] - mean[4], a[4], sh[4]),
                    fmaf(v[5] - mean[5], a[5], sh[5]));
    o.w = pack_bf16(fmaf(v[6] - mean[6], a[6], sh[6]),
                    fmaf(v[7] - mean[7], a[7], sh[7]));
    __stcs(os + (size_t)r * G, o);
  }
}

bool pow2(long long v) { return v > 0 && (v & (v - 1)) == 0; }

}  // namespace

extern "C" {

// out = the epilogue of x (see the note above), with part (float2 [B,
// MAX_CHUNKS, C]) and coef (float4 [B, C]) as scratch; every pointer 16-byte
// aligned. Returns a CUDA error code (0 when the three launches were
// accepted).
int cfr_prefix_epilogue(const void* x, const void* nb, const void* style,
                        void* part, void* coef, void* out, int B, int C,
                        int HW, void* stream) {
  if (B <= 0 || C % CH || !pow2(C / CH) || C > CMAX || !pow2(HW) ||
      (long long)C * HW < CTA * CH ||
      (long long)B * HW * (C / CH) > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // moments: about MOMENT_BLOCKS blocks, at most MAX_CHUNKS a sample, each
  // of whole row lanes (a multiple of CTA / (C / 8) rows: C H W >= CTA * CH)
  int chunks = 1;
  while (chunks < MAX_CHUNKS && B * chunks * 2 <= MOMENT_BLOCKS &&
         (long long)(HW / (chunks * 2)) * C >= CTA * CH)
    chunks *= 2;
  prefix_moments_kernel<<<B * chunks, CTA, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(nb),
      static_cast<float2*>(part), C, HW, HW / chunks, chunks);
  prefix_coef_kernel<<<(B * C + CTA - 1) / CTA, CTA, 0, s>>>(
      static_cast<const float2*>(part), static_cast<const uint16_t*>(style),
      static_cast<float4*>(coef), B, C, HW, chunks);
  // apply: APPLY_BYTES of x a block
  int rows = APPLY_BYTES / (2 * C);
  if (rows > HW) rows = HW;
  prefix_apply_kernel<<<B * (HW / rows), CTA, 0, s>>>(
      static_cast<const uint4*>(x), static_cast<const uint4*>(nb),
      static_cast<const float4*>(coef), static_cast<uint4*>(out), C, HW, rows,
      HW / rows);
  return (int)cudaGetLastError();
}

}  // extern "C"
