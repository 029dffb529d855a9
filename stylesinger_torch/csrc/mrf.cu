// One fused conv step of a HiFi-GAN MRF group over overlap-save blocks.
//
// Replaces the TPU kernel stylesinger_tpu/ops/mrf_pallas.py::fused_mrf_blocks
// (body _mrf_kernel).  That kernel runs a whole MRF group (3 ResBlock1 with
// kernels 3/7/11 x dilations 1/3/5 x 2 convs = 18 "SAME" convs, each after a
// leaky-relu(0.1) and a validity-mask multiply, residual adds, the mean of the
// 3 blocks and a halo crop) on one [block + 2*halo, C] block held in VMEM.
//
// What bounds it on an H100: operations.  A group does 2*k*C*C FLOP per conv
// and time step (about 2*T*C^2*126 per stage) in f32; at C = 128 that is more
// than 300 FLOP per byte of input and output.
//
// Design: a whole block and all 18 weight matrices (about 1.1 MB of f32
// activations at C = 128) do not fit in an SM's 227 KB of shared memory, so
// this kernel is one conv step, launched 18 times per group by the wrapper
// (kernels/mrf.py), and the group is not yet fused on the card.  One launch
// computes, for every block n and output time t in [t_begin, t_begin+t_len):
//
//   v = bias + sum_{tap, ci} act(x[n, t + (tap - (k-1)/2) * d, ci]) w[tap, ci, co]
//   act(u) = leaky_relu(u, 0.1) * mask[n, u's time], 0 outside [0, L)
//   v += res[n, t, co]   (optional residual)
//   v += acc[n, t, co]   (optional running sum of resblock outputs)
//   out[n, t - out_off, co] = v * scale
//
// so the residual adds, the 3-block mean and the final halo crop ride in the
// epilogue.  A block of 256 threads owns 64 time rows x CO output channels.
// Time is tiled inside each overlap-save block; the activated input rows of
// the tile plus the conv's reach are staged in shared memory 32 input channels
// at a time (the activation is applied as they are loaded), and the weights
// are streamed through shared memory one tap at a time.  Each thread keeps a
// 4 x CPT register tile of sums.  f32 FMA throughout, no tensor cores yet.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;      // output time rows per block
constexpr int kCi = 32;        // input-channel chunk staged at a time
constexpr int kCiPad = kCi + 1;
constexpr int kMaxReach = 64;  // (k - 1) * d

template <int CPT>
__global__ void __launch_bounds__(kThreads)
mrf_conv_kernel(const float* __restrict__ x, const float* __restrict__ mask,
                const float* __restrict__ w, const float* __restrict__ bias,
                const float* __restrict__ res, const float* acc_in,
                float* out, int L, int C, int k, int d, int t_begin,
                int t_len, int out_len, int out_off, float scale) {
  constexpr int kCo = 16 * CPT;
  __shared__ float xs[(kRows + kMaxReach) * kCiPad];
  __shared__ float ws[kCi * kCo];

  const int n = blockIdx.z;
  const int tb = t_begin + blockIdx.x * kRows;
  const int co0 = blockIdx.y * kCo;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int half = (k - 1) / 2 * d;
  const int rows = kRows + (k - 1) * d;
  const float* xn = x + (size_t)n * L * C;
  const float* mn = mask + (size_t)n * L;

  float acc[4][CPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  }

  for (int ci0 = 0; ci0 < C; ci0 += kCi) {
    const int n_ci = min(kCi, C - ci0);
    __syncthreads();  // previous chunk's readers are done with xs
    for (int i = threadIdx.x; i < rows * kCi; i += kThreads) {
      const int r = i / kCi;
      const int c = i % kCi;
      const int t = tb - half + r;
      float v = 0.f;
      if (c < n_ci && t >= 0 && t < L) {
        v = xn[(size_t)t * C + ci0 + c];
        v = (v > 0.f ? v : 0.1f * v) * mn[t];
      }
      xs[r * kCiPad + c] = v;
    }
    for (int tap = 0; tap < k; ++tap) {
      __syncthreads();  // xs staged; previous tap's readers are done with ws
      for (int i = threadIdx.x; i < kCi * kCo; i += kThreads) {
        const int c = i / kCo;
        const int o = i % kCo;
        ws[i] = (c < n_ci && co0 + o < C)
                    ? w[((size_t)tap * C + ci0 + c) * C + co0 + o]
                    : 0.f;
      }
      __syncthreads();
      const float* xrow = xs + (ty * 4 + tap * d) * kCiPad;
#pragma unroll 8
      for (int c = 0; c < kCi; ++c) {
        float a[4];
        float b[CPT];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = xrow[i * kCiPad + c];
#pragma unroll
        for (int j = 0; j < CPT; ++j) b[j] = ws[c * kCo + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < CPT; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = tb + ty * 4 + i;
    if (t >= t_begin + t_len) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int co = co0 + tx + 16 * j;
      if (co >= C) continue;
      const size_t idx = ((size_t)n * L + t) * C + co;
      float v = acc[i][j] + bias[co];
      if (res != nullptr) v += res[idx];
      if (acc_in != nullptr) v += acc_in[idx];
      out[((size_t)n * out_len + (t - out_off)) * C + co] = v * scale;
    }
  }
}

}  // namespace

// x, res, acc_in [nb, L, C]; mask [nb, L]; w [k, C, C] (tap, in, out);
// bias [C]; out [nb, out_len, C].  res and acc_in may be null; acc_in may
// alias out when out_len == L and out_off == 0.
// Returns cudaGetLastError() after the launch.
extern "C" int ss_mrf_conv(const float* x, const float* mask, const float* w,
                           const float* bias, const float* res,
                           const float* acc_in, float* out, int nb, int L,
                           int C, int k, int d, int t_begin, int t_len,
                           int out_len, int out_off, float scale,
                           void* stream) {
  if (C <= 0 || (k - 1) * d > kMaxReach || t_len <= 0 || nb <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const int cpt = (C % 64 == 0) ? 4 : (C % 32 == 0) ? 2 : 1;
  const int co_tile = 16 * cpt;
  const dim3 grid((t_len + kRows - 1) / kRows, (C + co_tile - 1) / co_tile,
                  nb);
  cudaStream_t s = (cudaStream_t)stream;
  if (cpt == 4) {
    mrf_conv_kernel<4><<<grid, kThreads, 0, s>>>(
        x, mask, w, bias, res, acc_in, out, L, C, k, d, t_begin, t_len,
        out_len, out_off, scale);
  } else if (cpt == 2) {
    mrf_conv_kernel<2><<<grid, kThreads, 0, s>>>(
        x, mask, w, bias, res, acc_in, out, L, C, k, d, t_begin, t_len,
        out_len, out_off, scale);
  } else {
    mrf_conv_kernel<1><<<grid, kThreads, 0, s>>>(
        x, mask, w, bias, res, acc_in, out, L, C, k, d, t_begin, t_len,
        out_len, out_off, scale);
  }
  return (int)cudaGetLastError();
}
