// Log10-mel spectrogram of a mono waveform, one pass per tile of frames.
//
// Replaces the TPU kernel stylesinger_tpu/ops/mel_pallas.py::mel_spectrogram
// (body _mel_kernel): zero-center-padded frames x periodic Hann window ->
// real DFT -> sqrt(re^2 + im^2) -> mel projection -> log10(max(., eps)).
//
// What bounds it on an H100: operations.  A 4 s clip at 48 kHz (751 frames,
// n_fft 1024, 513 bins, 80 mels) needs about 1.6e9 FLOP against about 1 MB
// of input and output.
//
// Precision: the DFT sums run in f64.  A direct f32 DFT carries rounding
// noise of about 1e-6 in each bin, the size of the bins that a clean voice
// leaves nearly empty, and log10 near the 1e-6 floor turns that noise into
// errors of several 1e-2 (measured against the plain version on an H100).
// The twiddles are exact f64 values cos/sin(2*pi*i/n_fft), indexed by
// (n * f) mod n_fft, so no [n_fft, bins] table is read at all.
//
// Design: one block of 256 threads owns kFrames consecutive frames.  The
// windowed samples are staged in shared memory kChunk at a time (the window
// is applied as the tile is loaded, and samples outside the signal read as
// the zero center padding), beside the n_fft-entry twiddle tables.  Each
// thread owns up to three frequency bins and keeps their real and imaginary
// sums for all kFrames frames in registers.  The magnitude tile stays in
// shared memory, and the mel projection and log10 run in the same kernel, so
// the [frames, 513] magnitude never reaches device memory.  No tensor cores,
// TMA or wgmma yet: this is the simple first kernel.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;                  // frames per block
constexpr int kChunk = 256;                 // samples per staged chunk
constexpr int kMaxFft = 1024;
constexpr int kMaxFreqs = kMaxFft / 2 + 1;
constexpr int kPer = (kMaxFreqs + kThreads - 1) / kThreads;  // bins per thread

__global__ void __launch_bounds__(kThreads)
mel_kernel(const float* __restrict__ wav, int n_samples,
           const float* __restrict__ window, const float* __restrict__ mel_t,
           float* __restrict__ out, int n_frames, int n_fft, int hop,
           int n_mels, float eps) {
  __shared__ double tw_cos[kMaxFft];
  __shared__ double tw_sin[kMaxFft];
  __shared__ float xs[kFrames][kChunk];
  __shared__ float mag[kFrames * kMaxFreqs];

  const int tid = threadIdx.x;
  const int frame0 = blockIdx.x * kFrames;
  const int pad = n_fft / 2;
  const int n_freqs = n_fft / 2 + 1;

  for (int i = tid; i < n_fft; i += kThreads) {
    double s, c;
    sincospi(2.0 * i / n_fft, &s, &c);
    tw_cos[i] = c;
    tw_sin[i] = s;
  }

  double re[kPer][kFrames];
  double im[kPer][kFrames];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
#pragma unroll
    for (int fr = 0; fr < kFrames; ++fr) {
      re[j][fr] = 0.0;
      im[j][fr] = 0.0;
    }
  }

  for (int n0 = 0; n0 < n_fft; n0 += kChunk) {
    __syncthreads();  // twiddles written; previous chunk's readers done
    for (int i = tid; i < kFrames * kChunk; i += kThreads) {
      const int fr = i / kChunk;
      const int nn = i % kChunk;
      const int n = n0 + nn;
      const int frame = frame0 + fr;
      float v = 0.f;
      if (frame < n_frames && n < n_fft) {
        const long s = (long)frame * hop - pad + n;
        if (s >= 0 && s < n_samples) v = wav[s] * window[n];
      }
      xs[fr][nn] = v;
    }
    __syncthreads();
    const int n_here = min(kChunk, n_fft - n0);
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int f = tid + j * kThreads;
      if (f >= n_freqs) continue;
      int idx = (int)(((long)n0 * f) % n_fft);  // (n * f) mod n_fft
      for (int nn = 0; nn < n_here; ++nn) {
        const double c = tw_cos[idx];
        const double s = tw_sin[idx];
#pragma unroll
        for (int fr = 0; fr < kFrames; ++fr) {
          const double x = (double)xs[fr][nn];
          re[j][fr] = fma(x, c, re[j][fr]);
          im[j][fr] = fma(x, s, im[j][fr]);
        }
        idx += f;
        if (idx >= n_fft) idx -= n_fft;
      }
    }
  }

#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int f = tid + j * kThreads;
    if (f < n_freqs) {
#pragma unroll
      for (int fr = 0; fr < kFrames; ++fr) {
        mag[fr * n_freqs + f] =
            (float)sqrt(re[j][fr] * re[j][fr] + im[j][fr] * im[j][fr]);
      }
    }
  }
  __syncthreads();

  for (int o = tid; o < kFrames * n_mels; o += kThreads) {
    const int fr = o / n_mels;
    const int m = o % n_mels;
    const int frame = frame0 + fr;
    if (frame >= n_frames) continue;
    double acc = 0.0;
    for (int f = 0; f < n_freqs; ++f) {
      acc = fma((double)mag[fr * n_freqs + f], (double)mel_t[f * n_mels + m],
                acc);
    }
    out[(long)frame * n_mels + m] = (float)log10(fmax(acc, (double)eps));
  }
}

}  // namespace

// wav [n_samples] -> out [n_frames, n_mels]; window [n_fft];
// mel_t [n_fft/2 + 1, n_mels]; all f32, contiguous; n_fft <= 1024.
// Returns cudaGetLastError() after the launch.
extern "C" int ss_mel_spectrogram(const float* wav, int n_samples,
                                  const float* window, const float* mel_t,
                                  float* out, int n_frames, int n_fft,
                                  int hop, int n_mels, float eps,
                                  void* stream) {
  if (n_fft > kMaxFft || n_fft < 2 || n_frames <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n_frames + kFrames - 1) / kFrames);
  mel_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      wav, n_samples, window, mel_t, out, n_frames, n_fft, hop, n_mels, eps);
  return (int)cudaGetLastError();
}
