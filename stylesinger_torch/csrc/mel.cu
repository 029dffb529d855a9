// Log10-mel spectrogram of a mono waveform: one f64 FFT per pair of frames
// in shared memory.
//
// Replaces the TPU kernel stylesinger_tpu/ops/mel_pallas.py::mel_spectrogram
// (body _mel_kernel): zero-center-padded frames x periodic Hann window ->
// real DFT -> sqrt(re^2 + im^2) -> mel projection -> log10(max(., eps)).
//
// What bounds it on an H100: operations, and at this size the launch.  A 4 s
// clip at 48 kHz (751 frames, n_fft 1024, 513 bins, 80 mels) needs about
// 8e7 FLOP as an FFT (2.5 N log2 N per frame) plus the mel projection, and
// about 1 MB of input and output: about 1 us of the card's time, less than a
// kernel launch.  A direct DFT would need 1.6e9 FLOP in f64.
//
// Precision: the transform runs in f64.  f32 rounding noise of about 1e-6 in
// each bin is the size of the bins that a clean voice leaves nearly empty,
// and log10 near the 1e-6 floor turns it into errors of several 1e-2
// (measured against the plain version on an H100 with an f32 direct DFT).
// The twiddles are f64 values from sincospi, computed in the block.
//
// Design: one block of 256 threads owns kFrames = 4 consecutive frames.  Two
// real frames ride as the real and imaginary parts of one complex signal, so
// the block runs two radix-2 decimation-in-time FFTs of n_fft points in
// shared memory (the windowed samples are written in bit-reversed order as
// they are loaded; samples outside the signal read as the zero center
// padding), and the two spectra are separated afterwards:
//   X_a[f] = (Z[f] + conj Z[N-f]) / 2,   X_b[f] = (Z[f] - conj Z[N-f]) / 2i.
// The magnitudes go to shared memory over the FFT buffers, and the mel
// projection (f64 sums over each filter's nonzero band of bins, which the
// wrapper finds once) and log10 run in the same kernel, so neither the
// spectrum nor the magnitude reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;              // frames per block
constexpr int kFfts = kFrames / 2;      // complex FFTs per block
constexpr int kMaxFft = 1024;
constexpr int kMaxFreqs = kMaxFft / 2 + 1;
constexpr int kItems = (kFfts * kMaxFreqs + kThreads - 1) / kThreads;

__global__ void __launch_bounds__(kThreads)
mel_fft_kernel(const float* __restrict__ wav, int n_samples,
               const float* __restrict__ window,
               const float* __restrict__ mel_t,
               const int* __restrict__ bands, float* __restrict__ out,
               int n_frames, int n_fft, int log2n, int hop, int n_mels,
               float eps) {
  __shared__ double2 z[kFfts][kMaxFft];     // 32 KB; later the magnitudes
  __shared__ double2 tw[kMaxFft / 2];       // exp(-2 pi i j / n_fft)

  const int tid = threadIdx.x;
  const int frame0 = blockIdx.x * kFrames;
  const int pad = n_fft / 2;
  const int half_n = n_fft / 2;
  const int n_freqs = half_n + 1;

  for (int j = tid; j < half_n; j += kThreads) {
    double s, c;
    sincospi(-2.0 * j / n_fft, &s, &c);
    tw[j] = make_double2(c, s);
  }
  // frame fr goes to FFT fr / 2, real part for even fr, imaginary for odd
  double* zd = reinterpret_cast<double*>(&z[0][0]);
  for (int i = tid; i < kFrames * n_fft; i += kThreads) {
    const int fr = i >> log2n;
    const int n = i & (n_fft - 1);
    const int frame = frame0 + fr;
    float v = 0.f;
    if (frame < n_frames) {
      const long s = (long)frame * hop - pad + n;
      if (s >= 0 && s < n_samples) v = wav[s] * window[n];
    }
    const int pos = (int)(__brev((unsigned)n) >> (32 - log2n));
    zd[2 * ((fr >> 1) * kMaxFft + pos) + (fr & 1)] = (double)v;
  }
  __syncthreads();

  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    const int tw_step = n_fft >> s;
    for (int b = tid; b < kFfts * half_n; b += kThreads) {
      const int f = b / half_n;
      const int j = b - f * half_n;
      const int pos = j & (half - 1);
      const int i0 = ((j >> (s - 1)) << s) + pos;
      const int i1 = i0 + half;
      const double2 w = tw[pos * tw_step];
      const double2 u = z[f][i0];
      const double2 x = z[f][i1];
      const double2 v = make_double2(w.x * x.x - w.y * x.y,
                                     w.x * x.y + w.y * x.x);
      z[f][i0] = make_double2(u.x + v.x, u.y + v.y);
      z[f][i1] = make_double2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }

  // separate the two real spectra; magnitudes in registers, then over z
  double mag_a[kItems], mag_b[kItems];
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = tid + it * kThreads;
    mag_a[it] = mag_b[it] = 0.0;
    if (item < kFfts * n_freqs) {
      const int f = item / n_freqs;
      const int q = item - f * n_freqs;
      const double2 p = z[f][q];
      const double2 m = z[f][(n_fft - q) & (n_fft - 1)];
      const double ar = 0.5 * (p.x + m.x), ai = 0.5 * (p.y - m.y);
      const double br = 0.5 * (p.y + m.y), bi = -0.5 * (p.x - m.x);
      mag_a[it] = sqrt(ar * ar + ai * ai);
      mag_b[it] = sqrt(br * br + bi * bi);
    }
  }
  __syncthreads();
  double* mag = zd;  // [kFrames][n_freqs]
#pragma unroll
  for (int it = 0; it < kItems; ++it) {
    const int item = tid + it * kThreads;
    if (item < kFfts * n_freqs) {
      const int f = item / n_freqs;
      const int q = item - f * n_freqs;
      mag[(2 * f) * n_freqs + q] = mag_a[it];
      mag[(2 * f + 1) * n_freqs + q] = mag_b[it];
    }
  }
  __syncthreads();

  for (int o = tid; o < kFrames * n_mels; o += kThreads) {
    const int fr = o / n_mels;
    const int m = o - fr * n_mels;
    const int frame = frame0 + fr;
    if (frame >= n_frames) continue;
    const double* mg = mag + fr * n_freqs;
    double acc = 0.0;
    for (int q = bands[2 * m]; q < bands[2 * m + 1]; ++q) {
      acc = fma(mg[q], (double)mel_t[q * n_mels + m], acc);
    }
    out[(long)frame * n_mels + m] = (float)log10(fmax(acc, (double)eps));
  }
}

}  // namespace

// wav [n_samples] -> out [n_frames, n_mels]; window [n_fft];
// mel_t [n_fft/2 + 1, n_mels]; all f32, contiguous; bands [n_mels, 2] int32:
// the bins [first, last + 1) where mel filter m is nonzero; n_fft a power of
// two, 2 <= n_fft <= 1024.  Returns cudaGetLastError() after the launch.
extern "C" int ss_mel_spectrogram(const float* wav, int n_samples,
                                  const float* window, const float* mel_t,
                                  const int* bands, float* out,
                                  int n_frames, int n_fft,
                                  int hop, int n_mels, float eps,
                                  void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n_fft) ++log2n;
  if (n_fft > kMaxFft || n_fft < 2 || (1 << log2n) != n_fft ||
      n_frames <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((n_frames + kFrames - 1) / kFrames);
  mel_fft_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      wav, n_samples, window, mel_t, bands, out, n_frames, n_fft, log2n, hop,
      n_mels, eps);
  return (int)cudaGetLastError();
}
