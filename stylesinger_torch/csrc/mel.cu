// Log10-mel spectrogram of a mono waveform: one f64 FFT per pair of frames
// in shared memory, or a direct f64 DFT where n_fft is not a power of two.
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
//
// Domain.  The Pallas kernel is a DFT done as a matmul and takes any n_fft
// (its [n_fft, bins] tables are 71 MB at 4096).  Here every n_fft from 2 to
// 4096 runs: a power of two takes the FFT, with its buffers in dynamic
// shared memory (2 FFTs + twiddles + magnitudes: 57 KB at 1024, 226 KB at
// 4096, past the static 48 KB, so the launch opts in); any other n_fft takes
// mel_dft_kernel, a direct f64 DFT (bins per thread in passes, the samples
// staged in chunks, the twiddles as f64 tables indexed by (n * f) mod
// n_fft), with the same magnitude tile, mel projection and log10.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kFrames = 4;              // frames per block
constexpr int kFfts = kFrames / 2;      // complex FFTs per block
constexpr int kMaxFft = 4096;
constexpr int kChunk = 256;             // DFT: samples per staged chunk
constexpr int kPer = 2;                 // DFT: bins per thread per pass

size_t fft_smem(int n_fft) {
  return (size_t)kFfts * n_fft * sizeof(double2) +
         (size_t)(n_fft / 2) * sizeof(double2) +
         (size_t)kFrames * (n_fft / 2 + 1) * sizeof(double);
}

size_t dft_smem(int n_fft) {
  return (size_t)2 * n_fft * sizeof(double) +
         (size_t)kFrames * (n_fft / 2 + 1) * sizeof(double) +
         (size_t)kFrames * kChunk * sizeof(float);
}

// The windowed sample n of a frame; zero outside the signal (the center
// padding) and for frames past the end.
__device__ __forceinline__ float sample(const float* __restrict__ wav,
                                        int n_samples,
                                        const float* __restrict__ window,
                                        int frame, int n_frames, int hop,
                                        int pad, int n) {
  if (frame >= n_frames) return 0.f;
  const long s = (long)frame * hop - pad + n;
  return s >= 0 && s < n_samples ? wav[s] * window[n] : 0.f;
}

// mel projection (f64 sums over each filter's nonzero band of bins) and
// log10 of the block's kFrames magnitude rows
__device__ __forceinline__ void project(const double* mag, int n_freqs,
                                        const float* __restrict__ mel_t,
                                        const int* __restrict__ bands,
                                        float* __restrict__ out, int frame0,
                                        int n_frames, int n_mels, float eps) {
  for (int o = threadIdx.x; o < kFrames * n_mels; o += kThreads) {
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

__global__ void __launch_bounds__(kThreads)
mel_fft_kernel(const float* __restrict__ wav, int n_samples,
               const float* __restrict__ window,
               const float* __restrict__ mel_t,
               const int* __restrict__ bands, float* __restrict__ out,
               int n_frames, int n_fft, int log2n, int hop, int n_mels,
               float eps) {
  extern __shared__ double2 dyn[];
  double2* z = dyn;                        // [kFfts][n_fft]
  double2* tw = dyn + kFfts * n_fft;       // exp(-2 pi i j / n_fft)
  double* mag = reinterpret_cast<double*>(tw + n_fft / 2);  // [kFrames][F]

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
  double* zd = reinterpret_cast<double*>(z);
  for (int i = tid; i < kFrames * n_fft; i += kThreads) {
    const int fr = i >> log2n;
    const int n = i & (n_fft - 1);
    const float v = sample(wav, n_samples, window, frame0 + fr, n_frames,
                           hop, pad, n);
    const int pos = (int)(__brev((unsigned)n) >> (32 - log2n));
    zd[2 * ((fr >> 1) * n_fft + pos) + (fr & 1)] = (double)v;
  }
  __syncthreads();

  for (int s = 1; s <= log2n; ++s) {
    const int half = 1 << (s - 1);
    const int tw_step = n_fft >> s;
    for (int b = tid; b < kFfts * half_n; b += kThreads) {
      const int f = b / half_n;
      const int j = b - f * half_n;
      const int pos = j & (half - 1);
      const int i0 = f * n_fft + ((j >> (s - 1)) << s) + pos;
      const int i1 = i0 + half;
      const double2 w = tw[pos * tw_step];
      const double2 u = z[i0];
      const double2 x = z[i1];
      const double2 v = make_double2(w.x * x.x - w.y * x.y,
                                     w.x * x.y + w.y * x.x);
      z[i0] = make_double2(u.x + v.x, u.y + v.y);
      z[i1] = make_double2(u.x - v.x, u.y - v.y);
    }
    __syncthreads();
  }

  // separate the two real spectra into the magnitude rows
  for (int item = tid; item < kFfts * n_freqs; item += kThreads) {
    const int f = item / n_freqs;
    const int q = item - f * n_freqs;
    const double2 p = z[f * n_fft + q];
    const double2 m = z[f * n_fft + ((n_fft - q) & (n_fft - 1))];
    const double ar = 0.5 * (p.x + m.x), ai = 0.5 * (p.y - m.y);
    const double br = 0.5 * (p.y + m.y), bi = -0.5 * (p.x - m.x);
    mag[(2 * f) * n_freqs + q] = sqrt(ar * ar + ai * ai);
    mag[(2 * f + 1) * n_freqs + q] = sqrt(br * br + bi * bi);
  }
  __syncthreads();
  project(mag, n_freqs, mel_t, bands, out, frame0, n_frames, n_mels, eps);
}

__global__ void __launch_bounds__(kThreads)
mel_dft_kernel(const float* __restrict__ wav, int n_samples,
               const float* __restrict__ window,
               const float* __restrict__ mel_t,
               const int* __restrict__ bands, float* __restrict__ out,
               int n_frames, int n_fft, int hop, int n_mels, float eps) {
  extern __shared__ double dyn_d[];
  const int n_freqs = n_fft / 2 + 1;
  double* tw_cos = dyn_d;                          // [n_fft]
  double* tw_sin = dyn_d + n_fft;                  // [n_fft]
  double* mag = dyn_d + 2 * n_fft;                 // [kFrames][n_freqs]
  float* xs = reinterpret_cast<float*>(mag + kFrames * n_freqs);
  //                                                  [kFrames][kChunk]

  const int tid = threadIdx.x;
  const int frame0 = blockIdx.x * kFrames;
  const int pad = n_fft / 2;

  for (int i = tid; i < n_fft; i += kThreads) {
    double s, c;
    sincospi(2.0 * i / n_fft, &s, &c);
    tw_cos[i] = c;
    tw_sin[i] = s;
  }

  for (int f_base = 0; f_base < n_freqs; f_base += kThreads * kPer) {
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
      __syncthreads();  // twiddles written; the last chunk's readers done
      for (int i = tid; i < kFrames * kChunk; i += kThreads) {
        const int fr = i / kChunk;
        const int n = n0 + i % kChunk;
        xs[i] = n < n_fft ? sample(wav, n_samples, window, frame0 + fr,
                                   n_frames, hop, pad, n)
                          : 0.f;
      }
      __syncthreads();
      const int n_here = min(kChunk, n_fft - n0);
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int f = f_base + tid + j * kThreads;
        if (f >= n_freqs) continue;
        int idx = (int)(((long)n0 * f) % n_fft);  // (n * f) mod n_fft
        for (int nn = 0; nn < n_here; ++nn) {
          const double c = tw_cos[idx];
          const double s = tw_sin[idx];
#pragma unroll
          for (int fr = 0; fr < kFrames; ++fr) {
            const double x = (double)xs[fr * kChunk + nn];
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
      const int f = f_base + tid + j * kThreads;
      if (f >= n_freqs) continue;
#pragma unroll
      for (int fr = 0; fr < kFrames; ++fr) {
        mag[fr * n_freqs + f] =
            sqrt(re[j][fr] * re[j][fr] + im[j][fr] * im[j][fr]);
      }
    }
  }
  __syncthreads();
  project(mag, n_freqs, mel_t, bands, out, frame0, n_frames, n_mels, eps);
}

int launch_with(const void* kernel, size_t bytes) {
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

}  // namespace

// wav [n_samples] -> out [n_frames, n_mels]; window [n_fft];
// mel_t [n_fft/2 + 1, n_mels]; all f32, contiguous; bands [n_mels, 2] int32:
// the bins [first, last + 1) where mel filter m is nonzero;
// 2 <= n_fft <= 4096 (a power of two runs the FFT, any other size the direct
// DFT).  Returns a CUDA error code (cudaGetLastError() after the launch).
extern "C" int ss_mel_spectrogram(const float* wav, int n_samples,
                                  const float* window, const float* mel_t,
                                  const int* bands, float* out,
                                  int n_frames, int n_fft,
                                  int hop, int n_mels, float eps,
                                  void* stream) {
  if (n_fft > kMaxFft || n_fft < 2 || n_frames <= 0) {
    return (int)cudaErrorInvalidValue;
  }
  int log2n = 0;
  while ((1 << log2n) < n_fft) ++log2n;
  const dim3 grid((n_frames + kFrames - 1) / kFrames);
  cudaStream_t s = (cudaStream_t)stream;
  if ((1 << log2n) == n_fft) {
    const size_t bytes = fft_smem(n_fft);
    const int e = launch_with((const void*)mel_fft_kernel, bytes);
    if (e != 0) return e;
    mel_fft_kernel<<<grid, kThreads, bytes, s>>>(
        wav, n_samples, window, mel_t, bands, out, n_frames, n_fft, log2n,
        hop, n_mels, eps);
  } else {
    const size_t bytes = dft_smem(n_fft);
    const int e = launch_with((const void*)mel_dft_kernel, bytes);
    if (e != 0) return e;
    mel_dft_kernel<<<grid, kThreads, bytes, s>>>(
        wav, n_samples, window, mel_t, bands, out, n_frames, n_fft, hop,
        n_mels, eps);
  }
  return (int)cudaGetLastError();
}
