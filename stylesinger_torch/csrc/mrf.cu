// One dilation step of a HiFi-GAN MRF group over overlap-save blocks, on the
// tensor cores (wgmma, 3xTF32).
//
// Replaces the TPU kernel stylesinger_tpu/ops/mrf_pallas.py::fused_mrf_blocks
// (body _mrf_kernel).  That kernel runs a whole MRF group (3 ResBlock1 with
// kernels 3/7/11 x dilations 1/3/5 x 2 convs = 18 "SAME" convs, each after a
// leaky-relu(0.1) and a validity-mask multiply, residual adds, the mean of the
// 3 blocks and a halo crop) on one [block + 2*halo, C] block held in VMEM.
//
// What bounds it on an H100: operations.  A group does 2*k*C*C FLOP per conv
// and time step (about 2*T*C^2*126 per stage), more than 300 FLOP per byte of
// input and output at C = 128.  On the CUDA cores (67 TFLOP/s f32) that alone
// is about 21 ms for the three vocoder stages; the TF32 tensor cores give
// 495 TFLOP/s, and 3xTF32 (below) does three products for each one.
//
// Design.  A whole block and the 18 weight matrices do not fit in an SM's
// 227 KB of shared memory at C = 128, so the wrapper (kernels/mrf.py) launches
// this kernel once per dilation step, 9 times per group.  One launch computes
// for every block n and output time t in [t_begin, t_begin + t_len):
//
//   act(u)  = leaky_relu(u, 0.1) * mask[n, time of u], 0 outside [0, L)
//   h[t']   = act(conv_d(act(x))[t'] + b1)            (conv1, dilation d)
//   v       = x[t] + conv_1(h)[t] + b2                (conv2, dilation 1)
//   v      += acc[n, t]                               (optional block sum)
//   out[n, t - out_off] = v * scale
//
// A thread block owns R output rows and all C output channels.  It stages the
// activated input rows it needs (R + (k-1) + (k-1)*d) once in shared memory,
// computes h over R + k - 1 rows with conv1, writes h over the input tile (h
// never reaches device memory), and runs conv2 from there.  So a step reads x
// once and writes its output once, where two separate convs would also write
// and read h.  The residual, the running block sum, the 1/3 mean and the halo
// crop ride in the epilogue.
//
// Each conv is an implicit GEMM per tap: M = time rows, N = C_out, K = C_in;
// A is the shared-memory tile shifted by tap * dilation rows, B is W[tap].
// Each warpgroup issues wgmma.m64nNk8 TF32 with B from shared memory and A
// from registers: the tile holds f32 values, and each warp loads its A
// fragments with plain 32-bit shared loads at any row shift (row stride 4 mod
// 32 words: no bank conflicts) and splits them as it loads them; a tile of
// both TF32 halves would not fit beside the weights at C = 128.  f32 accuracy
// is kept by 3xTF32: each operand is split into hi = tf32(a) and
// lo = tf32(a - hi), and the tensor cores sum lo*hi + hi*lo + hi*hi into an
// f32 accumulator.  One TF32 product alone would err by about 5e-4 relative
// (truncated: 1e-3), past the 1e-4 * max|y| check against the f32 twin.  The
// wrapper splits the weights once per call and lays them out as the
// shared-memory image wgmma reads (K-major 8 x 16-byte core matrices, both
// halves of one tap x 32 input channels per chunk).  The chunks stream
// through a ring of 4 stages with cp.async and one barrier per chunk: while
// the wgmmas of one chunk run, the next chunk's A fragments are loaded and
// the two after it are in flight.  The input tile also arrives by cp.async,
// and the epilogues issue all their loads before their stores.
//
// A block is 2 warpgroups, 128 rows x BN = 32, 64 or 128 output channels
// (C is padded to BN, and K to 32; the wrapper pads the weights with zeros).
// C > 128 is refused: at BN = 128 the widest tile ((128 + 64) rows x 132
// words) and the weight ring take 232,448 bytes, all of an SM's 227 KB.  A
// wider C would need output-channel tiles that share one h.
//
// bf16 mode (vocoder_compute_dtype: bfloat16, the repo's recipe).  The
// Pallas kernel's compute_dtype=bfloat16 form rounds at fixed points: its
// operands are bf16, each conv's product is summed in f32 and rounded to
// bf16 after its bias, lrelu and the mask run in bf16, the residual stream
// x + y is rounded to bf16, the three resblocks are summed in f32 and the
// mean is rounded to bf16.  mrf_step_bf16_kernel rounds at the same points:
// one wgmma.m64nNk16 bf16 product per 16 input channels, f32 accumulators,
// no 3-term split; h stays in shared memory as bf16; the running block sum
// is an f32 buffer and every other buffer is bf16.  The tile and the weight
// ring take about a quarter of the f32 design's bytes per row of weights and
// half its tile, so two blocks fit on an SM at C = 128
// (ss_mrf_occupancy reports it).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;  // 2 warpgroups, 64 rows each
constexpr int kBM = 128;       // rows of h per block
constexpr int kKc = 32;        // input channels per staged weight chunk
constexpr int kMaxReach = 64;  // (k - 1) * d
constexpr int kMaxC = 128;

struct Args {
  const float* x;       // [nb, L, C]
  const float* mask;    // [nb, L]
  const float* w1;      // laid out: [k, kpad / 32, 2, 32 * BN]
  const float* b1;      // [C]
  const float* w2;      // laid out, as w1
  const float* b2;      // [C]
  const float* acc_in;  // [nb, L, C] or null; may alias out
  float* out;           // [nb, out_len, C]
  int L, C, k, d, t_begin, t_len, out_len, out_off;
  float scale;
  int vec4;             // C % 4 == 0 and x 16-byte aligned
};

constexpr int kStages = 4;     // weight chunks in flight
// elements of one staged weight chunk: the {hi, lo} TF32 halves of
// kKc x BN for f32, kKc x BN values for bf16
template <typename T>
__host__ __device__ constexpr int chunk_elems(int bn) {
  return std::is_same<T, float>::value ? 2 * kKc * bn : kKc * bn;
}
// floats of the f32 weight ring
constexpr int ring_floats(int bn) { return kStages * chunk_elems<float>(bn); }

__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// x ~= hi + lo with both halves TF32, each truncated (the low 13 mantissa
// bits cleared): x - hi is exact in f32, and lo's truncation leaves an error
// of at most 2^-20 |x|.  Two masks and a subtraction: on an H100 the group
// ran about 9 % faster than with two cvt.rna.tf32.f32 per operand.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// A shared-memory matrix descriptor for B: K-major, no swizzle, 8 x 16-byte
// core matrices, the next core matrix along K 128 bytes on, the next along N
// (8 output channels) kKc x 4 bytes on: kKc / 4 core matrices for f32 and
// kKc / 8 for bf16.
template <typename T>
__device__ __forceinline__ uint64_t b_desc(const T* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  constexpr int sbo = kKc * (int)sizeof(T) * 8;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

template <int N>
__device__ __forceinline__ void wgmma(float (&d)[N / 2],
                                      const uint32_t (&a)[4], uint64_t desc);

template <>
__device__ __forceinline__ void wgmma<32>(float (&d)[16],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma<64>(float (&d)[32],
                                          const uint32_t (&a)[4],
                                          uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma<128>(float (&d)[64],
                                           const uint32_t (&a)[4],
                                           uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_bf16(float (&d)[N / 2],
                                           const uint32_t (&a)[4],
                                           uint64_t desc);

template <>
__device__ __forceinline__ void wgmma_bf16<32>(float (&d)[16],
                                        const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<64>(float (&d)[32],
                                        const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <>
__device__ __forceinline__ void wgmma_bf16<128>(float (&d)[64],
                                        const uint32_t (&a)[4], uint64_t desc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(1)
      : "memory");
}

template <int N>
__device__ __forceinline__ void fence_operands(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ float act(float u, float m) {
  return (u > 0.f ? u : 0.1f * u) * m;
}

// 16 (4) bytes from global to shared memory with cp.async; zeros where
// !valid.
__device__ __forceinline__ void copy16(void* dst, const void* src,
                                       bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void copy4(float* dst, const float* src,
                                      bool valid) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 4 : 0));
}

// Copies chunk q of a laid-out weight (kernels/mrf.py::_kernel_layout:
// [k, kpad / 32, 2, 32 * BN], chunk q = tap * kpad / 32 + ci / 32, the TF32
// halves of W[tap, ci0:ci0+32, :BN] in the order wgmma reads them; bf16:
// _kernel_layout_bf16, [k, kpad / 32, 32 * BN]) into dst with cp.async.
template <typename T, int BN>
__device__ __forceinline__ void stage(T* dst, const T* w, int q) {
  constexpr int kElems = chunk_elems<T>(BN);
  constexpr int kVec = 16 / (int)sizeof(T);
  const T* src = w + (size_t)q * kElems;
  for (int i = threadIdx.x * kVec; i < kElems; i += kThreads * kVec) {
    copy16(dst + i, src + i, true);
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Makes this thread's finished cp.async writes visible to wgmma (the async
// proxy); a barrier after it makes everyone's.
template <int N>
__device__ __forceinline__ void landed() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A fragments of one chunk, per warp: f32 keeps both TF32 halves of 4 k8
// steps, bf16 the values of 2 k16 steps.
template <typename T>
struct Frag;
template <>
struct Frag<float> {
  uint32_t hi[kKc / 8][4];
  uint32_t lo[kKc / 8][4];
};
template <>
struct Frag<bf16> {
  uint32_t a[kKc / 16][4];
};

// the first column of this thread's A fragments: t4 (f32), 2 * t4 (bf16)
template <typename T>
__device__ __forceinline__ int a_col(int t4) {
  return std::is_same<T, float>::value ? t4 : 2 * t4;
}

// This warp's A fragments of one chunk (4 k8 steps), split into TF32
// halves: rows g and g+8, columns t4 and t4+4 of each k8 step.
__device__ __forceinline__ void load_a(Frag<float>& f, const float* p,
                                       int S) {
#pragma unroll
  for (int kk = 0; kk < kKc / 8; ++kk) {
    split(p[kk * 8], f.hi[kk][0], f.lo[kk][0]);
    split(p[8 * S + kk * 8], f.hi[kk][1], f.lo[kk][1]);
    split(p[kk * 8 + 4], f.hi[kk][2], f.lo[kk][2]);
    split(p[8 * S + kk * 8 + 4], f.hi[kk][3], f.lo[kk][3]);
  }
}

__device__ __forceinline__ uint32_t ld_pair(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// bf16: 2 k16 steps, each register a pair of channels: rows g and g+8,
// columns 2 t4 (+1) and 2 t4 + 8 (+1).  One 32-bit load per pair at any
// row shift.
__device__ __forceinline__ void load_a(Frag<bf16>& f, const bf16* p, int S) {
#pragma unroll
  for (int kk = 0; kk < kKc / 16; ++kk) {
    f.a[kk][0] = ld_pair(p + kk * 16);
    f.a[kk][1] = ld_pair(p + 8 * S + kk * 16);
    f.a[kk][2] = ld_pair(p + kk * 16 + 8);
    f.a[kk][3] = ld_pair(p + 8 * S + kk * 16 + 8);
  }
}

template <int M, int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[M][N]) {
#pragma unroll
  for (int i = 0; i < M; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) asm volatile("" : "+r"(r[i][j]) :: "memory");
}

__device__ __forceinline__ void fence_frag(Frag<float>& f) {
  fence_regs(f.hi);
  fence_regs(f.lo);
}

__device__ __forceinline__ void fence_frag(Frag<bf16>& f) { fence_regs(f.a); }

// The k8 steps of one chunk, 3 products each (lo*hi, hi*lo, hi*hi), as one
// wgmma group.  ops: the chunk's hi half, then its lo half.
template <int BN>
__device__ __forceinline__ void issue(float (&acc)[BN / 2], Frag<float>& f,
                                      const float* ops) {
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kKc / 8; ++kk) {
    const uint64_t dh = b_desc(ops + kk * 64);
    wgmma<BN>(acc, f.lo[kk], dh);
    wgmma<BN>(acc, f.hi[kk], b_desc(ops + kKc * BN + kk * 64));
    wgmma<BN>(acc, f.hi[kk], dh);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// bf16: the 2 k16 steps of one chunk, one product each, as one wgmma group.
template <int BN>
__device__ __forceinline__ void issue(float (&acc)[BN / 2], Frag<bf16>& f,
                                      const bf16* ops) {
  fence_operands(acc);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kKc / 16; ++kk) {
    wgmma_bf16<BN>(acc, f.a[kk], b_desc(ops + kk * 128));
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// acc += sum over taps and input channels of a_s[row + tap*step][ci] *
// w[tap][ci][col] for this warpgroup's 64 rows and all columns.  The caller
// has staged chunk 0 into stage 0 of ring.  The chunks cycle through a ring
// of kStages stages, with one barrier per chunk: while the wgmmas of chunk q
// run, each warp loads the A fragments of chunk q + 1 into its other
// register set, the copies of chunks q + 1 and q + 2 are in flight, and after
// the barrier chunk q + 3 is copied into the stage that q - 1 used.  Ends
// with a barrier, so the caller may overwrite a_s and ring afterwards.
template <typename T, int BN>
__device__ __forceinline__ void conv_pass(float (&acc)[BN / 2],
                                          const T* a_s, int S,
                                          const T* w, int k, int step,
                                          int kpad, T* ring) {
  constexpr int kStage = chunk_elems<T>(BN);
  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const T* a_row = a_s + (warp * 16 + g) * S + a_col<T>(t4);
  const int nkc = kpad / kKc;
  const int nq = k * nkc;
  auto a_at = [&](int q) {
    return a_row + (q / nkc) * step * S + q % nkc * kKc;
  };
  Frag<T> fr[2];

  for (int q = 1; q < kStages - 1 && q < nq; ++q) {
    stage<T, BN>(ring + q * kStage, w, q);
  }
  if (nq >= 3) {  // chunk 0 has landed
    landed<2>();
  } else if (nq == 2) {
    landed<1>();
  } else {
    landed<0>();
  }
  __syncthreads();
  load_a(fr[0], a_at(0), S);

  // one chunk; B = q % 2 is known at compile time, so that the register
  // sets stay in registers
  auto chunk = [&](auto parity, int q) {
    constexpr int B = decltype(parity)::value;
    issue<BN>(acc, fr[B], ring + q % kStages * kStage);
    if (q + 1 < nq) {
      // the wgmmas of q - 1 are done: their register set is free
      asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
      fence_frag(fr[1 - B]);
      load_a(fr[1 - B], a_at(q + 1), S);
      if (q + 2 < nq) {  // chunk q + 1 has landed
        landed<1>();
      } else {
        landed<0>();
      }
      // ... for every thread, and stage (q - 1) % kStages is free
      __syncthreads();
      if (q + kStages - 1 < nq) {
        stage<T, BN>(ring + (q + kStages - 1) % kStages * kStage, w,
                     q + kStages - 1);
      }
    }
  };
  for (int q = 0; q < nq; q += 2) {
    chunk(std::integral_constant<int, 0>(), q);
    if (q + 1 < nq) chunk(std::integral_constant<int, 1>(), q + 1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_operands(acc);
  fence_frag(fr[0]);
  fence_frag(fr[1]);
  __syncthreads();  // every warp is done reading a_s and ring
}

template <int BN, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
mrf_step_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  const int C = a.C;
  const int k = a.k;
  const int L = a.L;
  const int kpad = (C + kKc - 1) / kKc * kKc;
  const int S = kpad + 4;                 // 4 mod 32 words: no bank conflicts
  const int reach = (k - 1) * a.d;
  const int p2 = (k - 1) / 2;
  const int rows_out = kBM - (k - 1);  // R
  const int tile_rows = kBM + reach;
  float* tile = smem;                  // act(x) rows, then h rows
  float* ring = smem + round32(tile_rows * S);
  const bool vec4 = a.vec4 != 0;

  const int n = blockIdx.y;
  const int tb = a.t_begin + blockIdx.x * rows_out;  // first output row
  const int t0 = tb - p2 - p2 * a.d;                 // time of tile row 0
  const float* xn = a.x + (size_t)n * L * C;
  const float* mn = a.mask + (size_t)n * L;

  stage<float, BN>(ring, a.w1, 0);

  // the input rows, channels zero-padded to kpad: copied with cp.async
  // (zeros outside the signal and the channels), then activated in place
  const int kq = kpad / 4;
  for (int i = threadIdx.x; i < tile_rows * kq; i += kThreads) {
    const int r = i / kq;
    const int c = (i % kq) * 4;
    const int t = t0 + r;
    float* dst = tile + r * S + c;
    const float* src = xn + (size_t)t * C + c;
    const bool in = t >= 0 && t < L;
    if (vec4) {
      copy16(dst, in && c < C ? src : xn, in && c < C);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        copy4(dst + j, in && c + j < C ? src + j : xn, in && c + j < C);
      }
    }
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  landed<0>();
  __syncthreads();
  for (int i = threadIdx.x; i < tile_rows * kq; i += kThreads) {
    const int r = i / kq;
    const int t = t0 + r;
    if (t < 0 || t >= L) continue;
    float4* p = reinterpret_cast<float4*>(tile + r * S + (i % kq) * 4);
    const float m = mn[t];
    const float4 v = *p;
    *p = make_float4(act(v.x, m), act(v.y, m), act(v.z, m), act(v.w, m));
  }

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

  // conv1 over all kBM rows of h
  conv_pass<float, BN>(acc, tile, S, a.w1, k, a.d, kpad, ring);
  stage<float, BN>(ring, a.w2, 0);

  // accumulator element j: row g (+8 for j % 4 >= 2) of this warp's 16 rows,
  // column 8 * (j / 4) + 2 * t4 (+1 for odd j)
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int row0 = (threadIdx.x >> 5) * 16 + g;

  // h = act(conv1 + b1) over the input tile; zero outside [0, L) (conv2's
  // SAME padding) and in the padded channels.  All loads first, then all
  // stores, so that the loads are in flight together.
  const int t_top = tb - p2 + row0;  // rows g and g + 8 of this warp
  const bool in_top = t_top >= 0 && t_top < L;
  const bool in_bot = t_top + 8 >= 0 && t_top + 8 < L;
  const float m_top = in_top ? mn[t_top] : 0.f;
  const float m_bot = in_bot ? mn[t_top + 8] : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const int c = (j >> 2) * 8 + 2 * t4 + (j & 1);
    const bool in = (j & 2) ? in_bot : in_top;
    acc[j] = c < C && in ? act(acc[j] + a.b1[c], (j & 2) ? m_bot : m_top)
                         : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const int r = row0 + ((j >> 1) & 1) * 8;
    const int c = (j >> 2) * 8 + 2 * t4 + (j & 1);
    if (c < kpad) tile[r * S + c] = acc[j];
    acc[j] = 0.f;
  }

  // conv2 (all kBM rows; the rows past R are discarded)
  conv_pass<float, BN>(acc, tile, S, a.w2, k, 1, kpad, ring);

  // the residual, the bias and the block sum: all loads first, then all
  // stores (acc_in may alias out, so a store would hold back later loads)
  const int t_end = a.t_begin + a.t_len;
  auto col = [&](int j) { return (j >> 2) * 8 + 2 * t4 + (j & 1); };
  auto live = [&](int j) {
    const int r = row0 + ((j >> 1) & 1) * 8;
    return r < rows_out && tb + r < t_end && col(j) < C;
  };
  auto index = [&](int j) {  // of x[n, t, c]
    const int t = tb + row0 + ((j >> 1) & 1) * 8;
    return ((long long)n * L + t) * C + col(j);
  };
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    if (!live(j)) continue;
    const long long idx = index(j);
    float v = a.x[idx] + (acc[j] + a.b2[col(j)]);
    if (a.acc_in != nullptr) v += a.acc_in[idx];
    acc[j] = v * a.scale;
  }
  // out[n, t - out_off, c] sits shift floats before x[n, t, c]
  const long long shift = ((long long)n * (L - a.out_len) + a.out_off) * C;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    if (live(j)) a.out[index(j) - shift] = acc[j];
  }
}

template <int BN, int MIN_BLOCKS>
int launch(const Args& a, int nb, cudaStream_t stream) {
  const int kpad = (a.C + kKc - 1) / kKc * kKc;
  const size_t bytes = (size_t)(round32((kBM + (a.k - 1) * a.d) * (kpad + 4)) +
                                ring_floats(BN)) * 4;
  const size_t most = (size_t)(round32((kBM + kMaxReach) * (BN + 4)) +
                               ring_floats(BN)) * 4;
  cudaError_t e = cudaFuncSetAttribute(
      mrf_step_kernel<BN, MIN_BLOCKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e != cudaSuccess) return (int)e;
  const int rows_out = kBM - (a.k - 1);
  const dim3 grid((a.t_len + rows_out - 1) / rows_out, nb);
  mrf_step_kernel<BN, MIN_BLOCKS><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}


// ---------------------------------------------------------------------------
// bf16 mode
// ---------------------------------------------------------------------------

struct ArgsBf16 {
  const bf16* x;        // [nb, L, C]
  const bf16* mask;     // [nb, L]
  const bf16* w1;       // laid out: [k, kpad / 32, 32 * BN]
  const float* b1;      // [C]
  const bf16* w2;       // laid out, as w1
  const float* b2;      // [C]
  const float* acc_in;  // [nb, L, C] f32 or null; may alias out
  void* out;            // [nb, out_len, C]: f32 if out_f32, else bf16
  int out_f32;
  int L, C, k, d, t_begin, t_len, out_len, out_off;
  float scale;
  int vec8;             // C % 8 == 0 and x 16-byte aligned
};

// The bf16 value nearest 0.1: jax.nn.leaky_relu multiplies a bf16 array by
// its slope cast to bf16.
constexpr float kSlopeBf16 = 0.10009765625f;

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// lrelu(u) * m for a bf16 value u, each product rounded to bf16
__device__ __forceinline__ float act_bf16(float u, float m) {
  return round_bf16((u > 0.f ? u : round_bf16(u * kSlopeBf16)) * m);
}

// bytes of the bf16 tile: rows of kpad + 8 values (a row is 4 mod 32 words
// at kpad 64 and 128, 20 at kpad 32: no bank conflicts for the A loads),
// rounded up to 128 bytes so that the weight ring after it is aligned
__host__ __device__ constexpr int tile_bytes_bf16(int rows, int kpad) {
  return (rows * (kpad + 8) * 2 + 127) / 128 * 128;
}

template <int BN>
constexpr size_t smem_bytes_bf16(int reach, int kpad) {
  return (size_t)tile_bytes_bf16(kBM + reach, kpad) +
         (size_t)kStages * chunk_elems<bf16>(BN) * 2;
}

// The same step as mrf_step_kernel, in the bf16 mode (see the header).
template <int BN, int MIN_BLOCKS>
__global__ void __launch_bounds__(kThreads, MIN_BLOCKS)
mrf_step_bf16_kernel(const ArgsBf16 a) {
  extern __shared__ __align__(128) unsigned char smem_raw[];
  const int C = a.C;
  const int k = a.k;
  const int L = a.L;
  const int kpad = (C + kKc - 1) / kKc * kKc;
  const int S = kpad + 8;
  const int reach = (k - 1) * a.d;
  const int p2 = (k - 1) / 2;
  const int rows_out = kBM - (k - 1);
  const int tile_rows = kBM + reach;
  bf16* tile = reinterpret_cast<bf16*>(smem_raw);  // act(x) rows, then h
  bf16* ring = reinterpret_cast<bf16*>(smem_raw +
                                       tile_bytes_bf16(tile_rows, kpad));

  const int n = blockIdx.y;
  const int tb = a.t_begin + blockIdx.x * rows_out;
  const int t0 = tb - p2 - p2 * a.d;
  const bf16* xn = a.x + (size_t)n * L * C;
  const bf16* mn = a.mask + (size_t)n * L;

  stage<bf16, BN>(ring, a.w1, 0);

  // the input rows, activated in bf16 as they are loaded; zeros outside
  // the signal and in the padded channels
  const int kv = kpad / 8;
  for (int i = threadIdx.x; i < tile_rows * kv; i += kThreads) {
    const int r = i / kv;
    const int c = (i % kv) * 8;
    const int t = t0 + r;
    uint32_t packed[4] = {0u, 0u, 0u, 0u};
    if (t >= 0 && t < L && c < C) {
      const float m = __bfloat162float(mn[t]);
      const bf16* src = xn + (size_t)t * C + c;
      float v[8];
      if (a.vec8) {
        const uint4 raw = *reinterpret_cast<const uint4*>(src);
        const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
        for (int j = 0; j < 8; ++j) v[j] = __bfloat162float(e[j]);
      } else {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          v[j] = c + j < C ? __bfloat162float(src[j]) : 0.f;
        }
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const __nv_bfloat162 h = __floats2bfloat162_rn(
            act_bf16(v[2 * j], m), act_bf16(v[2 * j + 1], m));
        packed[j] = *reinterpret_cast<const uint32_t*>(&h);
      }
    }
    *reinterpret_cast<uint4*>(tile + r * S + c) =
        make_uint4(packed[0], packed[1], packed[2], packed[3]);
  }

  float acc[BN / 2];
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) acc[j] = 0.f;

  // conv1 over all kBM rows of h
  conv_pass<bf16, BN>(acc, tile, S, a.w1, k, a.d, kpad, ring);
  stage<bf16, BN>(ring, a.w2, 0);

  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int row0 = (threadIdx.x >> 5) * 16 + g;

  // h = act(bf16(conv1 + b1)) over the input tile, as bf16; zero outside
  // [0, L) (conv2's SAME padding) and in the padded channels
  const int t_top = tb - p2 + row0;
  const bool in_top = t_top >= 0 && t_top < L;
  const bool in_bot = t_top + 8 >= 0 && t_top + 8 < L;
  const float m_top = in_top ? __bfloat162float(mn[t_top]) : 0.f;
  const float m_bot = in_bot ? __bfloat162float(mn[t_top + 8]) : 0.f;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    const int c = (j >> 2) * 8 + 2 * t4 + (j & 1);
    const bool in = (j & 2) ? in_bot : in_top;
    acc[j] = c < C && in
                 ? act_bf16(round_bf16(acc[j] + a.b1[c]),
                            (j & 2) ? m_bot : m_top)
                 : 0.f;
  }
#pragma unroll
  for (int j = 0; j < BN / 2; j += 2) {
    const int r = row0 + ((j >> 1) & 1) * 8;
    const int c = (j >> 2) * 8 + 2 * t4;
    if (c < kpad) {
      *reinterpret_cast<__nv_bfloat162*>(tile + r * S + c) =
          __floats2bfloat162_rn(acc[j], acc[j + 1]);
    }
    acc[j] = 0.f;
    acc[j + 1] = 0.f;
  }

  // conv2 (all kBM rows; the rows past R are discarded)
  conv_pass<bf16, BN>(acc, tile, S, a.w2, k, 1, kpad, ring);

  // y = bf16(conv2 + b2); v = bf16(x + y) (+ the f32 block sum) * scale
  const int t_end = a.t_begin + a.t_len;
  auto col = [&](int j) { return (j >> 2) * 8 + 2 * t4 + (j & 1); };
  auto live = [&](int j) {
    const int r = row0 + ((j >> 1) & 1) * 8;
    return r < rows_out && tb + r < t_end && col(j) < C;
  };
  auto index = [&](int j) {
    const int t = tb + row0 + ((j >> 1) & 1) * 8;
    return ((long long)n * L + t) * C + col(j);
  };
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    if (!live(j)) continue;
    const long long idx = index(j);
    float v = round_bf16(__bfloat162float(a.x[idx]) +
                         round_bf16(acc[j] + a.b2[col(j)]));
    if (a.acc_in != nullptr) v += a.acc_in[idx];
    acc[j] = v * a.scale;
  }
  const long long shift = ((long long)n * (L - a.out_len) + a.out_off) * C;
#pragma unroll
  for (int j = 0; j < BN / 2; ++j) {
    if (!live(j)) continue;
    if (a.out_f32) {
      static_cast<float*>(a.out)[index(j) - shift] = acc[j];
    } else {
      static_cast<bf16*>(a.out)[index(j) - shift] =
          __float2bfloat16_rn(acc[j]);
    }
  }
}

template <int BN, int MIN_BLOCKS>
int launch_bf16(const ArgsBf16& a, int nb, cudaStream_t stream) {
  const int kpad = (a.C + kKc - 1) / kKc * kKc;
  const size_t bytes = smem_bytes_bf16<BN>((a.k - 1) * a.d, kpad);
  const size_t most = smem_bytes_bf16<BN>(kMaxReach, BN);
  cudaError_t e = cudaFuncSetAttribute(
      mrf_step_bf16_kernel<BN, MIN_BLOCKS>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e != cudaSuccess) return (int)e;
  const int rows_out = kBM - (a.k - 1);
  const dim3 grid((a.t_len + rows_out - 1) / rows_out, nb);
  mrf_step_bf16_kernel<BN, MIN_BLOCKS><<<grid, kThreads, bytes, stream>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of the step kernel that fit on one SM with `bytes` of dynamic
// shared memory each.
template <typename K>
int occupancy(K kernel, size_t bytes, size_t most, int* blocks) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)most);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, kernel, kThreads, bytes);
}

int tile_width(int C) { return C <= 32 ? 32 : C <= 64 ? 64 : 128; }

bool bad_step(int C, int bn, int k, int d, int nb, int L, int t_begin,
              int t_len, int out_len, int out_off, const void* w1,
              const void* w2) {
  return C <= 0 || C > kMaxC || bn != tile_width(C) || k < 1 || d < 1 ||
         (k - 1) * d > kMaxReach || ((uintptr_t)w1 | (uintptr_t)w2) % 16 ||
         nb <= 0 || t_len <= 0 || t_begin < 0 || t_begin + t_len > L ||
         t_begin - out_off < 0 || t_begin + t_len - out_off > out_len;
}

}  // namespace

// One dilation step (see the header).  x, acc_in [nb, L, C]; mask [nb, L];
// w1, w2 laid out by the wrapper for tile width bn = 32, 64 or 128, the
// least that holds C (see stage()); b1, b2 [C]; out [nb, out_len, C].
// acc_in may be null and may alias out; out must not alias x.  Returns a
// CUDA error code (0 after a launch that was accepted).
extern "C" int ss_mrf_step(const float* x, const float* mask, const float* w1,
                           const float* b1, const float* w2, const float* b2,
                           const float* acc_in, float* out, int nb, int L,
                           int C, int bn, int k, int d, int t_begin,
                           int t_len, int out_len, int out_off, float scale,
                           void* stream) {
  if (bad_step(C, bn, k, d, nb, L, t_begin, t_len, out_len, out_off, w1,
               w2)) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, mask, w1, b1, w2, b2, acc_in, out,
               L, C, k, d, t_begin, t_len, out_len, out_off, scale,
               (C % 4 == 0 && (uintptr_t)x % 16 == 0) ? 1 : 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 32) return launch<32, 2>(a, nb, s);
  if (bn == 64) return launch<64, 2>(a, nb, s);
  return launch<128, 1>(a, nb, s);
}

// The same step in the bf16 mode.  x [nb, L, C] and mask [nb, L] bf16;
// w1, w2 laid out by the wrapper as bf16 (kernels/mrf.py::
// _kernel_layout_bf16); b1, b2 [C] f32; acc_in [nb, L, C] f32 or null;
// out [nb, out_len, C] f32 when out_f32 is set, else bf16.
extern "C" int ss_mrf_step_bf16(const void* x, const void* mask,
                                const void* w1, const float* b1,
                                const void* w2, const float* b2,
                                const float* acc_in, void* out, int out_f32,
                                int nb, int L, int C, int bn, int k, int d,
                                int t_begin, int t_len, int out_len,
                                int out_off, float scale, void* stream) {
  if (bad_step(C, bn, k, d, nb, L, t_begin, t_len, out_len, out_off, w1,
               w2)) {
    return (int)cudaErrorInvalidValue;
  }
  const ArgsBf16 a{static_cast<const bf16*>(x),
                   static_cast<const bf16*>(mask),
                   static_cast<const bf16*>(w1), b1,
                   static_cast<const bf16*>(w2), b2, acc_in, out, out_f32,
                   L, C, k, d, t_begin, t_len, out_len, out_off, scale,
                   (C % 8 == 0 && (uintptr_t)x % 16 == 0) ? 1 : 0};
  cudaStream_t s = (cudaStream_t)stream;
  if (bn == 32) return launch_bf16<32, 2>(a, nb, s);
  if (bn == 64) return launch_bf16<64, 2>(a, nb, s);
  return launch_bf16<128, 2>(a, nb, s);
}

// For C channels and a step of reach (k - 1) * d, in the f32 (bf16_mode =
// 0) or bf16 mode: the dynamic shared memory of one block (*smem, bytes)
// and how many blocks fit on one SM (*blocks).  Returns a CUDA error code.
extern "C" int ss_mrf_occupancy(int C, int k, int d, int bf16_mode,
                                int* blocks, int* smem) {
  const int bn = tile_width(C);
  const int kpad = (C + kKc - 1) / kKc * kKc;
  const int reach = (k - 1) * d;
  if (C <= 0 || C > kMaxC || reach > kMaxReach) {
    return (int)cudaErrorInvalidValue;
  }
  if (bf16_mode) {
    if (bn == 32) {
      *smem = (int)smem_bytes_bf16<32>(reach, kpad);
      return occupancy(mrf_step_bf16_kernel<32, 2>, *smem,
                       smem_bytes_bf16<32>(kMaxReach, 32), blocks);
    }
    if (bn == 64) {
      *smem = (int)smem_bytes_bf16<64>(reach, kpad);
      return occupancy(mrf_step_bf16_kernel<64, 2>, *smem,
                       smem_bytes_bf16<64>(kMaxReach, 64), blocks);
    }
    *smem = (int)smem_bytes_bf16<128>(reach, kpad);
    return occupancy(mrf_step_bf16_kernel<128, 2>, *smem,
                     smem_bytes_bf16<128>(kMaxReach, 128), blocks);
  }
  auto f32_bytes = [&](int rows, int width) {
    return (size_t)(round32(rows * (width + 4)) + ring_floats(bn)) * 4;
  };
  *smem = (int)f32_bytes(kBM + reach, kpad);
  const size_t most = f32_bytes(kBM + kMaxReach, bn);
  if (bn == 32) return occupancy(mrf_step_kernel<32, 2>, *smem, most, blocks);
  if (bn == 64) return occupancy(mrf_step_kernel<64, 2>, *smem, most, blocks);
  return occupancy(mrf_step_kernel<128, 1>, *smem, most, blocks);
}
