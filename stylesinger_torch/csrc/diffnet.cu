// One residual layer of the diffusion denoisers (DiffNet, DDiffNet,
// F0DiffNet, MDiffNet) for inference, on the tensor cores (wgmma, 3xTF32).
//
// Replaces no TPU kernel: the JAX package leaves this layer to XLA
// (stylesinger_tpu/models/diffnet.py::ResidualBlock).  It was added
// because the layer is most of the device time of batch synthesis: 300
// denoiser calls a batch of 16 x 3000 frames, 20 (mel, C = 256) or 10 (F0,
// C = 192) layers each.  Through the PyTorch modules (the path autograd
// keeps) a layer is a cuDNN f32 conv on the CUDA cores, a 1x1 conditioner
// conv, a 1x1 output conv, transposes around each and seven elementwise
// passes over 50-100 MB tensors.
//
// What one launch computes, on [B, T, C] channels-last rows (models/
// diffnet.py::ResidualBlock.forward and the skip sum of _Stack.run):
//
//   y        = x + pstep[b]                  (0 outside [0, T) of the item)
//   a        = dilated_conv_d(y) + cp        (k = 3, SAME, per item)
//   g        = sigmoid(a[:, :C]) * tanh(a[:, C:])
//   o        = g @ W_out + b_out             (1x1)
//   out      = (x + o[:, :C]) * scale        (scale = 1 / sqrt(2) in f32)
//   skips    = o[:, C:]  (first layer)  or  skips + o[:, C:]
//
// cp [B, T, 2C] is the conditioner projection with both convs' biases,
// which does not change over a sampler's chain: the wrapper computes it
// once per chain (kernels/diffnet.py) and the kernel starts its
// accumulators from it.  Extending K by the conditioner's rows instead
// (25 % more products, the conditioner read per layer call) took 1.04 ms a
// mel layer against 0.64 ms + 0.30 ms once a chain (PERF.md).
//
// What bounds it on an H100: operations.  A mel layer does 2 x 48,000 x
// (3 x 256 + 256) x 512 = 50 GFLOP of f32 products per call and moves
// ~300 MB (x, cp, out, skips); 3xTF32 (below) does three tensor-core
// products for each, so 151 GFLOP at TF32's 495 TFLOP/s (0.31 ms) against
// 0.09 ms of bytes at 3.35 TB/s.
//
// Design.  A thread block owns kBM = 128 rows of one item (a tile never
// reads across an item's end: rows outside [0, T) of the item are zeros,
// the conv's SAME padding) and all 2C columns, in C / 64 passes of 128
// columns: the 64 "gate" columns of a pass are matched with the 64 filter
// columns C above them, so every thread holds both halves of the gate in
// its own accumulators and the gate needs no exchange.  Each of the two
// warpgroups owns 64 rows.  The block stages y over kBM + 2d rows once in
// shared memory (f32), runs the dilated conv as an implicit GEMM per tap
// (A = the tile shifted by tap * d rows), gates each pass and writes g to
// its own rows of out (they come back from L2, not HBM), loads g over the
// tile once y is done with, and runs the output projection with g as A,
// C / 64 passes of 64 residual + 64 skip columns, whose epilogue writes
// out and skips from the registers.  So y, a and o never reach memory.
//
// Products are wgmma.m64n128k8 TF32 with A from registers (loaded from the
// f32 tile and split as loaded) and B from shared memory.  f32 accuracy is
// kept by 3xTF32: each operand is split into hi = tf32(a) and lo =
// tf32(a - hi), and lo*hi + hi*lo + hi*hi is summed into f32 accumulators;
// one TF32 product alone errs by ~5e-4 relative.  hi*hi goes to one set of
// accumulators and the two cross products to a second, added at the end:
// the tensor cores' f32 additions are not correctly rounded, and this way
// the large sum takes one of them per 8 inputs instead of three (against
// f64, the mel layer's error fell from 2.5e-6 to 8.6e-7 of max|y|, cuDNN
// f32's is 3.7e-7; 7 % slower).  The wrapper splits the weights once (and
// again when they change) into the shared-memory image that wgmma reads:
// chunks of 16 input rows x 128 columns, both halves, K-major 8 x 16-byte
// core matrices, in the order the block consumes them, so the whole layer
// is one stream of 16 KB chunks.  The stream runs through a ring of 4
// stages with cp.async and one barrier per chunk, across the passes
// without draining: while the wgmmas of one chunk run, each warp loads the
// next chunk's A fragments and the two after it are in flight.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kThreads = 256;  // 2 warpgroups, 64 rows each
constexpr int kBM = 128;       // rows of a block
constexpr int kBN = 128;       // columns of a pass: 64 matched pairs
constexpr int kKc = 16;        // input rows per staged weight chunk
constexpr int kStages = 4;     // weight chunks in flight
constexpr int kChunk = 2 * kKc * kBN;  // floats of a chunk: hi, then lo
constexpr int kMaxReach = 16;  // (k - 1) * d, d <= 8

struct Args {
  const float* x;      // [B, T, C]
  const float* pstep;  // [B, C]
  const float* cp;     // [B, T, 2C]
  const float* w;      // the laid-out weights (kernels/diffnet.py)
  const float* bo;     // [2C]
  float* out;          // [B, T, C]
  float* skips;        // [B, T, C]
  int T, d, first;
  float scale;
};

__host__ __device__ constexpr int round32(int n) { return (n + 31) / 32 * 32; }

// floats of the y tile (and later g): kBM + kMaxReach rows of C + 4 (4 mod
// 32 words: the A loads below hit 32 banks)
template <int C>
__host__ __device__ constexpr int tile_floats() {
  return round32((kBM + kMaxReach) * (C + 4));
}

template <int C>
constexpr size_t smem_bytes() {
  return (size_t)(tile_floats<C>() + kStages * kChunk) * 4;
}

// x ~= hi + lo with both halves TF32, each truncated (the low 13 mantissa
// bits cleared): x - hi is exact in f32, and lo's truncation leaves an
// error of at most 2^-20 |x|.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi)) & 0xffffe000u;
}

// A shared-memory matrix descriptor for B: K-major, no swizzle, 8 x 16-byte
// core matrices, the next core matrix along K 128 bytes on, the next along
// N (8 columns) kKc / 4 core matrices (512 bytes) on.
__device__ __forceinline__ uint64_t b_desc(const float* p) {
  const uint32_t addr = (uint32_t)__cvta_generic_to_shared(p);
  constexpr int sbo = kKc * 4 * 8;
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32);
}

__device__ __forceinline__ void wgmma(float (&d)[64], const uint32_t (&a)[4],
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
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

__device__ __forceinline__ void copy16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src));
}

// Copies chunk q of the laid-out weights into dst with cp.async, as one
// commit group.
__device__ __forceinline__ void stage(float* dst, const float* w, int q) {
  const float* src = w + (size_t)q * kChunk;
  for (int i = threadIdx.x * 4; i < kChunk; i += kThreads * 4) {
    copy16(dst + i, src + i);
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

// A fragments of one chunk (2 k8 steps), both TF32 halves: rows g and g+8,
// columns t4 and t4+4 of each k8 step.
struct Frag {
  uint32_t hi[kKc / 8][4];
  uint32_t lo[kKc / 8][4];
};

// top: this thread's row g at the chunk's first column; bot: row g + 8
__device__ __forceinline__ void load_a(Frag& f, const float* top,
                                       const float* bot) {
#pragma unroll
  for (int kk = 0; kk < kKc / 8; ++kk) {
    split(top[kk * 8], f.hi[kk][0], f.lo[kk][0]);
    split(bot[kk * 8], f.hi[kk][1], f.lo[kk][1]);
    split(top[kk * 8 + 4], f.hi[kk][2], f.lo[kk][2]);
    split(bot[kk * 8 + 4], f.hi[kk][3], f.lo[kk][3]);
  }
}

__device__ __forceinline__ void fence_frag(Frag& f) {
#pragma unroll
  for (int i = 0; i < kKc / 8; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      asm volatile("" : "+r"(f.hi[i][j]) :: "memory");
      asm volatile("" : "+r"(f.lo[i][j]) :: "memory");
    }
}

// The 2 k8 steps of one chunk, 3 products each, as one wgmma group: hi*hi
// into acc, lo*hi and hi*lo into accx.  ops: the chunk's hi half, then its
// lo half.
__device__ __forceinline__ void issue(float (&acc)[64], float (&accx)[64],
                                      Frag& f, const float* ops) {
  fence_acc(acc);
  fence_acc(accx);
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int kk = 0; kk < kKc / 8; ++kk) {
    const uint64_t dh = b_desc(ops + kk * 64);
    wgmma(accx, f.lo[kk], dh);
    wgmma(accx, f.hi[kk], b_desc(ops + kKc * kBN + kk * 64));
    wgmma(acc, f.hi[kk], dh);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// The A operand of a pass in the tile: chunk i reads this thread's rows
// g (at) and g + 8 (bot_at) of tap i / per_tap, shifted by tap * step rows.
struct SmemRows {
  const float* top;  // this thread's row g, column t4
  int S, per_tap, step;
  __device__ const float* at(int i) const {
    return top + (i / per_tap) * step * S + (i % per_tap) * kKc;
  }
  __device__ const float* bot_at(int i) const { return at(i) + 8 * S; }
};

// acc + accx += the n chunks q0 .. q0 + n - 1 of the weight stream times
// the tile rows `rows` gives.  On entry chunk q0 has landed for every
// thread and a barrier has passed since, and chunks up to q0 + kStages - 2
// are issued.
// Every chunk ends with the next one landed and a barrier, after which the
// chunk kStages - 1 ahead is copied into the stage the previous one used,
// so the stream runs on across passes (Q chunks in all).  Returns with
// this thread's wgmmas done.
__device__ __forceinline__ void run_pass(float (&acc)[64], float (&accx)[64],
                                         const SmemRows& rows,
                                         int q0, int n, int Q,
                                         const float* w, float* ring) {
  Frag fr[2];
  load_a(fr[0], rows.at(0), rows.bot_at(0));
  // one chunk; B = i % 2 is known at compile time, so that both register
  // sets stay in registers
  auto chunk = [&](auto parity, int i) {
    constexpr int B = decltype(parity)::value;
    const int q = q0 + i;
    issue(acc, accx, fr[B], ring + q % kStages * kChunk);
    // the wgmmas of chunk q - 1 are done: their registers and stage free
    asm volatile("wgmma.wait_group.sync.aligned 1;\n" ::: "memory");
    if (i + 1 < n) {
      fence_frag(fr[1 - B]);
      load_a(fr[1 - B], rows.at(i + 1), rows.bot_at(i + 1));
    }
    if (q + 1 < Q) {
      if (q + 2 < Q) {  // chunk q + 1 has landed ...
        landed<1>();
      } else {
        landed<0>();
      }
      __syncthreads();  // ... for every thread, and stage (q - 1) is free
      if (q + kStages - 1 < Q) {
        stage(ring + (q + kStages - 1) % kStages * kChunk, w,
              q + kStages - 1);
      }
    }
  };
  for (int i = 0; i < n; i += 2) {
    chunk(std::integral_constant<int, 0>(), i);
    if (i + 1 < n) chunk(std::integral_constant<int, 1>(), i + 1);
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  fence_acc(acc);
  fence_acc(accx);
  fence_frag(fr[0]);
  fence_frag(fr[1]);
}

template <int C>
__global__ void __launch_bounds__(kThreads, 1)
diffnet_layer_kernel(const Args a) {
  extern __shared__ __align__(128) float smem[];
  constexpr int S = C + 4;
  constexpr int NC = C / 64;          // passes of each product
  constexpr int PT = C / kKc;         // chunks per tap (and of the output)
  constexpr int Q1 = 3 * PT;          // chunks of a conv pass
  constexpr int Q = NC * (Q1 + PT);   // the whole stream
  float* tile = smem;
  float* ring = smem + tile_floats<C>();
  const int T = a.T;
  const int d = a.d;
  const int b = blockIdx.y;
  const int tb = blockIdx.x * kBM;    // time of the block's first row
  const int t0 = tb - d;              // time of tile row 0
  const float* xb = a.x + (size_t)b * T * C;

  for (int q = 0; q < kStages - 1; ++q) stage(ring + q * kChunk, a.w, q);

  // y = x + pstep over kBM + 2d rows; zeros outside the item
  const float* pb = a.pstep + (size_t)b * C;
  constexpr int kq = C / 4;
  const int tile_rows = kBM + 2 * d;
  for (int i = threadIdx.x; i < tile_rows * kq; i += kThreads) {
    const int r = i / kq;
    const int c = (i % kq) * 4;
    const int t = t0 + r;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (t >= 0 && t < T) {
      const float4 xv = *reinterpret_cast<const float4*>(xb + (size_t)t * C +
                                                         c);
      const float4 p = *reinterpret_cast<const float4*>(pb + c);
      v = make_float4(xv.x + p.x, xv.y + p.y, xv.z + p.z, xv.w + p.w);
    }
    *reinterpret_cast<float4*>(tile + r * S + c) = v;
  }
  landed<kStages - 2>();  // chunk 0 has landed ...
  __syncthreads();         // ... for every thread

  const int warp = threadIdx.x >> 5;
  const int g = (threadIdx.x & 31) >> 2;
  const int t4 = threadIdx.x & 3;
  const int row0 = warp * 16 + g;     // rows row0 and row0 + 8 of the block
  const int ttop = tb + row0;
  const bool in_top = ttop < T;
  const bool in_bot = ttop + 8 < T;
  // accumulator element j: row row0 (+8 for j % 4 >= 2), column
  // 8 * (j / 4) + 2 * t4 (+1 for odd j) of the pass's 128
  auto pcol = [&](int j) { return (j >> 2) * 8 + 2 * t4 + (j & 1); };

  float acc[64], accx[64];
  const SmemRows yrows{tile + row0 * S + t4, S, PT, d};
  float* ob = a.out + (size_t)b * T * C;
  float* sb = a.skips + (size_t)b * T * C;

  // the dilated conv, pass j: gate channels [64 j, 64 j + 64) and the
  // filter channels C above them; g goes to the block's own rows of out
  for (int j = 0; j < NC; ++j) {
    // the accumulators start from cp
#pragma unroll
    for (int e = 0; e < 64; e += 2) {
      const int col = (e < 32 ? 0 : C - 64) + 64 * j + pcol(e);
      float2 v = make_float2(0.f, 0.f);
      if ((e & 2) ? in_bot : in_top) {
        const int t = ttop + ((e & 2) ? 8 : 0);
        v = *reinterpret_cast<const float2*>(
            a.cp + ((size_t)b * T + t) * 2 * C + col);
      }
      acc[e] = v.x;
      acc[e + 1] = v.y;
      accx[e] = accx[e + 1] = 0.f;
    }
    run_pass(acc, accx, yrows, j * Q1, Q1, Q, a.w, ring);
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      if (!((e & 2) ? in_bot : in_top)) continue;
      float gv[2];
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float s = 1.f / (1.f + expf(-(acc[e + h] + accx[e + h])));
        gv[h] = s * tanhf(acc[e + h + 32] + accx[e + h + 32]);
      }
      const size_t idx = (size_t)(ttop + ((e & 2) ? 8 : 0)) * C + 64 * j +
                         pcol(e);
      *reinterpret_cast<float2*>(ob + idx) = make_float2(gv[0], gv[1]);
    }
  }

  // g over the tile (zeros past the item), once every warp is done
  // reading y and every g has been written
  __syncthreads();
  for (int i = threadIdx.x; i < kBM * kq; i += kThreads) {
    const int r = i / kq;
    const int c = (i % kq) * 4;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (tb + r < T) {
      v = *reinterpret_cast<const float4*>(ob + (size_t)(tb + r) * C + c);
    }
    *reinterpret_cast<float4*>(tile + r * S + c) = v;
  }
  __syncthreads();

  // the output projection, pass j: residual channels [64 j, 64 j + 64)
  // and the skip channels C above them
  const SmemRows grows{tile + row0 * S + t4, S, PT, 0};
  for (int j = 0; j < NC; ++j) {
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] = accx[e] = 0.f;
    run_pass(acc, accx, grows, NC * Q1 + j * PT, PT, Q, a.w, ring);
#pragma unroll
    for (int e = 0; e < 64; ++e) acc[e] += accx[e];
    // all loads first, then all stores
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const bool in = (e & 2) ? in_bot : in_top;
      if (!in) continue;
      const int ch = 64 * j + pcol(e);
      const size_t idx = (size_t)(ttop + ((e & 2) ? 8 : 0)) * C + ch;
      const float2 xv = *reinterpret_cast<const float2*>(xb + idx);
      const float2 br = *reinterpret_cast<const float2*>(a.bo + ch);
      const float2 bs = *reinterpret_cast<const float2*>(a.bo + C + ch);
      float2 sk = make_float2(acc[e + 32] + bs.x, acc[e + 33] + bs.y);
      if (!a.first) {
        const float2 old = *reinterpret_cast<const float2*>(sb + idx);
        sk = make_float2(old.x + sk.x, old.y + sk.y);
      }
      acc[e] = (xv.x + (acc[e] + br.x)) * a.scale;
      acc[e + 1] = (xv.y + (acc[e + 1] + br.y)) * a.scale;
      acc[e + 32] = sk.x;
      acc[e + 33] = sk.y;
    }
#pragma unroll
    for (int e = 0; e < 32; e += 2) {
      const bool in = (e & 2) ? in_bot : in_top;
      if (!in) continue;
      const size_t idx = (size_t)(ttop + ((e & 2) ? 8 : 0)) * C + 64 * j +
                         pcol(e);
      *reinterpret_cast<float2*>(ob + idx) = make_float2(acc[e], acc[e + 1]);
      *reinterpret_cast<float2*>(sb + idx) =
          make_float2(acc[e + 32], acc[e + 33]);
    }
  }
}

template <int C>
int launch(const Args& a, int nb, cudaStream_t stream) {
  static unsigned long long ready = 0;  // per device: the attribute is set
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  if (dev >= 64 || !(ready >> dev & 1ull)) {
    e = cudaFuncSetAttribute(diffnet_layer_kernel<C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem_bytes<C>());
    if (e != cudaSuccess) return (int)e;
    if (dev < 64) ready |= 1ull << dev;
  }
  const dim3 grid((a.T + kBM - 1) / kBM, nb);
  diffnet_layer_kernel<C><<<grid, kThreads, smem_bytes<C>(), stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// One residual layer (see the header).  x, out, skips [nb, T, C]; pstep
// [nb, C]; cp [nb, T, 2C]; w laid out by kernels/diffnet.py::layout for C;
// bo [2C].  C is 64, 128, 192 or 256 and d 1 to 8; every pointer 16-byte
// aligned; out must not alias x or skips.  Returns a CUDA error code (0
// after a launch that was accepted).
extern "C" int ss_diffnet_layer(const float* x, const float* pstep,
                                const float* cp, const float* w,
                                const float* bo, float* out, float* skips,
                                int nb, int T, int C, int d, int first,
                                float scale, void* stream) {
  const uintptr_t ptrs = (uintptr_t)x | (uintptr_t)pstep | (uintptr_t)cp |
                         (uintptr_t)w | (uintptr_t)bo | (uintptr_t)out |
                         (uintptr_t)skips;
  if (nb <= 0 || T <= 0 || d < 1 || 2 * d > kMaxReach || ptrs % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const Args a{x, pstep, cp, w, bo, out, skips, T, d, first, scale};
  cudaStream_t s = (cudaStream_t)stream;
  switch (C) {
    case 64: return launch<64>(a, nb, s);
    case 128: return launch<128>(a, nb, s);
    case 192: return launch<192>(a, nb, s);
    case 256: return launch<256>(a, nb, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
