// Weight gradient of the depthwise convolution (stride 1, SAME padding) for
// Hopper (sm_90a): bf16 NHWC x and dy in, fp32 (K, K, 1, C) out.
//
// Replaces: experiments/dw_conv_bwd_pallas_vs_xla.py::_flat_kernel,
// ::_chan_kernel and ::_roll_kernel (reached through pl_flat_wgrad,
// pl_chan_wgrad and pl_roll_wgrad). The three compute one function in three
// TPU lane layouts,
//   dW[kh, kw, 0, c] = sum_{n, oh, ow} x_pad[n, oh+kh, ow+kw, c] * dy[n, oh, ow, c]
// with x_pad the input with K/2 zeros around H and W, for K = 3 and 5.
// (_roll_kernel returns it with its taps flipped, a fault of that probe;
// this kernel computes the gradient itself.)
//
// Bound on an H100: memory. It reads x and dy once and writes K*K*C floats:
// at the probe's 512 images of 112 x 112 x 32 that is 822 MB, 0.245 ms at
// 3.35 TB/s; its 2*K*K*N*H*W*C fp32 operations take 0.055 ms at the CUDA
// cores' 67 TFLOP/s.
//
// Design: a streaming reduction. The TPU kernels carried the sum from one
// sequential grid step to the next in their output block; here blocks run
// in parallel, so each owns (a slice of the N*H output rows, a tile of 32
// channels) and writes its fp32 partial sums to (chunks, K, K, C); a second
// launch adds the chunks in order. No atomics, so a rerun gives the same
// bits; the number of chunks follows the shape alone (about eight blocks an
// SM).
//   * Stages. A block walks its rows a stage at a time: RS output rows (two
//     per thread) with their K - 1 halo input rows, full width, staged in
//     shared memory by 16-byte cp.async copies (8 channels each) into two
//     buffers, so that stage s + 1 lands while stage s computes; one barrier
//     pair covers RS rows. Rows are flat over N*H: a stage may cross images,
//     and a tap whose input row lies in another image is skipped. Columns
//     outside the image are zeros written once. Where C is not a multiple
//     of 8 (or a pointer is not 16-byte aligned) the same stages are filled
//     by plain loads instead.
//   * Register blocking along W. A thread owns one channel pair and a run of
//     R = 7 output columns of one row; per kh it reads the R + K - 1 x values
//     of its window once and makes R*K fused multiply-adds per channel from
//     them, keeping its pair's K*K sums in registers (50 at K = 5). Threads
//     of a warp read 16 channel pairs of one pixel and 16 of a pixel R (or a
//     row of an odd width) further, so the reads are free of bank conflicts.
//     Small images put several rows side by side: P = 256 / (16 * runs)
//     rows of a stage are computed at once.
//   * At the end the block adds its threads' sums per channel in a fixed
//     order through shared memory and writes its partial.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;
typedef __nv_bfloat162 bf162;
typedef long long i64;

namespace {

constexpr int THREADS = 256;
constexpr int CT = 32;                    // channels of a block's tile (64 B a pixel)
constexpr int PAIRS = CT / 2;             // channel pairs of a tile, one a thread
constexpr int PIECES = CT / 8;            // 16-byte copies a pixel
constexpr int R = 7;                      // output columns of a thread's run
constexpr int MAX_RUNS = THREADS / PAIRS; // 16 runs: W <= 112
constexpr int ROWS_PER_THREAD = 2;        // output rows a thread takes in a stage
constexpr int MAX_SMEM = 227 * 1024;
constexpr int TARGET_BLOCKS = 8 * 132;    // about eight blocks for each of the H100's SMs

// The stage geometry for width W and kernel size K.
struct Plan {
  int runs;       // column runs of a row
  int P;          // rows computed side by side
  int RS;         // output rows of a stage
  int XW;         // x tile columns: runs * R + K - 1, the image at [K/2, K/2 + W)
  int DW;         // dy tile columns: runs * R, the image at [0, W)
  int x_elems;    // bf16 of a stage's x tile
  int stage;      // bf16 of a stage (x tile, then dy tile)
  int smem;       // bytes: two stages, or the final reduction if larger
};

__host__ __device__ inline Plan make_plan(int W, int K) {
  Plan p;
  p.runs = (W + R - 1) / R;
  p.P = THREADS / (PAIRS * p.runs);
  p.RS = ROWS_PER_THREAD * p.P;
  p.XW = p.runs * R + K - 1;
  p.DW = p.runs * R;
  p.x_elems = (p.RS + K - 1) * p.XW * CT;
  p.stage = p.x_elems + p.RS * p.DW * CT;
  const int stages = 2 * p.stage * int(sizeof(bf16));
  const int red = p.runs * p.P * K * K * CT * int(sizeof(float));
  p.smem = stages > red ? stages : red;
  return p;
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
               "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Copy nrows rows of src from flat row fr0 on, channels [c0, c0 + CT), into
// dst rows of dstw pixels starting at column col0; rows outside [0, rows)
// and channels past C read as zeros. Thread i takes the 16-byte pieces i,
// i + THREADS, ... of the rows, stepping (step_rows, step_j) = divmod(THREADS,
// W * PIECES) so that no piece costs a division.
__device__ void load_rows(bf16* dst, int dstw, int col0, const bf16* __restrict__ src, i64 fr0,
                          int nrows, i64 rows, int W, int C, int c0, int step_rows, int step_j,
                          bool async) {
  const int rowp = W * PIECES;
  int tr = int(threadIdx.x) / rowp;
  int j = int(threadIdx.x) % rowp;
  while (tr < nrows) {
    const int w = j / PIECES;
    const int c = c0 + 8 * (j % PIECES);
    const i64 fr = fr0 + tr;
    const bf16* from = src + (fr * W + w) * C + c;
    bf16* to = dst + (tr * dstw + col0 + w) * CT + (c - c0);
    const bool row_ok = fr >= 0 && fr < rows;
    if (async) {
      const bool ok = row_ok && c < C;
      cp_async16(to, ok ? from : src, ok);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        to[e] = row_ok && c + e < C ? from[e] : __float2bfloat16(0.0f);
    }
    tr += step_rows;
    j += step_j;
    if (j >= rowp) {
      j -= rowp;
      ++tr;
    }
  }
}

// Stage output rows [sr0, sr0 + rs): x rows [sr0 - K/2, sr0 + rs + K/2) and
// dy rows [sr0, sr0 + rs) into buf.
template <int K>
__device__ void load_stage(bf16* buf, const Plan& pl, const bf16* __restrict__ x,
                           const bf16* __restrict__ dy, i64 sr0, int rs, i64 rows, int W, int C,
                           int c0, int step_rows, int step_j, bool async) {
  load_rows(buf, pl.XW, K / 2, x, sr0 - K / 2, rs + K - 1, rows, W, C, c0, step_rows, step_j,
            async);
  load_rows(buf + pl.x_elems, pl.DW, 0, dy, sr0, rs, rows, W, C, c0, step_rows, step_j, async);
}

template <int K>
__global__ void __launch_bounds__(THREADS, 2)
wgrad_partial_kernel(const bf16* __restrict__ x, const bf16* __restrict__ dy,
                     float* __restrict__ partial, int N, int H, int W, int C, int chunks,
                     int async) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int PAD = K / 2;
  constexpr int KK = K * K;
  const Plan pl = make_plan(W, K);
  bf16* bufs = reinterpret_cast<bf16*>(smem);
  const int tid = threadIdx.x;
  const int g = tid % PAIRS;
  const int run = tid / PAIRS % pl.runs;
  const int p = tid / (PAIRS * pl.runs);
  const bool active = p < pl.P;
  const int c0 = blockIdx.y * CT;
  const i64 rows = i64(N) * H;
  const i64 r0 = rows * blockIdx.x / chunks;
  const i64 r1 = rows * (blockIdx.x + 1) / chunks;
  const int nstages = int((r1 - r0 + pl.RS - 1) / pl.RS);
  const int step_rows = THREADS / (W * PIECES);
  const int step_j = THREADS % (W * PIECES);

  // zeros where no copy writes: the halo columns and the columns past W
  for (int i = tid; i < 2 * pl.stage / 8; i += THREADS)
    reinterpret_cast<uint4*>(bufs)[i] = make_uint4(0u, 0u, 0u, 0u);
  __syncthreads();

  float2 acc[KK];
#pragma unroll
  for (int t = 0; t < KK; ++t) acc[t] = make_float2(0.0f, 0.0f);

  auto rows_of = [&](int s) {  // output rows of stage s
    const i64 left = r1 - r0 - i64(s) * pl.RS;
    return int(left < pl.RS ? left : pl.RS);
  };
  load_stage<K>(bufs, pl, x, dy, r0, rows_of(0), rows, W, C, c0, step_rows, step_j, async);
  cp_async_commit();
  for (int s = 0; s < nstages; ++s) {
    if (s + 1 < nstages) {
      load_stage<K>(bufs + ((s + 1) & 1) * pl.stage, pl, x, dy, r0 + i64(s + 1) * pl.RS,
                    rows_of(s + 1), rows, W, C, c0, step_rows, step_j, async);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
#ifndef WGRAD_LOADS_ONLY  // the probe's ablation build: stages every row, adds nothing
    if (active) {
      const bf16* xs = bufs + (s & 1) * pl.stage;
      const bf16* dys = xs + pl.x_elems;
      const i64 sr0 = r0 + i64(s) * pl.RS;
      const int rs = rows_of(s);
#pragma unroll
      for (int j = 0; j < ROWS_PER_THREAD; ++j) {
        const int lr = p + j * pl.P;
        if (lr < rs) {
          const int oh = int((sr0 + lr) % H);
          const bf16* drow = dys + (lr * pl.DW + run * R) * CT + 2 * g;
          float2 d[R];
#pragma unroll
          for (int i = 0; i < R; ++i)
            d[i] = __bfloat1622float2(*reinterpret_cast<const bf162*>(drow + i * CT));
#pragma unroll
          for (int kh = 0; kh < K; ++kh) {
            const int ih = oh + kh - PAD;
            if (ih < 0 || ih >= H) continue;  // the tap's input row is padding
            const bf16* xrow = xs + ((lr + kh) * pl.XW + run * R) * CT + 2 * g;
            float2 xv[R + K - 1];
#pragma unroll
            for (int i = 0; i < R + K - 1; ++i)
              xv[i] = __bfloat1622float2(*reinterpret_cast<const bf162*>(xrow + i * CT));
#pragma unroll
            for (int kw = 0; kw < K; ++kw) {
#pragma unroll
              for (int i = 0; i < R; ++i) {
                acc[kh * K + kw].x = fmaf(xv[i + kw].x, d[i].x, acc[kh * K + kw].x);
                acc[kh * K + kw].y = fmaf(xv[i + kw].y, d[i].y, acc[kh * K + kw].y);
              }
            }
          }
        }
      }
    }
#endif
    __syncthreads();  // the buffer is free for stage s + 2
  }

  // the block's sums: the runs and rows of each channel added in order
  float* red = reinterpret_cast<float*>(smem);  // [runs * P][KK][CT]
  const int items = pl.runs * pl.P;
  if (active) {
    const int item = run + pl.runs * p;
#pragma unroll
    for (int t = 0; t < KK; ++t) {
      red[(item * KK + t) * CT + 2 * g] = acc[t].x;
      red[(item * KK + t) * CT + 2 * g + 1] = acc[t].y;
    }
  }
  __syncthreads();
  for (int e = tid; e < KK * CT; e += THREADS) {
    const int t = e / CT;
    const int c = e % CT;
    if (c0 + c >= C) continue;
    float sum = 0.0f;
    for (int it = 0; it < items; ++it) sum += red[(it * KK + t) * CT + c];
    partial[(i64(blockIdx.x) * KK + t) * C + c0 + c] = sum;
  }
}

// dW[i] = sum over chunks in order of partial[chunk][i], i over K*K*C
__global__ void wgrad_reduce_kernel(const float* __restrict__ partial, float* __restrict__ out,
                                    int chunks, int kkc) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= kkc) return;
  float s = 0.0f;
  for (int j = 0; j < chunks; ++j) s += partial[i64(j) * kkc + i];
  out[i] = s;
}

}  // namespace

// The number of row slices (chunks) the kernel splits N*H into for this
// shape, or 0 when the kernel does not take it (K other than 3 and 5, W over
// 112).
extern "C" int dw_conv_wgrad_chunks(int N, int H, int W, int C, int K) {
  if ((K != 3 && K != 5) || N < 1 || H < 1 || W < 1 || C < 1) return 0;
  if ((W + R - 1) / R > MAX_RUNS || make_plan(W, K).smem > MAX_SMEM) return 0;
  const int tiles = (C + CT - 1) / CT;
  if (tiles > 65535) return 0;
  const i64 rows = i64(N) * H;
  const i64 want = (TARGET_BLOCKS + tiles - 1) / tiles;
  return int(want < rows ? want : rows);
}

// x, dy (N, H, W, C) bf16 contiguous; partial (chunks, K, K, C) fp32 scratch;
// out (K, K, 1, C) fp32. chunks from dw_conv_wgrad_chunks.
extern "C" int dw_conv_wgrad(const void* x, const void* dy, void* partial, void* out, int N,
                             int H, int W, int C, int K, int chunks, void* stream) {
  if (chunks < 1 || chunks != dw_conv_wgrad_chunks(N, H, W, C, K))
    return int(cudaErrorInvalidValue);
  const dim3 grid(chunks, (C + CT - 1) / CT);
  const int smem = make_plan(W, K).smem;
  const int async = C % 8 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(dy) % 16 == 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bf16* xb = static_cast<const bf16*>(x);
  const bf16* db = static_cast<const bf16*>(dy);
  float* pf = static_cast<float*>(partial);
  cudaError_t err;
  if (K == 3) {
    err = cudaFuncSetAttribute(wgrad_partial_kernel<3>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    wgrad_partial_kernel<3><<<grid, THREADS, smem, s>>>(xb, db, pf, N, H, W, C, chunks, async);
  } else {
    err = cudaFuncSetAttribute(wgrad_partial_kernel<5>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return int(err);
    wgrad_partial_kernel<5><<<grid, THREADS, smem, s>>>(xb, db, pf, N, H, W, C, chunks, async);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return int(err);
  const int kkc = K * K * C;
  wgrad_reduce_kernel<<<(kkc + 255) / 256, 256, 0, s>>>(pf, static_cast<float*>(out), chunks, kkc);
  return int(cudaGetLastError());
}
