// Per-(feature, bin) gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram.py::_hist_kernel_body
// (launched by _pallas_histogram_body). Same function:
//
//     out[f, b, c] = sum_t [bins[row_t, f] == b] * gh[row_t, c]
//
// over rows row_t = t (dense) or row_t = idx[t] (a row-index list, which
// is how the learner histograms the smaller child without materialising
// bins[idx]). bins is [N, Fp] uint8 row-major with Fp a multiple of 8;
// gh is [N, C] (C <= 8); out is [Fp, B, C] and must be zero on entry.
//
// Design. The TPU kernel factorises each bin into hi/lo nibbles and runs
// one-hot matmuls into a VMEM-resident accumulator over a sequential row
// grid. Hopper has no sequential grid and a scatter-add is cheap here, so
// the kernel is the classic shared-memory histogram instead: the grid is
// (row chunks) x (feature groups of 8). Eight features of one row are
// 8 contiguous bytes, read with one 8-byte load; the C gh values of the
// row are read once. Each block keeps its group's [8, B, C] accumulator
// in shared memory (8*256*4*4 = 32 KB for the learner's B=256, C=4),
// adds with shared-memory atomics, and at the end adds its non-zero
// partial sums into the global output with global atomics.
//
// Bound on this card: memory bytes. Each call must read S*Fp bytes of
// bins, S*C*sizeof(gh) of gh and S*4 of idx, and write Fp*B*C*4: at
// 3.35 TB/s that is ~0.2 ms for S = 10.5M rows at Fp = 32, C = 4 (f32).
// The operation count (S*Fp*C adds) is far below the card's rate. The
// likely real limit is shared-atomic contention on hot bins, and the
// re-read of each row's gh by every feature group's block.
//
// Templated on (gh type, accumulator type): f32 -> f32 for the learner,
// int8 -> int32 and int16 -> int32 for quantized gradients (exact, so
// order-independent). The TPU package has no kernel for int16 rows (it
// sends them through an einsum); here a CUDA tensor must reach a kernel,
// so 16-bit rows get their own instance of the same template. The caller
// keeps |row| * rows below 2^31 (ops/quantize.py effective_quant_max).
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 8;      // features per block (one 8-byte load)
constexpr int kMaxC = 8;       // stat columns per row
constexpr int kThreads = 256;

template <typename GH, typename ACC>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ bins, const GH* __restrict__ gh,
            const int32_t* __restrict__ idx, ACC* __restrict__ out,
            int64_t S, int Fp, int B, int C, int64_t rows_per_block) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ACC* acc = reinterpret_cast<ACC*>(smem_raw);
  const int group = blockIdx.y;
  const int n_acc = kGroup * B * C;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) acc[i] = ACC(0);
  __syncthreads();

  const int64_t begin = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  int64_t end = begin + rows_per_block;
  if (end > S) end = S;
  const int64_t col = static_cast<int64_t>(group) * kGroup;
  for (int64_t t = begin + threadIdx.x; t < end; t += blockDim.x) {
    const int64_t row = idx != nullptr ? static_cast<int64_t>(idx[t]) : t;
    const uint64_t packed =
        *reinterpret_cast<const uint64_t*>(bins + row * Fp + col);
    ACC v[kMaxC];
#pragma unroll
    for (int c = 0; c < kMaxC; ++c) {
      v[c] = c < C ? static_cast<ACC>(gh[row * C + c]) : ACC(0);
    }
#pragma unroll
    for (int f = 0; f < kGroup; ++f) {
      const int b = static_cast<int>((packed >> (8 * f)) & 0xFFu);
      if (b < B) {
        ACC* dst = acc + (f * B + b) * C;
#pragma unroll
        for (int c = 0; c < kMaxC; ++c) {
          if (c < C) atomicAdd(dst + c, v[c]);
        }
      }
    }
  }
  __syncthreads();

  ACC* gout = out + col * B * C;
  for (int i = threadIdx.x; i < n_acc; i += blockDim.x) {
    const ACC a = acc[i];
    if (a != ACC(0)) atomicAdd(gout + i, a);
  }
}

template <typename GH, typename ACC>
int launch(const void* bins, const void* gh, const void* idx, void* out,
           long long S, int Fp, int B, int C, void* stream) {
  if (S <= 0) return static_cast<int>(cudaSuccess);
  if (Fp <= 0 || Fp % kGroup != 0 || B <= 0 || B > 256 || C <= 0 ||
      C > kMaxC) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  int num_sms = 0;
  err = cudaDeviceGetAttribute(&num_sms, cudaDevAttrMultiProcessorCount,
                               dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int groups = Fp / kGroup;
  // about eight blocks per SM in all; each chunk keeps >= 1024 rows so a
  // small child does not pay a block flush per handful of rows
  long long max_chunks = (8LL * num_sms) / groups;
  if (max_chunks < 1) max_chunks = 1;
  long long chunks = (S + 1023) / 1024;
  if (chunks > max_chunks) chunks = max_chunks;
  const long long rows_per_block = (S + chunks - 1) / chunks;
  chunks = (S + rows_per_block - 1) / rows_per_block;

  const size_t smem = sizeof(ACC) * static_cast<size_t>(kGroup) * B * C;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(hist_kernel<GH, ACC>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  dim3 grid(static_cast<unsigned>(chunks), static_cast<unsigned>(groups));
  hist_kernel<GH, ACC><<<grid, kThreads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(bins), static_cast<const GH*>(gh),
      static_cast<const int32_t*>(idx), static_cast<ACC*>(out), S, Fp, B, C,
      rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// f32 gh -> f32 histogram. idx may be null (all S rows in order).
int lgbm_histogram_f32(const void* bins, const void* gh, const void* idx,
                       void* out, long long S, int Fp, int B, int C,
                       void* stream) {
  return launch<float, float>(bins, gh, idx, out, S, Fp, B, C, stream);
}

// int8 gh -> int32 histogram (quantized gradients).
int lgbm_histogram_i8(const void* bins, const void* gh, const void* idx,
                      void* out, long long S, int Fp, int B, int C,
                      void* stream) {
  return launch<int8_t, int>(bins, gh, idx, out, S, Fp, B, C, stream);
}

// int16 gh -> int32 histogram (16-bit quantized gradients).
int lgbm_histogram_i16(const void* bins, const void* gh, const void* idx,
                       void* out, long long S, int Fp, int B, int C,
                       void* stream) {
  return launch<int16_t, int>(bins, gh, idx, out, S, Fp, B, C, stream);
}

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
