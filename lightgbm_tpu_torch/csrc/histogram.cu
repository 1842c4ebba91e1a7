// Per-(feature, bin) gradient histogram for Hopper (sm_90a).
//
// Replaces the TPU kernel lightgbm_tpu/ops/histogram.py::_hist_kernel_body
// (launched by _pallas_histogram_body). Same function:
//
//     out[f, b, c] = sum_t [bins[row_t, f] == b] * gh[row_t, c]
//
// over rows row_t = t (dense) or row_t = idx[t] (a row-index list, which
// is how the learner histograms the smaller child without materialising
// bins[idx]). bins is [N, Fp] row-major with Fp a multiple of 8, uint8
// (B <= 256) or uint16 (any B up to 65536: max_bin > 255, and EFB bundle
// columns of more than 256 bins); gh is [N, C] (C <= 8); out is
// [Fp, B, C] and is written whole (no zero fill needed). A bin value >= B
// is skipped. This file builds the uint8 library; histogram_u16.cu
// includes it with LGBM_BIN_T = uint16_t, so the two compile in parallel.
//
// Bound on this card: memory bytes. A call must read S*Fp*sizeof(bin) of
// bins, S*C*sizeof(gh) of gh and S*4 of idx, and write Fp*B*C*4: ~0.15 ms
// at 3.35 TB/s for S = 10.5M rows at Fp = 32, C = 4 (f32, uint8 bins),
// ~0.25 ms with uint16 bins. The adds (S*Fp*C) are far below the card's
// rate.
//
// Design (the TPU kernel's hi/lo-nibble one-hot matmuls into a VMEM
// accumulator do not carry over: Hopper has no sequential grid, and a
// scatter into shared memory is cheap):
//
// * Slabs. A feature's B bins are cut into slabs of SB = min(B, 256) bins
//   (nslab = ceil(B / SB); one slab when B <= 256). A (feature, slab)
//   pair is the unit of ownership: pairs are numbered f * nslab + s, a
//   block's group (blockIdx.y) takes Fg = 16 or 32 consecutive pairs, and
//   each of its 16 warps owns Fg / 16 of them, with their [SB, C]
//   accumulators in shared memory ([Fg, SB, C] f32 / f64, [Fg, C, SB]
//   int32). A warp reads the bin of every staged row of its pair's
//   feature and adds only the rows whose bin falls in its slab (a bin
//   outside takes the key 256, which is skipped like a bin >= B): one
//   shared-memory read of the bin per slab, and no two warps ever touch
//   one bin. At B = 1024, Fp = 32 and C = 4 that is 4 groups of 32 pairs
//   (8 features each), 128 KB of f32 accumulators per block, where one
//   warp per whole feature would need 256 KB, past the 227 KB a block
//   may use.
// * Row work without contended or CAS atomics. A warp takes 32 rows (one
//   per lane) of its pairs at a time. A pair whose 32 rows share one key
//   (a vote; the learner's zero padding features always do) is summed per
//   lane in registers and added to the bin when the key changes.
//   Otherwise the float instances find the lanes that share a key with
//   eight ballots (nine with uint16 bins, for the outside key 256), sum
//   each group by a tree of shuffles over its ranks and let the group's
//   lowest lane do a plain load-add-store; the int32 instances, exact in
//   any order, add each lane's row with a native shared atomic add (no
//   CAS loop; measured ~2x faster than the tree for them).
// * One read per row per group. A block stages a tile of T rows (the
//   group's features' bins and the row's gh) in shared memory with
//   cp.async, double-buffered so the next tile's copy overlaps this
//   tile's work, and every warp reads the tile from there. Groups exist
//   only when the accumulators of all pairs do not fit; at Fp = 32 and
//   B <= 256 there is one. Each group reads the rows' gh again: the price
//   of the wide form (4 groups at B = 1024, 16 at B = 4096).
// * A cross-block sum in a fixed order. The grid is persistent (at most
//   one block per SM, fewer for few rows); each block stores its partial
//   to scratch[blockIdx.x] with plain stores, and a second kernel sums
//   the partials in block order. With one block the partial goes straight
//   to the output. Lanes, rows, tiles and blocks are all combined in a
//   fixed order, so the float histograms are deterministic: the same
//   inputs give the same bits on every run.
//
// The launch plan (groups, pairs per group, slabs, staged features, tile
// rows, blocks, shared bytes, scratch shape) is computed by
// ops/histogram.py::launch_plan and passed in.
//
// Two entries per instance. The host-count entry (lgbm_histogram_*)
// takes the row count and the row blocks from the host. The device-count
// entry (lgbm_histogram_*_dev) reads the row count from device memory,
// where the learner's split step wrote it (the length of the smaller
// child's row list), so the step needs no host read and can be replayed
// as a CUDA graph: it launches the widest grid of the shape's plan
// (num_sms / groups row blocks), each block derives the plan for n rows
// (plan_blocks, the arithmetic of launch_plan) and the blocks past it
// return at once. Both entries give the same bytes for the same rows.
// Every launch of either entry adds one to a device counter of the
// instance (thread 0 of block (0, 0)), which counts graph replays too.
//
// Templated on (bin type, gh type, accumulator type, output type):
// f32 -> f32 for the learner; f32 -> f64 -> f32 for f64 histograms
// (tpu_use_f64_hist: f64 adds, f64 partials, a block-order sum in f64
// and one rounding to f32 at the output, as the TPU package's f64
// einsum/segment path rounds once); int8 -> int32 and int16 -> int32 for
// quantized gradients (exact). The TPU package has no kernel for int16
// rows or f64 sums (it sends them through an einsum); here a CUDA tensor
// must reach a kernel, so they get their own instances of the same
// template. The caller keeps |row| * rows below 2^31 (ops/quantize.py
// effective_quant_max).
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#ifndef LGBM_BIN_T
#define LGBM_BIN_T uint8_t
#define LGBM_ENTRY(name) lgbm_histogram_##name
#endif

namespace {

using BinT = LGBM_BIN_T;

constexpr int kWarps = 16;               // warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kMaxC = 8;                 // stat columns per row
constexpr int kMaxSmem = 232448;         // a block's shared memory (bytes)
constexpr int kSlab = 256;               // bins per slab at most
constexpr int kSkip = 256;               // the key of a bin outside a slab
constexpr unsigned kFull = 0xFFFFFFFFu;
// key bits: a uint8 bin is its own key (a bin >= B is skipped by value);
// a uint16 bin becomes its offset in the slab or kSkip, nine bits
constexpr int kKeyBits = sizeof(BinT) == 1 ? 8 : 9;
constexpr int kMaxBins = sizeof(BinT) == 1 ? 256 : 65536;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// copy `unit` bytes global -> shared; units of 4, 8 and 16 go through
// cp.async, 2 and 1 (a row whose bytes or alignment allow no wider unit)
// by a plain load and store
__device__ __forceinline__ void copy_unit(unsigned char* dst,
                                          const unsigned char* src,
                                          int unit) {
  if (unit == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else if (unit == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else if (unit == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                     smem_addr(dst)),
                 "l"(src));
  } else if (unit == 2) {
    *reinterpret_cast<uint16_t*>(dst) =
        *reinterpret_cast<const uint16_t*>(src);
  } else {
    *dst = *src;
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

struct Args {
  const BinT* bins;
  const void* gh;
  const int32_t* idx;
  void* out;              // written directly by a lone row block
  void* scratch;          // per-block partials when there are more
  long long S;            // rows summed (idx length, or N); host count
  long long rows_per_block;
  const int32_t* count;   // device count (the device-count entry) or null
  int max_blocks;         // the device-count entry's grid width
  int min_rows;           // rows a block takes at least
  unsigned long long* launches;  // device launch counter
  int Fp, B, C;
  int Fg;                 // (feature, slab) pairs per group, 16 or 32
  int SB;                 // bins per slab (min(B, 256))
  int nslab;              // slabs per feature
  int Fs;                 // features staged per tile row (tile stride)
  int T;                  // tile rows (a multiple of 32)
  int bins_unit, gh_unit; // copy unit in bytes
};

// Row blocks and rows per block for n rows: at most max_blocks, each of
// at least min_rows rows, then as few as hold n (ops/histogram.py
// launch_plan and device_plan repeat this arithmetic). n = 0 gives one
// block of no rows, which writes a zero histogram.
__host__ __device__ __forceinline__ int plan_blocks(long long n,
                                                    int max_blocks,
                                                    int min_rows,
                                                    long long* per_block) {
  if (n <= 0) {
    *per_block = 0;
    return 1;
  }
  long long b = (n + min_rows - 1) / min_rows;
  if (b > max_blocks) b = max_blocks;
  if (b < 1) b = 1;
  const long long per = (n + b - 1) / b;
  *per_block = per;
  return static_cast<int>((n + per - 1) / per);
}

// the first feature and the feature count of group g's pairs
__host__ __device__ __forceinline__ void group_features(int g, int Fg,
                                                        int nslab, int Fp,
                                                        int* f0, int* nf) {
  const int p0 = g * Fg;
  int p1 = p0 + Fg;
  if (p1 > Fp * nslab) p1 = Fp * nslab;
  *f0 = p0 / nslab;
  *nf = (p1 - 1) / nslab - *f0 + 1;
}

// stage rows [t0, t0 + n) of this block's range into one tile buffer
template <typename GH>
__device__ __forceinline__ void issue_tile(const Args& a, long long t0, int n,
                                           int f0, int nf, unsigned char* tb,
                                           unsigned char* tg) {
  constexpr int kB = static_cast<int>(sizeof(BinT));
  const int fb = a.Fs * kB;  // tile row stride in bytes
  const int bins_per_row = nf * kB / a.bins_unit;
  const int gh_bytes = a.C * static_cast<int>(sizeof(GH));
  const int gh_per_row = gh_bytes / a.gh_unit;
  const unsigned char* bins = reinterpret_cast<const unsigned char*>(a.bins);
  const unsigned char* gh = static_cast<const unsigned char*>(a.gh);
  for (int u = threadIdx.x; u < n * bins_per_row; u += kThreads) {
    const int r = u / bins_per_row;
    const int q = u - r * bins_per_row;
    const long long t = t0 + r;
    const long long row = a.idx != nullptr ? __ldg(a.idx + t) : t;
    copy_unit(tb + r * fb + q * a.bins_unit,
              bins + (row * a.Fp + f0) * kB + q * a.bins_unit, a.bins_unit);
  }
  for (int u = threadIdx.x; u < n * gh_per_row; u += kThreads) {
    const int r = u / gh_per_row;
    const int q = u - r * gh_per_row;
    const long long t = t0 + r;
    const long long row = a.idx != nullptr ? __ldg(a.idx + t) : t;
    copy_unit(tg + r * gh_bytes + q * a.gh_unit,
              gh + row * gh_bytes + q * a.gh_unit, a.gh_unit);
  }
}

// one row's C stats from the tile, widened to the accumulator type: one
// vector load where the row is 4, 8 or 16 bytes (the learner's C = 4)
template <typename GH, typename ACC, int CV>
__device__ __forceinline__ void load_row(const GH* p, int C, ACC v[CV]) {
  const int nbytes = C * static_cast<int>(sizeof(GH));
  if (nbytes == 16 || nbytes == 8 || nbytes == 4) {
    int4 w = make_int4(0, 0, 0, 0);
    if (nbytes == 16) {
      w = *reinterpret_cast<const int4*>(p);
    } else if (nbytes == 8) {
      const int2 h = *reinterpret_cast<const int2*>(p);
      w.x = h.x;
      w.y = h.y;
    } else {
      w.x = *reinterpret_cast<const int*>(p);
    }
    const GH* e = reinterpret_cast<const GH*>(&w);
    constexpr int kVec = 16 / static_cast<int>(sizeof(GH));
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      v[c] = c < C && c < kVec ? static_cast<ACC>(e[c < kVec ? c : 0])
                               : ACC(0);
    }
    return;
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) v[c] = c < C ? static_cast<ACC>(p[c]) : ACC(0);
}

// the valid lanes whose key equals this lane's: one ballot per key bit
__device__ __forceinline__ unsigned peers_of(unsigned key, unsigned valid) {
  unsigned peers = valid;
#pragma unroll
  for (int k = 0; k < kKeyBits; ++k) {
    const unsigned on = (key >> k) & 1u;
    const unsigned bit = __ballot_sync(kFull, on);
    peers &= on ? bit : ~bit;
  }
  return peers;
}

// The int32 instances keep their accumulators channel-major, [Fg, C, SB]:
// a warp's 32 atomics for one channel then spread over all 32 banks (bin
// b in bank b mod 32), where [Fg, SB, C] would put them in 8. The float
// instances keep [Fg, SB, C] (f32: for its 16-byte load-add-store).
template <typename ACC>
constexpr bool kChannelMajor = std::is_same<ACC, int>::value;

// the accumulator of (pair j, slab bin b, channel 0); channel c is at
// + c * stride
template <typename ACC>
__device__ __forceinline__ ACC* bin_at(ACC* acc, int j, int b, int SB, int C,
                                       int& stride) {
  if constexpr (kChannelMajor<ACC>) {
    stride = SB;
    return acc + j * SB * C + b;
  } else {
    stride = 1;
    return acc + (j * SB + b) * C;
  }
}

template <typename ACC>
struct Vec4;
template <>
struct Vec4<float> {
  using type = float4;
};
template <>
struct Vec4<int> {
  using type = int4;
};

// a plain load-add-store: only this lane of this warp writes the bin
template <typename ACC, int CV>
__device__ __forceinline__ void add_to_bin(ACC* acc, int j, int b, int SB,
                                           int C, const ACC s[CV]) {
  int stride;
  ACC* dst = bin_at(acc, j, b, SB, C, stride);
  if constexpr (!kChannelMajor<ACC> && sizeof(ACC) == 4) {
    if (C == 4) {  // 16-byte aligned
      using V = typename Vec4<ACC>::type;
      V w = *reinterpret_cast<V*>(dst);
      w.x += s[0];
      w.y += s[1];
      w.z += s[2];
      w.w += s[3];
      *reinterpret_cast<V*>(dst) = w;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CV; ++c) {
    if (c < C) dst[c * stride] += s[c];
  }
}

// A warp's running sums of the rows it found all under one key of a pair
// (every row of the chunk in the same bin, as in the learner's zero
// padding features, or all outside the slab): each lane adds its own
// row's values in registers, and the warp adds them into the bin only
// when the key changes or the block ends.
template <typename ACC, int KPW, int CV>
struct Pending {
  int bin[KPW];      // -1: nothing pending
  ACC sum[KPW][CV];
};

// the 32 lanes' pending sums of pair j, by a butterfly in a fixed order,
// into its bin (lane 0; a key >= the slab's nb bins is skipped)
template <typename ACC, int KPW, int CV>
__device__ __forceinline__ void flush_pending(Pending<ACC, KPW, CV>& p, int j,
                                              ACC* acc, int lane, int nb,
                                              int SB, int C) {
  if (p.bin[j] < 0) return;                       // warp-uniform
  if (p.bin[j] < nb) {                            // warp-uniform
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      if (c < C) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1) {
          p.sum[j][c] += __shfl_xor_sync(kFull, p.sum[j][c], o);
        }
      }
    }
    if (lane == 0) add_to_bin<ACC, CV>(acc, j, p.bin[j], SB, C, p.sum[j]);
  }
  p.bin[j] = -1;
#pragma unroll
  for (int c = 0; c < CV; ++c) p.sum[j][c] = ACC(0);
}

// The pairs of one warp: each one's feature in the tile row, its first
// bin and its bin count (nb; 0 for a pair past the group's end)
template <int KPW>
struct WarpPairs {
  int fl[KPW];
  int s0[KPW];
  int nb[KPW];
};

// The row work of one warp on 32 rows (one per lane) of its KPW pairs.
// Each row's bin becomes its key in the pair's slab. A pair whose 32 rows
// all hold one key (a vote on lane 0's key) goes to the pending sums.
// Otherwise:
// * int32 (exact in any order): each lane adds its row into its bin with
//   a native shared-memory atomic add (RED.ADD), no conflict search;
// * f32 / f64: the lanes that share a key of the slab (peers_of over
//   the lanes with a bin in it), and the sum of their values, complete
//   in the group's lowest lane (rank 0), by a tree over the group's
//   ranks: each lane finds the peer one rank above it,
//   then doubles that pointer each step, for log2 of the largest group's
//   size steps; the KPW pairs' trees run in one loop, so their shuffles
//   interleave; rank 0 does a plain load-add-store. The trees' shapes
//   depend only on the bins, so a float sum is the same on every run.
template <typename ACC, int KPW, int CV>
__device__ __forceinline__ void rows_of_warp(ACC* acc, const BinT* rb,
                                             const WarpPairs<KPW>& wp,
                                             const ACC v[CV], bool valid,
                                             unsigned valid_lanes, int lane,
                                             int SB, int C,
                                             Pending<ACC, KPW, CV>& pend) {
  int b[KPW];
  if constexpr (sizeof(BinT) == 1) {
    // one slab per feature (s0 = 0; a bin >= B is skipped by value): the
    // warp's features are consecutive in the tile row, two bins a load
    const BinT* p = rb + wp.fl[0];
    if constexpr (KPW == 2) {
      const uint32_t w = *reinterpret_cast<const uint16_t*>(p);
      b[0] = w & 0xFFu;
      b[1] = w >> 8;
    } else {
#pragma unroll
      for (int j = 0; j < KPW; ++j) b[j] = p[j];
    }
  } else {
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      const int off = static_cast<int>(rb[wp.fl[j]]) - wp.s0[j];
      b[j] = static_cast<unsigned>(off) < static_cast<unsigned>(wp.nb[j])
                 ? off
                 : kSkip;
    }
  }
  bool mixed[KPW];
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    // an invalid lane holds lane 0's row, so it never breaks a one-key
    // chunk
    const int bin = __shfl_sync(kFull, b[j], 0);
    mixed[j] = !__all_sync(kFull, b[j] == bin);
    if (!mixed[j] && wp.nb[j] > 0) {      // warp-uniform
      if (bin != pend.bin[j]) {
        flush_pending<ACC, KPW, CV>(pend, j, acc, lane, wp.nb[j], SB, C);
        pend.bin[j] = bin;
      }
      if (valid) {
#pragma unroll
        for (int c = 0; c < CV; ++c) pend.sum[j][c] += v[c];
      }
    }
  }
  if constexpr (std::is_same<ACC, int>::value) {
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      if (mixed[j] && valid && b[j] < wp.nb[j]) {
        int stride;
        ACC* dst = bin_at(acc, j, b[j], SB, C, stride);
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          if (c < C) atomicAdd(dst + c * stride, v[c]);
        }
      }
    }
  } else {
    const unsigned below = (1u << lane) - 1u;
    unsigned peers[KPW];
    int rank[KPW], next[KPW];
    unsigned largest = 0u;
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      if (mixed[j]) {                    // warp-uniform
        // with uint16 bins only the lanes whose bin lies in the slab take
        // part: the others (most of them in a wide feature) would form
        // one large group that stores nothing but sets the tree's depth
        // (uint8 bins lie below B in the learner: every valid lane)
        const bool live =
            valid && (sizeof(BinT) == 1 || b[j] < wp.nb[j]);
        peers[j] = peers_of(b[j], sizeof(BinT) == 1
                                      ? valid_lanes
                                      : __ballot_sync(kFull, live));
        rank[j] = __popc(peers[j] & below);
        const unsigned above = peers[j] & ~below & ~(1u << lane);
        next[j] = above != 0u ? __ffs(above) - 1 : 32;  // 32: none
        if (live) {
          largest = max(largest, static_cast<unsigned>(__popc(peers[j])));
        }
      } else {
        rank[j] = 1;                     // no store
        next[j] = 32;
      }
    }
    largest = __reduce_max_sync(kFull, largest);
    ACC s[KPW][CV];
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
#pragma unroll
      for (int c = 0; c < CV; ++c) s[j][c] = v[c];
    }
    for (unsigned step = 1; step < largest; step <<= 1) {
#pragma unroll
      for (int j = 0; j < KPW; ++j) {
        const int src = next[j] < 32 ? next[j] : lane;
        const bool take = next[j] < 32 && (rank[j] & (2 * step - 1)) == 0;
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          if (c < C) {
            const ACC o = __shfl_sync(kFull, s[j][c], src);
            if (take) s[j][c] += o;
          }
        }
        const int jump = __shfl_sync(kFull, next[j], src);
        next[j] = next[j] < 32 ? jump : 32;
      }
    }
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      // rank 0 of a valid group, in a bin of the slab (others skipped)
      if (valid && rank[j] == 0 && b[j] < wp.nb[j]) {
        add_to_bin<ACC, CV>(acc, j, b[j], SB, C, s[j]);
      }
    }
  }
}

template <typename GH, typename ACC, typename OUT, int KPW, int CV>
__global__ void __launch_bounds__(kThreads, 1)
hist_rows_kernel(Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int kB = static_cast<int>(sizeof(BinT));
  const int group = blockIdx.y;
  int f0, nf;
  group_features(group, a.Fg, a.nslab, a.Fp, &f0, &nf);
  const int p0 = group * a.Fg;                       // the group's first pair
  const int np = min(a.Fg, a.Fp * a.nslab - p0);     // its pairs
  const int SBC = a.SB * a.C;
  const int acc_bytes = a.Fg * SBC * static_cast<int>(sizeof(ACC));
  const int gh_bytes = a.C * static_cast<int>(sizeof(GH));
  ACC* acc = reinterpret_cast<ACC*>(smem);
  // two tile buffers: bins [T, Fs] each, then gh [T, C] each
  unsigned char* const tb0 = smem + acc_bytes;
  unsigned char* const tg0 = tb0 + 2 * a.T * a.Fs * kB;
  const int tb_step = a.T * a.Fs * kB;
  const int tg_step = a.T * gh_bytes;

  if (a.launches != nullptr && blockIdx.x == 0 && blockIdx.y == 0 &&
      threadIdx.x == 0) {
    atomicAdd(a.launches, 1ULL);
  }
  // this launch's rows and row blocks: from the host, or from the count
  // in device memory (blocks past the plan return at once)
  long long S = a.S;
  long long per_block = a.rows_per_block;
  int blocks = static_cast<int>(gridDim.x);
  if (a.count != nullptr) {
    S = *a.count;
    blocks = plan_blocks(S, a.max_blocks, a.min_rows, &per_block);
    if (static_cast<int>(blockIdx.x) >= blocks) return;  // block-uniform
  }
  const long long begin = static_cast<long long>(blockIdx.x) * per_block;
  long long end = begin + per_block;
  if (end > S) end = S;
  if (end < begin) end = begin;
  const int n_rows = static_cast<int>(end - begin);
  const int n_tiles = (n_rows + a.T - 1) / a.T;

  // start the first tile's copy, then zero the accumulators meanwhile
  issue_tile<GH>(a, begin, min(a.T, n_rows), f0, nf, tb0, tg0);
  cp_async_commit();
  for (int i = threadIdx.x; i < acc_bytes / 16; i += kThreads) {
    reinterpret_cast<int4*>(smem)[i] = make_int4(0, 0, 0, 0);
  }

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int wp0 = warp * KPW;            // the warp's first pair
  const int npw = min(KPW, np - wp0);    // its pairs in this group
  ACC* const wacc = acc + wp0 * SBC;
  WarpPairs<KPW> wp;
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    const int p = p0 + wp0 + j;
    const int f = p / a.nslab;
    const int s = p - f * a.nslab;
    wp.fl[j] = j < npw ? f - f0 : 0;
    wp.s0[j] = s * a.SB;
    wp.nb[j] = j < npw ? min(a.SB, a.B - wp.s0[j]) : 0;
  }
  Pending<ACC, KPW, CV> pend;
#pragma unroll
  for (int j = 0; j < KPW; ++j) {
    pend.bin[j] = -1;
#pragma unroll
    for (int c = 0; c < CV; ++c) pend.sum[j][c] = ACC(0);
  }
  for (int it = 0; it < n_tiles; ++it) {
    if (it + 1 < n_tiles) {
      const long long t1 = begin + static_cast<long long>(it + 1) * a.T;
      const int nb = (it + 1) & 1;
      issue_tile<GH>(a, t1, min(a.T, static_cast<int>(end - t1)), f0, nf,
                     tb0 + nb * tb_step, tg0 + nb * tg_step);
    }
    cp_async_commit();
    cp_async_wait_one();
    __syncthreads();

    const int rows = min(a.T, n_rows - it * a.T);
    const BinT* tbins =
        reinterpret_cast<const BinT*>(tb0 + (it & 1) * tb_step);
    const GH* tgh = reinterpret_cast<const GH*>(tg0 + (it & 1) * tg_step);
    if (npw > 0) {                       // warp-uniform
      for (int r0 = 0; r0 < rows; r0 += 32) {
        const int r = r0 + lane;
        const bool valid = r < rows;
        const int rr = valid ? r : r0;  // an idle lane copies lane 0's row
        ACC v[CV];
        load_row<GH, ACC, CV>(tgh + rr * a.C, a.C, v);
        rows_of_warp<ACC, KPW, CV>(wacc, tbins + rr * a.Fs, wp, v, valid,
                                   __ballot_sync(kFull, valid), lane, a.SB,
                                   a.C, pend);
      }
    }
    __syncthreads();  // the next iteration's copy overwrites this buffer
  }
  if (npw > 0) {
#pragma unroll
    for (int j = 0; j < KPW; ++j) {
      flush_pending<ACC, KPW, CV>(pend, j, wacc, lane, wp.nb[j], a.SB, a.C);
    }
  }

  __syncthreads();
  // the block's partial of its pairs: plain coalesced stores into its own
  // slot of scratch ([blocks, Fp, B, C] ACC), or, for a lone block, into
  // the output (OUT: an f64 sum is rounded to f32 once, here)
  const long long slot = static_cast<long long>(blockIdx.x) * a.Fp;
  if (blocks > 1 || std::is_same<ACC, OUT>::value) {
    ACC* dst = static_cast<ACC*>(blocks > 1 ? a.scratch : a.out);
    if (!kChannelMajor<ACC> && a.nslab == 1) {
      // one slab per feature: the group's [nf, B, C] is contiguous
      int4* d16 = reinterpret_cast<int4*>(dst + (slot + f0) * a.B * a.C);
      const int4* s16 = reinterpret_cast<const int4*>(smem);
      const int n16 = np * SBC * static_cast<int>(sizeof(ACC)) / 16;
      for (int i = threadIdx.x; i < n16; i += kThreads) d16[i] = s16[i];
      return;
    }
  }
  for (int i = threadIdx.x; i < np * a.SB; i += kThreads) {
    const int j = i / a.SB;
    const int lb = i - j * a.SB;
    const int p = p0 + j;
    const int f = p / a.nslab;
    const int b = (p - f * a.nslab) * a.SB + lb;
    if (b >= a.B) continue;
    const long long o = ((slot + f) * a.B + b) * a.C;
    int stride;
    const ACC* src = bin_at(acc, j, lb, a.SB, a.C, stride);
    for (int c = 0; c < a.C; ++c) {
      if (blocks > 1) {
        static_cast<ACC*>(a.scratch)[o + c] = src[c * stride];
      } else {
        static_cast<OUT*>(a.out)[o + c] = static_cast<OUT>(src[c * stride]);
      }
    }
  }
}

// out[i] = sum over blocks k, in order k = 0, 1, ..., of scratch[k][i]
// (in ACC, rounded to OUT once); with a device count the row blocks are
// those of plan_blocks, and one block (it wrote out itself) leaves
// nothing to do
template <typename ACC, typename OUT>
__global__ void __launch_bounds__(256)
hist_sum_kernel(const ACC* __restrict__ scratch, OUT* __restrict__ out,
                int blocks, long long n, const int32_t* count,
                int max_blocks, int min_rows) {
  if (count != nullptr) {
    long long per_block;
    blocks = plan_blocks(*count, max_blocks, min_rows, &per_block);
    if (blocks <= 1) return;
  }
  const long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                      threadIdx.x;
  if (i >= n) return;
  ACC s = scratch[i];
  for (int k = 1; k < blocks; ++k) s += scratch[k * n + i];
  out[i] = static_cast<OUT>(s);
}

// the shared-memory attribute is a property of the function on each
// device, so it is set once per (instance, device)
constexpr int kMaxDevices = 64;

template <typename GH, typename ACC, typename OUT, int KPW, int CV>
cudaError_t launch_rows(dim3 grid, int smem, cudaStream_t st, const Args& a) {
  static bool configured[kMaxDevices] = {};  // allow the full 227 KB
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < 0 || dev >= kMaxDevices) return cudaErrorInvalidDevice;
  if (!configured[dev]) {
    err = cudaFuncSetAttribute(
        hist_rows_kernel<GH, ACC, OUT, KPW, CV>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kMaxSmem);
    if (err != cudaSuccess) return err;
    configured[dev] = true;
  }
  hist_rows_kernel<GH, ACC, OUT, KPW, CV><<<grid, kThreads, smem, st>>>(a);
  return cudaGetLastError();
}

// the instance for Fg / 16 pairs per warp (1 or 2) and C <= 4 or 8
template <typename GH, typename ACC, typename OUT>
cudaError_t dispatch_rows(dim3 grid, int smem, cudaStream_t st,
                          const Args& a) {
  const int kpw = a.Fg / kWarps;
  if (a.C <= 4) {
    if (kpw == 2) return launch_rows<GH, ACC, OUT, 2, 4>(grid, smem, st, a);
    if (kpw == 1) return launch_rows<GH, ACC, OUT, 1, 4>(grid, smem, st, a);
  } else {
    if (kpw == 2) return launch_rows<GH, ACC, OUT, 2, 8>(grid, smem, st, a);
    if (kpw == 1) return launch_rows<GH, ACC, OUT, 1, 8>(grid, smem, st, a);
  }
  return cudaErrorInvalidValue;
}

// the widest copy unit (16, 8, 4, 2 or 1 bytes) that divides a row's
// bytes, its stride and the base address
int copy_unit_for(long long row_bytes, long long stride, const void* base) {
  const uintptr_t p = reinterpret_cast<uintptr_t>(base);
  for (int u = 16; u >= 2; u >>= 1) {
    if (row_bytes % u == 0 && stride % u == 0 && p % u == 0) return u;
  }
  return 1;
}

// checks and Args shared by both entries; returns cudaSuccess or
// cudaErrorInvalidValue
template <typename GH, typename ACC>
cudaError_t make_args(const void* bins, const void* gh, const void* idx,
                      void* out, void* scratch, void* launches, int Fp,
                      int B, int C, int Fg, int groups, int Fs, int T,
                      int smem, Args* a) {
  constexpr int kB = static_cast<int>(sizeof(BinT));
  const int gh_bytes = C * static_cast<int>(sizeof(GH));
  const int SB = B < kSlab ? B : kSlab;
  const int nslab = SB > 0 ? (B + SB - 1) / SB : 0;
  if (Fp <= 0 || Fp % 8 != 0 || B <= 0 || B > kMaxBins || C <= 0 ||
      C > kMaxC || (Fg != 16 && Fg != 32) ||
      groups != (Fp * nslab + Fg - 1) / Fg || Fs <= 0 || T <= 0 ||
      T % 32 != 0 || out == nullptr || smem > kMaxSmem ||
      static_cast<long long>(smem) <
          static_cast<long long>(Fg) * SB * C *
                  static_cast<long long>(sizeof(ACC)) +
              2LL * T * (Fs * kB + gh_bytes)) {
    return cudaErrorInvalidValue;
  }
  a->bins = static_cast<const BinT*>(bins);
  a->gh = gh;
  a->idx = static_cast<const int32_t*>(idx);
  a->out = out;
  a->scratch = scratch;
  a->S = 0;
  a->rows_per_block = 0;
  a->count = nullptr;
  a->max_blocks = 1;
  a->min_rows = 1;
  a->launches = static_cast<unsigned long long*>(launches);
  a->Fp = Fp;
  a->B = B;
  a->C = C;
  a->Fg = Fg;
  a->SB = SB;
  a->nslab = nslab;
  a->Fs = Fs;
  a->T = T;
  // a unit that divides the row stride, the tile stride, and every
  // group's first feature and staged bytes; every group fits the tile
  int unit = copy_unit_for(Fs * kB, static_cast<long long>(Fp) * kB, bins);
  for (int g = 0; g < groups; ++g) {
    int f0, nf;
    group_features(g, Fg, nslab, Fp, &f0, &nf);
    if (nf > Fs) return cudaErrorInvalidValue;
    while ((f0 * kB) % unit != 0 || (nf * kB) % unit != 0) unit >>= 1;
  }
  a->bins_unit = unit;
  a->gh_unit = copy_unit_for(gh_bytes, gh_bytes, gh);
  return cudaSuccess;
}

// the host-count entry: S rows in `blocks` row blocks of rows_per_block
template <typename GH, typename ACC, typename OUT>
int launch(const void* bins, const void* gh, const void* idx, void* out,
           void* scratch, void* launches, long long S, int Fp, int B, int C,
           int Fg, int groups, int Fs, int T, int blocks,
           long long rows_per_block, int smem, void* stream) {
  if (S <= 0) return static_cast<int>(cudaSuccess);
  Args a;
  cudaError_t err = make_args<GH, ACC>(bins, gh, idx, out, scratch, launches,
                                       Fp, B, C, Fg, groups, Fs, T, smem, &a);
  if (err != cudaSuccess || blocks <= 0 || rows_per_block <= 0 ||
      static_cast<long long>(blocks) * rows_per_block < S ||
      (blocks > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.S = S;
  a.rows_per_block = rows_per_block;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(blocks), static_cast<unsigned>(groups));
  err = dispatch_rows<GH, ACC, OUT>(grid, smem, st, a);
  if (err != cudaSuccess || blocks == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(Fp) * B * C;
  hist_sum_kernel<ACC, OUT>
      <<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
          static_cast<const ACC*>(scratch), static_cast<OUT*>(out), blocks,
          n, nullptr, 0, 0);
  return static_cast<int>(cudaGetLastError());
}

// the device-count entry: *count rows of idx (count in device memory), a
// grid of max_blocks row blocks of which plan_blocks(*count) work;
// scratch holds max_blocks partials (it may be null when max_blocks is
// 1). Launches the sum kernel always: it returns at once for one block.
template <typename GH, typename ACC, typename OUT>
int launch_dev(const void* bins, const void* gh, const void* idx,
               const void* count, void* out, void* scratch, void* launches,
               int Fp, int B, int C, int Fg, int groups, int Fs, int T,
               int max_blocks, int min_rows, int smem, void* stream) {
  Args a;
  cudaError_t err = make_args<GH, ACC>(bins, gh, idx, out, scratch, launches,
                                       Fp, B, C, Fg, groups, Fs, T, smem, &a);
  if (err != cudaSuccess || idx == nullptr || count == nullptr ||
      max_blocks <= 0 || min_rows <= 0 ||
      (max_blocks > 1 && scratch == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  a.count = static_cast<const int32_t*>(count);
  a.max_blocks = max_blocks;
  a.min_rows = min_rows;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  dim3 grid(static_cast<unsigned>(max_blocks), static_cast<unsigned>(groups));
  err = dispatch_rows<GH, ACC, OUT>(grid, smem, st, a);
  if (err != cudaSuccess || max_blocks == 1) return static_cast<int>(err);
  const long long n = static_cast<long long>(Fp) * B * C;
  hist_sum_kernel<ACC, OUT>
      <<<static_cast<unsigned>((n + 255) / 256), 256, 0, st>>>(
          static_cast<const ACC*>(scratch), static_cast<OUT*>(out),
          max_blocks, n, a.count, max_blocks, min_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define LGBM_HISTOGRAM_ARGS                                                   \
  const void *bins, const void *gh, const void *idx, void *out,              \
      void *scratch, void *launches, long long S, int Fp, int B, int C,      \
      int Fg, int groups, int Fs, int T, int blocks,                         \
      long long rows_per_block, int smem, void *stream
#define LGBM_HISTOGRAM_PASS                                                  \
  bins, gh, idx, out, scratch, launches, S, Fp, B, C, Fg, groups, Fs, T,     \
      blocks, rows_per_block, smem, stream
#define LGBM_HISTOGRAM_DEV_ARGS                                               \
  const void *bins, const void *gh, const void *idx, const void *count,      \
      void *out, void *scratch, void *launches, int Fp, int B, int C,        \
      int Fg, int groups, int Fs, int T, int max_blocks, int min_rows,       \
      int smem, void *stream
#define LGBM_HISTOGRAM_DEV_PASS                                              \
  bins, gh, idx, count, out, scratch, launches, Fp, B, C, Fg, groups, Fs, T, \
      max_blocks, min_rows, smem, stream

extern "C" {

// f32 gh -> f32 histogram. idx may be null (all S rows in order);
// scratch ([blocks, Fp, B, C] of the accumulator type) may be null when
// blocks == 1; launches (a device uint64 counter) may be null.
int LGBM_ENTRY(f32)(LGBM_HISTOGRAM_ARGS) {
  return launch<float, float, float>(LGBM_HISTOGRAM_PASS);
}

// f32 gh -> f64 sums -> f32 histogram (tpu_use_f64_hist / gpu_use_dp).
int LGBM_ENTRY(f64)(LGBM_HISTOGRAM_ARGS) {
  return launch<float, double, float>(LGBM_HISTOGRAM_PASS);
}

// int8 gh -> int32 histogram (quantized gradients).
int LGBM_ENTRY(i8)(LGBM_HISTOGRAM_ARGS) {
  return launch<int8_t, int, int>(LGBM_HISTOGRAM_PASS);
}

// int16 gh -> int32 histogram (16-bit quantized gradients).
int LGBM_ENTRY(i16)(LGBM_HISTOGRAM_ARGS) {
  return launch<int16_t, int, int>(LGBM_HISTOGRAM_PASS);
}

// The device-count entries: the first *count rows of idx, with count an
// int32 in device memory.
int LGBM_ENTRY(f32_dev)(LGBM_HISTOGRAM_DEV_ARGS) {
  return launch_dev<float, float, float>(LGBM_HISTOGRAM_DEV_PASS);
}

int LGBM_ENTRY(f64_dev)(LGBM_HISTOGRAM_DEV_ARGS) {
  return launch_dev<float, double, float>(LGBM_HISTOGRAM_DEV_PASS);
}

int LGBM_ENTRY(i8_dev)(LGBM_HISTOGRAM_DEV_ARGS) {
  return launch_dev<int8_t, int, int>(LGBM_HISTOGRAM_DEV_PASS);
}

int LGBM_ENTRY(i16_dev)(LGBM_HISTOGRAM_DEV_ARGS) {
  return launch_dev<int16_t, int, int>(LGBM_HISTOGRAM_DEV_PASS);
}

// the kernel's limits, for the launch plan
int LGBM_ENTRY(max_smem)(void) { return kMaxSmem; }

const char* lgbm_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
