// Pattern-block Myers edit distance, one block of KB pattern words per
// launch, one thread per pair, for Hopper (sm_90a).
//
// Replaces: taxtk/ops/pallas_myers.py::_make_kernel_chunked (the Pallas
// TPU kernel launched by _pallas_chunked, once per pattern block, from
// batched_edit_distance_pallas_myers_long).
//
// What it computes: one launch of Myers' bit-parallel recurrence (Myers,
// JACM 1999; Hyyro's block form) for pattern words p*KB .. p*KB+KB-1 of
// each pair over the pair's whole text.  The launch contract is the TPU
// kernel's, and that of ops/myers_ref.py::myers_block_step:
//   * Pv = ~0 and Mv = 0 at the start of every launch;
//   * the carries into word 0 at text position j come from hin[j]
//     (ph | mh << 1), the carries out of word KB-1 go to hout[j];
//   * the pattern-end mask is set only in word mword (relative to this
//     block; outside [0, KB) when the pattern ends in another block);
//   * score and res come in from the previous launch and go out; res is
//     harvested at j == n_len, where the score stops moving.
// The thread stops at its own n_len: hin and hout are read and written
// for j < n_len only, which is all the next launch reads.
//
// Layout: the text comes straight from the resident sequence pool (2 or 4
// codes per byte, lowest field first), the match masks from the device-
// built planes peq[KB, ALPHA, U] of this block through pat_idx, and the
// carry stream hin/hout [N, B] int8 is coalesced across the pairs of a
// warp (pair-minor).
//
// What bounds it on this card: integer issue.  Each (char, word) step is ~13
// essential 32-bit logic/add/shift instructions for 32 DP cells (132 SMs x 128
// lanes per clock, ALU and FMA pipes); the carry stream adds 2 bytes per pair
// per char per block.  Design response, as Kernel 1 (csrc/myers_short.cu): KB
// is a template parameter so Pv/Mv live in registers (at KB = 64 that is 128
// of the 255 registers a thread may hold), and one warp per block spreads a
// small batch over as many SMs as it has warps.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ALPHA = 5;
constexpr int THREADS = 32;  // 1024 pairs -> 32 blocks

template <int KB, int BITS>
__global__ void __launch_bounds__(THREADS) myers_chunked_kernel(
    const int8_t* __restrict__ pool, long long pool_stride, int pool_rows,
    const int32_t* __restrict__ txt_col,
    const uint32_t* __restrict__ peq, long long peq_cols,
    const int32_t* __restrict__ pat_idx, const int32_t* __restrict__ mword,
    const int32_t* __restrict__ mbit, const int32_t* __restrict__ nlen,
    const int32_t* __restrict__ score_in, const int32_t* __restrict__ res_in,
    const int8_t* __restrict__ hin, int32_t* __restrict__ score_out,
    int32_t* __restrict__ res_out, int8_t* __restrict__ hout, int n_pairs) {
  constexpr int CPB = 8 / BITS;
  constexpr int FMASK = (1 << BITS) - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const int n = nlen[i];
  const int kk = mword[i];  // no hmask bit when outside [0, KB)
  const uint32_t bit = 1u << (mbit[i] & 31);
  uint32_t pv[KB], mv[KB];
#pragma unroll
  for (int k = 0; k < KB; ++k) {
    pv[k] = 0xFFFFFFFFu;
    mv[k] = 0u;
  }
  int score = score_in[i];
  int res = res_in[i];
  const int8_t* col = pool + txt_col[i];
  const uint32_t* pq = peq + pat_idx[i];
  int packed = 0xFF;
  for (int j = 0; j < n; ++j) {
    const int f = j % CPB;
    if (f == 0) {
      const int row = j / CPB;
      packed = row < pool_rows
                   ? static_cast<int>(static_cast<uint8_t>(
                         col[static_cast<long long>(row) * pool_stride]))
                   : 0xFF;
    }
    const int tc = (packed >> (f * BITS)) & FMASK;
    const long long h = static_cast<long long>(j) * n_pairs + i;
    const int carry_in = hin[h];
    uint32_t carry_ph = carry_in & 1, carry_mh = (carry_in >> 1) & 1;
    uint32_t ph_hit = 0u, mh_hit = 0u;
#pragma unroll
    for (int k = 0; k < KB; ++k) {
      const uint32_t eq0 =
          (BITS == 2 || tc < ALPHA)
              ? __ldg(pq + static_cast<long long>(k * ALPHA + tc) * peq_cols)
              : 0u;
      const uint32_t pv_k = pv[k];
      const uint32_t mv_k = mv[k];
      const uint32_t eq = eq0 | carry_mh;
      const uint32_t xv = eq | mv_k;
      const uint32_t add = (eq & pv_k) + pv_k;
      const uint32_t xh = (add ^ pv_k) | eq;
      const uint32_t ph = mv_k | ~(xh | pv_k);
      const uint32_t mh = pv_k & xh;
      const uint32_t hm = (k == kk) ? bit : 0u;
      ph_hit |= ph & hm;
      mh_hit |= mh & hm;
      const uint32_t ph_shift = (ph << 1) | carry_ph;
      const uint32_t mh_shift = (mh << 1) | carry_mh;
      carry_ph = ph >> 31;
      carry_mh = mh >> 31;
      pv[k] = mh_shift | ~(xv | ph_shift);
      mv[k] = ph_shift & xv;
    }
    hout[h] = static_cast<int8_t>(carry_ph | (carry_mh << 1));
    score += static_cast<int>(ph_hit != 0u) - static_cast<int>(mh_hit != 0u);
    if (j + 1 == n) res = score;
  }
  score_out[i] = score;
  res_out[i] = res;
}

template <int KB>
int launch(int bits, dim3 grid, cudaStream_t st, const int8_t* pool,
           long long stride, int rows, const int32_t* txt_col,
           const uint32_t* peq, long long peq_cols, const int32_t* pat_idx,
           const int32_t* mword, const int32_t* mbit, const int32_t* nlen,
           const int32_t* score_in, const int32_t* res_in, const int8_t* hin,
           int32_t* score_out, int32_t* res_out, int8_t* hout, int n) {
  if (bits == 2) {
    myers_chunked_kernel<KB, 2><<<grid, THREADS, 0, st>>>(
        pool, stride, rows, txt_col, peq, peq_cols, pat_idx, mword, mbit,
        nlen, score_in, res_in, hin, score_out, res_out, hout, n);
  } else if (bits == 4) {
    myers_chunked_kernel<KB, 4><<<grid, THREADS, 0, st>>>(
        pool, stride, rows, txt_col, peq, peq_cols, pat_idx, mword, mbit,
        nlen, score_in, res_in, hin, score_out, res_out, hout, n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry (bound with ctypes).  hin and hout are int8 [N, n_pairs]
// (N >= every n_len); score/res in and out int32 [n_pairs]; peq points at
// this block's first word.  Returns cudaGetLastError() after the launch,
// or cudaErrorInvalidValue for a block width or bits outside the set.
extern "C" int taxtk_myers_chunked(
    const void* pool, long long pool_stride, int pool_rows,
    const void* txt_col, const void* peq, long long peq_cols,
    const void* pat_idx, const void* mword, const void* mbit,
    const void* nlen, const void* score_in, const void* res_in,
    const void* hin, void* score_out, void* res_out, void* hout,
    int n_pairs, int KB, int bits, void* stream) {
  if (n_pairs <= 0) return 0;
  const dim3 grid((n_pairs + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) {
    return static_cast<const int32_t*>(p);
  };
  switch (KB) {
    case 64:
      return launch<64>(
          bits, grid, st, static_cast<const int8_t*>(pool), pool_stride,
          pool_rows, i32(txt_col), static_cast<const uint32_t*>(peq),
          peq_cols, i32(pat_idx), i32(mword), i32(mbit), i32(nlen),
          i32(score_in), i32(res_in), static_cast<const int8_t*>(hin),
          static_cast<int32_t*>(score_out), static_cast<int32_t*>(res_out),
          static_cast<int8_t*>(hout), n_pairs);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
