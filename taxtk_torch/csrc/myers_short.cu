// Short-pair Myers edit distance, one thread per pair, for Hopper (sm_90a).
//
// Replaces: taxtk/ops/pallas_myers.py::_make_kernel (the single-launch
// Pallas TPU kernel, launched by _pallas_single through _call_pool).
//
// What it computes: the exact global edit distance of each pair by Myers'
// bit-parallel recurrence (Myers, JACM 1999; Hyyro's block form), the
// shorter side as the pattern of K 32-bit words, the text streamed one
// char at a time.  The rules of the TPU kernel are kept to the letter:
//   * init Pv = ~0, Mv = 0, score = m_len, res = max(m_len, n_len), and a
//     single-bit hmask at the pattern's last cell (word (m-1)>>5, bit
//     (m-1)&31; m == 0 sets no bit and the host pins the result);
//   * a text code >= ALPHA (the 4-bit sentinel 15) matches nothing;
//   * res = score is harvested at j == n_len, so pad codes past a text's
//     end (2-bit pad reads as code 3) never reach the result.
//
// Layout: the text comes straight from the resident sequence pool
// (pool[row, txt_col[pair]], 2 or 4 codes per byte, lowest field first),
// and the pattern match masks from the device-built planes
// peq[K, ALPHA, U] through pat_idx[pair].  Nothing is staged per launch.
//
// What bounds it on this card: integer issue.  Each (char, word) step is ~13
// essential 32-bit logic/add/shift instructions for 32 DP cells; the H100
// issues 132 SMs x 128 lanes of them per clock (ALU and FMA pipes).  The
// per-word peq load (4 B per word per char, from L1/L2) is the second limit.
// Design response: K is a template parameter so Pv/Mv live in registers (zero
// pad words are inert, as taxtk's _quantize_K notes), and the thread stops at
// its own n_len instead of running the launch-wide text extent.  Keeping a
// warp's peq in shared memory, or a warp per pair with shuffled carries, is
// later work.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ALPHA = 5;
constexpr int THREADS = 64;  // 8192 pairs -> 128 blocks, about one per SM

template <int K, int BITS>
__global__ void __launch_bounds__(THREADS) myers_short_kernel(
    const int8_t* __restrict__ pool, long long pool_stride, int pool_rows,
    const int32_t* __restrict__ txt_col,
    const uint32_t* __restrict__ peq, long long peq_cols,
    const int32_t* __restrict__ pat_idx,
    const int32_t* __restrict__ nlen, const int32_t* __restrict__ mlen,
    int32_t* __restrict__ out, int n_pairs) {
  constexpr int CPB = 8 / BITS;
  constexpr int FMASK = (1 << BITS) - 1;
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pairs) return;
  const int n = nlen[i];
  const int m = mlen[i];
  uint32_t pv[K], mv[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    pv[k] = 0xFFFFFFFFu;
    mv[k] = 0u;
  }
  int score = m;
  int res = max(m, n);
  const int mm = m - 1;
  const int kk = mm >> 5;  // -1 when m == 0: no hmask bit anywhere
  const uint32_t bit = 1u << (mm & 31);
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
    uint32_t carry_ph = 1u, carry_mh = 0u, ph_hit = 0u, mh_hit = 0u;
#pragma unroll
    for (int k = 0; k < K; ++k) {
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
    score += static_cast<int>(ph_hit != 0u) - static_cast<int>(mh_hit != 0u);
    if (j + 1 == n) res = score;
  }
  out[i] = res;
}

template <int K>
int launch(int bits, dim3 grid, cudaStream_t st, const int8_t* pool,
           long long stride, int rows, const int32_t* txt_col,
           const uint32_t* peq, long long peq_cols, const int32_t* pat_idx,
           const int32_t* nlen, const int32_t* mlen, int32_t* out, int n) {
  if (bits == 2) {
    myers_short_kernel<K, 2><<<grid, THREADS, 0, st>>>(
        pool, stride, rows, txt_col, peq, peq_cols, pat_idx, nlen, mlen, out,
        n);
  } else if (bits == 4) {
    myers_short_kernel<K, 4><<<grid, THREADS, 0, st>>>(
        pool, stride, rows, txt_col, peq, peq_cols, pat_idx, nlen, mlen, out,
        n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry (bound with ctypes).  Returns cudaGetLastError() after the
// launch, or cudaErrorInvalidValue for a K or bits outside the template set.
extern "C" int taxtk_myers_short(const void* pool, long long pool_stride,
                                 int pool_rows, const void* txt_col,
                                 const void* peq, long long peq_cols,
                                 const void* pat_idx, const void* nlen,
                                 const void* mlen, void* out, int n_pairs,
                                 int K, int bits, void* stream) {
  if (n_pairs <= 0) return 0;
  const dim3 grid((n_pairs + THREADS - 1) / THREADS);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int8_t*>(pool);
  const auto* tcol = static_cast<const int32_t*>(txt_col);
  const auto* q = static_cast<const uint32_t*>(peq);
  const auto* pidx = static_cast<const int32_t*>(pat_idx);
  const auto* nl = static_cast<const int32_t*>(nlen);
  const auto* ml = static_cast<const int32_t*>(mlen);
  auto* o = static_cast<int32_t*>(out);
  switch (K) {
    case 1: return launch<1>(bits, grid, st, p, pool_stride, pool_rows, tcol, q, peq_cols, pidx, nl, ml, o, n_pairs);
    case 2: return launch<2>(bits, grid, st, p, pool_stride, pool_rows, tcol, q, peq_cols, pidx, nl, ml, o, n_pairs);
    case 4: return launch<4>(bits, grid, st, p, pool_stride, pool_rows, tcol, q, peq_cols, pidx, nl, ml, o, n_pairs);
    case 8: return launch<8>(bits, grid, st, p, pool_stride, pool_rows, tcol, q, peq_cols, pidx, nl, ml, o, n_pairs);
    case 16: return launch<16>(bits, grid, st, p, pool_stride, pool_rows, tcol, q, peq_cols, pidx, nl, ml, o, n_pairs);
    case 32: return launch<32>(bits, grid, st, p, pool_stride, pool_rows, tcol, q, peq_cols, pidx, nl, ml, o, n_pairs);
    case 64: return launch<64>(bits, grid, st, p, pool_stride, pool_rows, tcol, q, peq_cols, pidx, nl, ml, o, n_pairs);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
