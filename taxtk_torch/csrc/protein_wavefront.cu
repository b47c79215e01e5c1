// Protein global alignment (BLOSUM62, linear gap -1) with traceback stats,
// one warp per pair, for Hopper (sm_90a).
//
// Replaces: taxtk/ops/pallas_protein.py::_make_kernel (the v5 Pallas TPU
// kernel, launched by _raw_call from _from_codes / _call_pool).
//
// What it computes, per pair: the Needleman-Wunsch score H(alen, blen) of
// a (rows) against b (columns), and the match and diagonal-step counts of
// the preferred optimal path packed as dc << 16 | matches (unsigned
// wrap, as v5's carry).  The cell rule is v5's to the letter:
//   diag = H(i-1, j-1) + SUB[a_i][b_j], gapbest = max(left, up) - 1,
//   best = max(diag, gapbest); the diagonal wins ties; otherwise the
//   horizontal arm (left, consume-B) wins when left >= up;
//   boundaries H(i, 0) = -i and H(0, j) = -j with zero stats.
// Codes clamp to 31 and SUB is the 32 x 32 table unpacked from v5's
// nibble-packed profile (sentinels score -4); a == b counts a match.  The
// warp stops at the pair's own lengths, so no sentinel is ever read.  A
// pair with an empty side gets -max(alen, blen) and zero stats.
//
// Layout: a and b come straight from the bits=8 sequence pool (one code
// per byte, column per sequence).  Lanes take 32 consecutive rows (a
// strip); the strip sweeps the columns as a skewed wavefront: at step s
// lane l is at column s - l + 1.  The cell above comes from lane l-1's
// previous step by __shfl_up_sync, with the b code riding along, so the
// warp reads one b code per step.  Lane 0 takes the row above the strip
// from a per-pair DP row in global scratch, which lane 31 overwrites with
// the strip's last row: per-pair state does not depend on shared memory,
// so any bucket length works.
//
// What bounds it on this card: integer issue.  Each cell is 12 essential INT32
// ops (the table load, two adds, two maxes, three compares, two selects of the
// stats, two stat increments); the H100 issues 132 SMs x 128 lanes of them per
// clock (ALU and FMA pipes).  The per-step shuffles (3) and the skew (31 idle
// lane-steps per strip of 32 rows) are the overhead this design pays for its
// simplicity.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CODES = 32;
constexpr int GAP = -1;
constexpr int WARPS = 4;  // pairs per block
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ int code_at(const int8_t* col, long long stride,
                                       int pos) {
  const int c = static_cast<uint8_t>(col[static_cast<long long>(pos) * stride]);
  return c < CODES - 1 ? c : CODES - 1;
}

__global__ void __launch_bounds__(WARPS * 32) protein_wavefront_kernel(
    const int8_t* __restrict__ pool, long long stride,
    const int32_t* __restrict__ a_col, const int32_t* __restrict__ b_col,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ blen,
    const int32_t* __restrict__ sub_g, int2* __restrict__ scratch,
    int32_t* __restrict__ out, int n_pairs, int n_max) {
  __shared__ int sub[CODES * CODES];
  for (int k = threadIdx.x; k < CODES * CODES; k += blockDim.x) {
    sub[k] = sub_g[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int p = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (p >= n_pairs) return;  // warp-uniform
  const int m = alen[p];
  const int n = blen[p];
  if (m == 0 || n == 0) {
    if (lane == 0) {
      out[p] = GAP * max(m, n);
      out[n_pairs + p] = 0;
    }
    return;
  }
  const int8_t* acol = pool + a_col[p];
  const int8_t* bcol = pool + b_col[p];
  int2* row = scratch + static_cast<long long>(p) * (n_max + 1);
  for (int j = lane; j <= n; j += 32) row[j] = make_int2(GAP * j, 0);
  __syncwarp();

  for (int i0 = 0; i0 < m; i0 += 32) {
    const int i = i0 + lane + 1;  // this lane's row
    const int ac = i <= m ? code_at(acol, stride, i - 1) : CODES - 1;
    const int* subrow = sub + ac * CODES;
    int left_s = GAP * i;  // H(i, 0)
    unsigned left_x = 0u;
    int diag_s = GAP * (i - 1);  // H(i-1, 0)
    unsigned diag_x = 0u;
    int bc = CODES - 1;
    const int steps = n + min(31, m - i0 - 1);
    for (int s = 0; s < steps; ++s) {
      const int j = s - lane + 1;
      // lane l-1's cell of the previous step is H(i-1, j) here
      int up_s = __shfl_up_sync(FULL, left_s, 1);
      unsigned up_x = __shfl_up_sync(FULL, left_x, 1);
      const int up_b = __shfl_up_sync(FULL, bc, 1);
      if (j < 1 || j > n) continue;
      if (lane == 0) {
        const int2 u = row[j];
        up_s = u.x;
        up_x = static_cast<unsigned>(u.y);
        bc = code_at(bcol, stride, j - 1);
      } else {
        bc = up_b;
      }
      const int dv = diag_s + subrow[bc];
      const int gb = max(left_s, up_s) + GAP;
      const int best = max(dv, gb);
      unsigned x;
      if (dv == best) {
        x = diag_x + static_cast<unsigned>(ac == bc) + 0x10000u;
      } else {
        x = left_s >= up_s ? left_x : up_x;
      }
      diag_s = up_s;
      diag_x = up_x;
      left_s = best;
      left_x = x;
      if (lane == 31) row[j] = make_int2(best, static_cast<int>(x));
      if (i == m && j == n) {
        out[p] = best;
        out[n_pairs + p] = static_cast<int>(x);
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Plain C entry (bound with ctypes).  out is int32 [2, n_pairs] (score,
// dc << 16 | matches); scratch holds n_pairs x (n_max + 1) int2.  Returns
// cudaGetLastError() after the launch.
extern "C" int taxtk_protein_wavefront(const void* pool, long long stride,
                                       const void* a_col, const void* b_col,
                                       const void* alen, const void* blen,
                                       const void* sub, void* scratch,
                                       void* out, int n_pairs, int n_max,
                                       void* stream) {
  if (n_pairs <= 0) return 0;
  const dim3 grid((n_pairs + WARPS - 1) / WARPS);
  protein_wavefront_kernel<<<grid, WARPS * 32, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pool), stride,
      static_cast<const int32_t*>(a_col), static_cast<const int32_t*>(b_col),
      static_cast<const int32_t*>(alen), static_cast<const int32_t*>(blen),
      static_cast<const int32_t*>(sub), static_cast<int2*>(scratch),
      static_cast<int32_t*>(out), n_pairs, n_max);
  return static_cast<int>(cudaGetLastError());
}
