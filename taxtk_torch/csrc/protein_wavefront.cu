// Protein global alignment (BLOSUM62, linear gap -1) with traceback stats,
// a band of warps per pair, for Hopper (sm_90a).
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
// kernel stops at the pair's own lengths, so no sentinel is ever read.  A
// pair with an empty side gets -max(alen, blen) and zero stats.  The rule
// is not symmetric in a and b, so a stays on the rows: no pair is
// transposed.
//
// What bounds it on this card: integer issue.  A cell is 9 essential
// INT32 ops (chip_smoke.py's OPS_PER_CELL: the diagonal's add, an add-max
// for max(left, up) - 1, the max with the diagonal, three compares, two
// selects of the stats, one add of both stat increments); the H100 issues
// 132 SMs x 128 lanes of them a clock.  A step adds four shuffles (the cell
// above and the band's head, score and stats each), two selects of lane
// 0's input, two shared-memory loads (the b code, the table entry) and
// lane 31's ring store: some 23 instructions a warp step in ptxas's
// output (40 registers, no spill).  Neither a bank-conflict-free copy of
// the table per lane nor loading the step's table entries a few steps
// ahead made the kernel faster where the launch has many pairs: there the
// step's instructions and shuffles, not the chain's latency, hold it.
//
// Layout.  One block per pair, nw warps (a launch argument, 1 to 16; the
// wrapper's kernel_geometry sets it from the bucket's M).  A
// band is nw consecutive strips of 32 rows; warp w of a band takes rows
// top + 32w + 1 .. top + 32w + 32, one row a lane, and sweeps the columns
// as a skewed wavefront: at its step s lane l is at column s - l + 1.  The
// cell above a lane's row comes from lane l-1's previous step by
// __shfl_up_sync; lane 0's (row top + 32w) comes from the warp above.
//
// The step's chain.  The old kernel (one warp per pair walking its strips
// in turn) had lane 0 load the row above and the b code from global memory
// inside every step, some 600 cycles a step.  Here nothing on a step's
// chain leaves the SM:
//   * warps are chained through a shared-memory ring: lane 31 of warp w
//     stores its (score, stats) each step; warp w+1 runs 64 steps behind
//     and, at the start of each tile of 32 steps, loads the 32 entries its
//     lane 0 will need (one per lane) and broadcasts one a step by
//     __shfl_sync; a named barrier over the band's warps (bar.sync 1,
//     32 * warps) every tile orders the ring (myers_systolic.cu's and
//     dna_wavefront.cu's idiom);
//   * the b codes sit in a shared-memory ring of 2,048 bytes that the
//     band's first warp fills a tile ahead of every warp's use, so a lane
//     reads its step's code (and then its table entry) at an address known
//     before the step: the loads issue ahead of the chain;
//   * a pair taller than one band runs its bands in turn in the same
//     block: the band's last warp copies each tile's 32 ring entries to
//     the pair's DP row in global scratch (coalesced int2, after the
//     tile), and the next band's first warp loads that row and the b
//     codes one tile (32 columns) ahead of the step that needs them.  The
//     band barrier orders the copy before the load (same block).
// So a pair of m rows takes about ceil(m / (32 nw)) * (n + 31 + 64 (nw -
// 1)) steps with its strips running concurrently, against ceil(m / 32) *
// (n + 31) steps of a serial walk.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CODES = 32;
constexpr int GAP = -1;
constexpr int MAX_WARPS = 16;  // the wrapper mirrors it
constexpr int TILE = 32;       // steps between barriers
constexpr int RING = 128;      // ring entries per warp (a power of two)
constexpr int LAG = 2 * TILE;  // steps warp w+1 runs behind warp w
// b-code ring: a power of two above the widest span of columns a band
// reads between two writes of a slot (LAG * (MAX_WARPS - 1) + 3 * TILE),
// mirrored for its first TILE bytes so that a lane's 32 steps of a tile
// read consecutive bytes
constexpr int BRING = 2048;
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void band_barrier(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ int code_at(const int8_t* col, long long stride,
                                       int pos) {
  const int c = static_cast<uint8_t>(col[static_cast<long long>(pos) * stride]);
  return c < CODES - 1 ? c : CODES - 1;
}

// One tile (32 steps) of one warp: at step r lane l is at 0-based column
// jb + r (jb = s0 - l).  head_s/head_x: lane l holds lane 0's cell above
// for step r = l.  bwin[r]: the b code of column jb + r.  Lane 31 stores
// its cell of step r to slot[r].  CHECK: some lane is outside [0, n) in
// this tile.
template <bool CHECK>
__device__ __forceinline__ void tile(int2* __restrict__ slot,
                                     const uint8_t* __restrict__ bwin,
                                     const int* __restrict__ subrow, int ac,
                                     int lane, int jb, int n, int head_s,
                                     int head_x, int& left_s,
                                     unsigned& left_x, int& diag_s,
                                     unsigned& diag_x) {
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const int recv_s = __shfl_up_sync(FULL, left_s, 1);
    const unsigned recv_x = __shfl_up_sync(FULL, left_x, 1);
    const int hs = __shfl_sync(FULL, head_s, r);
    const unsigned hx = static_cast<unsigned>(__shfl_sync(FULL, head_x, r));
    const int bc = bwin[r];
    const int sc = subrow[bc];
    const unsigned inc = ac == bc ? 0x10001u : 0x10000u;
    if (!CHECK || static_cast<unsigned>(jb + r) < static_cast<unsigned>(n)) {
      const int up_s = lane == 0 ? hs : recv_s;
      const unsigned up_x = lane == 0 ? hx : recv_x;
      const int dv = diag_s + sc;
      const int best = max(dv, max(left_s, up_s) + GAP);
      const unsigned x =
          dv == best ? diag_x + inc : (left_s >= up_s ? left_x : up_x);
      diag_s = up_s;
      diag_x = up_x;
      left_s = best;
      left_x = x;
    }
    if (lane == 31) slot[r] = make_int2(left_s, static_cast<int>(left_x));
  }
}

__global__ void __launch_bounds__(MAX_WARPS * 32) protein_wavefront_kernel(
    const int8_t* __restrict__ pool, long long stride,
    const int32_t* __restrict__ a_col, const int32_t* __restrict__ b_col,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ blen,
    const int32_t* __restrict__ sub_g, int2* __restrict__ scratch,
    int32_t* __restrict__ out, int n_pairs, int row_stride, int nw) {
  __shared__ int sub[CODES * CODES];
  __shared__ int2 ring[MAX_WARPS][RING];
  __shared__ uint8_t bring[BRING + TILE];
  const int p = blockIdx.x;
  const int m = alen[p];
  const int n = blen[p];
  if (m == 0 || n == 0) {  // block-uniform
    if (threadIdx.x == 0) {
      out[p] = GAP * max(m, n);
      out[n_pairs + p] = 0;
    }
    return;
  }
  for (int k = threadIdx.x; k < CODES * CODES; k += blockDim.x) {
    sub[k] = sub_g[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int strips = (m + 31) / 32;
  const int8_t* acol = pool + a_col[p];
  const int8_t* bcol = pool + b_col[p];
  int2* rb = scratch + static_cast<long long>(p) * row_stride;
  // the bands of the pair in turn; a band's warps are its first nws
  for (int top = 0; top < m; top += 32 * nw) {
    const int nws = min(nw, strips - top / 32);
    if (w >= nws) return;  // warp-uniform: no later band has more warps
    const int i = top + 32 * w + lane + 1;  // this lane's row
    const int ac = i <= m ? code_at(acol, stride, i - 1) : CODES - 1;
    const int* subrow = sub + ac * CODES;
    int left_s = GAP * i;  // H(i, 0)
    unsigned left_x = 0u;
    int diag_s = GAP * (i - 1);  // H(i-1, 0)
    unsigned diag_x = 0u;
    // the band's last warp hands its last row to the next band
    const bool publish = w == nws - 1 && top + 32 * nws < m;
    const int steps = n + 31 + LAG * (nws - 1);
    // the first warp's next tile: lane l holds column base + l's b code
    // and the cell above the band there, H(top, column + 1)
    int next_c = CODES - 1;
    int2 next_h = make_int2(0, 0);
    auto fetch = [&](int base) {
      const int c = base + lane;
      if (c < n) {
        next_c = code_at(bcol, stride, c);
        next_h = top == 0 ? make_int2(GAP * (c + 1), 0) : __ldcg(rb + c);
      }
    };
    if (w == 0) fetch(0);
    for (int t0 = 0; t0 < steps; t0 += TILE) {
      const int s0 = t0 - LAG * w;  // this warp's first step of the tile
      int2 head;
      if (w == 0) {
        head = next_h;
        const int slot = (t0 + lane) & (BRING - 1);
        bring[slot] = static_cast<uint8_t>(next_c);
        if (slot < TILE) bring[slot + BRING] = static_cast<uint8_t>(next_c);
        if (t0 + TILE < n) fetch(t0 + TILE);
        __syncwarp();
      } else {
        // lane 31 of warp w-1 stored column s0 + lane at its band clock
        // t0 + lane - (LAG - 31)
        head = ring[w - 1][(t0 + lane - (LAG - 31)) & (RING - 1)];
      }
      if (s0 + TILE > 0 && s0 - 31 < n) {  // warp-uniform: some lane is live
        int2* slot = ring[w] + (t0 & (RING - 1));
        const int jb = s0 - lane;
        const uint8_t* bwin = bring + (jb & (BRING - 1));
        if (s0 >= 31 && s0 + TILE <= n) {
          tile<false>(slot, bwin, subrow, ac, lane, jb, n, head.x, head.y,
                      left_s, left_x, diag_s, diag_x);
        } else {
          tile<true>(slot, bwin, subrow, ac, lane, jb, n, head.x, head.y,
                     left_s, left_x, diag_s, diag_x);
        }
        if (publish) {
          // lane 31's columns of this tile, s0 - 31 .. s0, to the DP row
          __syncwarp();
          const int c = s0 - 31 + lane;
          if (c >= 0 && c < n) rb[c] = ring[w][(t0 + lane) & (RING - 1)];
        }
      }
      band_barrier(32 * nws);
    }
    // the lane of row m holds H(m, n) and its stats
    if (i == m) {
      out[p] = left_s;
      out[n_pairs + p] = static_cast<int>(left_x);
    }
  }
}

}  // namespace

// Plain C entry (bound with ctypes).  out is int32 [2, n_pairs] (score,
// dc << 16 | matches); scratch holds n_pairs x row_stride int2 (row_stride
// >= every blen) where a pair can have more than one band (alen > 32 * nw),
// else it is not read.  nw: warps per band, 1 to 16.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for nw
// outside [1, 16].
extern "C" int taxtk_protein_wavefront(const void* pool, long long stride,
                                       const void* a_col, const void* b_col,
                                       const void* alen, const void* blen,
                                       const void* sub, void* scratch,
                                       void* out, int n_pairs, int row_stride,
                                       int nw, void* stream) {
  if (nw < 1 || nw > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs <= 0) return 0;
  protein_wavefront_kernel<<<n_pairs, 32 * nw, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pool), stride,
      static_cast<const int32_t*>(a_col), static_cast<const int32_t*>(b_col),
      static_cast<const int32_t*>(alen), static_cast<const int32_t*>(blen),
      static_cast<const int32_t*>(sub), static_cast<int2*>(scratch),
      static_cast<int32_t*>(out), n_pairs, row_stride, nw);
  return static_cast<int>(cudaGetLastError());
}
