// Batched Levenshtein distance by the min-plus wavefront, for Hopper
// (sm_90a).
//
// Replaces: taxtk/ops/pallas_dna.py::_kernel (the Pallas TPU kernel of the
// `wavefront` DNA backend's drop-in, launched by _pallas_call).
//
// What it computes, per pair: D(alen, blen) of
//   D(i, j) = min(D(i-1, j) + 1, D(i, j-1) + 1, D(i-1, j-1) + (a_i != b_j)),
//   D(i, 0) = i, D(0, j) = j,
// over the pair's own alen x blen cells.  Codes compare by equality, so N
// (code 4) matches N, as `a_ext != bx` does in the TPU kernel.  A pair with
// an empty side gets max(alen, blen).  The distance is symmetric, so each
// pair runs with its longer side as the rows (b's codes where blen > alen)
// and its shorter side as the columns.  The TPU kernel's pad layout (a_ext
// and the reversed, sentinel-padded b, there for the lane roll) has no
// counterpart: the kernel reads both sides as they are and stops each pair
// at its own last column.
//
// What bounds it on this card: integer issue.  A cell is 3 INT32
// instructions.  On a match D = D(i-1, j-1), which is never more than the
// other two terms + 1 (neighbouring cells differ by at most 1); otherwise
// D = min(up, left, diag) + 1.  So: the compare a_i == b_j, one DPX
// three-way min __vimin3_s32, and the +1 as an add predicated on the
// mismatch, written over the register that holds diag (which is the
// answer on a match): the add is the select.  The H100 issues 132 SMs x
// 128 lanes of integer instructions a clock.  Two of the three are on the
// serial chain down a lane's rows (min, add).  Forms with a one-op chain,
// D = min(up + 1, min(left + 1, diag + cost)) with two DPX add-mins, take
// 4 to 5 instructions a cell (ptxas turns the cost into a compare, an add
// and a predicated move) and were the slower at the engine's largest
// launch on the H100, the faster only where a few long pairs leave the
// card short of warps; there the wrapper takes R = 4, which halves the
// chain a step.  Beside the cells, a step costs
// two shuffles, the unpack and the pack of the packed value, the range
// test of edge tiles and a shared-memory store; the design spreads those
// over R rows a lane and keeps global memory off the critical path.
//
// Layout.  A strip is H = 32 * R consecutive rows (R = 4, 8 or 16, a
// template argument; the wrapper takes 8 for launches that fill the card,
// 4 below).  Lane l of a warp owns rows l*R+1 .. l*R+R of its strip and
// sweeps the columns as a skewed wavefront: at step s lane l is at column
// s - l.  The cell above a lane's first row and the column's code come
// from lane l-1's previous step, packed into one __shfl_up_sync (value |
// code << 24; values stay below 2^24).
//
// A band.  A block of nw warps (nw <= 16; the wrapper takes 4, or a
// pair's strips if fewer: chip_smoke.py times 1 to 16 on one long pair) runs
// nw consecutive strips of one pair.  Warp w+1 trails warp w through a
// shared-memory ring: lane 31 of warp w stores its packed value each
// step, lane 0 of warp w+1 reads it 33 steps later; a named barrier
// over the band's warps (bar.sync 1, 32 * warps) every 32 steps orders the
// ring, and warp w+1 runs 64 steps behind warp w, so that what it reads in
// a tile was written before the last barrier (the idiom of
// myers_systolic.cu).  The band's last row goes to global memory only when
// another band of the pair follows: after each tile its last warp copies
// the tile's 32 ring entries to the pair's boundary row, fences, and
// publishes how many columns are there.  Only the band's first warp reads
// that row, and it loads the next tile's 32 entries before it computes the
// current tile, polling the counter only when the value it saw last does
// not cover them: the L2 round trip overlaps a tile of compute, and fences,
// polls and boundary traffic are 1/nw of a strip-per-warp design's.  A
// band shorter than nw strips (a pair's last band) runs its own warps only;
// the barrier counts them, and the idle warps wait for the next ticket.
//
// Tickets.  Blocks take bands in ticket order (one global atomicAdd per
// band), band-major: ticket t is band t / n_pairs of pair t % n_pairs, up
// to the most bands a pair of the launch's widths can have, and a ticket
// past its pair's bands (or of an empty side) is passed over.  So the
// launch needs no table of its pairs' bands, and the wrapper no pass over
// the lengths.  Band b of a pair waits only on band b-1, whose ticket is
// n_pairs less and was taken by a block that was running then and holds it
// to the end: no deadlock in any block order.  A wait of seconds means a
// broken invariant: the poll traps instead of hanging the card.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int MAX_WARPS = 16;  // the wrapper mirrors it
constexpr int TILE = 32;       // steps between barriers
constexpr int RING = 128;      // ring entries per warp (a power of two)
constexpr int WARP_LAG = 2 * TILE;  // steps warp w+1 runs behind warp w
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int VMASK = 0xFFFFFF;

__device__ __forceinline__ void band_barrier(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ int load_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// One tile (32 steps) of one warp: lane l takes columns c0 - l .. c0 + 31
// - l (0-based).  CHECK: some lane is outside [0, n) in this tile.
template <int R, bool CHECK>
__device__ __forceinline__ void tile(int* slot, int lane, int c0, int n,
                                     int chunk, const int (&acode)[R],
                                     int (&col)[R], int& diag, int& send) {
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const int recv = __shfl_up_sync(FULL, send, 1);
    const int head = __shfl_sync(FULL, chunk, r);
    const int c = c0 + r - lane;
    if (!CHECK || (c >= 0 && c < n)) {
      const int inp = lane == 0 ? head : recv;
      const int bc = static_cast<int>(static_cast<unsigned>(inp) >> 24);
      int up = inp & VMASK;
      int dg = diag;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int left = col[k];
        const int m3 = __vimin3_s32(up, left, dg) + 1;
        up = acode[k] == bc ? dg : m3;
        dg = left;
        col[k] = up;
      }
      diag = inp & VMASK;
      send = up | (inp & ~VMASK);
    }
    if (lane == 31) slot[r] = send;
  }
}

// The first warp's input for columns base + lane: the packed (D(top,
// column + 1) | code << 24), from the codes on the pair's first band and
// from the boundary row after the band above published that far on the
// others.  `avail` is the count of published columns this lane 0 saw last.
__device__ __forceinline__ int fetch(const uint8_t* __restrict__ cseq,
                                     const int* rb, const int* wait_on,
                                     int& avail, int base, int n, int lane) {
  const int c = base + lane;
  if (wait_on == nullptr) {
    return c < n ? (c + 1) | (static_cast<int>(cseq[c]) << 24) : 0;
  }
  const int need = min(base + TILE, n);
  if (lane == 0) {
    for (int spins = 0; avail < need; ++spins) {
      avail = load_acquire(wait_on);
      if (avail >= need) break;
      if (spins > (1 << 24)) __trap();
      __nanosleep(128);
    }
  }
  __syncwarp();
  return c < n ? __ldcg(rb + c) : 0;
}

// One warp's strip: rows top+1 .. top+H of a pair with `rows` rows (codes
// rseq) and n columns (codes cseq), the warp w of a band of nws warps.
// wait_on: the band above's published count (null on the first band);
// publish: this band's count (null unless this is the band's last warp and
// a band follows).  The lane that holds row `rows` writes D(rows, n).
template <int R>
__device__ void strip(const uint8_t* __restrict__ rseq,
                      const uint8_t* __restrict__ cseq, int rows, int n,
                      int top, int w, int nws, int* rb, const int* wait_on,
                      int* publish, int (*ring)[RING], int* out_p, int lane) {
  const int row0 = top + lane * R;  // rows row0+1 .. row0+R
  int acode[R], col[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = row0 + k + 1;
    acode[k] = i <= rows ? static_cast<int>(rseq[i - 1]) : 0x100;
    col[k] = i;  // D(i, 0)
  }
  int diag = row0;  // D(row0, 0)
  int send = 0;
  int avail = 0;
  const int lag = WARP_LAG * w;
  const int steps = n + 31 + WARP_LAG * (nws - 1);
  int next = w == 0 ? fetch(cseq, rb, wait_on, avail, 0, n, lane) : 0;
  for (int t0 = 0; t0 < steps; t0 += TILE) {
    const int c0 = t0 - lag;
    int chunk;
    if (w == 0) {
      chunk = next;
      if (t0 + TILE < n) {
        next = fetch(cseq, rb, wait_on, avail, t0 + TILE, n, lane);
      }
    } else {
      // lane 31 of warp w-1 wrote column c0 + lane at its step t0 + lane - 33
      chunk = ring[w - 1][(t0 + lane - (WARP_LAG - 31)) & (RING - 1)];
    }
    if (c0 + 31 >= 0 && c0 - 31 < n) {  // warp-uniform: some lane is live
      int* slot = ring[w] + (t0 & (RING - 1));
      if (c0 >= 31 && c0 + 31 < n) {
        tile<R, false>(slot, lane, c0, n, chunk, acode, col, diag, send);
      } else {
        tile<R, true>(slot, lane, c0, n, chunk, acode, col, diag, send);
      }
      if (publish != nullptr) {
        // lane 31's columns of this tile, c0 - 31 .. c0, to the boundary
        // row for the band below
        __syncwarp();
        const int c = c0 - 31 + lane;
        if (c >= 0 && c < n) rb[c] = ring[w][(t0 + lane) & (RING - 1)];
        __threadfence();
        __syncwarp();
        if (lane == 0 && c0 >= 0) store_volatile(publish, min(c0 + 1, n));
      }
    }
    band_barrier(32 * nws);
  }
  // the lane that holds row `rows` has D(rows, n) in its column state
  const int mrel = rows - 1 - top;
  if (mrel >= 0 && mrel < 32 * R && mrel / R == lane) {
    int v = col[0];
#pragma unroll
    for (int k = 1; k < R; ++k) v = k == mrel % R ? col[k] : v;
    *out_p = v;
  }
}

template <int R>
__global__ void __launch_bounds__(MAX_WARPS * 32) dna_wavefront_kernel(
    const uint8_t* __restrict__ a, long long a_stride,
    const uint8_t* __restrict__ b, long long b_stride,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ blen,
    int* __restrict__ rows_buf, long long row_stride, int* progress,
    int* __restrict__ ticket, int32_t* __restrict__ out, int n_pairs,
    int n_tickets, int nw) {
  __shared__ int ring[MAX_WARPS][RING];
  __shared__ int s_ticket[2];
  // empty sides need no band
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    const int m = alen[p];
    const int n = blen[p];
    if (m == 0 || n == 0) out[p] = max(m, n);
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int it = 0;; ++it) {
    // two slots: a slot is written again only after every warp passed the
    // next __syncthreads, so after it read this one
    if (threadIdx.x == 0) s_ticket[it & 1] = atomicAdd(ticket, 1);
    __syncthreads();
    const int t = s_ticket[it & 1];
    if (t >= n_tickets) return;  // block-uniform
    const int p = t % n_pairs;
    const int band = t / n_pairs;
    const uint8_t* ap = a + p * a_stride;
    const uint8_t* bp = b + p * b_stride;
    const bool sw = blen[p] > alen[p];
    const int rows = sw ? blen[p] : alen[p];
    const int n = sw ? alen[p] : blen[p];
    const int strips = n > 0 ? (rows + 32 * R - 1) / (32 * R) : 0;
    const int s0 = band * nw;
    if (s0 >= strips) continue;  // block-uniform: no such band
    const int nws = min(nw, strips - s0);
    if (warp < nws) {
      const bool last_band = s0 + nws >= strips;
      strip<R>(sw ? bp : ap, sw ? ap : bp, rows, n, (s0 + warp) * 32 * R,
               warp, nws, rows_buf + p * row_stride,
               band > 0 ? progress + t - n_pairs : nullptr,
               warp == nws - 1 && !last_band ? progress + t : nullptr, ring,
               out + p, lane);
    }
  }
}

template <int R>
int launch(int nw, cudaStream_t st, const void* a, long long a_stride,
           const void* b, long long b_stride, const void* alen,
           const void* blen, void* rows, long long row_stride,
           void* progress, void* ticket, void* out, int n_pairs,
           int n_tickets) {
  int per_sm = 0;
  int sms = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, dna_wavefront_kernel<R>, 32 * nw, 0);
  // more blocks than can be resident would only wait for an SM to take a
  // ticket that a running block takes sooner
  const int grid = max(1, min(n_tickets, max(1, per_sm) * sms));
  dna_wavefront_kernel<R><<<grid, 32 * nw, 0, st>>>(
      static_cast<const uint8_t*>(a), a_stride,
      static_cast<const uint8_t*>(b), b_stride,
      static_cast<const int32_t*>(alen), static_cast<const int32_t*>(blen),
      static_cast<int*>(rows), row_stride, static_cast<int*>(progress),
      static_cast<int*>(ticket), static_cast<int32_t*>(out), n_pairs,
      n_tickets, nw);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry (bound with ctypes).  a [n_pairs, a_stride] and b
// [n_pairs, b_stride] uint8 codes; alen, blen int32 [n_pairs]; rows int32
// [n_pairs, row_stride >= min(alen, blen)] scratch; progress int32
// [n_tickets] and ticket int32 [1], both zero; out int32 [n_pairs].
// n_tickets = n_pairs * the most bands a pair can have (ceil(strips / nw),
// strips = ceil(max(alen, blen) / (32 * R))); R in {4, 8, 16}, nw in
// [1, 16].  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for R or nw outside those sets.
extern "C" int taxtk_dna_wavefront(const void* a, long long a_stride,
                                   const void* b, long long b_stride,
                                   const void* alen, const void* blen,
                                   void* rows, long long row_stride,
                                   void* progress, void* ticket, void* out,
                                   int n_pairs, int n_tickets,
                                   int rows_per_lane, int nw, void* stream) {
  if (nw < 1 || nw > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_per_lane) {
    case 4:
      return launch<4>(nw, st, a, a_stride, b, b_stride, alen, blen, rows,
                       row_stride, progress, ticket, out, n_pairs, n_tickets);
    case 8:
      return launch<8>(nw, st, a, a_stride, b, b_stride, alen, blen, rows,
                       row_stride, progress, ticket, out, n_pairs, n_tickets);
    case 16:
      return launch<16>(nw, st, a, a_stride, b, b_stride, alen, blen, rows,
                        row_stride, progress, ticket, out, n_pairs,
                        n_tickets);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
