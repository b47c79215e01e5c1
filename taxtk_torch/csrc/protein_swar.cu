// Protein global alignment (BLOSUM62, linear gap -1) with traceback stats,
// two pairs per 32-bit word as 16-bit halves, a band of warps per pair of
// pairs, for Hopper (sm_90a).
//
// Replaces: taxtk/ops/pallas_protein.py::_make_kernel_swar (the v6 Pallas
// TPU kernel, launched by _raw_call_swar), taken by the entry when
// TAXTK_PROTEIN_SWAR=1 and the bucket lies in v6's domain (_swar_fits).
//
// What it computes is protein_wavefront.cu's function (see there), for
// pair p in the low halves and pair p + ceil(B/2) in the high halves.  As
// in v6 the scores ride biased (bias = steps_end + 8 of the bucket, so
// every cell a block computes lies in [8, 2^14)) and the stats split into
// a matches16x2 and a dc16x2 word.  A half beyond its own pair's lengths
// computes cells that feed no cell of that pair, and nothing crosses
// between halves, so the two pairs may have any lengths inside the
// bucket.
//
// The cell, per 32-bit word (two cells), 13 essential integer
// instructions:
//   * plain 32-bit adds stand for 16x2 adds wherever each half's operands
//     and result lie in [0, 2^16): the diagonal diag + (SUB + 4) - 4 (the
//     table's entries are biased to be non-negative; every biased diag +
//     SUB >= 4), the stat increments (counts below 2^14) and the two
//     compares below;
//   * the DPX 16x2 max __vimax_s16x2_relu gives max(left, up) (every half
//     is non-negative, so the relu is a no-op) and __viaddmax_s16x2 gives
//     best = max(max(left, up) - 1, diag), one instruction each;
//   * a per-half mask x >= y is the sign of 0x8000 + x - y in each half
//     (one IADD3; the halves lie in [0x4000, 0xC000), so nothing carries
//     across), spread over the half by one PRMT in its sign-replicating
//     mode: left >= up (the horizontal arm beats or ties) and
//     diag >= max(left, up) - 1 (the diagonal wins).  __vcmpges2 takes
//     several instructions on sm_90, and __vibmax_s16x2's bool outputs
//     spilled in the PR 2 kernel;
//   * each stat is two LOP3 selects of the masks after one add of the
//     diagonal's increment;
//   * a lane's table entry (SUB + 4) | (a == b) << 16 of each half comes
//     from its own table row in shared memory, and two PRMTs gather the
//     halves' entries into the packed SUB + 4 and match words.
//
// Layout and wavefront.  One block per pair of pairs, nw warps (a launch
// argument, 1 to 16; the wrapper's kernel_geometry sets it).  m and n are
// the larger of the two pairs' lengths.  A band is nw consecutive strips
// of 32 rows; warp w of a band takes rows top + 32w + 1 .. + 32 of both
// pairs, one row a lane, and sweeps the columns as a skewed wavefront: at
// its step s lane l is at column s - l + 1.  The cell above a lane's row
// comes from lane l-1's previous step by __shfl_up_sync (score2, ma2,
// dc2); lane 0's comes from the shared-memory ring below.
//
// The step.  Nothing on its chain leaves the SM, and no load waits behind
// the step's own store:
//   * warps are chained through a shared-memory ring of (score2, ma2,
//     dc2) cells: lane 31 of warp w stores its cell each step into ring
//     w + 1; warp w + 1 runs LAG = 63 steps behind, so its lane 0 reads
//     that cell one tile (32 steps) later at the same step of its tile; a
//     named barrier over the band's warps (bar.sync 1, 32 * warps) every
//     tile orders the ring, whose two halves alternate between tiles;
//   * the band's first warp fills ring 0 (the row above the band) and two
//     b-code rings (a byte a column a pair, a power of two of columns
//     above the band's reach, mirrored for their first tile, the sentinel
//     before any column) at the start of each tile, from registers it
//     loaded from global memory a tile before;
//   * each lane builds, once a band, its rows of the 32 x 32 table (the
//     rows of its two a codes) in its own column of shared memory (word
//     b * 32 + lane: a step's table loads meet no bank conflict);
//   * a step's loads run ahead of the chain: lane 0's cell above and the
//     b codes two steps ahead, the table entries one step ahead (their
//     addresses by IMAD);
//   * a pair of pairs taller than one band runs its bands in turn in the
//     same block: the band's last warp copies each tile's 32 cells to the
//     block's DP row in global scratch (uint4, after the tile), and the
//     next band's first warp loads that row one tile ahead;
//   * each half's final cell H(alen, blen) is kept by the lane of row
//     alen at the step of column blen, tested only in the checked tiles
//     (a warp-uniform test picks the tiles that can hold it), and written
//     after that tile; a half with an empty side is written up front.
// So a pair of pairs of m rows takes about ceil(m / (32 nw)) * (n + 31 +
// 63 (nw - 1)) steps with its strips running concurrently.
//
// What bounds it on this card: integer issue and the shared-memory pipe.
// A warp step in ptxas's output is some 36 instructions for 64 cells
// (counted in the unchecked tile's SASS by the verify skill's
// sass_step.py recipe): the 13 above, three shuffles, lane 0's ring load
// and lane 31's ring store, two code loads, two table loads with their
// address IMADs, two gathers, and the register moves and selects that
// feed lane 0 and the ring's 16-byte store.  The bound counts the 13
// essential ones of a word, 6.5 a cell (chip_smoke.py's
// SWAR_OPS_PER_CELL), for row 4 too at the same buckets, since both
// compute one function; some 18 a cell issue here.  Up to 96 registers (__maxnreg__): at 64
// ptxas spilled, and the shared memory, not the registers, caps a block's
// occupancy.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CODES = 32;
constexpr int MAX_WARPS = 16;  // the wrapper mirrors it
constexpr int TILE = 32;       // steps between barriers
constexpr int RING = 2 * TILE; // ring entries per warp: two tiles
constexpr int LAG = 2 * TILE - 1;  // steps warp w+1 runs behind warp w
// b-code rings of nw warps: a power of two above the widest span of
// columns a band reads between two writes of a slot (LAG * (nw - 1) +
// 3 * TILE), mirrored for their first TILE bytes so that a lane's 32 steps
// of a tile read consecutive bytes
__host__ __device__ constexpr int bring_size(int nw) {
  int size = TILE;
  while (size <= LAG * (nw - 1) + 3 * TILE) size *= 2;
  return size;
}
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned ONE2 = 0x00010001u;
constexpr unsigned MINUS_ONE2 = 0xFFFFFFFFu;  // -1 in each half: the gap
constexpr unsigned SIGN2 = 0x80008000u;

struct Cell {  // a lane's two cells: biased scores, matches, diag steps
  unsigned s, ma, dc;
};

__device__ __forceinline__ void band_barrier(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

__device__ __forceinline__ int code_at(const int8_t* col, long long stride,
                                       int pos) {
  const int c = static_cast<uint8_t>(col[static_cast<long long>(pos) * stride]);
  return c < CODES - 1 ? c : CODES - 1;
}

__device__ __forceinline__ unsigned pack2(int hi, int lo) {
  return (static_cast<unsigned>(hi) << 16) | (static_cast<unsigned>(lo) & 0xFFFFu);
}

// 0xFFFF in each half whose bit 15 is set, else 0 (prmt's sign mode)
__device__ __forceinline__ unsigned half_signs(unsigned x) {
  unsigned r;
  asm("prmt.b32 %0, %1, %1, 0xBB99;" : "=r"(r) : "r"(x));
  return r;
}

// The word at byte 128 b of a lane's table row (a shared-window address):
// one IMAD for the address, on the pipe that the step's selects and
// compares do not use.
__device__ __forceinline__ unsigned row_entry(unsigned row, int b) {
  unsigned v;
  asm("{ .reg .u32 a; mad.lo.u32 a, %1, 128, %2; ld.shared.u32 %0, [a]; }"
      : "=r"(v)
      : "r"(b), "r"(row));
  return v;
}

__device__ __forceinline__ unsigned sel2(unsigned m, unsigned t, unsigned f) {
  return (t & m) | (f & ~m);
}

// One tile (32 steps) of one warp: at step r lane l is at 0-based column
// jb + r (jb = s0 - l).  head[r]: lane 0's cell above at step r.  Lane 31
// stores its cell of step r to slot[r].  bl[r], bh[r]: the b codes of
// column jb + r.  rowl, rowh: the lane's table rows (shared-window
// addresses).  CHECK: some lane is outside [0, n) in this tile, or a lane
// may hold a final cell: rl (rh) is the step at which this lane holds its
// low (high) pair's final cell, or -1; the cell goes to kl (kh).
template <bool CHECK>
__device__ __forceinline__ void tile(const uint4* __restrict__ head,
                                     uint4* __restrict__ slot,
                                     const uint8_t* __restrict__ bl,
                                     const uint8_t* __restrict__ bh,
                                     unsigned rowl, unsigned rowh, int lane,
                                     int jb, int n, int rl, int rh,
                                     Cell& left, Cell& diag, Cell& kl,
                                     Cell& kh) {
  // the loads run ahead of the chain, and of lane 31's ring stores that
  // precede them: the codes and lane 0's cells above two steps ahead, the
  // lane's table entries {SUB + 4, a == b} one step ahead
  int cl = bl[0], ch = bh[0];
  unsigned el = row_entry(rowl, cl), eh = row_entry(rowh, ch);
  cl = bl[1];
  ch = bh[1];
  uint4 h0 = make_uint4(0u, 0u, 0u, 0u), h1 = h0;
  if (lane == 0) {
    h0 = head[0];
    h1 = head[1];
  }
#pragma unroll 16
  for (int r = 0; r < TILE; ++r) {
    const uint4 h = h0;
    h0 = h1;
    if (r + 2 < TILE && lane == 0) h1 = head[r + 2];
    // the halves' entries gather into the packed SUB + 4 and match bits
    const unsigned sub2 = __byte_perm(el, eh, 0x5410);
    const unsigned match2 = __byte_perm(el, eh, 0x7632);
    if (r + 1 < TILE) {
      el = row_entry(rowl, cl);
      eh = row_entry(rowh, ch);
    }
    if (r + 2 < TILE) {
      cl = bl[r + 2];
      ch = bh[r + 2];
    }
    Cell up;
    up.s = __shfl_up_sync(FULL, left.s, 1);
    up.ma = __shfl_up_sync(FULL, left.ma, 1);
    up.dc = __shfl_up_sync(FULL, left.dc, 1);
    if (lane == 0) up = Cell{h.x, h.y, h.z};
    if (!CHECK || static_cast<unsigned>(jb + r) < static_cast<unsigned>(n)) {
      const unsigned dv = diag.s + sub2 - 4 * ONE2;
      const unsigned gm = __vimax_s16x2_relu(left.s, up.s);
      const unsigned best = __viaddmax_s16x2(gm, MINUS_ONE2, dv);
      const unsigned hm = half_signs(left.s + SIGN2 - up.s);  // left >= up
      // diag >= max(left, up) - 1: the diagonal wins
      const unsigned dm = half_signs(dv + (SIGN2 + ONE2) - gm);
      const Cell c{best,
                   sel2(dm, diag.ma + match2, sel2(hm, left.ma, up.ma)),
                   sel2(dm, diag.dc + ONE2, sel2(hm, left.dc, up.dc))};
      diag = up;
      left = c;
      if (CHECK) {
        if (r == rl) kl = c;
        if (r == rh) kh = c;
      }
    }
    if (lane == 31) slot[r] = make_uint4(left.s, left.ma, left.dc, 0u);
  }
}

// Dynamic shared memory of a block of nw warps, in bytes: the ring, the
// lanes' table rows and the two b-code rings.
__host__ __device__ constexpr int smem_bytes(int nw) {
  return (nw + 1) * RING * 16 + nw * 2 * CODES * 32 * 4 +
         2 * (bring_size(nw) + TILE);
}

__global__ void __maxnreg__(96) protein_swar_kernel(
    const int8_t* __restrict__ pool, long long stride,
    const int32_t* __restrict__ a_col, const int32_t* __restrict__ b_col,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ blen,
    const int32_t* __restrict__ sub_g, uint4* __restrict__ scratch,
    int32_t* __restrict__ out, int n_pairs, int row_stride, int bias,
    int nw) {
  extern __shared__ uint4 smem[];
  // ring + w * RING: the cells above warp w's lane 0, two tiles of them
  uint4* ring = smem;
  // rows + (2 w + half) * CODES * 32: warp w's lanes' table rows of one
  // half, word b * 32 + lane the entry of the lane's a code and code b
  // (bank = lane: a step's loads meet no conflict)
  unsigned* rows = reinterpret_cast<unsigned*>(ring + (nw + 1) * RING);
  // bring_l[c % nb], bring_h[c % nb]: column c's b codes
  const int nb = bring_size(nw);
  uint8_t* bring_l = reinterpret_cast<uint8_t*>(rows + nw * 2 * CODES * 32);
  uint8_t* bring_h = bring_l + nb + TILE;
  const int half = (n_pairs + 1) / 2;
  const int pl = blockIdx.x;
  const int ph = pl + half;
  const bool has_h = ph < n_pairs;
  int ml = alen[pl], nl = blen[pl];
  int mh = has_h ? alen[ph] : 0, nh = has_h ? blen[ph] : 0;
  // empty sides: the all-gap score and zero stats, written up front
  if (ml == 0 || nl == 0) {
    if (threadIdx.x == 0) {
      out[pl] = -max(ml, nl);
      out[n_pairs + pl] = 0;
    }
    ml = nl = 0;
  }
  if (mh == 0 || nh == 0) {
    if (threadIdx.x == 0 && has_h) {
      out[ph] = -max(mh, nh);
      out[n_pairs + ph] = 0;
    }
    mh = nh = 0;
  }
  const int m = max(ml, mh);
  const int n = max(nl, nh);
  if (m == 0) return;  // block-uniform
  // the sentinel in every slot: a step's loads read slots of columns
  // outside [0, n) too, and their codes index the lanes' rows
  for (int k = threadIdx.x; k < (nb + TILE) / 2; k += blockDim.x) {
    reinterpret_cast<unsigned*>(bring_l)[k] = 0x1F1F1F1Fu;
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const int strips = (m + 31) / 32;
  const int8_t* acol_l = pool + a_col[pl];
  const int8_t* bcol_l = pool + b_col[pl];
  const int8_t* acol_h = pool + (has_h ? a_col[ph] : 0);
  const int8_t* bcol_h = pool + (has_h ? b_col[ph] : 0);
  uint4* rb = scratch + static_cast<long long>(pl) * row_stride;
  // the bands of the pair of pairs in turn; a band's warps are its first
  // nws
  for (int top = 0; top < m; top += 32 * nw) {
    const int nws = min(nw, strips - top / 32);
    if (w >= nws) return;  // warp-uniform: no later band has more warps
    const int row0 = top + 32 * w;  // the row above this warp's strip
    const int i = row0 + lane + 1;  // this lane's row, in both halves
    const int acl = i <= ml ? code_at(acol_l, stride, i - 1) : CODES - 1;
    const int ach = i <= mh ? code_at(acol_h, stride, i - 1) : CODES - 1;
    // the lane's table rows: its a codes against every b code, entry
    // (SUB + 4) | (a == b) << 16 (SUB from the table in global memory)
    unsigned* rowl = rows + 2 * w * CODES * 32 + lane;
    unsigned* rowh = rowl + CODES * 32;
    for (int b = 0; b < CODES; ++b) {
      const int sl = __ldg(sub_g + acl * CODES + b) + 4;
      const int sh = __ldg(sub_g + ach * CODES + b) + 4;
      rowl[b * 32] = static_cast<unsigned>(sl | (acl == b) << 16);
      rowh[b * 32] = static_cast<unsigned>(sh | (ach == b) << 16);
    }
    __syncwarp();  // the rows' stores before the steps' loads
    const unsigned row_l =
        static_cast<unsigned>(__cvta_generic_to_shared(rowl));
    const unsigned row_h =
        static_cast<unsigned>(__cvta_generic_to_shared(rowh));
    Cell left{pack2(bias - i, bias - i), 0u, 0u};              // H(i, 0)
    Cell diag{pack2(bias - i + 1, bias - i + 1), 0u, 0u};      // H(i-1, 0)
    // the lanes of rows ml and mh, if in this strip
    const int lml = ml - row0 - 1;
    const int lmh = mh - row0 - 1;
    // the band's last warp hands its last row to the next band
    const bool publish = w == nws - 1 && top + 32 * nws < m;
    const int steps = n + 31 + LAG * (nws - 1);
    // the first warp's next tile: lane l holds column base + l's b codes
    // and the cells above the band there, H(top, column + 1)
    int next_bl = CODES - 1, next_bh = CODES - 1;
    uint4 next_h = make_uint4(0u, 0u, 0u, 0u);
    auto fetch = [&](int base) {
      const int c = base + lane;
      if (c < n) {
        next_bl = c < nl ? code_at(bcol_l, stride, c) : CODES - 1;
        next_bh = c < nh ? code_at(bcol_h, stride, c) : CODES - 1;
        next_h = top == 0
                     ? make_uint4(pack2(bias - c - 1, bias - c - 1), 0u, 0u, 0u)
                     : __ldcg(rb + c);
      }
    };
    if (w == 0) fetch(0);
    for (int t0 = 0; t0 < steps; t0 += TILE) {
      const int s0 = t0 - LAG * w;  // this warp's first step of the tile
      const uint4* head = ring + w * RING + ((t0 - TILE) & (RING - 1));
      if (w == 0) {
        const int slot = (t0 + lane) & (nb - 1);
        bring_l[slot] = static_cast<uint8_t>(next_bl);
        bring_h[slot] = static_cast<uint8_t>(next_bh);
        if (slot < TILE) {
          bring_l[slot + nb] = static_cast<uint8_t>(next_bl);
          bring_h[slot + nb] = static_cast<uint8_t>(next_bh);
        }
        ring[((t0 - TILE) & (RING - 1)) + lane] = next_h;
        if (t0 + TILE < n) fetch(t0 + TILE);
        __syncwarp();
      }
      if (s0 + TILE > 0 && s0 - 31 < n) {  // warp-uniform: some lane is live
        uint4* slot = ring + (w + 1) * RING + (t0 & (RING - 1));
        const int jb = s0 - lane;
        const uint8_t* bl = bring_l + (jb & (nb - 1));
        const uint8_t* bh = bring_h + (jb & (nb - 1));
        // the step at which the lane of row ml (mh) reaches column nl (nh)
        const int rl = nl - 1 - s0 + lml;
        const int rh = nh - 1 - s0 + lmh;
        const bool hl = static_cast<unsigned>(lml) < 32u &&
                        static_cast<unsigned>(rl) < static_cast<unsigned>(TILE);
        const bool hh = static_cast<unsigned>(lmh) < 32u &&
                        static_cast<unsigned>(rh) < static_cast<unsigned>(TILE);
        if (s0 >= 31 && s0 + TILE <= n && !hl && !hh) {  // warp-uniform
          Cell k;
          tile<false>(head, slot, bl, bh, row_l, row_h, lane, jb, n, -1, -1,
                      left, diag, k, k);
        } else {
          const int myl = hl && lane == lml ? rl : -1;
          const int myh = hh && lane == lmh ? rh : -1;
          Cell kl{0u, 0u, 0u}, kh{0u, 0u, 0u};
          tile<true>(head, slot, bl, bh, row_l, row_h, lane, jb, n, myl, myh,
                     left, diag, kl, kh);
          if (myl >= 0) {
            out[pl] = static_cast<int>(kl.s & 0xFFFFu) - bias;
            out[n_pairs + pl] =
                static_cast<int>((kl.dc << 16) | (kl.ma & 0xFFFFu));
          }
          if (myh >= 0) {
            out[ph] = static_cast<int>(kh.s >> 16) - bias;
            out[n_pairs + ph] =
                static_cast<int>((kh.dc & 0xFFFF0000u) | (kh.ma >> 16));
          }
        }
        if (publish) {
          // lane 31's columns of this tile, s0 - 31 .. s0, to the DP row
          __syncwarp();
          const int c = s0 - 31 + lane;
          if (c >= 0 && c < n) rb[c] = slot[lane];
        }
      }
      band_barrier(32 * nws);
    }
  }
}

}  // namespace

// Plain C entry (bound with ctypes).  out is int32 [2, n_pairs] (score,
// dc << 16 | matches); scratch holds ceil(n_pairs / 2) x row_stride uint4
// (row_stride >= every blen) where a pair of pairs can have more than one
// band (max alen > 32 * nw), else it is not read.  bias: the scores'
// offset (steps_end + 8 of the bucket).  nw: warps per band, 1 to 16.
// Returns cudaGetLastError() after the launch, or cudaErrorInvalidValue
// for nw outside [1, 16].
extern "C" int taxtk_protein_swar(const void* pool, long long stride,
                                  const void* a_col, const void* b_col,
                                  const void* alen, const void* blen,
                                  const void* sub, void* scratch, void* out,
                                  int n_pairs, int row_stride, int bias,
                                  int nw, void* stream) {
  if (nw < 1 || nw > MAX_WARPS) return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs <= 0) return 0;
  // above 48 KB of dynamic shared memory (nw >= 6) the kernel needs the
  // attribute, which is per card: set at every launch on the current
  // card (the caller makes it the card of the launch's tensors; the call
  // costs far less than the launch)
  const cudaError_t attr = cudaFuncSetAttribute(
      protein_swar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem_bytes(MAX_WARPS));
  if (attr != cudaSuccess) return static_cast<int>(attr);
  protein_swar_kernel<<<(n_pairs + 1) / 2, 32 * nw, smem_bytes(nw),
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pool), stride,
      static_cast<const int32_t*>(a_col), static_cast<const int32_t*>(b_col),
      static_cast<const int32_t*>(alen), static_cast<const int32_t*>(blen),
      static_cast<const int32_t*>(sub), static_cast<uint4*>(scratch),
      static_cast<int32_t*>(out), n_pairs, row_stride, bias, nw);
  return static_cast<int>(cudaGetLastError());
}
