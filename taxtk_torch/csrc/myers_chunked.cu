// Pattern-block Myers edit distance for Hopper (sm_90a): one block of 64
// pattern words per launch, two warps per pair, the block's match masks in
// registers.
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
//   * the carries into word 0 at text position j come from the carry
//     stream hin, the carries out of word KB-1 go to hout, for j < n_len;
//   * the pattern ends in word mword of this block (outside [0, KB) when
//     it ends in another block), at bit mbit;
//   * score and res come in from the previous launch and go out; the
//     score follows the pattern's end row over chars 0 .. n_len-1 and res
//     takes it at j == n_len (a pair whose pattern ends in another block
//     passes its score through, and res takes it; n_len == 0 leaves both
//     as they came).
//
// Layout: the text comes straight from the resident sequence pool (2 or 4
// codes per byte, lowest field first), the match masks from the device-
// built planes peq[KB, ALPHA, U] of this block through pat_idx.  The carry
// stream is pair-major and packed, uint32 [B, hwords]: word w of a pair
// holds the PH carries of chars 16w .. 16w+15 in bits 0-15 and their MH
// carries in bits 16-31 (ops/myers_chunked.py::pack_carries).
//
// Design (after row 1's, csrc/myers_short.cu): two warps per pair, each
// lane holding one pattern word, 32 words a warp.  Each lane reads its
// word's match masks from peq once and keeps them as three bit planes of
// the pattern codes, with the word's Pv and Mv, in registers: nothing is
// read per char but the text and the carry stream, and neither on a
// step's dependent chain.  Lane l takes char t - l at its warp's step t, a
// skewed wavefront over the words, and hands its carries to lane l+1
// through one __shfl_sync a step (PH at bit 31, MH at bit 0).  That
// shuffle is a rotation: lane 31, whose carries go to the stream, hands
// lane 0 the stream's carries into word 0 instead, so no lane selects
// after the shuffle.  Lane 31 also:
//   * loads the stream word of the next 16 chars a tile ahead, as each
//     lane loads its chars; a step picks its two bits out of it;
//   * shifts its own PH and MH carry-outs into two registers, one
//     instruction each a step, and at the end of a tile writes the 16
//     chars then complete (t0-32 .. t0-17) as one stream word,
//     bit-reversed into place.
// The pair's two warps are chained through a shared-memory ring of such
// stream words: the second runs LAG steps behind the first, and they meet
// at a named barrier every tile, so the word the first warp's lane 31
// writes at the end of a tile is read by the second warp's lane 31 one
// tile later, a tile ahead of its use.  The first warp reads hin, the
// second writes hout.
//
// The score: no step tracks it.  It moves over the launch by D[m][n] -
// D[m][0] of the block's DP (m rows down to the pattern's end, n chars),
// whose top row's deltas are hin's and whose left column rises by 1 a row:
// the top row's deltas over chars 0 .. n-1, plus the vertical deltas at
// char n-1 of rows 1 .. m, less m.  The first warp's stream reader adds up
// the first a tile at a time; each word adds its share of the second, the
// popcounts of its Pv and Mv under the rows at or above the end, at the
// step it finishes char n-1; a shuffle reduction and shared memory sum
// them.  The TPU kernel adds the same sum up one char at a time.
//
// A warp takes n + 32 steps (its stream words complete for every j < n),
// in tiles of 16.  Words before their first char (the ramp) skip the
// update; that check and the harvest test run only in tiles that hold a
// ramp or a harvest step (a warp vote per tile).  Every word of the block
// computes, also past the pattern's end (its masks are zero there), since
// its carries go on to hout as the TPU kernel's do.
//
// What bounds it on this card: the latency of a warp's step, then integer
// issue.  The recurrence needs ~13 instructions per 32-cell word per char
// (chip_smoke.py's OPS_PER_WORD_CHAR, over 132 SMs x 128 lanes a clock); a
// step is some 16 for the word and 12 for the shuffle, the char's masks,
// the stream and the carry-outs, most on the 16-lane ALU pipe.  A launch
// lasts about as long as its longest text takes one warp, n + 32 + LAG
// steps, and at the aligner's launches (at most 1,024 pairs, 16 warps an
// SM) a warp issues its step with too little beside it to hide its
// dependent chain.  One warp a pair with two words a lane issues fewer
// instructions a pair but waits out a longer step: on the H100 it was the
// slower at every launch of the aligner's oversized route, and the faster
// only at 1,024 pairs of even lengths (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int KB = 64;  // pattern words per launch (2048 bp)
constexpr int ALPHA = 5;
constexpr int THREADS = 128;  // four warps a block
constexpr int TILE = 16;      // steps a tile: the chars of one stream word
constexpr unsigned FULL = 0xFFFFFFFFu;
// the carries a lane hands on: PH at bit 31, MH at bit 0
constexpr uint32_t HEAD = 0x80000000u;
constexpr int NW = 2;  // warps a pair, 32 pattern words each
constexpr int PAIRS_PER_BLOCK = THREADS / 32 / NW;
// the second warp of a pair runs LAG steps behind the first, so the ring
// word written at the end of the first's tile t0 + 32, that of chars t0 ..
// t0+15, is read one tile before the second reaches char t0
constexpr int LAG = 64;
constexpr int RING = 4;  // stream words a pair's ring holds (2 are live)

// One lane's text word: the 32 / BITS codes of its chars from pool row r0
// on, shifted down by sh bits (the lane's lag within a byte), lowest field
// first; rows outside the pool read as pad (all ones).  On the 4-bit wire
// every code >= ALPHA becomes plane code 7 (the low three bits of the
// nibble set), which no pattern position holds.
template <int BITS>
__device__ __forceinline__ uint32_t text_word(const int8_t* col,
                                              long long stride, int pool_rows,
                                              int r0, int sh) {
  uint64_t w = 0;
#pragma unroll
  for (int b = 0; b < 5; ++b) {  // 4 bytes of codes and one for the lag
    const int row = r0 + b;
    const uint32_t v =
        static_cast<unsigned>(row) < static_cast<unsigned>(pool_rows)
            ? static_cast<uint32_t>(static_cast<uint8_t>(
                  col[static_cast<long long>(row) * stride]))
            : 0xFFu;
    w |= static_cast<uint64_t>(v) << (8 * b);
  }
  uint32_t x = static_cast<uint32_t>(w >> sh);
  if (BITS == 4) {
    // bit 3 of each nibble: its low three bits plus 3 reach 8 (5..7), or
    // the code is 8 or more
    const uint32_t big = (((x & 0x77777777u) + 0x33333333u) | x) & 0x88888888u;
    x |= (big >> 1) | (big >> 2) | (big >> 3);
  }
  return x;
}

// All ones if bit 31 of x is set, else zero.
__device__ __forceinline__ uint32_t spread(uint32_t x) {
  return static_cast<uint32_t>(static_cast<int32_t>(x) >> 31);
}

// One tile (16 steps) of one lane.  The lane's word takes the carries
// the lane before made a step earlier (lane 0: those the last lane reads
// from the stream word h) and, as three plane masks k0..k2, its char from
// text0 (and at 4 bits text1), the lane's 16 chars; pc, mc: its own last
// carries, PH at bit 31, MH as a bit.  acc_ph, acc_mh: those carries, one
// bit a step, newest lowest.  EDGE: the tile holds a ramp step (the word
// before its first char) or the harvest step th, where the word has
// finished char n-1 and its vertical deltas under vm go into vsum; other
// tiles skip both tests.
template <int BITS, bool EDGE>
__device__ __forceinline__ void tile(
    uint32_t text0, uint32_t text1, uint32_t h, int t0, int lag, int th,
    int src, bool tail, uint32_t x0, uint32_t x1, uint32_t x2, uint32_t vm,
    uint32_t& pv, uint32_t& mv, uint32_t& pc, uint32_t& mc, int& vsum,
    uint32_t& acc_ph, uint32_t& acc_mh) {
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    // the stream's carries at char t0 + r: PH bit r, MH bit 16 + r
    const uint32_t from_h =
        ((h << (31 - r)) & HEAD) | ((h >> (16 + r)) & 1u);
    const uint32_t own = (pc & HEAD) | mc;
    const uint32_t cin = __shfl_sync(FULL, tail ? from_h : own, src);
    // the char's plane code as three all-ones-or-zero masks: each bit
    // shifted to the sign and spread by an arithmetic shift
    const uint32_t text = (BITS == 2 || r < 8) ? text0 : text1;
    const int f = BITS * (BITS == 2 ? r : r & 7);
    const uint32_t k0 = spread(text << (31 - f));
    const uint32_t k1 = spread(text << (30 - f));
    const uint32_t k2 = BITS == 4 ? spread(text << (29 - f)) : 0u;
    const int t = t0 + r;
    if (!EDGE || t >= lag) {
      // BITS == 2: x2 is the valid plane; BITS == 4: the code's bit 2
      const uint32_t eq0 = BITS == 2 ? x2 & ~((x0 ^ k0) | (x1 ^ k1))
                                     : ~((x0 ^ k0) | (x1 ^ k1) | (x2 ^ k2));
      const uint32_t mbit = cin & 1u;  // MH in
      const uint32_t eq = eq0 | mbit;
      const uint32_t xv = eq | mv;
      const uint32_t add = (eq & pv) + pv;
      const uint32_t xh = (add ^ pv) | eq;
      const uint32_t ph = mv | ~(xh | pv);
      const uint32_t mh = pv & xh;
      const uint32_t phs = __funnelshift_l(cin, ph, 1);  // ph << 1 | PH in
      const uint32_t mhs = (mh << 1) | mbit;
      pv = mhs | ~(xv | phs);
      mv = phs & xv;
      pc = ph;
      mc = mh >> 31;
      if (EDGE && t == th) vsum += __popc(pv & vm) - __popc(mv & vm);
    }
    acc_ph = __funnelshift_l(pc, acc_ph, 1);  // acc << 1 | PH out
    acc_mh = (acc_mh << 1) | mc;
  }
}

template <int BITS>
__global__ void __launch_bounds__(THREADS) myers_chunked_kernel(
    const int8_t* __restrict__ pool, long long pool_stride, int pool_rows,
    const int32_t* __restrict__ txt_col,
    const uint32_t* __restrict__ peq, long long peq_cols,
    const int32_t* __restrict__ pat_idx, const int32_t* __restrict__ mword,
    const int32_t* __restrict__ mbit, const int32_t* __restrict__ nlen,
    const int32_t* __restrict__ score_in, const int32_t* __restrict__ res_in,
    const uint32_t* __restrict__ hin, int32_t* __restrict__ score_out,
    int32_t* __restrict__ res_out, uint32_t* __restrict__ hout, int hwords,
    int n_pairs) {
  constexpr int CPB = 8 / BITS;
  __shared__ uint32_t ring[PAIRS_PER_BLOCK][RING];
  __shared__ int part_sum[PAIRS_PER_BLOCK];
  const int lane = threadIdx.x & 31;
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  const int i = warp / NW;           // the pair: warp-uniform, and shared
  if (i >= n_pairs) return;          // by its NW warps, which leave together
  const int part = warp % NW;        // which of the pair's warps
  const int pb = threadIdx.x / 32 / NW;  // the pair's place in the block
  const int n = nlen[i];
  const int mw = mword[i];
  const int mb = mbit[i] & 31;
  // the pattern ends in this block, at row 32 * mw + mb + 1 of it
  const bool ends = mw >= 0 && mw < KB;
  const int k = part * 32 + lane;  // the lane's pattern word
  // the word takes char t - lane at the warp's step t: it finishes char
  // n-1 at step th
  const int lag = lane;
  const int th = n > 0 ? n - 1 + lag : -TILE;
  // n + 32 steps a warp: its last word finishes char n-1 at step n-1 + 31,
  // and the tile that holds step n-1 + 32 writes the stream word of char
  // n-1
  const int steps = n > 0 ? n + 32 : 0;

  uint32_t p[ALPHA] = {0u, 0u, 0u, 0u, 0u};
  const uint32_t* pq = peq + pat_idx[i];
#pragma unroll
  for (int c = 0; c < (BITS == 2 ? 4 : ALPHA); ++c)
    p[c] = __ldg(pq + static_cast<long long>(k * ALPHA + c) * peq_cols);
  const uint32_t valid = p[0] | p[1] | p[2] | p[3] | p[4];
  const uint32_t x0 = p[1] | p[3];
  // BITS == 4: pads take code 6, which no text code matches
  const uint32_t x1 = BITS == 2 ? p[2] | p[3] : p[2] | p[3] | ~valid;
  const uint32_t x2 = BITS == 2 ? valid : p[4] | ~valid;
  // the word's rows at or above the pattern's end: their vertical deltas
  // at char n-1 count towards the score
  const uint32_t vm = !ends || k > mw ? 0u : k < mw ? ~0u : ~0u >> (31 - mb);
  uint32_t pv = 0xFFFFFFFFu, mv = 0u, pc = 0u, mc = 0u;
  // the lane's share of the score's move: its word's vertical deltas and,
  // at the first warp's stream reader, the top row's deltas
  int vsum = 0;
  // the lane reads its own chars t - lag: its words of a tile start
  // lag_rows pool rows before the tile's first row, sh bits in
  const int lag_rows = (lag + CPB - 1) / CPB;
  const int sh = BITS * (lag_rows * CPB - lag);
  const bool tail = lane == 31;
  const int src = (lane + 31) & 31;  // the lane before (lane 0: the last)
  const int8_t* col = pool + txt_col[i];
  const long long row0 = static_cast<long long>(i) * hwords;
  // the carries into the warp's first word come from hin, or from the
  // ring the first warp fills; those out of its last word go to the ring,
  // or to hout.  The last lane reads the one and writes the other
  uint32_t* ring_pair = ring[pb];
  auto stream_in = [&](int w) -> uint32_t {
    if (!tail || w * TILE >= n) return 0u;  // only words with a live char
    return part > 0 ? ring_pair[w % RING] : __ldg(hin + row0 + w);
  };
  uint32_t text0 = 0u, text1 = 0u, next0 = 0u, next1 = 0u, h = 0u;
  uint32_t next_h = 0u, acc_ph = 0u, acc_mh = 0u;
  const int start = part * LAG;  // the warp's first step on the pair's clock
  const int end = steps > 0 ? steps + (NW - 1) * LAG : 0;
  for (int c0 = 0; c0 < end; c0 += TILE) {
    const int t0 = c0 - start;  // this warp's own step
    if (t0 >= 0 && t0 < steps) {  // warp-uniform
      // 16 chars a tile: one text word at 2 bits, two at 4; the first
      // tile loads its own, every tile the next one's
      if (t0 == 0) {
        next0 = text_word<BITS>(col, pool_stride, pool_rows, -lag_rows, sh);
        if (BITS == 4)
          next1 =
              text_word<BITS>(col, pool_stride, pool_rows, 4 - lag_rows, sh);
        next_h = stream_in(0);
      }
      text0 = next0;
      text1 = next1;
      h = next_h;
      const int r0 = (t0 + TILE) / CPB - lag_rows;
      next0 = text_word<BITS>(col, pool_stride, pool_rows, r0, sh);
      if (BITS == 4)
        next1 = text_word<BITS>(col, pool_stride, pool_rows, r0 + 4, sh);
      next_h = stream_in(t0 / TILE + 1);
      if (part == 0 && tail && t0 < n) {
        // the top row's deltas at this word's live chars t0 .. n-1
        const uint32_t live =
            n - t0 >= TILE ? 0xFFFFu : (1u << (n - t0)) - 1u;
        vsum += __popc(h & live) - __popc((h >> TILE) & live);
      }
      if (t0 < 31 || __any_sync(FULL, th >= t0 && th < t0 + TILE)) {
        tile<BITS, true>(text0, text1, h, t0, lag, th, src, tail, x0, x1, x2,
                         vm, pv, mv, pc, mc, vsum, acc_ph, acc_mh);
      } else {
        tile<BITS, false>(text0, text1, h, t0, lag, th, src, tail, x0, x1,
                          x2, vm, pv, mv, pc, mc, vsum, acc_ph, acc_mh);
      }
      // the warp's last word has now finished chars t0-32 .. t0-17: acc
      // bit b holds char t0-16-b, so those chars are bits 16 .. 1, newest
      // lowest; reversed, they land in stream order
      const int j0 = t0 - 32;
      if (tail && j0 >= 0 && j0 < n) {
        const uint32_t word = ((__brev(acc_ph) >> 15) & 0xFFFFu) |
                              ((__brev(acc_mh) << 1) & 0xFFFF0000u);
        if (part < NW - 1) {
          ring_pair[(j0 / TILE) % RING] = word;
        } else {
          hout[row0 + j0 / TILE] = word;
        }
      }
    }
    // the pair's warps meet every tile: the ring word written at the end
    // of the first warp's tile is read one tile later
    asm volatile("bar.sync %0, %1;" ::"r"(1 + pb), "r"(32 * NW) : "memory");
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) vsum += __shfl_xor_sync(FULL, vsum, o);
  if (part == 0 && lane == 0) part_sum[pb] = vsum;
  asm volatile("bar.sync %0, %1;" ::"r"(1 + pb), "r"(32 * NW) : "memory");
  if (part == NW - 1 && lane == 0) {
    const int score = score_in[i];
    const int moved = ends && n > 0 ? vsum + part_sum[pb] - (32 * mw + mb + 1)
                                    : 0;
    score_out[i] = score + moved;
    res_out[i] = n > 0 ? score + moved : res_in[i];
  }
}

}  // namespace

// Plain C entry (bound with ctypes).  hin and hout are the packed carry
// streams, uint32 [n_pairs, hwords] (16 chars a word, hwords * 16 >= every
// n_len); score/res in and out int32 [n_pairs]; peq points at this block's
// first word.  Returns cudaGetLastError() after the launch, or
// cudaErrorInvalidValue for a block width or bits outside the set.
extern "C" int taxtk_myers_chunked(
    const void* pool, long long pool_stride, int pool_rows,
    const void* txt_col, const void* peq, long long peq_cols,
    const void* pat_idx, const void* mword, const void* mbit,
    const void* nlen, const void* score_in, const void* res_in,
    const void* hin, void* score_out, void* res_out, void* hout,
    int hwords, int n_pairs, int kb, int bits, void* stream) {
  if (n_pairs <= 0) return 0;
  if (kb != KB) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((n_pairs + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto i32 = [](const void* p) { return static_cast<const int32_t*>(p); };
#define TAXTK_CHUNKED(B)                                                    \
  myers_chunked_kernel<B><<<grid, THREADS, 0, st>>>(                        \
      static_cast<const int8_t*>(pool), pool_stride, pool_rows,             \
      i32(txt_col), static_cast<const uint32_t*>(peq), peq_cols,            \
      i32(pat_idx), i32(mword), i32(mbit), i32(nlen), i32(score_in),        \
      i32(res_in), static_cast<const uint32_t*>(hin),                       \
      static_cast<int32_t*>(score_out), static_cast<int32_t*>(res_out),     \
      static_cast<uint32_t*>(hout), hwords, n_pairs)
  if (bits == 2) {
    TAXTK_CHUNKED(2);
  } else if (bits == 4) {
    TAXTK_CHUNKED(4);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef TAXTK_CHUNKED
  return static_cast<int>(cudaGetLastError());
}
