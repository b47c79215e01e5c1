// Block-systolic Myers edit distance for long pairs, for Hopper (sm_90a).
//
// Replaces: taxtk/ops/pallas_myers_systolic.py::_make_systolic_kernel (the
// Pallas TPU kernel launched by _call_systolic after _stage_core).
//
// What it computes: the same exact global edit distance as the short
// kernel, for pairs whose pattern (the shorter side) spans many 32-word
// (1024 bp) blocks, up to 96 blocks.  The inputs are the slot arrays of
// host._pack_systolic ([n_rows, 128] int32, one slot per (pair, block)) and
// a per-pair table (first slot, slot count); the output is the same
// [n_rows, 128] per-slot array as the plain version's: the pair's distance
// at its pattern-end slot, the score seed mlen at every other slot.
//
// Design: one CUDA block per pair, one warp per KW pattern blocks, one
// lane per KW consecutive pattern words (KW = 2 below 46 blocks, 3 up to
// 96; chosen per launch from the largest pair).  Word g's state (Pv, Mv)
// and its pattern code, as three bit planes derived once from peq, live in
// registers, so no memory is read per text char but the text itself.  Lane
// l of warp w takes text char t - 64w - l at step t: a skewed wavefront.
// Each step, a lane receives from lane l-1's previous step the packed
// value char | PH<<8 | MH<<9 (the word-boundary carries and the char)
// through one __shfl_up_sync, so the serial chain per char is KW words and
// one shuffle.  Lane 0 of warp 0 inserts the text char with PH = 1, MH = 0
// (the row above the pattern); the text is read 32 chars at a time, one
// tile ahead, by the whole warp.  Lane 31 of warp w writes its packed
// value to a 128-entry shared-memory ring each step, and lane 0 of warp
// w+1 reads it 33 steps later; a named barrier over the pair's warps every
// 32 steps (a tile) orders the ring, and warp w+1 runs two tiles (64
// steps) behind warp w so that what it reads in a tile was written before
// the last barrier.  A pair takes n + 31 + 64 (nw - 1) steps for nw warps.
// Tiles in which every lane of a warp is live skip the per-step range
// test.  Why KW = 2 and not one word per lane: the per-step costs beside
// the recurrence (two shuffles, unpack, pack, the ring store) are paid once
// per KW words, and a pair needs half the warps, so half the pipeline fill.
// KW = 3 amortizes them further but leaves fewer warps to hide the chain:
// on the H100 it was the faster at 16 pairs of 49 blocks (17 warps against
// 25) and the slower at 25 blocks and below (chip_smoke.py times both).

// Kept to the letter: each word starts from fresh state (Pv = ~0, Mv = 0)
// at its first char and runs chars 0 .. n_len-1 only (the live window
// 1 <= jeff1 <= n_len), so the pattern-end lane's final score is the
// harvest at jeff1 == n_len (and the seed m when n_len == 0); text codes
// >= ALPHA match nothing on the 4-bit wire; pattern pads, which peq masks
// by plen, match nothing (a pad is plane code 6 on the 4-bit wire and a
// cleared valid plane on the 2-bit one); the empty-pair pin stays on the
// host (post).
//
// What bounds it on this card: integer issue.  The recurrence needs ~13
// instructions per 32 cells per char (chip_smoke.py's OPS_PER_WORD_CHAR;
// here the match mask takes 2 or 3 LOP3s from the planes), and the H100
// issues 132 SMs x 128 lanes of them a clock (ALU and FMA pipes); two
// shuffles and a select per step per lane come beside them.  Enough warps
// must be in flight to hide the per-step chain (one shuffle and KW
// dependent words): a block per pair gives a 1024-pair
// launch 1024 blocks, where a thread per (pair, block) slot would give it
// one block per 128 slots.  A pair is bounded by one SM's issue rate, so a
// launch of a few very long pairs leaves most SMs idle.  Pairs of one
// launch may use fewer warps than the block has; those warps only fill
// the slot outputs and exit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ALPHA = 5;
constexpr int KC = 32;      // pattern words per slot (1024 bp)
constexpr int MAX_WARPS = 32;
constexpr int RING = 128;   // ring entries per warp (a power of two)
constexpr int TILE = 32;    // steps between barriers
constexpr int WARP_LAG = 2 * TILE;  // steps warp w+1 runs behind warp w
constexpr unsigned FULL = 0xFFFFFFFFu;

__device__ __forceinline__ void pair_barrier(int nthreads) {
  asm volatile("bar.sync 1, %0;" ::"r"(nthreads) : "memory");
}

// One tile (32 steps) of one warp.  CHECK: some lane of the warp is
// outside its live chars in this tile (the ramps at both ends); a tile
// where every lane is live skips the per-step range test.
template <int BITS, int KW, bool END, bool CHECK>
__device__ __forceinline__ void tile(int (*ring)[RING], int warp, int lane,
                                     int t0, int lag, int n, int chunk,
                                     uint32_t (&pv)[KW], uint32_t (&mv)[KW],
                                     int& score, int& send,
                                     const uint32_t (&x0)[KW],
                                     const uint32_t (&x1)[KW],
                                     const uint32_t (&x2)[KW],
                                     const uint32_t (&hm)[KW]) {
  int* slot = ring[warp] + (t0 & (RING - 1));
#pragma unroll
  for (int r = 0; r < TILE; ++r) {
    const int recv = __shfl_up_sync(FULL, send, 1);
    const int head = __shfl_sync(FULL, chunk, r);
    const int c = t0 + r - lag;
    if (!CHECK || (c >= 0 && c < n)) {
      const int inp = lane == 0 ? head : recv;
      const int tc = inp & 0xFF;
      uint32_t cph = static_cast<uint32_t>(inp >> 8) & 1u;
      uint32_t cmh = static_cast<uint32_t>(inp >> 9) & 1u;
      // match mask from the planes: all-ones where the pattern code equals
      // tc (codes >= ALPHA take plane code 7, which no pattern position
      // holds)
      const int te = (BITS == 2 || tc < ALPHA) ? tc : 7;
      const uint32_t m0 = 0u - static_cast<uint32_t>(te & 1);
      const uint32_t m1 = 0u - static_cast<uint32_t>((te >> 1) & 1);
      const uint32_t m2 = 0u - static_cast<uint32_t>((te >> 2) & 1);
      uint32_t ph_hit = 0u, mh_hit = 0u;
#pragma unroll
      for (int q = 0; q < KW; ++q) {
        // BITS == 2: x2 is the valid plane; BITS == 4: the code's bit 2
        const uint32_t eq0 =
            BITS == 2 ? x2[q] & ~((x0[q] ^ m0) | (x1[q] ^ m1))
                      : ~((x0[q] ^ m0) | (x1[q] ^ m1) | (x2[q] ^ m2));
        const uint32_t eq = eq0 | cmh;
        const uint32_t xv = eq | mv[q];
        const uint32_t add = (eq & pv[q]) + pv[q];
        const uint32_t xh = (add ^ pv[q]) | eq;
        const uint32_t ph = mv[q] | ~(xh | pv[q]);
        const uint32_t mh = pv[q] & xh;
        if (END) {
          ph_hit |= ph & hm[q];
          mh_hit |= mh & hm[q];
        }
        const uint32_t phs = (ph << 1) | cph;
        const uint32_t mhs = (mh << 1) | cmh;
        cph = ph >> 31;
        cmh = mh >> 31;
        pv[q] = mhs | ~(xv | phs);
        mv[q] = phs & xv;
      }
      if (END) {
        score +=
            static_cast<int>(ph_hit != 0u) - static_cast<int>(mh_hit != 0u);
      }
      send = tc | static_cast<int>(cph << 8) | static_cast<int>(cmh << 9);
    }
    if (lane == 31) slot[r] = send;
  }
}

// All tiles of one warp of a pair; returns the pattern-end lane's score
// (meaningful only for that lane of the last warp, where END is true).
template <int BITS, int KW, bool END>
__device__ __forceinline__ int sweep(const int8_t* __restrict__ tcol,
                                     long long stride, int pool_rows,
                                     int (*ring)[RING], int warp, int lane,
                                     int nw, int n, int m,
                                     const uint32_t (&x0)[KW],
                                     const uint32_t (&x1)[KW],
                                     const uint32_t (&x2)[KW],
                                     const uint32_t (&hm)[KW]) {
  constexpr int CPB = 8 / BITS;
  constexpr int FMASK = (1 << BITS) - 1;
  uint32_t pv[KW], mv[KW];
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    pv[q] = 0xFFFFFFFFu;
    mv[q] = 0u;
  }
  int score = m;
  if (n <= 0) return score;
  // head insertion: char code | PH = 1 (bit 8), MH = 0
  auto text = [&](int c) {
    const int row = c / CPB;
    const int packed =
        (c < n && row < pool_rows)
            ? static_cast<int>(static_cast<uint8_t>(
                  tcol[static_cast<long long>(row) * stride]))
            : 0xFF;
    return ((packed >> ((c % CPB) * BITS)) & FMASK) | 256;
  };
  const int wlag = WARP_LAG * warp;
  const int lag = wlag + lane;
  const int steps = n + 31 + WARP_LAG * (nw - 1);
  int next = warp == 0 ? text(lane) : 0;
  int send = 0;
  for (int t0 = 0; t0 < steps; t0 += TILE) {
    // chars of this warp in this tile: t0 - wlag - 31 .. t0 + 31 - wlag
    const int lo = t0 - wlag - 31, hi = t0 + 31 - wlag;
    if (hi >= 0 && lo < n) {  // warp-uniform
      int chunk;
      if (warp == 0) {
        chunk = next;
        next = text(t0 + TILE + lane);
      } else {
        // lane 31 of warp w-1 wrote its value for step t - 33 there
        chunk = ring[warp - 1][(t0 + lane - (WARP_LAG - 31)) & (RING - 1)];
      }
      if (lo >= 0 && hi < n) {
        tile<BITS, KW, END, false>(ring, warp, lane, t0, lag, n, chunk, pv,
                                   mv, score, send, x0, x1, x2, hm);
      } else {
        tile<BITS, KW, END, true>(ring, warp, lane, t0, lag, n, chunk, pv,
                                  mv, score, send, x0, x1, x2, hm);
      }
    }
    pair_barrier(32 * nw);
  }
  return score;
}

template <int BITS, int KW>
__global__ void __launch_bounds__(MAX_WARPS * 32) myers_systolic_kernel(
    const int8_t* __restrict__ pool, long long pool_stride, int pool_rows,
    const uint32_t* __restrict__ peq, int B1,
    const int32_t* __restrict__ peq_col, const int32_t* __restrict__ txt_col,
    const int32_t* __restrict__ nlen, const int32_t* __restrict__ mword,
    const int32_t* __restrict__ mbit, const int32_t* __restrict__ mlen,
    const int32_t* __restrict__ pairs, int32_t* __restrict__ out,
    int n_slots) {
  __shared__ int ring[MAX_WARPS][RING];
  // slots that hold no pattern end give the score seed, as in the plain
  // version (no end bit, so no delta); each end slot is its pair's block's
  for (int s = blockIdx.x * blockDim.x + threadIdx.x; s < n_slots;
       s += gridDim.x * blockDim.x) {
    if (mword[s] < 0) out[s] = mlen[s];
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int s0 = pairs[2 * blockIdx.x];
  const int nb = pairs[2 * blockIdx.x + 1];
  const int nw = (nb + KW - 1) / KW;
  // a launch sized below one of its pairs (warps * KW < the pair's slot
  // count) would leave pattern words without a lane and sync more threads
  // than the block has: stop the launch instead
  if (nw * 32 > static_cast<int>(blockDim.x)) __trap();
  if (warp >= nw) return;  // the pair needs fewer warps than the block has
  const int s_end = s0 + nb - 1;
  const int kend = (nb - 1) * KC + mword[s_end];  // the pattern-end word
  const uint32_t end_bit = 1u << (mbit[s_end] & 31);

  uint32_t x0[KW], x1[KW], x2[KW], hm[KW];
#pragma unroll
  for (int q = 0; q < KW; ++q) {
    const int g = (warp * 32 + lane) * KW + q;  // pattern word
    uint32_t p[ALPHA] = {0u, 0u, 0u, 0u, 0u};
    if (g < nb * KC) {
      const int pc = peq_col[s0 + g / KC];
      const uint32_t* w = peq +
                          (static_cast<long long>(pc / B1) * KC + g % KC) *
                              ALPHA * B1 +
                          pc % B1;
#pragma unroll
      for (int c = 0; c < ALPHA; ++c) p[c] = __ldg(w + static_cast<long long>(c) * B1);
    }
    const uint32_t valid = p[0] | p[1] | p[2] | p[3] | p[4];
    x0[q] = p[1] | p[3];
    x1[q] = p[2] | p[3];
    if (BITS == 2) {
      x2[q] = p[0] | p[1] | p[2] | p[3];  // valid plane (no N on this wire)
    } else {
      x1[q] |= ~valid;  // pads take code 6: no text code matches it
      x2[q] = p[4] | ~valid;
    }
    hm[q] = g == kend ? end_bit : 0u;
  }
  const int8_t* tcol = pool + txt_col[s0];
  const int n = nlen[s0];
  const int m = mlen[s0];
  const int score =
      warp == nw - 1
          ? sweep<BITS, KW, true>(tcol, pool_stride, pool_rows, ring, warp,
                                  lane, nw, n, m, x0, x1, x2, hm)
          : sweep<BITS, KW, false>(tcol, pool_stride, pool_rows, ring, warp,
                                   lane, nw, n, m, x0, x1, x2, hm);
  if (kend / KW == warp * 32 + lane) out[s_end] = score;
}

template <int BITS>
int launch_bits(int kw, dim3 grid, dim3 block, cudaStream_t st,
                const int8_t* pool, long long stride, int rows,
                const uint32_t* peq, int B1, const int32_t* const* meta,
                const int32_t* pairs, int32_t* out, int n_slots) {
  switch (kw) {
    case 2:
      myers_systolic_kernel<BITS, 2><<<grid, block, 0, st>>>(
          pool, stride, rows, peq, B1, meta[0], meta[1], meta[2], meta[3],
          meta[4], meta[5], pairs, out, n_slots);
      break;
    case 3:
      myers_systolic_kernel<BITS, 3><<<grid, block, 0, st>>>(
          pool, stride, rows, peq, B1, meta[0], meta[1], meta[2], meta[3],
          meta[4], meta[5], pairs, out, n_slots);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry (bound with ctypes).  Every per-slot array (peq_col,
// txt_col, nlen, mword, mbit, mlen, out) is int32 [n_slots]; peq is uint32
// [nbmax*32, ALPHA, B1]; pairs is int32 [n_pairs, 2] (first slot, slot
// count), one CUDA block of 32 * warps threads each; kw in {2, 3} and
// kw * warps >= every pair's slot count (a pair past it traps the launch,
// which the next synchronization reports).  Returns cudaGetLastError() after
// the launch, or cudaErrorInvalidValue for bits other than 2 and 4, kw
// outside {2, 3} or warps outside [1, 32].
extern "C" int taxtk_myers_systolic(
    const void* pool, long long pool_stride, int pool_rows, const void* peq,
    int B1, const void* peq_col, const void* txt_col, const void* nlen,
    const void* mword, const void* mbit, const void* mlen, const void* pairs,
    void* out, int n_slots, int n_pairs, int kw, int warps, int bits,
    void* stream) {
  if (warps < 1 || warps > MAX_WARPS)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_pairs <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int8_t*>(pool);
  const auto* q = static_cast<const uint32_t*>(peq);
  const int32_t* meta[6] = {
      static_cast<const int32_t*>(peq_col), static_cast<const int32_t*>(txt_col),
      static_cast<const int32_t*>(nlen),    static_cast<const int32_t*>(mword),
      static_cast<const int32_t*>(mbit),    static_cast<const int32_t*>(mlen)};
  const auto* pr = static_cast<const int32_t*>(pairs);
  auto* o = static_cast<int32_t*>(out);
  const dim3 grid(n_pairs), block(32 * warps);
  if (bits == 2)
    return launch_bits<2>(kw, grid, block, st, p, pool_stride, pool_rows, q,
                          B1, meta, pr, o, n_slots);
  if (bits == 4)
    return launch_bits<4>(kw, grid, block, st, p, pool_stride, pool_rows, q,
                          B1, meta, pr, o, n_slots);
  return static_cast<int>(cudaErrorInvalidValue);
}
