// Short-pair Myers edit distance for Hopper (sm_90a): a group of lanes per
// pair, the pattern's match masks in registers.
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
// Design: a group of G = K / W lanes per pair, W consecutive pattern words
// per lane (W = 2 at K = 64; W = 1 or 2 at K = 16 and 32, W = 1 below;
// ops/myers_cuda.py::kernel_geometry picks it), so a warp holds 32 / G
// pairs and a block of four warps 128 / G.  Each lane reads its words'
// match masks from peq once, at the pair's start, and keeps them as three
// bit planes of the pattern codes (as csrc/myers_systolic.cu does), with
// its words' Pv and Mv, in registers: no memory is read per char but the
// text.  Pattern word k takes char t - k at step t, a skewed wavefront
// over words, not only over lanes: a lane's word q works one char behind
// its word q-1, on the carries word q-1 made the step before, so the words
// of one step are independent.  The group's lanes hand the carries of
// their last word on through one __shfl_up_sync of width G, PH at bit 31
// and MH at bit 0 of one value; the group's lane 0 takes PH = 1, MH = 0
// (the row above the pattern).  The char does not ride the shuffle, as it
// does in csrc/myers_systolic.cu: each lane reads its own chars from the
// pool, 32 / BITS at a time (16 2-bit or 8 4-bit codes in a 32-bit word
// built from five pool bytes), one tile ahead, and its later words reuse
// the masks of chars its word 0 took.  So a step's dependent chain is the
// shuffle, one word and the pack, and a lane of W words carries that chain
// over W steps (the char in the shuffle, as char | PH<<8 | MH<<9, and the
// words of a step chained through their carries made it longer, and ran
// slower on the H100).
//
// Per-pair pattern end: only the lane holding word kend = (m-1)>>5 keeps a
// score that matters, and it harvests char n-1 at step n-1 + kend: a pair
// takes n + kend steps.  Lanes past the pattern end compute on inert words
// (their masks are never loaded: zero) and their results go nowhere, since
// carries flow only to higher words; they keep executing the group's
// shuffles, so no lane of the warp stalls or diverges on them.  The warp
// runs the most steps of its pairs, in whole tiles; a pair's words past
// its own end or text compute on pad and are never harvested.  Words
// before their first char (the ramp, t < k) skip the update; that check
// and the harvest test run only in tiles that hold a ramp step or a
// harvest (a warp vote per tile), the other tiles take neither.  A warp
// whose pairs are all the aligner's 1 x 1 dummy rows runs one tile.
//
// What bounds it on this card: integer issue.  The recurrence needs ~13
// instructions per 32-cell word per char (chip_smoke.py's
// OPS_PER_WORD_CHAR, over 132 SMs x 128 lanes a clock); a step here is
// about 20 a word with its share of the shuffle, the select of lane 0's
// carries, the char's masks and the score, most on the 16-lane ALU pipe.
// At thousands of pairs that pipe is the limit.  At the engine's launches
// (at most 512 pairs: a 512-pair K = 64 launch is 512 warps in 128 blocks
// of 128 threads, about one warp on each of the card's 528 schedulers) a
// lone warp issues its step with little to hide the latency between its
// dependent instructions, so a launch takes about its longest pair's
// n + kend steps at that rate; more warps per pair (a pair's words over
// two warps) would be the next lever there.
//
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int ALPHA = 5;
constexpr int THREADS = 128;  // four warps a block
constexpr unsigned FULL = 0xFFFFFFFFu;
// the carries a lane hands on: PH at bit 31, MH at bit 0; a group's lane 0
// takes the row above the pattern, PH = 1 and MH = 0
constexpr uint32_t HEAD = 0x80000000u;

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

// One tile (32 / BITS steps) of one lane.  Word q of the lane takes the
// char word 0 took q steps before, with the carries word q-1 made then
// (pc, mc: PH at bit 31, MH as a bit), and word 0 the carries of the lane
// before, shuffled; k0..k2 hold each word's char as plane masks.  EDGE: the
// tile holds a ramp step (some word before its first char) or a harvest;
// other tiles skip both tests.
template <int G, int W, int BITS, bool EDGE>
__device__ __forceinline__ void tile(
    uint32_t text, int t0, int lag, int th, bool head,
    const uint32_t (&x0)[W], const uint32_t (&x1)[W],
    const uint32_t (&x2)[W], const uint32_t (&hm)[W], uint32_t (&pv)[W],
    uint32_t (&mv)[W], uint32_t (&k0)[W], uint32_t (&k1)[W],
    uint32_t (&k2)[W], uint32_t (&pc)[W], uint32_t (&mc)[W], int& score,
    int& res) {
#pragma unroll
  for (int r = 0; r < 32 / BITS; ++r) {
    uint32_t recv = 0u;
    if constexpr (G > 1) {
      const uint32_t send = (pc[W - 1] & HEAD) | mc[W - 1];
      recv = __shfl_up_sync(FULL, send, 1, G);
    }
    const uint32_t cin = head ? HEAD : recv;
#pragma unroll
    for (int q = W - 1; q > 0; --q) {
      k0[q] = k0[q - 1];
      k1[q] = k1[q - 1];
      k2[q] = k2[q - 1];
    }
    // the new char's plane code as three all-ones-or-zero masks
    k0[0] = 0u - ((text >> (BITS * r)) & 1u);
    k1[0] = 0u - ((text >> (BITS * r + 1)) & 1u);
    k2[0] = BITS == 4 ? 0u - ((text >> (BITS * r + 2)) & 1u) : 0u;
    const int t = t0 + r;
    uint32_t ph_hit = 0u, mh_hit = 0u;
    uint32_t npc[W], nmc[W];
#pragma unroll
    for (int q = 0; q < W; ++q) {
      const uint32_t pin = q == 0 ? cin : pc[q - 1];  // PH in, at bit 31
      const uint32_t mbit = q == 0 ? (cin & 1u) : mc[q - 1];  // MH in
      npc[q] = pc[q];
      nmc[q] = mc[q];
      if (!EDGE || t >= lag + q) {
        // BITS == 2: x2 is the valid plane; BITS == 4: the code's bit 2
        const uint32_t eq0 =
            BITS == 2
                ? x2[q] & ~((x0[q] ^ k0[q]) | (x1[q] ^ k1[q]))
                : ~((x0[q] ^ k0[q]) | (x1[q] ^ k1[q]) | (x2[q] ^ k2[q]));
        const uint32_t eq = eq0 | mbit;
        const uint32_t xv = eq | mv[q];
        const uint32_t add = (eq & pv[q]) + pv[q];
        const uint32_t xh = (add ^ pv[q]) | eq;
        const uint32_t ph = mv[q] | ~(xh | pv[q]);
        const uint32_t mh = pv[q] & xh;
        ph_hit |= ph & hm[q];
        mh_hit |= mh & hm[q];
        const uint32_t phs = __funnelshift_l(pin, ph, 1);  // ph << 1 | PH in
        const uint32_t mhs = (mh << 1) | mbit;
        pv[q] = mhs | ~(xv | phs);
        mv[q] = phs & xv;
        npc[q] = ph;
        nmc[q] = mh >> 31;
      }
    }
#pragma unroll
    for (int q = 0; q < W; ++q) {
      pc[q] = npc[q];
      mc[q] = nmc[q];
    }
    score += static_cast<int>(ph_hit != 0u) - static_cast<int>(mh_hit != 0u);
    if (EDGE && t == th) res = score;
  }
}

template <int K, int W, int BITS>
__global__ void __launch_bounds__(THREADS) myers_short_kernel(
    const int8_t* __restrict__ pool, long long pool_stride, int pool_rows,
    const int32_t* __restrict__ txt_col,
    const uint32_t* __restrict__ peq, long long peq_cols,
    const int32_t* __restrict__ pat_idx,
    const int32_t* __restrict__ nlen, const int32_t* __restrict__ mlen,
    int32_t* __restrict__ out, int n_pairs) {
  constexpr int G = K / W;   // lanes per pair
  constexpr int P = 32 / G;  // pairs per warp
  constexpr int CPB = 8 / BITS;
  constexpr int TILE = 32 / BITS;  // chars per text word
  static_assert(G * W == K && G >= 1 && G <= 32, "bad short geometry");
  const int lane = threadIdx.x & 31;
  const int gl = lane % G;  // lane within the pair's group
  const int warp = (blockIdx.x * THREADS + threadIdx.x) >> 5;
  if (warp * P >= n_pairs) return;  // warp-uniform: no pair in this warp
  const int i = warp * P + lane / G;
  const bool live = i < n_pairs;
  const int n = live ? nlen[i] : 0;
  const int m = live ? mlen[i] : 0;
  const int kk = (m - 1) >> 5;  // the pattern-end word; -1 at m == 0
  const int kend = m > 0 ? kk : 0;
  // word k takes char t - k at step t: the end word's lane harvests char
  // n-1 at step n-1 + kend, and no other lane harvests
  const int th = gl == kend / W ? n - 1 + kend : -1;
  const int steps = __reduce_max_sync(FULL, n > 0 ? n + kend : 0);

  uint32_t x0[W], x1[W], x2[W], hm[W], pv[W], mv[W];
  uint32_t k0[W], k1[W], k2[W], pc[W], mc[W];
  const uint32_t* pq = peq + (live ? pat_idx[i] : 0);
#pragma unroll
  for (int q = 0; q < W; ++q) {
    const int k = gl * W + q;
    uint32_t p[ALPHA] = {0u, 0u, 0u, 0u, 0u};
    if (k <= kk) {  // words past the pattern end are inert: left at zero
#pragma unroll
      for (int c = 0; c < (BITS == 2 ? 4 : ALPHA); ++c)
        p[c] = __ldg(pq + static_cast<long long>(k * ALPHA + c) * peq_cols);
    }
    const uint32_t valid = p[0] | p[1] | p[2] | p[3] | p[4];
    x0[q] = p[1] | p[3];
    x1[q] = p[2] | p[3];
    if (BITS == 2) {
      x2[q] = valid;  // no N on this wire
    } else {
      x1[q] |= ~valid;  // pads take code 6: no text code matches it
      x2[q] = p[4] | ~valid;
    }
    hm[q] = k == kk ? 1u << ((m - 1) & 31) : 0u;
    pv[q] = 0xFFFFFFFFu;
    mv[q] = 0u;
    k0[q] = k1[q] = k2[q] = pc[q] = mc[q] = 0u;
  }
  int score = m;
  int res = max(m, n);
  // the lane's word 0 reads its own chars t - lag: its word of a tile
  // starts lag_rows pool rows before the tile's first row, sh bits in
  const int lag = gl * W;
  const int lag_rows = (lag + CPB - 1) / CPB;
  const int sh = BITS * (lag_rows * CPB - lag);
  const bool head = gl == 0;
  const int8_t* col = pool + (live ? txt_col[i] : 0);
  uint32_t next = text_word<BITS>(col, pool_stride, pool_rows, -lag_rows, sh);
  for (int t0 = 0; t0 < steps; t0 += TILE) {
    const uint32_t text = next;
    next = text_word<BITS>(col, pool_stride, pool_rows,
                           (t0 + TILE) / CPB - lag_rows, sh);
    if (t0 < K - 1 || __any_sync(FULL, th >= t0 && th < t0 + TILE)) {
      tile<G, W, BITS, true>(text, t0, lag, th, head, x0, x1, x2, hm, pv, mv,
                             k0, k1, k2, pc, mc, score, res);
    } else {
      tile<G, W, BITS, false>(text, t0, lag, th, head, x0, x1, x2, hm, pv,
                              mv, k0, k1, k2, pc, mc, score, res);
    }
  }
  if (live && gl == kend / W) out[i] = res;
}

template <int K, int W>
int launch(int bits, cudaStream_t st, const int8_t* pool, long long stride,
           int rows, const int32_t* txt_col, const uint32_t* peq,
           long long peq_cols, const int32_t* pat_idx, const int32_t* nlen,
           const int32_t* mlen, int32_t* out, int n) {
  constexpr int PAIRS_PER_BLOCK = THREADS / 32 * (32 * W / K);
  const dim3 grid((n + PAIRS_PER_BLOCK - 1) / PAIRS_PER_BLOCK);
  if (bits == 2) {
    myers_short_kernel<K, W, 2><<<grid, THREADS, 0, st>>>(
        pool, stride, rows, txt_col, peq, peq_cols, pat_idx, nlen, mlen, out,
        n);
  } else if (bits == 4) {
    myers_short_kernel<K, W, 4><<<grid, THREADS, 0, st>>>(
        pool, stride, rows, txt_col, peq, peq_cols, pat_idx, nlen, mlen, out,
        n);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry (bound with ctypes).  (K, W) is one of the template set:
// W = 1 at K in {1, 2, 4, 8, 16, 32}, W = 2 at K in {16, 32, 64}.  Returns
// cudaGetLastError() after the launch, or cudaErrorInvalidValue for a
// (K, W) or bits outside the set.
extern "C" int taxtk_myers_short(const void* pool, long long pool_stride,
                                 int pool_rows, const void* txt_col,
                                 const void* peq, long long peq_cols,
                                 const void* pat_idx, const void* nlen,
                                 const void* mlen, void* out, int n_pairs,
                                 int K, int W, int bits, void* stream) {
  if (n_pairs <= 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const int8_t*>(pool);
  const auto* tcol = static_cast<const int32_t*>(txt_col);
  const auto* q = static_cast<const uint32_t*>(peq);
  const auto* pidx = static_cast<const int32_t*>(pat_idx);
  const auto* nl = static_cast<const int32_t*>(nlen);
  const auto* ml = static_cast<const int32_t*>(mlen);
  auto* o = static_cast<int32_t*>(out);
#define TAXTK_SHORT(KK, WW)                                                 \
  if (K == KK && W == WW)                                                   \
    return launch<KK, WW>(bits, st, p, pool_stride, pool_rows, tcol, q,     \
                          peq_cols, pidx, nl, ml, o, n_pairs);
  TAXTK_SHORT(1, 1)
  TAXTK_SHORT(2, 1)
  TAXTK_SHORT(4, 1)
  TAXTK_SHORT(8, 1)
  TAXTK_SHORT(16, 1)
  TAXTK_SHORT(16, 2)
  TAXTK_SHORT(32, 1)
  TAXTK_SHORT(32, 2)
  TAXTK_SHORT(64, 2)
#undef TAXTK_SHORT
  return static_cast<int>(cudaErrorInvalidValue);
}
