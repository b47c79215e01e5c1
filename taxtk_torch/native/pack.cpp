// The sequence pool's wire layout, packed on the host (the port's own
// source; taxtk packs it in numpy).
//
// taxtk_pack_text_pool writes what ops/host.py::_pack_text_pool returns: a
// [n_bytes, Up] uint8 array whose column u holds row u's codes, clamped to
// the sentinel (1 << bits) - 1 and packed 8 / bits to a byte from position
// 0, and 0xFF past the row's own length.  A column with length 0 (a row the
// caller leaves out, or one of the pad columns past n_cols) is all 0xFF.
//
// One pass over 64-column tiles, each in bands of 256 output rows: the band
// of each row of the tile is packed contiguously into a scratch buffer that
// stays in L1 (0xFF past the row's end), which is then written transposed,
// 8 x 8 bytes at a time, so every store into the output is a run of
// contiguous bytes and a band's output rows stay in cache across the tile.
// Output rows past the tile's longest row are filled with 0xFF per tile,
// and those past the longest row of all with one memset.  Single-threaded:
// the host route's Myers batch runs on every core beside it.

#include <algorithm>
#include <cstdint>
#include <cstring>

namespace {

constexpr int64_t TILE = 64;
constexpr int64_t BAND = 256;  // output rows packed per scratch fill

template <int BITS>
inline uint8_t pack_byte(const uint8_t* src) {
  constexpr int CPB = 8 / BITS;
  constexpr unsigned SENT = (1u << BITS) - 1;
  unsigned v = 0;
  for (int f = 0; f < CPB; ++f)
    v |= std::min<unsigned>(src[f], SENT) << (BITS * f);
  return static_cast<uint8_t>(v);
}

// Row of L codes -> nbt bytes at dst: whole bytes, then the last partial
// byte (its missing fields the sentinel), then 0xFF.
template <int BITS>
void pack_row(const uint8_t* src, int64_t L, uint8_t* dst, int64_t nbt) {
  constexpr int CPB = 8 / BITS;
  constexpr unsigned SENT = (1u << BITS) - 1;
  const int64_t full = L / CPB;
  for (int64_t i = 0; i < full; ++i) dst[i] = pack_byte<BITS>(src + i * CPB);
  int64_t b = full;
  const int rem = static_cast<int>(L - full * CPB);
  if (rem) {
    unsigned v = 0;
    for (int f = 0; f < CPB; ++f)
      v |= (f < rem ? std::min<unsigned>(src[full * CPB + f], SENT) : SENT)
           << (BITS * f);
    dst[b++] = static_cast<uint8_t>(v);
  }
  if (nbt > b) std::memset(dst + b, 0xFF, nbt - b);
}

inline void swap_bits(uint64_t& a, uint64_t& b, int s, uint64_t m) {
  const uint64_t t = ((a >> s) ^ b) & m;
  b ^= t;
  a ^= t << s;
}

// 8 x 8 bytes: src rows j (stride ls) -> dst rows k (stride ld), dst[k][j] =
// src[j][k]; w <= 8 columns of dst are stored.
inline void transpose8(const uint8_t* src, int64_t ls, uint8_t* dst,
                       int64_t ld, int64_t w) {
  uint64_t r[8];
  for (int j = 0; j < 8; ++j) std::memcpy(&r[j], src + j * ls, 8);
  for (int j = 0; j < 4; ++j)
    swap_bits(r[j], r[j + 4], 32, 0x00000000FFFFFFFFull);
  for (int j : {0, 1, 4, 5})
    swap_bits(r[j], r[j + 2], 16, 0x0000FFFF0000FFFFull);
  for (int j : {0, 2, 4, 6})
    swap_bits(r[j], r[j + 1], 8, 0x00FF00FF00FF00FFull);
  if (w == 8) {
    for (int k = 0; k < 8; ++k) std::memcpy(dst + k * ld, &r[k], 8);
  } else {
    for (int k = 0; k < 8; ++k) std::memcpy(dst + k * ld, &r[k], w);
  }
}

template <int BITS>
void pack_pool(const uint8_t* const* rows, const int64_t* lens,
               int64_t n_cols, int64_t nbmax, int64_t Up, uint8_t* out) {
  constexpr int64_t CPB = 8 / BITS;
  uint8_t scratch[TILE * BAND];
  int64_t nb[TILE];
  for (int64_t c0 = 0; c0 < Up; c0 += TILE) {
    const int64_t w = std::min(TILE, Up - c0);
    const int64_t live = std::max<int64_t>(0, std::min(w, n_cols - c0));
    int64_t nbt = 0;  // the tile's longest row, in bytes
    for (int64_t j = 0; j < TILE; ++j) {
      nb[j] = j < live ? (lens[c0 + j] + CPB - 1) / CPB : 0;
      nbt = std::max(nbt, nb[j]);
    }
    const int64_t wg = (w + 7) & ~int64_t(7);
    for (int64_t b_lo = 0; b_lo < nbt; b_lo += BAND) {
      const int64_t bh = std::min(BAND, nbt - b_lo);
      const int64_t ls = (bh + 7) & ~int64_t(7);
      for (int64_t j = 0; j < wg; ++j) {
        const int64_t L = nb[j] > b_lo
            ? std::min(lens[c0 + j] - b_lo * CPB, bh * CPB) : 0;
        pack_row<BITS>(L ? rows[c0 + j] + b_lo * CPB : nullptr, L,
                       scratch + j * ls, ls);
      }
      for (int64_t b0 = 0; b0 < bh; b0 += 8) {
        const int64_t hb = std::min<int64_t>(8, bh - b0);
        uint8_t* d = out + (b_lo + b0) * Up + c0;
        for (int64_t j0 = 0; j0 < w; j0 += 8) {
          const uint8_t* s = scratch + j0 * ls + b0;
          const int64_t wj = std::min<int64_t>(8, w - j0);
          if (hb == 8) {
            transpose8(s, ls, d + j0, Up, wj);
          } else {
            uint8_t tmp[64];
            transpose8(s, ls, tmp, 8, 8);
            for (int64_t k = 0; k < hb; ++k)
              std::memcpy(d + j0 + k * Up, tmp + k * 8, wj);
          }
        }
      }
    }
    for (int64_t b = nbt; b < nbmax; ++b)
      std::memset(out + b * Up + c0, 0xFF, w);
  }
}

}  // namespace

extern "C" {

// rows[u], lens[u] for u < n_cols (a row of length 0 is not read; Up >=
// n_cols); out is [n_bytes, Up].  Returns 0, or -1 if bits is not 2, 4 or 8,
// Up < n_cols, or a row needs more than n_bytes bytes (nothing written).
int taxtk_pack_text_pool(const uint8_t* const* rows, const int64_t* lens,
                         int64_t n_cols, int bits, int64_t n_bytes,
                         int64_t Up, uint8_t* out) {
  if ((bits != 2 && bits != 4 && bits != 8) || Up < n_cols || n_cols < 0)
    return -1;
  const int64_t cpb = 8 / bits;
  int64_t nbmax = 0;
  for (int64_t u = 0; u < n_cols; ++u) {
    if (lens[u] < 0) return -1;
    nbmax = std::max(nbmax, (lens[u] + cpb - 1) / cpb);
  }
  if (nbmax > n_bytes) return -1;
  if (bits == 2)
    pack_pool<2>(rows, lens, n_cols, nbmax, Up, out);
  else if (bits == 4)
    pack_pool<4>(rows, lens, n_cols, nbmax, Up, out);
  else
    pack_pool<8>(rows, lens, n_cols, nbmax, Up, out);
  if (n_bytes > nbmax)
    std::memset(out + nbmax * Up, 0xFF, (n_bytes - nbmax) * Up);
  return 0;
}

}  // extern "C"
