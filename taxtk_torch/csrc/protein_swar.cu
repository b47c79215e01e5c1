// Protein global alignment (BLOSUM62, linear gap -1) with traceback stats,
// two pairs per 32-bit word as 16-bit halves, one warp per two pairs, for
// Hopper (sm_90a).
//
// Replaces: taxtk/ops/pallas_protein.py::_make_kernel_swar (the v6 Pallas
// TPU kernel, launched by _raw_call_swar), taken by the entry when
// TAXTK_PROTEIN_SWAR=1 and the bucket lies in v6's domain (_swar_fits).
//
// What it computes is protein_wavefront.cu's function (see there), for
// pair p in the low halves and pair p + ceil(B/2) in the high halves.  As
// in v6 the scores ride biased (bias = steps_end + 8 of the bucket, so
// every real cell lies in [8, 2^14)) and the stats split into a
// matches16x2 and a dc16x2 word.  The half-wise arithmetic is CUDA's
// 16x2 SIMD intrinsics:
//   * __vmaxs2 gives max(left, up) and best = max(diag, gapbest) per
//     signed half;
//   * __vcmpges2 gives the per-half masks left >= up (v6's horizontal-arm
//     masks) and diag >= gapbest (v6's take-diagonal masks);
//   * __vadd2 adds per half without a carry across, __vcmpeq2 compares.
// The DPX form __vibmax_s16x2, whose per-half predicates are the same
// masks, returns them through bool pointers; ptxas kept those on the
// stack (a 12-byte spill per cell), so the masks come from __vcmpges2.
// A half beyond its own pair's lengths computes cells that feed no cell
// of that pair, and nothing crosses between halves, so the two pairs may
// have any lengths inside the bucket.
//
// Layout and wavefront: lanes take a strip of 32 rows of both pairs, the
// strip sweeps the columns skewed by one step per lane, the cell above
// and the b codes come down by __shfl_up_sync, and a per-warp DP row in
// global scratch carries strip to strip; one warp walks its strips in
// turn (protein_wavefront.cu's band of warps per pair is not carried over
// yet).
//
// What bounds it on this card: integer issue, the same essential work per
// cell as v5 (see protein_wavefront.cu); each instruction here serves two
// cells.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CODES = 32;
constexpr int WARPS = 4;  // pairs of pairs per block
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr unsigned ONE2 = 0x00010001u;
constexpr unsigned MINUS_ONE2 = 0xFFFFFFFFu;  // -1 in each half: the gap

__device__ __forceinline__ int code_at(const int8_t* col, long long stride,
                                       int pos) {
  const int c = static_cast<uint8_t>(col[static_cast<long long>(pos) * stride]);
  return c < CODES - 1 ? c : CODES - 1;
}

__device__ __forceinline__ unsigned pack2(int hi, int lo) {
  return (static_cast<unsigned>(hi) << 16) | (static_cast<unsigned>(lo) & 0xFFFFu);
}

__device__ __forceinline__ unsigned sel2(unsigned m, unsigned t, unsigned f) {
  return (t & m) | (f & ~m);
}

__global__ void __launch_bounds__(WARPS * 32) protein_swar_kernel(
    const int8_t* __restrict__ pool, long long stride,
    const int32_t* __restrict__ a_col, const int32_t* __restrict__ b_col,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ blen,
    const int32_t* __restrict__ sub_g, uint4* __restrict__ scratch,
    int32_t* __restrict__ out, int n_pairs, int n_max, int bias) {
  __shared__ int sub[CODES * CODES];
  for (int k = threadIdx.x; k < CODES * CODES; k += blockDim.x) {
    sub[k] = sub_g[k];
  }
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const int half = (n_pairs + 1) / 2;
  const int w = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (w >= half) return;  // warp-uniform
  const int pl = w;
  const int ph = w + half;
  const bool has_h = ph < n_pairs;
  int ml = alen[pl], nl = blen[pl];
  int mh = has_h ? alen[ph] : 0, nh = has_h ? blen[ph] : 0;
  // empty sides: the all-gap score and zero stats, written up front
  if (ml == 0 || nl == 0) {
    if (lane == 0) {
      out[pl] = -max(ml, nl);
      out[n_pairs + pl] = 0;
    }
    ml = nl = 0;
  }
  if (mh == 0 || nh == 0) {
    if (lane == 0 && has_h) {
      out[ph] = -max(mh, nh);
      out[n_pairs + ph] = 0;
    }
    mh = nh = 0;
  }
  const int m = max(ml, mh);
  const int n = max(nl, nh);
  if (m == 0) return;
  const int8_t* acol_l = pool + a_col[pl];
  const int8_t* bcol_l = pool + b_col[pl];
  const int8_t* acol_h = pool + (has_h ? a_col[ph] : 0);
  const int8_t* bcol_h = pool + (has_h ? b_col[ph] : 0);
  uint4* row = scratch + static_cast<long long>(w) * (n_max + 1);
  for (int j = lane; j <= n; j += 32) {
    row[j] = make_uint4(pack2(bias - j, bias - j), 0u, 0u, 0u);
  }
  __syncwarp();

  for (int i0 = 0; i0 < m; i0 += 32) {
    const int i = i0 + lane + 1;  // this lane's row, in both halves
    const int acl = i <= ml ? code_at(acol_l, stride, i - 1) : CODES - 1;
    const int ach = i <= mh ? code_at(acol_h, stride, i - 1) : CODES - 1;
    const unsigned a2 = pack2(ach, acl);
    const int* subl = sub + acl * CODES;
    const int* subh = sub + ach * CODES;
    unsigned left_s = pack2(bias - i, bias - i);  // H(i, 0)
    unsigned left_ma = 0u, left_dc = 0u;
    unsigned diag_s = pack2(bias - (i - 1), bias - (i - 1));  // H(i-1, 0)
    unsigned diag_ma = 0u, diag_dc = 0u;
    unsigned b2 = pack2(CODES - 1, CODES - 1);
    const int steps = n + min(31, m - i0 - 1);
    for (int s = 0; s < steps; ++s) {
      const int j = s - lane + 1;
      unsigned up_s = __shfl_up_sync(FULL, left_s, 1);
      unsigned up_ma = __shfl_up_sync(FULL, left_ma, 1);
      unsigned up_dc = __shfl_up_sync(FULL, left_dc, 1);
      const unsigned up_b = __shfl_up_sync(FULL, b2, 1);
      if (j < 1 || j > n) continue;
      if (lane == 0) {
        const uint4 u = row[j];
        up_s = u.x;
        up_ma = u.y;
        up_dc = u.z;
        const int bl = j <= nl ? code_at(bcol_l, stride, j - 1) : CODES - 1;
        const int bh = j <= nh ? code_at(bcol_h, stride, j - 1) : CODES - 1;
        b2 = pack2(bh, bl);
      } else {
        b2 = up_b;
      }
      const unsigned sub2 = pack2(subh[b2 >> 16], subl[b2 & 0xFFFFu]);
      const unsigned dv = __vadd2(diag_s, sub2);
      const unsigned gm = __vmaxs2(left_s, up_s);
      // left >= up per half: the horizontal arm beats or ties
      const unsigned hm = __vcmpges2(left_s, up_s);
      const unsigned gb = __vadd2(gm, MINUS_ONE2);
      const unsigned best = __vmaxs2(dv, gb);
      // diag >= gapbest per half: the diagonal wins
      const unsigned dm = __vcmpges2(dv, gb);
      const unsigned match2 = __vcmpeq2(a2, b2) & ONE2;
      const unsigned ma = sel2(dm, __vadd2(diag_ma, match2),
                               sel2(hm, left_ma, up_ma));
      const unsigned dc = sel2(dm, __vadd2(diag_dc, ONE2),
                               sel2(hm, left_dc, up_dc));
      diag_s = up_s;
      diag_ma = up_ma;
      diag_dc = up_dc;
      left_s = best;
      left_ma = ma;
      left_dc = dc;
      if (lane == 31) row[j] = make_uint4(best, ma, dc, 0u);
      if (i == ml && j == nl) {
        out[pl] = static_cast<int>(best & 0xFFFFu) - bias;
        out[n_pairs + pl] = static_cast<int>((dc << 16) | (ma & 0xFFFFu));
      }
      if (i == mh && j == nh) {
        out[ph] = static_cast<int>(best >> 16) - bias;
        out[n_pairs + ph] =
            static_cast<int>((dc & 0xFFFF0000u) | (ma >> 16));
      }
    }
    __syncwarp();
  }
}

}  // namespace

// Plain C entry (bound with ctypes).  out is int32 [2, n_pairs] (score,
// dc << 16 | matches); scratch holds ceil(n_pairs / 2) x (n_max + 1)
// uint4.  Returns cudaGetLastError() after the launch.
extern "C" int taxtk_protein_swar(const void* pool, long long stride,
                                  const void* a_col, const void* b_col,
                                  const void* alen, const void* blen,
                                  const void* sub, void* scratch, void* out,
                                  int n_pairs, int n_max, int bias,
                                  void* stream) {
  if (n_pairs <= 0) return 0;
  const int half = (n_pairs + 1) / 2;
  const dim3 grid((half + WARPS - 1) / WARPS);
  protein_swar_kernel<<<grid, WARPS * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(pool), stride,
      static_cast<const int32_t*>(a_col), static_cast<const int32_t*>(b_col),
      static_cast<const int32_t*>(alen), static_cast<const int32_t*>(blen),
      static_cast<const int32_t*>(sub), static_cast<uint4*>(scratch),
      static_cast<int32_t*>(out), n_pairs, n_max, bias);
  return static_cast<int>(cudaGetLastError());
}
