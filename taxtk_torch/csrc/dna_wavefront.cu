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
// an empty side gets max(alen, blen).  The TPU kernel's pad layout (a_ext
// and the reversed, sentinel-padded b, there for the lane roll) has no
// counterpart: the kernel reads a and b as they are and stops each pair at
// its own last column.
//
// Layout: a strip is 32 * R consecutive rows of a; lane l of a warp owns
// rows l*R+1 .. l*R+R of its strip and sweeps b's columns as a skewed
// wavefront (at step s lane l is at column s - l).  The cell above a lane's
// first row and the b code come from lane l-1's previous step, packed into
// one __shfl_up_sync (value | code << 24; values stay below 2^24).  Lane 0
// takes the row above the strip and the b codes from a 32-column chunk
// loaded coalesced by the whole warp.
//
// One pair spreads over many warps on many SMs: each warp takes strips in
// ticket order (one global atomicAdd per strip), and strip t of a pair
// trails strip t-1 through the pair's boundary row in global memory (lane
// 31 writes the strip's last row in place, column by column) and a
// progress counter that strip t-1 publishes every 32 columns.  A warp holds
// one ticket at a time and tickets are taken only by running warps, so the
// strip a warp waits for is always held by a running warp: no deadlock, in
// any block order.
//
// What bounds it on this card: integer issue.  Each cell is 4 essential INT32
// ops: the compare a_i != b_j, the add D(i-1, j-1) + cost, the min of up and
// left, and Hopper's DPX add-min __viaddmin_s32 (min(x + 1, y)), which fuses
// the +1 with the last min.  The H100 issues 132 SMs x 128 lanes of integer
// instructions per clock.  The overheads this design pays: two shuffles per R
// cells, the skew of 31 lane-steps per strip, and the strip-to-strip lag of at
// least 64 columns, which leaves SMs idle while a single long pair's pipeline
// fills.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

// the wrapper (ops/dna_wavefront.py) mirrors H as STRIP_ROWS and WARPS
constexpr int R = 4;        // rows per lane
constexpr int H = 32 * R;   // rows per strip
constexpr int WARPS = 4;    // warps per block
constexpr unsigned FULL = 0xFFFFFFFFu;
constexpr int VMASK = 0xFFFFFF;

__device__ __forceinline__ int load_volatile(const int* p) {
  return *reinterpret_cast<const volatile int*>(p);
}

__device__ __forceinline__ void store_volatile(int* p, int v) {
  *reinterpret_cast<volatile int*>(p) = v;
}

// One strip: rows top+1 .. top+H of pair p, all n columns.
__device__ void run_strip(const uint8_t* __restrict__ arow,
                          const uint8_t* __restrict__ brow,
                          int* __restrict__ rb, int* __restrict__ progress,
                          int t, int strip, int m, int n,
                          int* __restrict__ out_p, int lane) {
  const int top = strip * H;
  const bool first = strip == 0;
  const bool has_next = top + H < m;
  const int row0 = top + lane * R + 1;  // this lane's first row (1-based)
  int acode[R], col[R];
#pragma unroll
  for (int k = 0; k < R; ++k) {
    const int i = row0 + k;
    acode[k] = i <= m ? static_cast<int>(arow[i - 1]) : 0x100;
    col[k] = i;  // D(i, 0)
  }
  int diag = row0 - 1;  // D(row0 - 1, 0)
  // the lane and row holding D(m, n), if this strip has row m
  const int mrel = m - 1 - top;
  const bool owns_m = mrel >= 0 && mrel < H && mrel / R == lane;
  const int km = mrel % R;
  int chunk = 0;  // packed (D(top, j) | b_j << 24), j = chunk start + lane
  int send = 0;   // (D(last row, j) | b_j << 24) for lane + 1's next step
  const int steps = n + 31;
  for (int s = 1; s <= steps; ++s) {
    if (((s - 1) & 31) == 0 && s <= n) {  // warp-uniform chunk refill
      const int need = min(s + 31, n);
      if (!first) {
        if (lane == 0) {
          // a wait of seconds means a broken invariant: abort the launch
          // (the wrapper's caller sees the error) rather than hang the card
          for (int spins = 0; load_volatile(progress + t - 1) < need;
               ++spins) {
            if (spins > (1 << 24)) __trap();
            __nanosleep(64);
          }
        }
        __syncwarp();
        __threadfence();
      }
      const int j = s + lane;
      if (j <= n) {
        const int v = first ? j : __ldcg(rb + j);
        chunk = v | (static_cast<int>(brow[j - 1]) << 24);
      }
    }
    const int recv = __shfl_up_sync(FULL, send, 1);
    const int head = __shfl_sync(FULL, chunk, (s - 1) & 31);
    const int j = s - lane;
    if (j >= 1 && j <= n) {
      const int inp = lane == 0 ? head : recv;
      const int bc = static_cast<int>(static_cast<unsigned>(inp) >> 24);
      int up = inp & VMASK;
      int dg = diag;
#pragma unroll
      for (int k = 0; k < R; ++k) {
        const int left = col[k];
        const int v = __viaddmin_s32(min(up, left), 1,
                                     dg + static_cast<int>(acode[k] != bc));
        dg = left;
        col[k] = v;
        up = v;
      }
      diag = inp & VMASK;
      send = up | (bc << 24);
      if (owns_m && j == n) {
        int vm = col[0];
#pragma unroll
        for (int k = 1; k < R; ++k) vm = k == km ? col[k] : vm;
        *out_p = vm;
      }
      if (has_next && lane == 31) {
        rb[j] = up;  // D(top + H, j) for the next strip
        if ((j & 31) == 0 || j == n) {
          __threadfence();
          store_volatile(progress + t, j);
        }
      }
    }
  }
}

__global__ void __launch_bounds__(WARPS * 32) dna_wavefront_kernel(
    const uint8_t* __restrict__ a, long long a_stride,
    const uint8_t* __restrict__ b, long long b_stride,
    const int32_t* __restrict__ alen, const int32_t* __restrict__ blen,
    const int32_t* __restrict__ strip_base, int* __restrict__ rows,
    long long row_stride, int* __restrict__ progress,
    int* __restrict__ ticket, int32_t* __restrict__ out, int n_pairs) {
  // empty sides need no strip
  for (int p = blockIdx.x * blockDim.x + threadIdx.x; p < n_pairs;
       p += gridDim.x * blockDim.x) {
    const int m = alen[p];
    const int n = blen[p];
    if (m == 0 || n == 0) out[p] = max(m, n);
  }
  const int lane = threadIdx.x & 31;
  const int total = strip_base[n_pairs];
  for (;;) {
    int t = 0;
    if (lane == 0) t = atomicAdd(ticket, 1);
    t = __shfl_sync(FULL, t, 0);
    if (t >= total) return;  // warp-uniform
    // the pair of ticket t: the last p with strip_base[p] <= t
    int lo = 0, hi = n_pairs - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (strip_base[mid] <= t) {
        lo = mid;
      } else {
        hi = mid - 1;
      }
    }
    const int p = lo;
    run_strip(a + p * a_stride, b + p * b_stride, rows + p * row_stride,
              progress, t, t - strip_base[p], alen[p], blen[p], out + p,
              lane);
  }
}

}  // namespace

// Plain C entry (bound with ctypes).  a [n_pairs, a_stride] and b
// [n_pairs, b_stride] uint8 codes; strip_base int32 [n_pairs + 1], the
// prefix sum of each pair's strips (ceil(alen / 128), 0 for an empty
// side); rows int32 [n_pairs, row_stride >= blen + 1] scratch; progress
// int32 [strip_base[n_pairs]] and ticket int32 [1], both zero; out int32
// [n_pairs].  Returns cudaGetLastError() after the launch.
extern "C" int taxtk_dna_wavefront(const void* a, long long a_stride,
                                   const void* b, long long b_stride,
                                   const void* alen, const void* blen,
                                   const void* strip_base, void* rows,
                                   long long row_stride, void* progress,
                                   void* ticket, void* out, int n_pairs,
                                   int n_blocks, void* stream) {
  if (n_pairs <= 0) return 0;
  dna_wavefront_kernel<<<n_blocks, WARPS * 32, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(a), a_stride,
      static_cast<const uint8_t*>(b), b_stride,
      static_cast<const int32_t*>(alen), static_cast<const int32_t*>(blen),
      static_cast<const int32_t*>(strip_base), static_cast<int*>(rows),
      row_stride, static_cast<int*>(progress), static_cast<int*>(ticket),
      static_cast<int32_t*>(out), n_pairs);
  return static_cast<int>(cudaGetLastError());
}

