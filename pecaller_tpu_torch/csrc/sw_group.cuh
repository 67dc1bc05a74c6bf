// The thread-group DP row shared by K1 (sw_align_x.cu), K2
// (sw_tb_rows.cu) and K3 (sw_align.cu).
//
// A group of G threads owns one lane; thread g of the group owns the
// C = sw_group_cols(M, G) consecutive columns [g*C, g*C + C).  Its
// columns of the three DP planes and its read codes live in registers.
// The match rule is a template policy `Match`: Match::code(b) is the
// register of read byte b (sw_group_init), Match::bump(r, q) the score
// of the row's reference value r against register q (sw_group_row).
// Match::ref(b) is the row value of reference byte b.  K1 and K2 take
// SwXMatch, the xcode rule of sw_bump; K3 its byte rule (SwByteMatch,
// sw_align.cu).  K1 and K3 are one kernel, sw_group_align_kernel, that
// differs in its rule and in K1's tie count.
// One row (sw_group_row):
//   1. c0 (diagonal) and c1 (deletion) need the old row at their column
//      and the one to its left: the only value from outside a thread is
//      max(o0, o1, o2) of the left neighbour's last column (shfl_up);
//   2. the insertion plane c2[j] = max_{j' <= j} a[j'] - j, with
//      a[0] = -OPEN and a[j] = c0[j-1] - OPEN + j, is an inclusive
//      max-scan: a running max over the thread's own columns (its first
//      a takes the neighbour's last new c0, one more shfl_up), then an
//      exclusive max-scan of the segment maxima over the group in
//      log2(G) shuffle steps with identity SW_NEG (never offset, so it
//      cannot wrap), then one max per column.
// Every DP dependency points left, so columns past the read never feed
// the columns before them; their threads compute them only to stay in
// the shuffles.  Hopper's DPX instructions take max3 (__vimax3_s32) and
// max(a + b, c) (__viaddmax_s32) in one instruction each (VIMNMX3,
// VIADDMNMX in SASS).
#pragma once

#include <cuda_runtime.h>

#include "sw_kernels.h"

#define SW_FULL 0xffffffffu

// The instantiated C of each G, smallest first (0 ends a row): a launch
// takes the smallest C with G x C >= M + 1, so the widest read is
// 32 x 18 - 1 = 575.  Each C serves the widths sw_group_for gives its G,
// but for two diagnostic instances: 16 x 8 and 32 x 4 serve no width the
// launch picks by itself; they let chip_smoke.py time the three group
// sizes at the main-path width (M = 112) with an explicit `group`.
constexpr int kSwXCols[3][7] = {{8, 15, 16, 0},
                                {8, 12, 16, 0},
                                {4, 10, 12, 14, 16, 18, 0}};

constexpr int sw_x_row(int G) { return G == 8 ? 0 : (G == 16 ? 1 : 2); }

static inline bool sw_group_ok(int G) { return G == 8 || G == 16 || G == 32; }

// Threads per lane by width: 8 up to 128 columns, 16 up to 256, 32 up
// to 576; fewer threads a lane means fewer shuffles a column.
static inline int sw_group_for(int M) {
  return M + 1 <= 8 * 16 ? 8 : (M + 1 <= 16 * 16 ? 16 : 32);
}

// Columns per thread with `group` threads per lane (0 = by width) for
// reads of width M; 0 where no instance fits.
static inline int sw_group_cols(int M, int group) {
  const int G = group ? group : sw_group_for(M);
  if (!sw_group_ok(G) || M < 0) return 0;
  for (const int C : kSwXCols[sw_x_row(G)])
    if (C && G * C >= M + 1) return C;
  return 0;
}

// Calls run<G, C>() for the instance of (G, C); cudaErrorInvalidValue
// where the table has none.
template <int G, int I = 0, class Run>
static int sw_group_dispatch(int C, const Run& run) {
  constexpr int CC = kSwXCols[sw_x_row(G)][I];
  if constexpr (CC == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (C == CC) return run.template operator()<G, CC>();
    return sw_group_dispatch<G, I + 1>(C, run);
  }
}

template <class Run>
static int sw_group_launch(int G, int C, const Run& run) {
  switch (G) {
    case 8: return sw_group_dispatch<8>(C, run);
    case 16: return sw_group_dispatch<16>(C, run);
    default: return sw_group_dispatch<32>(C, run);
  }
}

#ifdef __CUDACC__
// The xcode rule of K1 and K2: a read code and a row value are the
// xcode itself.
template <bool BIS>
struct SwXMatch {
  static __device__ __forceinline__ int code(int b) { return b; }
  static __device__ __forceinline__ int ref(int b) { return b; }
  static __device__ __forceinline__ int bump(int r, int q) {
    return sw_bump<BIS>(r, q);
  }
};

// Row 0 of the three planes and the read codes of the thread's columns
// (column j scores read position j - 1).
template <class Match, int C>
__device__ __forceinline__ void sw_group_init(int (&S0)[C], int (&S1)[C],
                                              int (&S2)[C], int (&rd)[C],
                                              const uint8_t* read, bool live,
                                              int j0, int M) {
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const int b = j == 0 ? 0 : -(SW_OPEN + (j - 1) * SW_EXT);
    S0[c] = b;
    S1[c] = b;
    S2[c] = j == 0 ? -SW_OPEN : b;
    rd[c] = (live && j >= 1 && j <= M) ? Match::code(read[j - 1]) : 0;
  }
}

// The new row (c0, c1, c2) from the old one (S0, S1, S2) against
// reference value rb.  Every thread of `mask` (whole groups of the warp)
// calls it.
template <class Match, int G, int C>
__device__ __forceinline__ void sw_group_row(
    unsigned mask, const int (&S0)[C], const int (&S1)[C],
    const int (&S2)[C], const int (&rd)[C], int rb, int g, int j0,
    int (&c0)[C], int (&c1)[C], int (&c2)[C]) {
  // c0, c1 from the old row; column j0 - 1 from the left neighbour
  const int p3_left = __shfl_up_sync(
      mask, __vimax3_s32(S0[C - 1], S1[C - 1], S2[C - 1]), 1, G);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int l = c > 0 ? c - 1 : 0;
    const int p3 = c == 0 ? p3_left : __vimax3_s32(S0[l], S1[l], S2[l]);
    c0[c] = p3 + Match::bump(rb, rd[c]);
    c1[c] = __viaddmax_s32(S0[c], -SW_OPEN, S1[c] - SW_EXT);
  }
  if (g == 0) {  // column 0
    c0[0] = 0;
    c1[0] = 0;
  }

  // c2: running max of a over own columns, then the group's scan
  const int c0_left = __shfl_up_sync(mask, c0[C - 1], 1, G);
  int run[C];
  run[0] = g == 0 ? -SW_OPEN : c0_left - SW_OPEN + j0;
#pragma unroll
  for (int c = 1; c < C; ++c)
    run[c] = __viaddmax_s32(c0[c - 1], j0 + c - SW_OPEN, run[c - 1]);
  int x = run[C - 1];
#pragma unroll
  for (int d = 1; d < G; d <<= 1) {
    const int t = __shfl_up_sync(mask, x, d, G);
    if (g >= d) x = max(x, t);
  }
  int ex = __shfl_up_sync(mask, x, 1, G);
  if (g == 0) ex = SW_NEG;
#pragma unroll
  for (int c = 0; c < C; ++c) c2[c] = max(ex, run[c]) - (j0 + c);
}

// K1 and K3: the best cell of column rlen (sw_align_x.cu and
// sw_align.cu give the contract and the design).  A group of G threads
// owns a lane; per row, the group's threads load G reference bytes at
// once, coalesced, turn each into its row value (Match::ref) and
// shuffle out one per row; sw_group_row computes the new row; the
// thread that owns column rlen updates best / k / i and, with TIE, the
// count of cells that attain the final best (K1's tie flag; reset on
// every strict improvement).  Without TIE, tie_out is not written.
// Lanes of one warp may stop at different rows (blen, and several lanes
// share a warp when G < 32): the warp loops to its longest lane and an
// inactive row updates nothing.  Tail lanes past B stay in the shuffles
// and write nothing; no thread leaves before the last shuffle.
// One block an SM at least, so ptxas may take up to 255 registers: with
// its default budget the 12-column instances spill.
#define SW_GROUP_THREADS 256

template <class Match, bool TIE, int G, int C>
__global__ void __launch_bounds__(SW_GROUP_THREADS, 1)
    sw_group_align_kernel(const uint8_t* __restrict__ refs,
                          const int32_t* __restrict__ blens,
                          const uint8_t* __restrict__ reads,
                          const int32_t* __restrict__ rlens,
                          int32_t* __restrict__ score,
                          int32_t* __restrict__ bk_out,
                          int32_t* __restrict__ bi_out,
                          uint8_t* __restrict__ tie_out, int B, int N,
                          int M, int n_rows) {
  const int g = threadIdx.x % G;
  const long lane = ((long)blockIdx.x * SW_GROUP_THREADS + threadIdx.x) / G;
  const bool live = lane < B;
  const int j0 = g * C;  // this thread's first column

  const int rlen = live ? rlens[lane] : 0;
  const int blen = live ? blens[lane] : 0;
  int rows = n_rows < blen ? n_rows : blen;  // active rows 1..rows
  if (rows < 0) rows = 0;
  const bool in_range = live && rlen >= 0 && rlen <= M;
  const bool own = in_range && rlen / C == g;  // owns column rlen
  const int c_own = rlen - j0;

  int S0[C], S1[C], S2[C], rd[C];
  sw_group_init<Match>(S0, S1, S2, rd, reads + lane * M, live, j0, M);
  int best = rlen == 0 ? 0 : -(SW_OPEN + (rlen - 1) * SW_EXT);
  int bk = 0, bi = 0, n_at = 1;

  const int max_rows = __reduce_max_sync(SW_FULL, in_range ? rows : 0);
  for (int i0 = 0; i0 < max_rows; i0 += G) {
    const int ri = i0 + g;
    const int chunk =
        (live && ri < N) ? Match::ref(refs[lane * N + ri]) : 0;
    const int k_end = max_rows - i0 < G ? max_rows - i0 : G;
    for (int k = 0; k < k_end; ++k) {
      const int i = i0 + k + 1;
      const int rb = __shfl_sync(SW_FULL, chunk, k, G);
      int c0[C], c1[C], c2[C];
      sw_group_row<Match, G, C>(SW_FULL, S0, S1, S2, rd, rb, g, j0, c0, c1,
                                c2);
#pragma unroll
      for (int c = 0; c < C; ++c) {
        S0[c] = c0[c];
        S1[c] = c1[c];
        S2[c] = c2[c];
      }

      if (own && i <= rows) {
        int v[3] = {0, 0, 0};
#pragma unroll
        for (int c = 0; c < C; ++c) {
          if (c == c_own) {
            v[0] = S0[c];
            v[1] = S1[c];
            v[2] = S2[c];
          }
        }
#pragma unroll
        for (int kk = 0; kk < 3; ++kk) {
          if (v[kk] > best) {
            best = v[kk];
            bk = kk;
            bi = i;
            n_at = 1;
          } else if (TIE && v[kk] == best) {
            ++n_at;
          }
        }
      }
    }
  }

  if (own) {
    score[lane] = best;
    bk_out[lane] = bk;
    bi_out[lane] = bi;
    if (TIE) tie_out[lane] = n_at >= 2;
  } else if (live && !in_range && g == 0) {
    // no column equals rlen: every candidate is NEG, none is `>`, and
    // each active row adds three equal cells to the count
    score[lane] = SW_NEG;
    bk_out[lane] = 0;
    bi_out[lane] = 0;
    if (TIE) tie_out[lane] = (1 + 3 * rows) >= 2;
  }
}

struct SwGroupAlignArgs {
  const uint8_t* refs;
  const int32_t* blens;
  const uint8_t* reads;
  const int32_t* rlens;
  int32_t* score;
  int32_t* bk;
  int32_t* bi;
  uint8_t* tie;  // K1's tie flags; unused without TIE
  int B, N, M, n_rows;
  cudaStream_t s;
};

template <template <bool> class Match, bool TIE, bool BIS>
struct SwGroupAlignRun {
  const SwGroupAlignArgs& a;
  template <int G, int C>
  int operator()() const {
    const long threads = (long)a.B * G;
    const int grid =
        (int)((threads + SW_GROUP_THREADS - 1) / SW_GROUP_THREADS);
    sw_group_align_kernel<Match<BIS>, TIE, G, C>
        <<<grid, SW_GROUP_THREADS, 0, a.s>>>(a.refs, a.blens, a.reads,
                                             a.rlens, a.score, a.bk, a.bi,
                                             a.tie, a.B, a.N, a.M,
                                             a.n_rows);
    return (int)cudaGetLastError();
  }
};

// `group`: threads per lane, 0 = sw_lane_group(M), the main path's
// choice; 8, 16 or 32 force it (tests, and timing each group size).
template <template <bool> class Match, bool TIE>
static int sw_group_align_launch(const SwGroupAlignArgs& a, int bisulfite,
                                 int group) {
  if (a.B <= 0) return 0;
  const int G = group ? group : sw_group_for(a.M);
  const int C = sw_group_cols(a.M, G);
  if (C == 0) return (int)cudaErrorInvalidValue;
  return bisulfite
             ? sw_group_launch(G, C, SwGroupAlignRun<Match, TIE, true>{a})
             : sw_group_launch(G, C, SwGroupAlignRun<Match, TIE, false>{a});
}
#endif
