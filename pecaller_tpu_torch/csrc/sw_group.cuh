// The thread-group DP row shared by K1 (sw_align_x.cu) and K2
// (sw_tb_rows.cu).
//
// A group of G threads owns one lane; thread g of the group owns the
// C = sw_group_cols(M, G) consecutive columns [g*C, g*C + C).  Its
// columns of the three DP planes and its read codes live in registers.
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
// Row 0 of the three planes and the read codes of the thread's columns
// (column j scores read position j - 1).
template <int C>
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
    rd[c] = (live && j >= 1 && j <= M) ? read[j - 1] : 0;
  }
}

// The new row (c0, c1, c2) from the old one (S0, S1, S2) against
// reference code rb.  Every thread of `mask` (whole groups of the warp)
// calls it.
template <bool BIS, int G, int C>
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
    c0[c] = p3 + sw_bump<BIS>(rb, rd[c]);
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
#endif
