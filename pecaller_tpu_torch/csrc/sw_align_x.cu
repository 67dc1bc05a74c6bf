// K1: batched glocal affine Smith-Waterman on xcodes, best cell of the
// last read column.
//
// Replaces the TPU kernel pecaller_tpu/ops/sw_pallas2.py
// sw_align_x_pallas (_align_kernel).  Same contract as the plain
// version pecaller_tpu_torch/ops/sw2.py sw_align_x, bit for bit:
// (score, plane k, row i) of the first strict-`>` argmax over (row,
// plane 0, 1, 2) in column rlen, and a tie flag counting cells that
// attain the final best (the count resets on every strict improvement).
//
// What bounds it on an H100: integer operations, once the card is full.
// A main-path batch is 24576 lanes x 125 rows x 113 columns, ~3.5e8 DP
// cells of ~20 integer operations; the inputs are ~6 MB and the outputs
// 0.4 MB, so device memory is not the limit.
//
// Design.  A group of G threads owns one lane; thread g of the group
// owns the C = ceil((M + 1) / G) consecutive columns [g*C, g*C + C).
// Its columns of the three DP planes and its read codes live in
// registers, so nothing goes through shared memory and occupancy is set
// by registers alone (a one-thread-per-lane design with the row in
// shared memory needed (M + 1) x 13 bytes a lane: 94 KB for a block of
// 64 lanes at M = 112, two blocks an SM, one warp per scheduler, and a
// dependent chain of shared-memory loads per cell).  A main-path batch
// puts 24576 x G threads in flight instead of 24576.  One row:
//   1. the group's threads load G reference bytes at once, coalesced,
//      and shuffle out one per row;
//   2. c0 (diagonal) and c1 (deletion) need the old row at their column
//      and the one to its left: the only value from outside a thread is
//      max(o0, o1, o2) of the left neighbour's last column (shfl_up);
//   3. the insertion plane c2[j] = max_{j' <= j} a[j'] - j, with
//      a[0] = -OPEN and a[j] = c0[j-1] - OPEN + j, is an inclusive
//      max-scan: a running max over the thread's own columns (its first
//      a takes the neighbour's last new c0, one more shfl_up), then an
//      exclusive max-scan of the segment maxima over the group in
//      log2(G) shuffle steps with identity SW_NEG (never offset, so it
//      cannot wrap), then one max per column;
//   4. the thread that owns column rlen updates best / k / i / tie.
// Every DP dependency points left, so columns past rlen never feed
// column rlen; their threads compute them only to stay in the shuffles.
// Lanes of one warp may stop at different rows (blen, and several lanes
// share a warp when G < 32): the warp loops to its longest lane and an
// inactive row updates nothing.  Tail lanes past B stay in the shuffles
// and write nothing; no thread leaves before the last shuffle.
// Hopper's DPX instructions take max3 (__vimax3_s32) and max(a + b, c)
// (__viaddmax_s32) in one instruction each (VIMNMX3, VIADDMNMX in SASS).
// G is picked from the width: 8 up to 128 columns, 16 up to 256, 32 up
// to 576; fewer threads a lane means fewer shuffles a column, and at the
// main-path width G = 8 was the fastest of the three (PERF.md).
#include <cuda_runtime.h>

#include "sw_kernels.h"

#define SW_X_THREADS 256
#define SW_X_FULL 0xffffffffu

// One block an SM at least, so ptxas may take up to 255 registers: with
// its default budget the 12-column instances spill.
template <bool BIS, int G, int C>
__global__ void __launch_bounds__(SW_X_THREADS, 1)
    sw_align_x_kernel(const uint8_t* __restrict__ refs,
                      const int32_t* __restrict__ blens,
                      const uint8_t* __restrict__ reads,
                      const int32_t* __restrict__ rlens,
                      int32_t* __restrict__ score,
                      int32_t* __restrict__ bk_out,
                      int32_t* __restrict__ bi_out,
                      uint8_t* __restrict__ tie_out, int B, int N, int M,
                      int n_rows) {
  const int g = threadIdx.x % G;
  const long lane = ((long)blockIdx.x * SW_X_THREADS + threadIdx.x) / G;
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
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int j = j0 + c;
    const int b = j == 0 ? 0 : -(SW_OPEN + (j - 1) * SW_EXT);
    S0[c] = b;
    S1[c] = b;
    S2[c] = j == 0 ? -SW_OPEN : b;
    // column j scores read position j - 1
    rd[c] = (live && j >= 1 && j <= M) ? reads[lane * M + j - 1] : 0;
  }
  int best = rlen == 0 ? 0 : -(SW_OPEN + (rlen - 1) * SW_EXT);
  int bk = 0, bi = 0, n_at = 1;

  const int max_rows = __reduce_max_sync(SW_X_FULL, in_range ? rows : 0);
  for (int i0 = 0; i0 < max_rows; i0 += G) {
    const int ri = i0 + g;
    const int chunk = (live && ri < N) ? refs[lane * N + ri] : 0;
    const int k_end = max_rows - i0 < G ? max_rows - i0 : G;
    for (int k = 0; k < k_end; ++k) {
      const int i = i0 + k + 1;
      const int rb = __shfl_sync(SW_X_FULL, chunk, k, G);

      // c0, c1 from the old row; column j0 - 1 from the left neighbour
      const int p3_left = __shfl_up_sync(
          SW_X_FULL, __vimax3_s32(S0[C - 1], S1[C - 1], S2[C - 1]), 1, G);
      int c0[C], c1[C];
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
      const int c0_left = __shfl_up_sync(SW_X_FULL, c0[C - 1], 1, G);
      int run[C];
      run[0] = g == 0 ? -SW_OPEN : c0_left - SW_OPEN + j0;
#pragma unroll
      for (int c = 1; c < C; ++c)
        run[c] = __viaddmax_s32(c0[c - 1], j0 + c - SW_OPEN, run[c - 1]);
      int x = run[C - 1];
#pragma unroll
      for (int d = 1; d < G; d <<= 1) {
        const int t = __shfl_up_sync(SW_X_FULL, x, d, G);
        if (g >= d) x = max(x, t);
      }
      int ex = __shfl_up_sync(SW_X_FULL, x, 1, G);
      if (g == 0) ex = SW_NEG;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        S0[c] = c0[c];
        S1[c] = c1[c];
        S2[c] = max(ex, run[c]) - (j0 + c);
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
          } else if (v[kk] == best) {
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
    tie_out[lane] = n_at >= 2;
  } else if (live && !in_range && g == 0) {
    // no column equals rlen: every candidate is NEG, each active row
    // adds three equal cells to the count
    score[lane] = SW_NEG;
    bk_out[lane] = 0;
    bi_out[lane] = 0;
    tie_out[lane] = (1 + 3 * rows) >= 2;
  }
}

struct SwXArgs {
  const uint8_t* refs;
  const int32_t* blens;
  const uint8_t* reads;
  const int32_t* rlens;
  int32_t* score;
  int32_t* bk;
  int32_t* bi;
  uint8_t* tie;
  int B, N, M, n_rows;
  cudaStream_t s;
};

template <bool BIS, int G, int C>
static int sw_x_run(const SwXArgs& a) {
  const long threads = (long)a.B * G;
  const int grid = (int)((threads + SW_X_THREADS - 1) / SW_X_THREADS);
  sw_align_x_kernel<BIS, G, C><<<grid, SW_X_THREADS, 0, a.s>>>(
      a.refs, a.blens, a.reads, a.rlens, a.score, a.bk, a.bi, a.tie, a.B,
      a.N, a.M, a.n_rows);
  return (int)cudaGetLastError();
}

// The instantiated C of each G, smallest first (0 ends a row): a launch
// takes the smallest C with G x C >= M + 1, so the widest read is
// 32 x 18 - 1 = 575 (the one-thread-per-lane design took 557).  Each C
// serves the widths sw_align_x_group gives its G, but for two
// diagnostic instances: 16 x 8 and 32 x 4 serve no width the launch
// picks by itself; they let chip_smoke.py time the three group sizes
// at the main-path width (M = 112) with an explicit `group`.
constexpr int kSwXCols[3][7] = {{8, 15, 16, 0},
                                {8, 12, 16, 0},
                                {4, 10, 12, 14, 16, 18, 0}};

constexpr int sw_x_row(int G) { return G == 8 ? 0 : (G == 16 ? 1 : 2); }

template <bool BIS, int G, int I>
static int sw_x_dispatch(const SwXArgs& a, int C) {
  constexpr int CC = kSwXCols[sw_x_row(G)][I];
  if constexpr (CC == 0) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (C == CC) return sw_x_run<BIS, G, CC>(a);
    return sw_x_dispatch<BIS, G, I + 1>(a, C);
  }
}

static bool sw_x_group_ok(int G) { return G == 8 || G == 16 || G == 32; }

extern "C" int sw_align_x_group(int M) {
  return M + 1 <= 8 * 16 ? 8 : (M + 1 <= 16 * 16 ? 16 : 32);
}

// Columns per thread a launch with `group` threads per lane (0 = by
// width) takes for reads of width M; 0 where no instance fits.
extern "C" int sw_align_x_cols(int M, int group) {
  const int G = group ? group : sw_align_x_group(M);
  if (!sw_x_group_ok(G) || M < 0) return 0;
  for (const int C : kSwXCols[sw_x_row(G)])
    if (C && G * C >= M + 1) return C;
  return 0;
}

// `group`: threads per lane, 0 = sw_align_x_group(M), the main path's
// choice; 8, 16 or 32 force it (tests, and timing each group size).
extern "C" int sw_align_x_launch(
    const uint8_t* refs, const int32_t* blens, const uint8_t* reads,
    const int32_t* rlens, int32_t* score, int32_t* bk, int32_t* bi,
    uint8_t* tie, int B, int N, int M, int n_rows, int bisulfite,
    int group, void* stream) {
  if (B <= 0) return 0;
  const int G = group ? group : sw_align_x_group(M);
  const int C = sw_align_x_cols(M, G);
  if (C == 0) return (int)cudaErrorInvalidValue;
  const SwXArgs a{refs, blens, reads, rlens, score, bk, bi, tie, B, N, M,
                  n_rows, static_cast<cudaStream_t>(stream)};
  switch (G * 2 + (bisulfite ? 1 : 0)) {
    case 16: return sw_x_dispatch<false, 8, 0>(a, C);
    case 17: return sw_x_dispatch<true, 8, 0>(a, C);
    case 32: return sw_x_dispatch<false, 16, 0>(a, C);
    case 33: return sw_x_dispatch<true, 16, 0>(a, C);
    case 64: return sw_x_dispatch<false, 32, 0>(a, C);
    default: return sw_x_dispatch<true, 32, 0>(a, C);
  }
}
