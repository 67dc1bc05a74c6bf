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
// Design.  A group of G threads owns one lane: the DP row of
// sw_group.cuh, thread g owning C consecutive columns in registers, so
// nothing goes through shared memory and occupancy is set by registers
// alone (a one-thread-per-lane design with the row in shared memory
// needed (M + 1) x 13 bytes a lane: 94 KB for a block of 64 lanes at
// M = 112, two blocks an SM, one warp per scheduler, and a dependent
// chain of shared-memory loads per cell).  A main-path batch puts
// 24576 x G threads in flight instead of 24576.  One row:
//   1. the group's threads load G reference bytes at once, coalesced,
//      and shuffle out one per row;
//   2. sw_group_row computes the new row (two shfl_up and a log2(G)
//      shuffle scan);
//   3. the thread that owns column rlen updates best / k / i / tie.
// Lanes of one warp may stop at different rows (blen, and several lanes
// share a warp when G < 32): the warp loops to its longest lane and an
// inactive row updates nothing.  Tail lanes past B stay in the shuffles
// and write nothing; no thread leaves before the last shuffle.
// G is picked from the width (sw_group_for); at the main-path width
// G = 8 was the fastest of the three (PERF.md).
#include <cuda_runtime.h>

#include "sw_group.cuh"

#define SW_X_THREADS 256

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
  sw_group_init(S0, S1, S2, rd, reads + lane * M, live, j0, M);
  int best = rlen == 0 ? 0 : -(SW_OPEN + (rlen - 1) * SW_EXT);
  int bk = 0, bi = 0, n_at = 1;

  const int max_rows = __reduce_max_sync(SW_FULL, in_range ? rows : 0);
  for (int i0 = 0; i0 < max_rows; i0 += G) {
    const int ri = i0 + g;
    const int chunk = (live && ri < N) ? refs[lane * N + ri] : 0;
    const int k_end = max_rows - i0 < G ? max_rows - i0 : G;
    for (int k = 0; k < k_end; ++k) {
      const int i = i0 + k + 1;
      const int rb = __shfl_sync(SW_FULL, chunk, k, G);
      int c0[C], c1[C], c2[C];
      sw_group_row<BIS, G, C>(SW_FULL, S0, S1, S2, rd, rb, g, j0, c0, c1,
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

template <bool BIS>
struct SwXRun {
  const SwXArgs& a;
  template <int G, int C>
  int operator()() const {
    return sw_x_run<BIS, G, C>(a);
  }
};

// The instance table of sw_group.cuh, which K2 shares.
extern "C" int sw_lane_group(int M) { return sw_group_for(M); }

extern "C" int sw_lane_cols(int M, int group) {
  return sw_group_cols(M, group);
}

// `group`: threads per lane, 0 = sw_lane_group(M), the main path's
// choice; 8, 16 or 32 force it (tests, and timing each group size).
extern "C" int sw_align_x_launch(
    const uint8_t* refs, const int32_t* blens, const uint8_t* reads,
    const int32_t* rlens, int32_t* score, int32_t* bk, int32_t* bi,
    uint8_t* tie, int B, int N, int M, int n_rows, int bisulfite,
    int group, void* stream) {
  if (B <= 0) return 0;
  const int G = group ? group : sw_group_for(M);
  const int C = sw_group_cols(M, G);
  if (C == 0) return (int)cudaErrorInvalidValue;
  const SwXArgs a{refs, blens, reads, rlens, score, bk, bi, tie, B, N, M,
                  n_rows, static_cast<cudaStream_t>(stream)};
  return bisulfite ? sw_group_launch(G, C, SwXRun<true>{a})
                   : sw_group_launch(G, C, SwXRun<false>{a});
}
