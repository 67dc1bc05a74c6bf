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
// cells of ~11 issued integer instructions (chip_smoke.py OPS_PER_CELL);
// the inputs are ~6 MB and the outputs 0.4 MB, so device memory is not
// the limit.
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
// The kernel is sw_group_align_kernel of sw_group.cuh, which K3 shares,
// with the xcode rule (SwXMatch) and the tie count.
// G is picked from the width (sw_group_for); at the main-path width
// G = 8 was the fastest of the three (PERF.md).
#include <cuda_runtime.h>

#include "sw_group.cuh"

// The instance table of sw_group.cuh, which K2 and K3 share.
extern "C" int sw_lane_group(int M) { return sw_group_for(M); }

extern "C" int sw_lane_cols(int M, int group) {
  return sw_group_cols(M, group);
}

extern "C" int sw_align_x_launch(
    const uint8_t* refs, const int32_t* blens, const uint8_t* reads,
    const int32_t* rlens, int32_t* score, int32_t* bk, int32_t* bi,
    uint8_t* tie, int B, int N, int M, int n_rows, int bisulfite,
    int group, void* stream) {
  const SwGroupAlignArgs a{refs, blens, reads, rlens, score, bk, bi, tie,
                           B, N, M, n_rows,
                           static_cast<cudaStream_t>(stream)};
  return sw_group_align_launch<SwXMatch, true>(a, bisulfite, group);
}
