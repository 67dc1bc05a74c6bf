// K3: batched glocal affine Smith-Waterman on raw reference and read
// bytes, best cell of the last read column (the v1 engine's scorer).
//
// Replaces the TPU kernel pecaller_tpu/ops/sw_pallas.py sw_align_pallas
// (_sw_kernel).  Same contract as the plain version
// pecaller_tpu_torch/ops/sw.py sw_align_device, bit for bit: (score,
// plane k, row i) of the first strict-`>` argmax over (row, plane 0, 1,
// 2) in column rlen, no tie flag.  The match rule is on bytes: equal
// bytes match, `N`/`n` on either side matches anything, and with
// bisulfite reference `C`/`c` also matches read `T`/`t`; every other
// byte (IUPAC letters, other lowercase) compares by equality.
//
// What bounds it on an H100: integer operations.  A v1 batch end is
// 16384 lanes x 160 x 112, ~1.6e8 DP cells of ~12 issued integer
// instructions (chip_smoke.py OPS_PER_CELL); the inputs are ~4.5 MB and
// the outputs 0.2 MB, so device memory is not the limit.
//
// Design: K1's kernel, sw_group_align_kernel of sw_group.cuh, under
// the byte rule of SwByteMatch and without the tie count: a group of G
// threads owns one lane, the DP row in registers (thread g owns C
// consecutive columns), no shared memory; the group loads G reference
// bytes at once, turns each into its row value (SwByteMatch::ref) and
// shuffles out one a row; the owner of column rlen keeps best / k / i.
// The byte rule costs about what K1's xcode rule costs: the read side's
// flags are folded into each column's register at load time and the
// reference side's into the row value once per row, so a cell's test
// issues three instructions (two LOP3 and a PLOP3), one more than K1's.
#include <cuda_runtime.h>

#include "sw_group.cuh"

__device__ __forceinline__ bool is_wild(int b) { return b == 'N' || b == 'n'; }

// The byte rule.  A read byte's column register holds the byte in bits
// 0-7 and three flags: bit 8 a wildcard (N/n), bit 9 a bisulfite T/t,
// bit 10 always.  A reference byte's row value holds the byte and the
// flags it matches: bit 8 always (a read wildcard matches every
// reference byte), bit 9 for a bisulfite C/c, bit 10 for a wildcard (it
// matches every column).  A cell matches when the bytes are equal or
// the two share a flag.
template <bool BIS>
struct SwByteMatch {
  static __device__ __forceinline__ int code(int b) {
    return b | 0x400 | (is_wild(b) ? 0x100 : 0) |
           ((BIS && (b == 'T' || b == 't')) ? 0x200 : 0);
  }
  static __device__ __forceinline__ int ref(int b) {
    return b | 0x100 | ((BIS && (b == 'C' || b == 'c')) ? 0x200 : 0) |
           (is_wild(b) ? 0x400 : 0);
  }
  static __device__ __forceinline__ int bump(int r, int q) {
    const bool m = (((r ^ q) & 0xFF) == 0) | ((r & q & 0x700) != 0);
    return m ? SW_MATCH : SW_MISMATCH;
  }
};

// `group`: threads per lane, 0 = sw_lane_group(M), the main path's
// choice; 8, 16 or 32 force it (tests, and timing each group size).
extern "C" int sw_align_launch(const uint8_t* refs, const int32_t* blens,
                               const uint8_t* reads, const int32_t* rlens,
                               int32_t* score, int32_t* bk, int32_t* bi,
                               int B, int N, int M, int n_rows,
                               int bisulfite, int group, void* stream) {
  const SwGroupAlignArgs a{refs, blens, reads, rlens, score, bk, bi,
                           nullptr, B, N, M, n_rows,
                           static_cast<cudaStream_t>(stream)};
  return sw_group_align_launch<SwByteMatch, false>(a, bisulfite, group);
}
