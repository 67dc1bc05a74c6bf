// C interface of the Smith-Waterman kernels K1, K2 and K3
// (sw_align_x.cu, sw_tb_rows.cu, sw_align.cu; their shared thread-group
// row in sw_group.cuh), loaded from Python with ctypes (ops/sw_cuda.py).
//
// Every pointer is a device pointer of a contiguous tensor in the
// (lanes, .) layout of ops/sw2.py; `stream` is a cudaStream_t.  The
// kernels allocate nothing and do not synchronise.  Each launcher
// returns cudaGetLastError() after the launch (0 = launched).
#pragma once

#include <stdint.h>

#define SW_MATCH 36
#define SW_MISMATCH (-12)
#define SW_OPEN 72
#define SW_EXT 1
#define SW_NEG (-(1 << 30))
#define SW_XN 4
#define SW_EV_DEL 4
#define SW_EV_NONE 5

#ifdef __cplusplus
extern "C" {
#endif

// The instance table of K1, K2 and K3 (sw_group.cuh): a launch with
// `group` threads per lane (8, 16 or 32; 0 = sw_lane_group(M), the main
// path's choice) gives each thread sw_lane_cols(M, group) columns (0: no
// instance takes width M).
int sw_lane_group(int M);
int sw_lane_cols(int M, int group);

// K1.
int sw_align_x_launch(const uint8_t* refs, const int32_t* blens,
                      const uint8_t* reads, const int32_t* rlens,
                      int32_t* score, int32_t* bk, int32_t* bi,
                      uint8_t* tie, int B, int N, int M, int n_rows,
                      int bisulfite, int group, void* stream);

// K2: cube: (B, n_rows, sw_tb_rows_row_bytes(M, group)) uint8 scratch
// for the decision bytes, 16-byte aligned; row i of a lane is G slots,
// thread g's slot holding the bytes of its C columns (0 where no
// instance takes width M).
int sw_tb_rows_row_bytes(int M, int group);
int sw_tb_rows_launch(const uint8_t* refs, const int32_t* blens,
                      const uint8_t* reads, const int32_t* rlens,
                      const int32_t* bt_k, const int32_t* bt_i,
                      uint8_t* cube, int8_t* ev_kind, int32_t* ins_j,
                      int32_t* ins_len, uint8_t* tie, int B, int N, int M,
                      int n_rows, int bisulfite, int group, void* stream);

// K3, on raw bytes (refs, reads).
int sw_align_launch(const uint8_t* refs, const int32_t* blens,
                    const uint8_t* reads, const int32_t* rlens,
                    int32_t* score, int32_t* bk, int32_t* bi, int B, int N,
                    int M, int n_rows, int bisulfite, int group,
                    void* stream);

#ifdef __cplusplus
}
#endif

#ifdef __CUDACC__
// Reference bonus-matrix semantics on xcodes: equal bases match, N
// matches everything, bisulfite adds ref C ~ read T.
template <bool BIS>
__device__ __forceinline__ int sw_bump(int ref_x, int read_x) {
  bool m = (ref_x == read_x) | (ref_x == SW_XN) | (read_x == SW_XN);
  if (BIS) m = m | ((ref_x == 1) & (read_x == 3));
  return m ? SW_MATCH : SW_MISMATCH;
}
#endif
