// K2: row-synchronous Smith-Waterman traceback on xcodes.
//
// Replaces the TPU kernel pecaller_tpu/ops/sw_pallas2.py
// sw_tb_rows_pallas (_tb_kernel).  Same contract as the plain version
// pecaller_tpu_torch/ops/sw2.py sw_traceback_rows, bit for bit:
// row-indexed events (base code, EV_DEL or EV_NONE), insertion runs
// attached at the row of their closing step (column 0 when the walk
// dies inside a run), and a walk-tie flag.
//
// Phase 1 replays the DP of K1 and stores 7 decision bits per cell:
// a0 (2 bits), b1, b2 and the tie bits t0, t1, t2.  Phase 2 walks from
// (bt_i, rlen, bt_k), consuming one reference row per step.
//
// What bounds it on an H100: the decision cube.  It is
// (rows) x (M + 1) bytes per lane, ~14 KB for 100 bp reads and ~230 MB
// for the 16384 lanes of a main-path batch, far past shared memory (the
// TPU kept it in VMEM).  Here it lives in a global scratch tensor that
// the wrapper allocates, laid out [row][column][lane] so the threads of
// a warp, one lane each, write 32 consecutive bytes per cell in phase
// 1.  Phase 2 reads back only the cells on the path, ~2 per row, with
// scattered addresses that mostly hit L2.  The replay stops at row
// bt_i, past which the walk reads nothing.  As in K1, one thread owns
// one lane and keeps its previous DP row and read in shared memory,
// column-major over the block's threads.  An insertion run inside a
// row is resolved by scanning the b2 bits leftwards from the current
// column (the TPU version took a prefix maximum over the whole row).
#include <cuda_runtime.h>

#include "sw_kernels.h"

struct Parts {
  int a0, b1, b2, t0, t1, t2;
};

__device__ __forceinline__ Parts sw_parts(int c0, int c1, int c2) {
  Parts p;
  const int m = max(c0, c1);
  p.a0 = c2 > m ? 2 : (c1 > c0 ? 1 : 0);
  p.b1 = (c1 - SW_EXT) > (c0 - SW_OPEN);
  p.b2 = (c2 - SW_EXT) > (c0 - SW_OPEN);
  p.t0 = (c1 == c0) | (c2 == m);
  p.t1 = (c1 - SW_EXT) == (c0 - SW_OPEN);
  p.t2 = (c2 - SW_EXT) == (c0 - SW_OPEN);
  return p;
}

template <bool BIS>
__global__ void sw_tb_rows_kernel(
    const uint8_t* __restrict__ refs, const int32_t* __restrict__ blens,
    const uint8_t* __restrict__ reads, const int32_t* __restrict__ rlens,
    const int32_t* __restrict__ bt_k, const int32_t* __restrict__ bt_i,
    uint8_t* __restrict__ cube, int8_t* __restrict__ ev_kind,
    int32_t* __restrict__ ins_j, int32_t* __restrict__ ins_len,
    uint8_t* __restrict__ tie_out, int B, int N, int M, int n_rows) {
  extern __shared__ int32_t smem[];
  const int T = blockDim.x;
  const int t = threadIdx.x;
  const long lane = (long)blockIdx.x * T + t;
  if (lane >= B) return;  // no block-wide barrier below
  const int W = M + 1;
  int32_t* S0 = smem;
  int32_t* S1 = smem + W * T;
  int32_t* S2 = smem + 2 * W * T;
  uint8_t* RD = reinterpret_cast<uint8_t*>(smem + 3 * W * T);

  int8_t* ev_l = ev_kind + lane * (long)n_rows;
  int32_t* ij_l = ins_j + lane * (long)n_rows;
  int32_t* il_l = ins_len + lane * (long)n_rows;
  for (int r = 0; r < n_rows; ++r) {
    ev_l[r] = SW_EV_NONE;
    ij_l[r] = -1;
    il_l[r] = 0;
  }
  const int rlen = rlens[lane];
  const int blen = blens[lane];
  const int bi0 = bt_i[lane];
  bool alive = (bi0 > 0) & (rlen > 0);
  bool tie = false;
  if (!alive) {
    tie_out[lane] = 0;
    return;
  }
  const int rmax = bi0 < n_rows ? bi0 : n_rows;  // rows the walk visits
  const long cs = (long)W * B;                    // cube row stride
#define CUBE(i, j) cube[((long)((i) - 1)) * cs + (long)(j) * B + lane]

  // ---- phase 1: replay the DP, store the decision bits of rows 1..rmax
  for (int j = 0; j < W; ++j) {
    const int b = j == 0 ? 0 : -(SW_OPEN + (j - 1) * SW_EXT);
    S0[j * T + t] = b;
    S1[j * T + t] = b;
    S2[j * T + t] = j == 0 ? -SW_OPEN : b;
  }
  const uint8_t* rd_g = reads + lane * (long)M;
  for (int j = 0; j < M; ++j) RD[j * T + t] = rd_g[j];
  const uint8_t* ref_g = refs + lane * (long)N;

  for (int i = 1; i <= rmax; ++i) {
    const bool active = i <= blen;
    const int rb = ref_g[i - 1];
    // column 0
    int o0 = S0[t], o1 = S1[t], o2 = S2[t];  // old row, column j-1
    int n0 = o0, n1 = o1, n2 = o2;           // new row, column j-1
    if (active) {
      n0 = 0;
      n1 = 0;
      n2 = -SW_OPEN;
      S0[t] = 0;
      S1[t] = 0;
      S2[t] = -SW_OPEN;
    }
    {
      const Parts po = sw_parts(o0, o1, o2);
      CUBE(i, 0) = (uint8_t)((po.b1 << 2) | (po.t1 << 5));
    }
    int z = -SW_OPEN;
    for (int j = 1; j < W; ++j) {
      const int q0 = S0[j * T + t];
      const int q1 = S1[j * T + t];
      const int q2 = S2[j * T + t];
      int m0 = q0, m1 = q1, m2 = q2;
      if (active) {
        m0 = max(max(o0, o1), o2) + sw_bump<BIS>(rb, RD[(j - 1) * T + t]);
        m1 = max(q0 - SW_OPEN, q1 - SW_EXT);
        z = max(z, n0 - SW_OPEN + j);
        m2 = z - j;
        S0[j * T + t] = m0;
        S1[j * T + t] = m1;
        S2[j * T + t] = m2;
      }
      const Parts pp = sw_parts(o0, o1, o2);  // (i-1, j-1)
      const Parts po = sw_parts(q0, q1, q2);  // (i-1, j)
      const Parts pn = sw_parts(n0, n1, n2);  // (i, j-1)
      CUBE(i, j) = (uint8_t)(pp.a0 | (po.b1 << 2) | (pn.b2 << 3) |
                             (pp.t0 << 4) | (po.t1 << 5) | (pn.t2 << 6));
      o0 = q0;
      o1 = q1;
      o2 = q2;
      n0 = m0;
      n1 = m1;
      n2 = m2;
    }
  }

  // ---- phase 2: row-synchronous walk -------------------------------
  int jj = rlen;
  int kk = bt_k[lane];
  for (int i = rmax; i >= 1 && alive; --i) {
    const bool is2 = kk == 2;
    const bool is1 = kk == 1;
    // insertion run: columns jj..jc, jc = last column <= jj whose b2
    // bit is 0 (column 0 always is); -1 when jj is off the row
    int jc = -1;
    bool tie_run = false;
    if (is2 && jj >= 0 && jj < W) {
      int c = jj;
      while (c >= 0 && ((CUBE(i, c) >> 3) & 1)) --c;
      jc = c;
      const int lo = jc > 1 ? jc : 1;
      for (int c2 = jj; c2 >= lo; --c2)
        if ((CUBE(i, c2) >> 6) & 1) {
          tie_run = true;
          break;
        }
    }
    const bool run_dead = is2 && jc <= 1;
    const int run_len = is2 ? (run_dead ? jj : jj - jc + 1) : 0;
    const int cstep = is2 ? jc - 1 : jj;
    const int cc = cstep < 0 ? 0 : (cstep > W - 1 ? W - 1 : cstep);
    const int bits = CUBE(i, cc);
    const int a0_c = bits & 3;
    const int b1_c = (bits >> 2) & 1;
    const bool consume = !run_dead;
    const bool diag = consume && !is1;
    int kcol = cc - 1;
    kcol = kcol < 0 ? 0 : (kcol > M ? M : kcol);
    int kind = SW_EV_NONE;
    if (kcol < M) {
      const int rx = rd_g[kcol];
      kind = rx == SW_XN ? SW_EV_NONE : (int)(int8_t)rx;
    }
    if (consume) ev_l[i - 1] = (int8_t)(diag ? kind : SW_EV_DEL);
    if ((diag && run_len > 0) || run_dead) {
      ij_l[i - 1] = run_dead ? 0 : cstep;
      il_l[i - 1] = run_len;
    }
    const int nk = is1 ? (b1_c == 1 ? 1 : 0) : a0_c;
    const int nj = is1 ? jj : cstep - 1;
    const bool nalive = consume && nj > 0 && i - 1 > 0;
    tie = tie || (diag && ((bits >> 4) & 1) && nalive) ||
          (is1 && ((bits >> 5) & 1) && nalive) || (is2 && tie_run);
    jj = nj;
    kk = nk;
    alive = nalive;
  }
#undef CUBE
  tie_out[lane] = tie;
}

extern "C" int sw_smem_bytes(int M, int threads) {
  const int W = M + 1;
  return W * threads * (3 * (int)sizeof(int32_t) + 1);
}

// Threads per block: 64 lanes while their DP rows fit in shared memory.
static inline int sw_threads_for(int M) {
  return sw_smem_bytes(M, 64) <= 200 * 1024 ? 64 : 32;
}

extern "C" int sw_tb_rows_launch(const uint8_t* refs, const int32_t* blens,
                                 const uint8_t* reads, const int32_t* rlens,
                                 const int32_t* bt_k, const int32_t* bt_i,
                                 uint8_t* cube, int8_t* ev_kind,
                                 int32_t* ins_j, int32_t* ins_len,
                                 uint8_t* tie, int B, int N, int M,
                                 int n_rows, int bisulfite, void* stream) {
  if (B <= 0) return 0;
  const int T = sw_threads_for(M);
  const int smem = sw_smem_bytes(M, T);
  const int grid = (B + T - 1) / T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bisulfite) {
    e = cudaFuncSetAttribute(sw_tb_rows_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    sw_tb_rows_kernel<true><<<grid, T, smem, s>>>(
        refs, blens, reads, rlens, bt_k, bt_i, cube, ev_kind, ins_j,
        ins_len, tie, B, N, M, n_rows);
  } else {
    e = cudaFuncSetAttribute(sw_tb_rows_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    sw_tb_rows_kernel<false><<<grid, T, smem, s>>>(
        refs, blens, reads, rlens, bt_k, bt_i, cube, ev_kind, ins_j,
        ins_len, tie, B, N, M, n_rows);
  }
  return (int)cudaGetLastError();
}
