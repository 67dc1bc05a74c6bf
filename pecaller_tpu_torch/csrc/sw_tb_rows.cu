// K2: row-synchronous Smith-Waterman traceback on xcodes.
//
// Replaces the TPU kernel pecaller_tpu/ops/sw_pallas2.py
// sw_tb_rows_pallas (_tb_kernel).  Same contract as the plain version
// pecaller_tpu_torch/ops/sw2.py sw_traceback_rows, bit for bit:
// row-indexed events (base code, EV_DEL or EV_NONE), insertion runs
// attached at the row of their closing step (column 0 when the walk
// dies inside a run), and a walk-tie flag.
//
// Phase 1 replays the DP of K1 and stores 7 decision bits per cell, the
// byte of ops/sw2.py decision_rows: a0 (2 bits), b1, b2 and the tie bits
// t0, t1, t2.  Phase 2 walks from (bt_i, rlen, bt_k), consuming one
// reference row per step.
//
// What bounds it on an H100: integer operations.  A main-path batch
// replays 16384 lanes x up to 125 rows x 113 columns, ~2.3e8 DP cells,
// each the K1 row step plus its decision byte; the inputs are ~4 MB and
// the outputs ~16 MB.  The decision cube (~16 KB a lane) is scratch and
// far past shared memory (the TPU kept it in VMEM): it lives in a global
// tensor that the wrapper allocates, `[lane][row][thread]`, each thread's
// slot sw_tb_slot(C) bytes, so a group's row is one contiguous run of
// G x slot bytes (128 B at the main-path width).
//
// Design.  A group of G threads owns one lane, with the DP row of
// sw_group.cuh in registers (as K1), so nothing goes through shared
// memory and a main-path batch puts 16384 x G threads in flight (a
// one-thread-per-lane design with the row in shared memory held one
// warp per scheduler and chained shared-memory loads in every cell).
// Phase 1, one row:
//   1. the parts of the old row at each own column j (a0, t0 for byte
//      j + 1; b1, t1 for byte j) are computed once, from the values the
//      row step reads anyway;
//   2. the row step of sw_group.cuh, in place; a lane whose row is past
//      blen holds its values and skips the step, whose shuffles take the
//      ballot of the lanes that step as their mask, so the old row need
//      not outlive the step;
//   3. b2, t2 of the new row at column j go to byte j + 1; only a
//      thread's first byte needs its left neighbour's last column (one
//      shfl_up of 5 bits);
//   4. the thread packs its C bytes into 32-bit words and stores them as
//      one 16-byte word (4 or 8 bytes for C <= 8, two for C = 18).
// Phase 2, the group walks together, one row per step:
//   1. each thread holds its word of row i and loads row i - 1's before
//      the step (the address does not depend on the walk; loading 2, 4
//      or 8 rows ahead measured no faster, PERF.md);
//   2. jc, the last column <= jj whose b2 bit is 0: each thread takes
//      its highest candidate from a bit mask of its bytes, a ballot finds
//      the highest thread that has one, and a shuffle brings its column;
//      tie_run (a t2 bit in [max(jc, 1), jj]) is one more ballot;
//   3. the byte of column cstep comes from the thread that owns it
//      (one shuffle);
//   4. the step's outputs are uniform over the group: thread g keeps
//      those of the rows r with r % G == g, and every G rows the group
//      stores G consecutive rows at once (rows the walk does not visit
//      keep EV_NONE, -1 and 0); the read code of a diagonal step is
//      loaded only then, off the walk's chain of dependent steps.
// Lanes of one warp walk to the warp's longest lane (inactive steps
// change nothing); dead lanes and tail lanes past B stay in the
// shuffles and write only their fill values.  Each thread reads back
// only the cube bytes it wrote itself.
#include <cuda_runtime.h>

#include "sw_group.cuh"

#define SW_TB_THREADS 128

// Bytes of a thread's slot in a cube row: its C decision bytes rounded
// up to a 4-, 8- or 16-byte word, or two 16-byte words.
__host__ __device__ constexpr int sw_tb_slot(int C) {
  return C <= 4 ? 4 : (C <= 8 ? 8 : (C <= 16 ? 16 : 32));
}

template <int NW>
__device__ __forceinline__ void slot_store(uint8_t* p,
                                           const uint32_t (&w)[NW]) {
  if constexpr (NW == 1) {
    *reinterpret_cast<uint32_t*>(p) = w[0];
  } else if constexpr (NW == 2) {
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  } else {
#pragma unroll
    for (int k = 0; k < NW / 4; ++k)
      reinterpret_cast<uint4*>(p)[k] =
          make_uint4(w[4 * k], w[4 * k + 1], w[4 * k + 2], w[4 * k + 3]);
  }
}

template <int NW>
__device__ __forceinline__ void slot_load(const uint8_t* p,
                                          uint32_t (&w)[NW]) {
  if constexpr (NW == 1) {
    w[0] = *reinterpret_cast<const uint32_t*>(p);
  } else if constexpr (NW == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x;
    w[1] = v.y;
  } else {
#pragma unroll
    for (int k = 0; k < NW / 4; ++k) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[k];
      w[4 * k] = v.x;
      w[4 * k + 1] = v.y;
      w[4 * k + 2] = v.z;
      w[4 * k + 3] = v.w;
    }
  }
}

// Bit BIT of each of the C bytes in w as a C-bit mask (byte c -> bit
// c): per word, the four bits moved to bits 24-27 by one multiply (the
// partial products land on distinct bits, so nothing carries).
template <int C, int BIT, int NW>
__device__ __forceinline__ uint32_t byte_bits(const uint32_t (&w)[NW]) {
  uint32_t m = 0;
#pragma unroll
  for (int k = 0; k < (C + 3) / 4; ++k) {
    const uint32_t t = (w[k] >> BIT) & 0x01010101u;
    m |= ((t * 0x01020408u) >> 24) << (4 * k);
  }
  return m & ((1u << C) - 1);
}

// One block an SM at least, so ptxas may take up to 255 registers; 128
// threads a block keep the occupancy steps fine.
template <bool BIS, int G, int C>
__global__ void __launch_bounds__(SW_TB_THREADS, 1)
    sw_tb_rows_kernel(const uint8_t* __restrict__ refs,
                      const int32_t* __restrict__ blens,
                      const uint8_t* __restrict__ reads,
                      const int32_t* __restrict__ rlens,
                      const int32_t* __restrict__ bt_k,
                      const int32_t* __restrict__ bt_i,
                      uint8_t* __restrict__ cube,
                      int8_t* __restrict__ ev_kind,
                      int32_t* __restrict__ ins_j,
                      int32_t* __restrict__ ins_len,
                      uint8_t* __restrict__ tie_out, int B, int N, int M,
                      int n_rows) {
  constexpr int S = sw_tb_slot(C);
  constexpr int NW = S / 4;
  constexpr int NB = (C + 3) / 4;  // words that hold bytes
  const int g = threadIdx.x % G;
  const long lane = ((long)blockIdx.x * SW_TB_THREADS + threadIdx.x) / G;
  const bool live = lane < B;
  const int j0 = g * C;  // this thread's first column
  const int W = M + 1;

  const int rlen = live ? rlens[lane] : 0;
  const int blen = live ? blens[lane] : 0;
  const int bi0 = live ? bt_i[lane] : 0;
  bool alive = live && bi0 > 0 && rlen > 0;
  const int rmax = alive ? min(bi0, n_rows) : 0;  // rows the walk visits
  const int wmax = __reduce_max_sync(SW_FULL, rmax);
  // this thread's slot of row i is at cube_l + (i - 1) * row
  const long row = (long)G * S;
  uint8_t* cube_l = cube + (long)lane * n_rows * row + (long)g * S;

  // ---- phase 1: replay the DP, store the decision bytes of rows 1..rmax
  int S0[C], S1[C], S2[C], rd[C];
  sw_group_init<SwXMatch<BIS>>(S0, S1, S2, rd, reads + lane * M, live,
                               j0, M);
  for (int i0 = 0; i0 < wmax; i0 += G) {
    const int ri = i0 + g;
    const int chunk = (live && ri < N) ? refs[lane * N + ri] : 0;
    const int k_end = wmax - i0 < G ? wmax - i0 : G;
    for (int k = 0; k < k_end; ++k) {
      const int i = i0 + k + 1;
      const int rb = __shfl_sync(SW_FULL, chunk, k, G);

      // old row (i - 1) at own column c: b1, t1 into byte c; a0, t0
      // into byte c + 1 (the last column's to the right neighbour)
      uint32_t w[NW] = {};
      int carry = 0;
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int o0 = S0[c], o1 = S1[c], o2 = S2[c];
        const int m = max(o0, o1);
        const int a0 = o2 > m ? 2 : (o1 > o0 ? 1 : 0);
        const int t0 = (o1 == o0) | (o2 == m);
        const int x = o1 - SW_EXT, y = o0 - SW_OPEN;
        w[c / 4] |= (uint32_t)(((x > y) << 2) | ((x == y) << 5))
                    << (8 * (c % 4));
        const int a = a0 | (t0 << 4);
        if (c + 1 < C)
          w[(c + 1) / 4] |= (uint32_t)a << (8 * ((c + 1) % 4));
        else
          carry = a;
      }

      // a row past blen holds its values: only the groups of the lanes
      // whose row steps take part in the step's shuffles
      const bool step = i <= blen;
      const unsigned stepping = __ballot_sync(SW_FULL, step);
      if (step) {
        int c0[C], c1[C], c2[C];
        sw_group_row<SwXMatch<BIS>, G, C>(stepping, S0, S1, S2, rd, rb, g,
                                          j0, c0, c1, c2);
#pragma unroll
        for (int c = 0; c < C; ++c) {
          S0[c] = c0[c];
          S1[c] = c1[c];
          S2[c] = c2[c];
        }
      }

      // new row (i) at own column c: b2, t2 into byte c + 1
#pragma unroll
      for (int c = 0; c < C; ++c) {
        const int x = S2[c] - SW_EXT, y = S0[c] - SW_OPEN;
        const int b = ((x > y) << 3) | ((x == y) << 6);
        if (c + 1 < C)
          w[(c + 1) / 4] |= (uint32_t)b << (8 * ((c + 1) % 4));
        else
          carry |= b;
      }
      const int left = __shfl_up_sync(SW_FULL, carry, 1, G);
      if (g > 0) w[0] |= (uint32_t)left;
      if (i <= rmax) slot_store(cube_l + (i - 1) * row, w);
    }
  }

  // ---- phase 2: the group walks back, one row per step ---------------
  const int wpos = threadIdx.x % 32;
  const unsigned gmask =
      (G == 32 ? SW_FULL : ((1u << (G % 32)) - 1)) << (wpos - g);
  int jj = rlen;
  int kk = live ? bt_k[lane] : 0;
  bool tie = false;
  uint32_t w[NW] = {};
  if (alive && rmax == wmax && wmax > 0)  // n_rows = 0: no row to load
    slot_load(cube_l + (wmax - 1) * row, w);
  int rec_ev = SW_EV_NONE, rec_j = -1, rec_l = 0;  // row r, r % G == g
  const int n_blocks = (n_rows + G - 1) / G;
  for (int r = n_blocks * G - 1; r >= 0; --r) {
    const int i = r + 1;  // the step of row i writes output row r
    if (i <= wmax && __any_sync(SW_FULL, alive)) {
      const bool act = alive && i <= rmax;
      uint32_t nx[NW] = {};
      if (alive && i >= 2 && i - 1 <= rmax)
        slot_load(cube_l + (i - 2) * row, nx);

      // insertion run: columns jj..jc, jc = last column <= jj whose b2
      // bit is 0 (column 0 always is); -1 when jj is off the row
      const int lim = jj - j0;
      const uint32_t upto =
          (jj < 0 || jj >= W || lim < 0)
              ? 0u
              : (lim >= C - 1 ? (1u << C) - 1 : (2u << lim) - 1);
      const uint32_t z = ~byte_bits<C, 3>(w) & upto;
      const int cand = z ? j0 + 31 - __clz(z) : -1;
      const unsigned has = __ballot_sync(SW_FULL, z != 0) & gmask;
      const int src = has ? (31 - __clz(has)) % G : 0;
      const int jc_s = __shfl_sync(SW_FULL, cand, src, G);
      const int jc = has ? jc_s : -1;
      // a b2 tie at a run column the walk visits, [max(jc, 1), jj]
      const int lo = (jc > 1 ? jc : 1) - j0;
      uint32_t t2 = byte_bits<C, 6>(w) & upto;
      if (lo > 0) t2 = lo >= C ? 0u : t2 & ~((1u << lo) - 1);
      const bool t2_any = (__ballot_sync(SW_FULL, t2 != 0) & gmask) != 0;

      const bool is2 = act && kk == 2;
      const bool is1 = act && kk == 1;
      const bool run_dead = is2 && jc <= 1;
      const int run_len = is2 ? (run_dead ? jj : jj - jc + 1) : 0;
      const int cstep = is2 ? jc - 1 : jj;
      const int cc = cstep < 0 ? 0 : (cstep > W - 1 ? W - 1 : cstep);
      // the byte of column cc, from the thread that owns it
      const int owner = cc / C;
      const int pos = cc - owner * C;
      uint32_t wsel = w[0];
#pragma unroll
      for (int q = 1; q < NB; ++q)
        if ((pos >> 2) == q) wsel = w[q];
      const int bits =
          (__shfl_sync(SW_FULL, wsel, owner, G) >> (8 * (pos & 3))) & 0xff;

      const bool consume = act && !run_dead;
      const bool diag = consume && !is1;
      if (g == r % G) {
        if (consume) {
          int kcol = cc - 1;
          kcol = kcol < 0 ? 0 : (kcol > M ? M : kcol);
          // a diagonal step keeps 16 + its read column: the read code
          // is loaded when the row is stored
          rec_ev = !diag ? SW_EV_DEL : (kcol < M ? 16 + kcol : SW_EV_NONE);
        }
        if ((diag && run_len > 0) || run_dead) {
          rec_j = run_dead ? 0 : cstep;
          rec_l = run_len;
        }
      }
      const int nk = is1 ? (bits >> 2) & 1 : bits & 3;
      const int nj = is1 ? jj : cstep - 1;
      const bool nalive = consume && nj > 0 && i - 1 > 0;
      tie = tie || (diag && ((bits >> 4) & 1) && nalive) ||
            (is1 && ((bits >> 5) & 1) && nalive) || (is2 && t2_any);
      if (act) {
        jj = nj;
        kk = nk;
        alive = nalive;
      }
#pragma unroll
      for (int k = 0; k < NW; ++k) w[k] = nx[k];
    }
    if (r % G == 0) {  // rows r .. r + G - 1 are done: thread g stores r + g
      const int ro = r + g;
      if (live && ro < n_rows) {
        int ev = rec_ev;
        if (ev >= 16) {
          const int rx = reads[lane * M + ev - 16];
          ev = rx == SW_XN ? SW_EV_NONE : rx;
        }
        const long o = lane * n_rows + ro;
        ev_kind[o] = (int8_t)ev;
        ins_j[o] = rec_j;
        ins_len[o] = rec_l;
      }
      rec_ev = SW_EV_NONE;
      rec_j = -1;
      rec_l = 0;
    }
  }
  if (live && g == 0) tie_out[lane] = tie;
}

struct SwTbArgs {
  const uint8_t* refs;
  const int32_t* blens;
  const uint8_t* reads;
  const int32_t* rlens;
  const int32_t* bt_k;
  const int32_t* bt_i;
  uint8_t* cube;
  int8_t* ev_kind;
  int32_t* ins_j;
  int32_t* ins_len;
  uint8_t* tie;
  int B, N, M, n_rows;
  cudaStream_t s;
};

template <bool BIS>
struct SwTbRun {
  const SwTbArgs& a;
  template <int G, int C>
  int operator()() const {
    const long threads = (long)a.B * G;
    const int grid = (int)((threads + SW_TB_THREADS - 1) / SW_TB_THREADS);
    sw_tb_rows_kernel<BIS, G, C><<<grid, SW_TB_THREADS, 0, a.s>>>(
        a.refs, a.blens, a.reads, a.rlens, a.bt_k, a.bt_i, a.cube,
        a.ev_kind, a.ins_j, a.ins_len, a.tie, a.B, a.N, a.M, a.n_rows);
    return (int)cudaGetLastError();
  }
};

extern "C" int sw_tb_rows_row_bytes(int M, int group) {
  const int G = group ? group : sw_group_for(M);
  const int C = sw_group_cols(M, G);
  return C ? G * sw_tb_slot(C) : 0;
}

// `group`: threads per lane, 0 = the kernel's choice for the width (the
// main path's); 8, 16 or 32 force it (tests, and timing each group
// size).  `cube` holds B x n_rows x sw_tb_rows_row_bytes(M, group)
// bytes.
extern "C" int sw_tb_rows_launch(
    const uint8_t* refs, const int32_t* blens, const uint8_t* reads,
    const int32_t* rlens, const int32_t* bt_k, const int32_t* bt_i,
    uint8_t* cube, int8_t* ev_kind, int32_t* ins_j, int32_t* ins_len,
    uint8_t* tie, int B, int N, int M, int n_rows, int bisulfite,
    int group, void* stream) {
  if (B <= 0) return 0;
  const int G = group ? group : sw_group_for(M);
  const int C = sw_group_cols(M, G);
  if (C == 0) return (int)cudaErrorInvalidValue;
  const SwTbArgs a{refs, blens, reads, rlens, bt_k, bt_i, cube, ev_kind,
                   ins_j, ins_len, tie, B, N, M, n_rows,
                   static_cast<cudaStream_t>(stream)};
  return bisulfite ? sw_group_launch(G, C, SwTbRun<true>{a})
                   : sw_group_launch(G, C, SwTbRun<false>{a});
}
