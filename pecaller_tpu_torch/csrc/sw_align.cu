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
// What bounds it on an H100: integer work.  A v1 batch end is 16384
// lanes x ~121 active rows x 101 columns, about 2e8 cells of ~25
// integer operations each; the inputs are ~4.5 MB and the outputs
// 0.2 MB, so device memory is not the limit.  The design is K1's
// (sw_align_x.cu): the TPU kernel solved the in-row insertion plane
// with a log-step cummax across sublanes; here one thread owns one lane
// and walks each row left to right, so the cummax is a running maximum
// in a register.  The previous DP row (three int32 planes) and the
// read's per-column match class live in shared memory, column-major
// over the block's threads ([column][thread]), so a warp touches 32
// consecutive words: no bank conflicts.  The read byte's wildcard and
// bisulfite-T flags are folded into one shared byte per column at load
// time, so the per-cell match test is two compares and a few logic
// ops.  A lane stops at column rlen and row min(n_rows, blen): cells
// past either never reach the last read column's active rows.
#include <cuda_runtime.h>

#include "sw_kernels.h"

// Shared bytes of one block of `threads` lanes for reads of width M.
static inline int sw_raw_smem_bytes(int M, int threads) {
  const int W = M + 1;
  // three int32 planes of W columns, the read's bytes and flags
  return W * threads * (3 * (int)sizeof(int32_t)) + 2 * M * threads;
}

__device__ __forceinline__ bool is_wild(int c) {
  return c == 'N' || c == 'n';
}

template <bool BIS>
__global__ void sw_align_kernel(const uint8_t* __restrict__ refs,
                                const int32_t* __restrict__ blens,
                                const uint8_t* __restrict__ reads,
                                const int32_t* __restrict__ rlens,
                                int32_t* __restrict__ score,
                                int32_t* __restrict__ bk_out,
                                int32_t* __restrict__ bi_out, int B, int N,
                                int M, int n_rows) {
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
  // per column: bit 0 wildcard, bit 1 bisulfite T
  uint8_t* RF = RD + M * T;

  const int rlen = rlens[lane];
  const int blen = blens[lane];
  int rows = n_rows < blen ? n_rows : blen;  // active rows 1..rows
  if (rows < 0) rows = 0;

  if (rlen < 0 || rlen > M) {
    // no column equals rlen: every candidate is NEG, none is `>`
    score[lane] = SW_NEG;
    bk_out[lane] = 0;
    bi_out[lane] = 0;
    return;
  }
  const int jl = rlen;  // last column computed

  for (int j = 0; j <= jl; ++j) {
    const int b = j == 0 ? 0 : -(SW_OPEN + (j - 1) * SW_EXT);
    S0[j * T + t] = b;
    S1[j * T + t] = b;
    S2[j * T + t] = j == 0 ? -SW_OPEN : b;
  }
  const uint8_t* rd_g = reads + lane * (long)M;
  for (int j = 0; j < jl; ++j) {
    const int c = rd_g[j];
    RD[j * T + t] = (uint8_t)c;
    RF[j * T + t] = (uint8_t)(is_wild(c) | ((BIS && (c == 'T' || c == 't'))
                                            << 1));
  }

  int best = S0[jl * T + t];
  int bk = 0, bi = 0;
  const uint8_t* ref_g = refs + lane * (long)N;

  for (int i = 1; i <= rows; ++i) {
    const int rb = ref_g[i - 1];
    // a wildcard reference byte matches every column; every reference
    // byte matches the read's wildcard columns and, for a bisulfite
    // reference C, its T columns
    const bool rwild = is_wild(rb);
    const int fmask = 1 | ((BIS && (rb == 'C' || rb == 'c')) ? 2 : 0);
    // column 0: c0 = c1 = 0, c2 = -OPEN
    int prev3 = max(max(S0[t], S1[t]), S2[t]);  // old row, column j-1
    int c0m = 0;                                 // new c0, column j-1
    int z = -SW_OPEN;                            // running cummax
    S0[t] = 0;
    S1[t] = 0;
    S2[t] = -SW_OPEN;
    int v0 = 0, v1 = 0, v2 = -SW_OPEN;
    for (int j = 1; j <= jl; ++j) {
      const int o0 = S0[j * T + t];
      const int o1 = S1[j * T + t];
      const int o2 = S2[j * T + t];
      const int q = RD[(j - 1) * T + t];
      const int f = RF[(j - 1) * T + t];
      const bool m = (q == rb) | rwild | ((f & fmask) != 0);
      const int c0 = prev3 + (m ? SW_MATCH : SW_MISMATCH);
      const int c1 = max(o0 - SW_OPEN, o1 - SW_EXT);
      z = max(z, c0m - SW_OPEN + j);
      const int c2 = z - j;
      prev3 = max(max(o0, o1), o2);
      c0m = c0;
      S0[j * T + t] = c0;
      S1[j * T + t] = c1;
      S2[j * T + t] = c2;
      v0 = c0;
      v1 = c1;
      v2 = c2;
    }
    const int v[3] = {v0, v1, v2};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      if (v[k] > best) {
        best = v[k];
        bk = k;
        bi = i;
      }
    }
  }
  score[lane] = best;
  bk_out[lane] = bk;
  bi_out[lane] = bi;
}

extern "C" int sw_align_smem_bytes(int M, int threads) {
  return sw_raw_smem_bytes(M, threads);
}

extern "C" int sw_align_launch(const uint8_t* refs, const int32_t* blens,
                               const uint8_t* reads, const int32_t* rlens,
                               int32_t* score, int32_t* bk, int32_t* bi,
                               int B, int N, int M, int n_rows,
                               int bisulfite, void* stream) {
  if (B <= 0) return 0;
  const int T = sw_raw_smem_bytes(M, 64) <= 200 * 1024 ? 64 : 32;
  const int smem = sw_raw_smem_bytes(M, T);
  const int grid = (B + T - 1) / T;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (bisulfite) {
    e = cudaFuncSetAttribute(sw_align_kernel<true>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    sw_align_kernel<true><<<grid, T, smem, s>>>(
        refs, blens, reads, rlens, score, bk, bi, B, N, M, n_rows);
  } else {
    e = cudaFuncSetAttribute(sw_align_kernel<false>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             smem);
    if (e != cudaSuccess) return (int)e;
    sw_align_kernel<false><<<grid, T, smem, s>>>(
        refs, blens, reads, rlens, score, bk, bi, B, N, M, n_rows);
  }
  return (int)cudaGetLastError();
}
