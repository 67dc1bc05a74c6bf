// Chaining votes and candidate selection of the v2 seed stage
// (FusedStep2.chain_dedup_select), in two kernels: chain_votes, then
// chain_select.  The genome mesh meets its shards between them (the
// pmax of Tmax) and after them (the psum of n_keep).
//
// Replaces no TPU kernel: the JAX package computes this step as XLA code
// (pecaller_tpu/mapper/device_map2.py:485 chain_dedup_select), and so
// does the plain version, pecaller_tpu_torch/ops/chain.py
// chain_votes_plain and chain_select_plain, with the same results bit
// for bit.  That tensor program broadcasts every anchor of a unit
// against every other: (U, 2, S-dd, 16, 16) differences for each vote
// distance, (U, F, 64) comparison chunks for the dedup, (U, F, 16)
// selection sums: on an H100 about 60 ms and 2 GB of temporaries a
// main-path batch (65,536 units of F = 256 anchors) for a few live
// anchors a unit, where these kernels take about 0.2 ms.
//
// What bounds it on an H100: bytes.  A unit's inputs are its F int32
// positions (at most 640) and a few per-probe words; chain_votes reads
// them and writes T (F int32) and Tmax; chain_select reads pos, T and
// Tmax again and writes 16 candidates.  A main-path batch moves ~85 MB
// in all (~25 us at 3.35 TB/s).
//
// Design.  One warp a unit, kWarps units a block, the unit's positions
// and diagonals in shared memory.
//   chain_votes: a coalesced pass loads the F positions, stores the
//     diagonals and, by ballot, a 16-bit mask of the valid slots of each
//     probe and the list of valid anchors in F order.  The lanes then
//     take the valid anchors (one each, strided), and each walks its
//     later probes of the same orientation up to n_segs - 1, testing
//     only the probe's valid slots (its mask's bits) until one lies
//     within MAX_OFF; T goes back out coalesced, Tmax by shuffles over
//     each probe's 16 lanes.
//   chain_select: the min_spots wipe and the min_match ratchet run on
//     the whole warp in the reference's order over (o, li), each probe's
//     Tmax and count held in a lane and broadcast by shuffle; a
//     coalesced pass finds the accepted anchors and compacts them (F
//     order) by ballot; each accepted anchor is compared with the
//     earlier accepted ones only (first-occurrence dedup); a ballot
//     prefix over the keep flags gives each kept anchor its rank, and
//     the first HIT_CAP are written.
// Every step is a fixed order over one warp: no atomics, so the result
// is deterministic.  Wrapping int32 arithmetic (diagonals, the
// ratchet's bound, abs of INT_MIN) follows the plain version's tensors.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kSegCap = 16;        // candidates a probe (SEG_CAP)
constexpr int kMaxS = 20;          // probes an orientation, at most
constexpr int kMaxF = 2 * kMaxS * kSegCap;
constexpr int kMaxP = 2 * kMaxS;
constexpr int kWarps = 4;          // units a block
constexpr int kHitCap = 16;        // HIT_CAP
constexpr int32_t kPosPad = 1 << 30;
constexpr int32_t kMaxOff = 12;    // max(2, IDEPTH - 4)
constexpr int64_t kWipeSpots = 200;
constexpr unsigned kAll = 0xffffffffu;

__device__ __forceinline__ int32_t wsub(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) -
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ int32_t wadd(int32_t a, int32_t b) {
  return static_cast<int32_t>(static_cast<uint32_t>(a) +
                              static_cast<uint32_t>(b));
}

__device__ __forceinline__ unsigned lanes_below(int lane) {
  return (1u << lane) - 1u;
}

__global__ void __launch_bounds__(kWarps * 32)
chain_votes_kernel(const int32_t* __restrict__ pos,
                   const int32_t* __restrict__ offsets,
                   const int32_t* __restrict__ n_segs,
                   int32_t* __restrict__ T, int32_t* __restrict__ Tmax,
                   int U, int S) {
  __shared__ int32_t s_dg[kWarps][kMaxF];     // diagonals
  __shared__ int32_t s_t[kWarps][kMaxF];      // votes, 0 where invalid
  __shared__ int16_t s_lst[kWarps][kMaxF];    // valid anchors, F order
  __shared__ uint32_t s_pm[kWarps][kMaxP];    // valid slots a probe
  __shared__ int32_t s_off[kWarps][kMaxS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (u >= U) return;                         // whole warps only
  const int F = 2 * S * kSegCap, P = 2 * S;
  int32_t* dg = s_dg[w];
  int32_t* tv = s_t[w];
  int16_t* lst = s_lst[w];
  uint32_t* pm = s_pm[w];
  int32_t* off = s_off[w];
  if (lane < S) off[lane] = offsets[u * S + lane];
  __syncwarp();

  const int32_t* pu = pos + u * F;
  int nv = 0;
  for (int b = 0; b < F; b += 32) {
    const int f = b + lane;
    const int32_t v = pu[f];
    const bool valid = v < kPosPad;
    dg[f] = wsub(v, off[(f >> 4) % S]);
    tv[f] = 0;
    const unsigned m = __ballot_sync(kAll, valid);
    if (lane == 0) {
      pm[b >> 4] = m & 0xffffu;
      pm[(b >> 4) + 1] = m >> 16;
    }
    if (valid)
      lst[nv + __popc(m & lanes_below(lane))] = static_cast<int16_t>(f);
    nv += __popc(m);
  }
  __syncwarp();

  // a vote may come from probes li + 1 .. min(S, n_segs) - 1
  const int32_t last = min(S - 1, wsub(n_segs[u], 1));
  for (int i = lane; i < nv; i += 32) {
    const int f = lst[i];
    const int p = f >> 4;
    const int o = p >= S;
    const int li = p - o * S;
    const int32_t d = dg[f];
    int votes = 1;
    for (int l2 = li + 1; l2 <= last; ++l2) {
      const int q = o * S + l2;
      unsigned m = pm[q];
      while (m) {
        const int j = __ffs(m) - 1;
        m &= m - 1;
        const int32_t x = wsub(d, dg[q * kSegCap + j]);
        const int32_t ax = x < 0 ? wsub(0, x) : x;   // abs(INT_MIN) < 0
        if (ax < kMaxOff) {
          ++votes;
          break;
        }
      }
    }
    tv[f] = votes;
  }
  __syncwarp();

  int32_t* tu = T + u * F;
  for (int b = 0; b < F; b += 32) {
    const int f = b + lane;
    int32_t x = tv[f];
    tu[f] = x;
    for (int k = 8; k; k >>= 1) x = max(x, __shfl_xor_sync(kAll, x, k));
    if ((lane & 15) == 0) Tmax[u * P + (f >> 4)] = x;
  }
}

__global__ void __launch_bounds__(kWarps * 32)
chain_select_kernel(const int32_t* __restrict__ pos,
                    const int32_t* __restrict__ T,
                    const int32_t* __restrict__ Tmax,
                    const int64_t* __restrict__ seg_tot,
                    const int32_t* __restrict__ offsets,
                    const int32_t* __restrict__ n_segs,
                    const int32_t* __restrict__ min_match0,
                    const int32_t* __restrict__ skip,
                    const int64_t* __restrict__ own_lo,
                    const int64_t* __restrict__ own_hi,
                    int32_t* __restrict__ hits,
                    int32_t* __restrict__ hits_off,
                    int8_t* __restrict__ orient, int32_t* __restrict__ tot,
                    int64_t* __restrict__ n_keep, int U, int S) {
  __shared__ int32_t s_dg[kWarps][kMaxF];     // accepted: diagonals
  __shared__ int16_t s_lst[kWarps][kMaxF];    // accepted: F index
  __shared__ int32_t s_off[kWarps][kMaxS];
  const int w = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kWarps + w;
  if (u >= U) return;
  const int F = 2 * S * kSegCap, P = 2 * S;
  int32_t* dg = s_dg[w];
  int16_t* lst = s_lst[w];
  int32_t* off = s_off[w];
  if (lane < S) off[lane] = offsets[u * S + lane];
  __syncwarp();

  // each lane holds probes lane and lane + 32: Tmax and the min_spots
  // terms of the probes inside the read
  const int32_t ns = n_segs[u];
  int32_t tm0 = 0, tm1 = 0;
  int64_t ms0 = 1 << 30, ms1 = 1 << 30;
  for (int r = 0; r < 2; ++r) {
    const int p = lane + 32 * r;
    if (p >= P) continue;
    const int32_t t = Tmax[u * P + p];
    if (r == 0) tm0 = t; else tm1 = t;
    const int o = p >= S;
    if (p - o * S < ns) {
      const int64_t c = seg_tot[u * P + p];
      if (o) ms1 = c < ms1 ? c : ms1; else ms0 = c < ms0 ? c : ms0;
    }
  }
  for (int k = 16; k; k >>= 1) {
    const int64_t x0 = __shfl_xor_sync(kAll, ms0, k);
    const int64_t x1 = __shfl_xor_sync(kAll, ms1, k);
    ms0 = x0 < ms0 ? x0 : ms0;
    ms1 = x1 < ms1 ? x1 : ms1;
  }
  const bool wipe0 = ms0 > kWipeSpots, wipe1 = ms1 > kWipeSpots;

  // the min_match ratchet over (o, li) in order
  const int32_t bound1 = wadd(1, wsub(ns, 1));   // 1 + max_depth
  const bool go = skip[u] == 0;
  int32_t cur = min_match0[u];
  uint64_t proc = 0;
  for (int p = 0; p < P; ++p) {
    const int o = p >= S;
    const int li = p - o * S;
    const int32_t t = __shfl_sync(kAll, p < 32 ? tm0 : tm1, p & 31);
    const bool active =
        go && !(o ? wipe1 : wipe0) && li <= wsub(bound1, cur);
    if (active) proc |= 1ull << p;
    cur = max(cur, active ? t : 0);
  }

  // accepted anchors, compacted in F order
  const bool sharded = own_lo != nullptr;
  const int64_t lo = sharded ? *own_lo : 0, hi = sharded ? *own_hi : 0;
  const int32_t* pu = pos + u * F;
  const int32_t* tu = T + u * F;
  int na = 0;
  for (int b = 0; b < F; b += 32) {
    const int f = b + lane;
    const int p = f >> 4;
    const int32_t v = pu[f];
    const int32_t d = wsub(v, off[p % S]);
    bool acc = ((proc >> p) & 1) && tu[f] == cur && v < kPosPad && !wipe1;
    if (sharded) acc = acc && d >= lo && d < hi;
    const unsigned m = __ballot_sync(kAll, acc);
    if (acc) {
      const int k = na + __popc(m & lanes_below(lane));
      dg[k] = d;
      lst[k] = static_cast<int16_t>(f);
    }
    na += __popc(m);
  }
  __syncwarp();

  // first-occurrence dedup, rank by ballot prefix, the first kHitCap out
  int32_t* hu = hits + u * kHitCap;
  int32_t* hou = hits_off + u * kHitCap;
  int8_t* ou = orient + u * kHitCap;
  int nk = 0;
  for (int b = 0; b < na; b += 32) {
    const int i = b + lane;
    bool keep = i < na;
    const int32_t d = keep ? dg[i] : 0;
    for (int j = 0; keep && j < i; ++j) keep = dg[j] != d;
    const unsigned m = __ballot_sync(kAll, keep);
    const int r = nk + __popc(m & lanes_below(lane));
    if (keep && r < kHitCap) {
      const int p = lst[i] >> 4;
      const int o = p >= S;
      const int32_t ofs = off[p - o * S];
      hu[r] = wadd(d, ofs);                       // the position
      hou[r] = ofs;
      ou[r] = static_cast<int8_t>(o);
    }
    nk += __popc(m);
  }
  if (lane >= nk && lane < kHitCap) {
    hu[lane] = 0;
    hou[lane] = 0;
    ou[lane] = 0;
  }
  if (lane == 0) {
    tot[u] = min(nk, kHitCap);
    n_keep[u] = nk;
  }
}

int blocks_for(int U) { return (U + kWarps - 1) / kWarps; }

}  // namespace

// pos (U, 2, S, 16) int32; offsets (U, S), n_segs (U,) int32; out T (U,
// 2, S, 16) and Tmax (U, 2, S) int32.  1 <= S <= 20.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int chain_votes_launch(const int32_t* pos, const int32_t* offsets,
                                  const int32_t* n_segs, int32_t* T,
                                  int32_t* Tmax, int U, int S,
                                  void* stream) {
  if (S < 1 || S > kMaxS) return static_cast<int>(cudaErrorInvalidValue);
  if (U <= 0) return 0;
  chain_votes_kernel<<<blocks_for(U), kWarps * 32, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      pos, offsets, n_segs, T, Tmax, U, S);
  return static_cast<int>(cudaGetLastError());
}

// pos, T as above; Tmax (U, 2, S) int32; seg_tot (U, 2, S) int64;
// offsets (U, S), n_segs, min_match0, skip (U,) int32; own_lo, own_hi:
// one int64 each, or both null (no genome shard).  Out: hits, hits_off
// (U, 16) int32, orient (U, 16) int8, tot (U,) int32, n_keep (U,) int64.
extern "C" int chain_select_launch(
    const int32_t* pos, const int32_t* T, const int32_t* Tmax,
    const int64_t* seg_tot, const int32_t* offsets, const int32_t* n_segs,
    const int32_t* min_match0, const int32_t* skip, const int64_t* own_lo,
    const int64_t* own_hi, int32_t* hits, int32_t* hits_off, int8_t* orient,
    int32_t* tot, int64_t* n_keep, int U, int S, void* stream) {
  if (S < 1 || S > kMaxS || (own_lo == nullptr) != (own_hi == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (U <= 0) return 0;
  chain_select_kernel<<<blocks_for(U), kWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      pos, T, Tmax, seg_tot, offsets, n_segs, min_match0, skip, own_lo,
      own_hi, hits, hits_off, orient, tot, n_keep, U, S);
  return static_cast<int>(cudaGetLastError());
}
