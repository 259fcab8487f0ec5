// MAJ-N over packed bit-planes for Hopper (sm_90a): out bit = (number of
// the N input planes with that bit set >= threshold), for each of the 32
// bits of each of W words.
//
// Replaces the TPU kernel repro/kernels/maj_n.py::maj_n (body _maj_kernel),
// PULSAR's many-input charge sharing on packed planes. Its caller in the
// port is the reliability plane's replica vote (repro_torch/reliability/
// faults.py::majority_vote): the majority, disagreement and weak-margin
// planes over R fault-injected replicas are MAJ-R at different thresholds.
// The chip model (repro_torch/core/chip.py::PulsarChip.apa_maj) votes with
// it too: each charge-sharing APA is MAJ over the non-neutral activated rows.
// Input [N <= 65535, W] 32-bit words row-major, output [W]. The plain version
// is repro_torch/kernels/ref.py::maj_n_fast (and ref.maj_n, bit-exact);
// ref.maj_n_grouped is the plain version of this kernel's decomposition.
//
// Algorithm (the Pallas kernel's): a K-bit bit-sliced counter per bit lane,
// K = bit_length(N), starts at 2^K - threshold; adding the N planes with a
// ripple of half adders, a lane whose count reaches the threshold carries
// out of the counter, and the OR of those carries is the majority plane.
//
// What bounds it on this card, in two regimes:
// * Large W (the replica vote at 2M lanes, kernel_bench's [31, 65536]):
//   device-memory bytes, (N + 1) * W * 4 (each plane word read once, the
//   output written once; about 3K + 1 integer ops per word per plane, far
//   under the op rate). 8 MB at [31, 65536] is 2.5 us at 3.35 TB/s, so
//   most of it must be in flight at once: a thread that waits for each
//   plane before it asks for the next leaves the card idle. A copy_ of
//   the same bytes is the practical floor (PERF.md).
// * W = 2048 (the chip model's row of PAPER_MODULE.row_bits bits, N <= 32
//   votes): latency and launch. The bytes (270 KB at N = 32) are 0.08 us;
//   what is left is the launch and each thread's chain of dependent
//   device-memory round trips.
//
// Design, against both:
// * A block covers a tile of `tile` word columns; a thread holds VEC = 4
//   neighbouring words (one 16-byte load, ld.global.nc.v4 with a 256-byte
//   L2 fetch, where the rows are 16-byte aligned, else four 4-byte loads
//   of columns tpg apart, so a warp still reads neighbouring words). The
//   block's threads are [groups][tpg]: row group g adds planes
//   [g*N/groups, (g+1)*N/groups) into its own K-bit counter in registers
//   (K a template parameter of 1..16, so the planes have compile-time
//   indices).
// * A thread issues the loads of BATCH = 4 planes before its first add,
//   so at the chip model's shape (at most 4 planes a thread) all of its
//   loads are in flight at once and it waits for one round of latency.
//   At large W a thread has 4 planes in flight and an SM 1,024 threads
//   (64 registers a thread up to K = 5), 64 KB: 4 measured faster than 8
//   there too, whose registers spill under that bound
//   (tools/maj_n_timing.py --batch 8).
// * The row groups' counters are merged in shared memory by a tree of
//   bit-sliced ripple adders (log2(groups) rounds, one barrier each). Group
//   0's counter starts at 2^K - threshold, the others at 0. The result is
//   the OR of every carry out of bit K - 1: each group's own and each
//   adder's. This is exact: the true total init + count <= 2^K - 1 + N <
//   2^(K+1), and every carry out of bit K - 1 takes 2^K out of the total
//   while each residual stays below 2^K, so the carries number exactly
//   floor(total / 2^K), which is 0 or 1 wherever the wrap happens, and 1
//   exactly where count >= threshold.
// * The geometry (groups, tile) is chosen per (N, W) in Python
//   (repro_torch/kernels/maj_n.py::geometry): at W = 2048 every thread has
//   at most 4 planes, in blocks of 8-thread groups over 32 words spread
//   on 64 SMs; at W >= 65536 every SM gets at least two blocks.
//   maj_n_launch checks it and refuses a bad pair.
// A ragged W needs no padding: out-of-range columns load nothing and store
// nothing.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int VEC = 4;            // words a thread holds
constexpr int BATCH = 4;          // plane loads in flight before an add
constexpr int MAX_THREADS = 256;  // a block's threads
constexpr int SMEM_BYTES = 48 * 1024;

// Blocks an SM must hold at once, so registers a thread: 64 up to K = 5
// (the main path's N <= 31), 128 up to K = 11, else what K needs.
constexpr int min_blocks(int k) { return k <= 5 ? 4 : k <= 11 ? 2 : 1; }

// A 16-byte read-only load that also asks L2 for the whole 256-byte
// line: a warp reads 512 neighbouring bytes of a plane, and the larger
// DRAM request is served faster than four 128-byte ones.
__device__ __forceinline__ uint4 load16(const uint32_t* p) {
  uint4 u;
  asm volatile(
      "ld.global.nc.L1::no_allocate.L2::256B.v4.u32 {%0, %1, %2, %3}, [%4];"
      : "=r"(u.x), "=r"(u.y), "=r"(u.z), "=r"(u.w)
      : "l"(p));
  return u;
}

// Block (tpg, groups); dynamic shared memory [groups][K + 1][tpg] uint4
// (the K counter planes and the carry-out plane of each row group).
template <int K, bool ALIGNED>
__global__ void __launch_bounds__(MAX_THREADS, min_blocks(K))
maj_n_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             int n, long long w, uint32_t init) {
  extern __shared__ uint4 slots[];
  const int t = threadIdx.x, g = threadIdx.y;
  const int tpg = blockDim.x, groups = blockDim.y;
  const long long base = (long long)blockIdx.x * tpg * VEC;
  // ALIGNED: words base + VEC*t + q; else words base + q*tpg + t.
  long long col[VEC];
  bool ok[VEC];
#pragma unroll
  for (int q = 0; q < VEC; ++q) {
    col[q] = ALIGNED ? base + (long long)t * VEC + q
                     : base + (long long)q * tpg + t;
    ok[q] = col[q] < w;
  }
  const int lo = (int)((long long)g * n / groups);
  const int hi = (int)((long long)(g + 1) * n / groups);

  uint32_t c[K][VEC];
  const uint32_t seed = g == 0 ? init : 0u;
#pragma unroll
  for (int j = 0; j < K; ++j)
#pragma unroll
    for (int q = 0; q < VEC; ++q) c[j][q] = ((seed >> j) & 1u) ? ~0u : 0u;
  uint32_t ov[VEC] = {0u, 0u, 0u, 0u};

  for (int i = lo; i < hi; i += BATCH) {
    uint32_t v[BATCH][VEC];
#pragma unroll
    for (int b = 0; b < BATCH; ++b) {
      const uint32_t* row = x + (long long)(i + b) * w;
      const bool live = i + b < hi;
      if (ALIGNED) {
        uint4 u = make_uint4(0u, 0u, 0u, 0u);
        if (live && ok[0]) u = load16(row + col[0]);
        v[b][0] = u.x; v[b][1] = u.y; v[b][2] = u.z; v[b][3] = u.w;
      } else {
#pragma unroll
        for (int q = 0; q < VEC; ++q)
          v[b][q] = (live && ok[q]) ? __ldg(row + col[q]) : 0u;
      }
    }
    // A zero plane (past hi) adds nothing: its carry is 0 at every bit.
#pragma unroll
    for (int b = 0; b < BATCH; ++b)
#pragma unroll
      for (int q = 0; q < VEC; ++q) {
        uint32_t carry = v[b][q];
#pragma unroll
        for (int j = 0; j < K; ++j) {
          const uint32_t s = c[j][q] ^ carry;
          carry &= c[j][q];
          c[j][q] = s;
        }
        ov[q] |= carry;
      }
  }

  // Tree merge: in the round of stride s, group g = s (mod 2s) hands its
  // counter to group g - s. One barrier a round suffices: a round's
  // writers (g = s mod 2s) and the next round's (g = 2s mod 4s) use
  // different slots, and a reader writes only in a later round.
  for (int s = 1; s < groups; s <<= 1) {
    if ((g & (2 * s - 1)) == s) {
      uint4* slot = slots + (long long)g * (K + 1) * tpg + t;
#pragma unroll
      for (int j = 0; j < K; ++j)
        slot[j * tpg] = make_uint4(c[j][0], c[j][1], c[j][2], c[j][3]);
      slot[K * tpg] = make_uint4(ov[0], ov[1], ov[2], ov[3]);
    }
    __syncthreads();
    if ((g & (2 * s - 1)) == 0 && g + s < groups) {
      const uint4* slot = slots + (long long)(g + s) * (K + 1) * tpg + t;
      uint32_t carry[VEC] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const uint4 o = slot[j * tpg];
        const uint32_t b4[VEC] = {o.x, o.y, o.z, o.w};
#pragma unroll
        for (int q = 0; q < VEC; ++q) {
          const uint32_t a = c[j][q], d = a ^ b4[q];
          c[j][q] = d ^ carry[q];
          carry[q] = (a & b4[q]) | (carry[q] & d);
        }
      }
      const uint4 o = slot[K * tpg];
      ov[0] |= carry[0] | o.x;
      ov[1] |= carry[1] | o.y;
      ov[2] |= carry[2] | o.z;
      ov[3] |= carry[3] | o.w;
    }
  }

  if (g == 0) {
    if (ALIGNED) {
      if (ok[0])
        *reinterpret_cast<uint4*>(out + col[0]) =
            make_uint4(ov[0], ov[1], ov[2], ov[3]);
    } else {
#pragma unroll
      for (int q = 0; q < VEC; ++q)
        if (ok[q]) out[col[q]] = ov[q];
    }
  }
}

template <int K>
int launch(const void* x, void* out, int n, long long w, int groups,
           int tile, uint32_t init, cudaStream_t stream) {
  const int tpg = tile / VEC;
  const size_t smem =
      groups > 1 ? (size_t)groups * (K + 1) * tpg * sizeof(uint4) : 0;
  const long long blocks = (w + tile - 1) / tile;
  if (smem > (size_t)SMEM_BYTES || blocks > 0x7FFFFFFFLL)
    return (int)cudaErrorInvalidValue;
  const bool aligned = w % VEC == 0 && (uintptr_t)x % 16 == 0 &&
                       (uintptr_t)out % 16 == 0;
  const dim3 block(tpg, groups);
  if (aligned)
    maj_n_kernel<K, true><<<(unsigned)blocks, block, smem, stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n, w, init);
  else
    maj_n_kernel<K, false><<<(unsigned)blocks, block, smem, stream>>>(
        (const uint32_t*)x, (uint32_t*)out, n, w, init);
  return (int)cudaGetLastError();
}

}  // namespace

// n in [1, 65535], threshold in [1, n]; groups in [1, n] row groups and a
// tile of `tile` words (a multiple of 4) with tile / 4 * groups <= 256
// threads and the merge's shared memory within 48 KB. Anything else
// returns cudaErrorInvalidValue without launching.
extern "C" int maj_n_launch(const void* x, void* out, int n, long long w,
                            int threshold, int groups, int tile,
                            void* stream) {
  if (n < 1 || n > 65535 || threshold < 1 || threshold > n || w < 0 ||
      groups < 1 || groups > n || tile < VEC || tile % VEC != 0 ||
      (long long)(tile / VEC) * groups > MAX_THREADS)
    return (int)cudaErrorInvalidValue;
  int k = 0;
  while ((n >> k) != 0) ++k;  // bit_length(n)
  const uint32_t init = (1u << k) - (uint32_t)threshold;
  if (w == 0) return (int)cudaGetLastError();
  cudaStream_t s = (cudaStream_t)stream;
  switch (k) {
    case 1: return launch<1>(x, out, n, w, groups, tile, init, s);
    case 2: return launch<2>(x, out, n, w, groups, tile, init, s);
    case 3: return launch<3>(x, out, n, w, groups, tile, init, s);
    case 4: return launch<4>(x, out, n, w, groups, tile, init, s);
    case 5: return launch<5>(x, out, n, w, groups, tile, init, s);
    case 6: return launch<6>(x, out, n, w, groups, tile, init, s);
    case 7: return launch<7>(x, out, n, w, groups, tile, init, s);
    case 8: return launch<8>(x, out, n, w, groups, tile, init, s);
    case 9: return launch<9>(x, out, n, w, groups, tile, init, s);
    case 10: return launch<10>(x, out, n, w, groups, tile, init, s);
    case 11: return launch<11>(x, out, n, w, groups, tile, init, s);
    case 12: return launch<12>(x, out, n, w, groups, tile, init, s);
    case 13: return launch<13>(x, out, n, w, groups, tile, init, s);
    case 14: return launch<14>(x, out, n, w, groups, tile, init, s);
    case 15: return launch<15>(x, out, n, w, groups, tile, init, s);
    default: return launch<16>(x, out, n, w, groups, tile, init, s);
  }
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
