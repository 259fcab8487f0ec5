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
// is repro_torch/kernels/ref.py::maj_n_fast (and ref.maj_n, bit-exact).
//
// Algorithm (the Pallas kernel's): a K-bit bit-sliced counter per bit lane,
// K = bit_length(N), starts at 2^K - threshold; adding the N planes with a
// ripple of half adders, a lane whose count reaches the threshold carries
// out of the counter, and the OR of those carries is the majority plane.
// What bounds it on this card: device-memory bytes, (N + 1) * W * 4 (each
// plane word is read once, about 2K + 1 integer ops per word per plane, far
// under the op rate). Design: one thread per word column; K is a template
// parameter (1..16, so N reaches 65535), so the K counter planes are registers with compile-time
// indices; threads of a warp read 32 neighbouring words of each plane (one
// 128-byte transaction per plane). A ragged W needs no padding.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int K>
__global__ void __launch_bounds__(256)
maj_n_kernel(const uint32_t* __restrict__ x, uint32_t* __restrict__ out,
             int n, long long w, uint32_t init) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= w) return;
  uint32_t planes[K];
#pragma unroll
  for (int j = 0; j < K; ++j) planes[j] = ((init >> j) & 1u) ? 0xFFFFFFFFu : 0u;
  uint32_t overflow = 0u;
  for (int i = 0; i < n; ++i) {
    uint32_t carry = __ldg(x + (long long)i * w + t);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint32_t s = planes[j] ^ carry;
      carry &= planes[j];
      planes[j] = s;
    }
    overflow |= carry;
  }
  out[t] = overflow;
}

template <int K>
void launch(const void* x, void* out, int n, long long w, uint32_t init,
            cudaStream_t stream) {
  const long long blocks = (w + 255) / 256;
  maj_n_kernel<K><<<(unsigned)blocks, 256, 0, stream>>>(
      (const uint32_t*)x, (uint32_t*)out, n, w, init);
}

}  // namespace

// n in [1, 65535], threshold in [1, n]; anything else returns
// cudaErrorInvalidValue without launching.
extern "C" int maj_n_launch(const void* x, void* out, int n, long long w,
                            int threshold, void* stream) {
  if (n < 1 || n > 65535 || threshold < 1 || threshold > n)
    return (int)cudaErrorInvalidValue;
  int k = 0;
  while ((n >> k) != 0) ++k;  // bit_length(n)
  const uint32_t init = (1u << k) - (uint32_t)threshold;
  if (w > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
      case 1: launch<1>(x, out, n, w, init, s); break;
      case 2: launch<2>(x, out, n, w, init, s); break;
      case 3: launch<3>(x, out, n, w, init, s); break;
      case 4: launch<4>(x, out, n, w, init, s); break;
      case 5: launch<5>(x, out, n, w, init, s); break;
      case 6: launch<6>(x, out, n, w, init, s); break;
      case 7: launch<7>(x, out, n, w, init, s); break;
      case 8: launch<8>(x, out, n, w, init, s); break;
      case 9: launch<9>(x, out, n, w, init, s); break;
      case 10: launch<10>(x, out, n, w, init, s); break;
      case 11: launch<11>(x, out, n, w, init, s); break;
      case 12: launch<12>(x, out, n, w, init, s); break;
      case 13: launch<13>(x, out, n, w, init, s); break;
      case 14: launch<14>(x, out, n, w, init, s); break;
      case 15: launch<15>(x, out, n, w, init, s); break;
      default: launch<16>(x, out, n, w, init, s); break;
    }
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
