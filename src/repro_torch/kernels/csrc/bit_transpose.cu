// 32x32 bit-matrix transpose of G independent tiles (horizontal <->
// vertical lane layout) for Hopper (sm_90a).
//
// Replaces the TPU kernel repro/kernels/bit_transpose.py::bit_transpose32
// (body _transpose_kernel). Input and output are [32, G] row-major 32-bit
// words: row k holds word k of each of the G tiles; out[j] bit i of a tile
// == x[i] bit j. The masked-swap network is Hacker's Delight 7-3; rows are
// loaded and stored in reversed order, which turns the network's
// bit-reversed transpose into the LSB-first one (the plain version is
// repro_torch/kernels/ref.py::bit_transpose32).
//
// What bounds it on this card: device-memory bytes. Each tile is read once
// and written once (256 bytes) for 80 register-only swap steps (~5 integer
// ops each), far below the card's op rate; 2M lanes move 16 MiB.
// Design: one thread per tile. Thread g loads x[k][g] for k = 0..31, so
// the 32 threads of a warp read 32 neighbouring words of each row (one
// 128-byte transaction per row), runs the 5-stage network in 32
// registers with compile-time indices (no local memory), and stores the
// same way. A ragged G needs no padding: the last block masks its tail.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

template <int J, uint32_t M>
__device__ __forceinline__ void swap_stage(uint32_t (&r)[32]) {
#pragma unroll
  for (int k = 0; k < 32; ++k) {
    if ((k & J) == 0) {
      const uint32_t t = (r[k] ^ (r[k + J] >> J)) & M;
      r[k] ^= t;
      r[k + J] ^= t << J;
    }
  }
}

__global__ void __launch_bounds__(256)
bit_transpose32_kernel(const uint32_t* __restrict__ x,
                       uint32_t* __restrict__ out, long long g) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= g) return;
  uint32_t r[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) r[k] = __ldg(x + (long long)(31 - k) * g + t);
  swap_stage<16, 0x0000FFFFu>(r);
  swap_stage<8, 0x00FF00FFu>(r);
  swap_stage<4, 0x0F0F0F0Fu>(r);
  swap_stage<2, 0x33333333u>(r);
  swap_stage<1, 0x55555555u>(r);
#pragma unroll
  for (int k = 0; k < 32; ++k) out[(long long)k * g + t] = r[31 - k];
}

}  // namespace

extern "C" int bit_transpose32_launch(const void* x, void* out, long long g,
                                      void* stream) {
  if (g > 0) {
    const long long blocks = (g + 255) / 256;
    bit_transpose32_kernel<<<(unsigned)blocks, 256, 0,
                             (cudaStream_t)stream>>>(
        (const uint32_t*)x, (uint32_t*)out, g);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
