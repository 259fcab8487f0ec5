// Vertical-layout bit-serial add for Hopper (sm_90a): a, b [width, W] 32-bit
// bit-planes (plane j holds bit j of 32 elements per word) -> out [width, W]
// sum planes, modulo 2^width (the carry out of the top plane is dropped).
//
// Replaces the TPU kernel repro/kernels/bitserial_add.py::bitserial_add (body
// _add_kernel): the PuM full-adder loop of the chip model's bit-serial ALU
// (repro_torch/core/alu.py::BitSerialAlu.add) fused into one pass, with the
// carry in a register instead of a DRAM row (carry = MAJ3(a, b, carry), the
// paper's own carry identity). The plain version is
// repro_torch/kernels/ref.py::bitserial_add, bit-exact.
//
// What bounds it on this card: device-memory bytes, 3 * width * W * 4 (each
// plane word of a and b read once, each out word written once; about 5
// integer ops per word per plane, far under the op rate). Design: one thread
// per word column, coalesced across a warp (32 neighbouring words of a plane
// are one 128-byte transaction). Only the carry is serial: the planes are
// taken in chunks of CHUNK, whose 2 * CHUNK loads are all issued before the
// chunk's carry chain runs, so each thread keeps 2 * CHUNK loads in flight.
// A runtime width (any width >= 1) needs a single instantiation; a ragged W
// needs no padding (the grid masks its tail).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int CHUNK = 8;

__global__ void __launch_bounds__(256)
bitserial_add_kernel(const uint32_t* __restrict__ a,
                     const uint32_t* __restrict__ b,
                     uint32_t* __restrict__ out, int width, long long w) {
  const long long t = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= w) return;
  uint32_t carry = 0u;
  int j = 0;
  for (; j + CHUNK <= width; j += CHUNK) {
    uint32_t av[CHUNK], bv[CHUNK];
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      av[k] = __ldg(a + (long long)(j + k) * w + t);
      bv[k] = __ldg(b + (long long)(j + k) * w + t);
    }
#pragma unroll
    for (int k = 0; k < CHUNK; ++k) {
      const uint32_t axb = av[k] ^ bv[k];
      out[(long long)(j + k) * w + t] = axb ^ carry;
      carry = (av[k] & bv[k]) | (carry & axb);
    }
  }
  for (; j < width; ++j) {
    const uint32_t x = __ldg(a + (long long)j * w + t);
    const uint32_t y = __ldg(b + (long long)j * w + t);
    const uint32_t axb = x ^ y;
    out[(long long)j * w + t] = axb ^ carry;
    carry = (x & y) | (carry & axb);
  }
}

}  // namespace

// width >= 1, w >= 0; anything else returns cudaErrorInvalidValue without
// launching.
extern "C" int bitserial_add_launch(const void* a, const void* b, void* out,
                                    int width, long long w, void* stream) {
  if (width < 1 || w < 0) return (int)cudaErrorInvalidValue;
  if (w > 0) {
    const long long blocks = (w + 255) / 256;
    bitserial_add_kernel<<<(unsigned)blocks, 256, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)a, (const uint32_t*)b, (uint32_t*)out, width, w);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
