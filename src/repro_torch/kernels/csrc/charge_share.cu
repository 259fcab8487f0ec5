// Charge-sharing bitline deviation for Hopper (sm_90a):
//
//   dV[p, b] = sum_i C[i, b] * (V[p, i, b] - VDD/2) / (C_bl + sum_i C[i, b])
//
// Replaces the TPU kernel repro/kernels/charge_share.py::charge_share (body
// _cs_kernel), the inner loop of the analog Monte-Carlo behind calibrate()
// (repro/core/analog.py::bitline_deviation). V is [P, N, B] float32 (P
// input patterns over the same bitlines), C is [N, B] float32 and shared by
// the P patterns, the output is [P, B] float32. The plain version is
// repro_torch/kernels/ref.py::charge_share.
//
// What bounds it on this card: device-memory bytes. Each output costs
// 2N + 1 flops against 4(N + 1) bytes of V and out (C is re-read by each
// pattern but is only N*B*4 bytes, 1/P of V, and stays in the 50 MB L2),
// so (P*N*B + N*B + P*B) * 4 bytes over 3.35 TB/s is the floor.
// Design: one thread per (pattern, bitline), the pattern on the grid's y
// axis (P <= 65535). Thread (p, b) walks the N <= 32
// rows of its column, accumulating numerator and denominator in two
// registers in row order, the order of the Pallas kernel (the denominator
// starts at C_bl). Neighbouring threads take neighbouring bitlines, so each
// row's load is one coalesced 128-byte transaction per warp. A ragged B
// needs no padding: the last block masks its tail.

#include <cuda_runtime.h>

namespace {

__global__ void __launch_bounds__(256)
charge_share_kernel(const float* __restrict__ v, const float* __restrict__ caps,
                    float* __restrict__ out, int n_rows,
                    long long n_bitlines, float half_vdd, float c_bl) {
  const long long b = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= n_bitlines) return;
  const long long p = blockIdx.y;
  const float* vp = v + p * n_rows * n_bitlines + b;
  const float* cp = caps + b;
  float num = 0.0f;
  float den = c_bl;
  for (int i = 0; i < n_rows; ++i) {
    const float c = __ldg(cp + (long long)i * n_bitlines);
    num += c * (__ldg(vp + (long long)i * n_bitlines) - half_vdd);
    den += c;
  }
  out[p * n_bitlines + b] = num / den;
}

}  // namespace

extern "C" int charge_share_launch(const void* v, const void* caps, void* out,
                                   long long n_patterns, int n_rows,
                                   long long n_bitlines, float vdd, float c_bl,
                                   void* stream) {
  if (n_patterns > 0 && n_bitlines > 0) {
    const dim3 grid((unsigned)((n_bitlines + 255) / 256), (unsigned)n_patterns);
    charge_share_kernel<<<grid, 256, 0, (cudaStream_t)stream>>>(
        (const float*)v, (const float*)caps, (float*)out, n_rows, n_bitlines,
        0.5f * vdd, c_bl);
  }
  return (int)cudaGetLastError();
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
