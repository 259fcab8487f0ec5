"""The port's kernels and the fused-program compiler around them.

Two hand-written CUDA kernels carry the fused flush on the GPU, each with
its plain PyTorch version beside it:

* ``bit_transpose`` — 32x32 bit-matrix transpose (``csrc/bit_transpose.cu``);
* ``codegen`` — the fused-program kernel, generated per program.

``ops`` dispatches between kernel and plain version by the tensor's
device. Modules are imported by path; nothing here builds at import.
"""
