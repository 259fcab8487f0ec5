"""The port's kernels and the fused-program compiler around them.

Hand-written CUDA kernels, each with its plain PyTorch version beside it:

* ``bit_transpose`` — 32x32 bit-matrix transpose (``csrc/bit_transpose.cu``);
* ``codegen`` — the fused-program kernel, generated per program;
* ``maj_n`` — MAJ-N over packed planes (``csrc/maj_n.cu``), the replica
  vote of the reliability plane;
* ``charge_share`` — the bitline deviation of the analog Monte-Carlo
  (``csrc/charge_share.cu``).

``ops`` dispatches between kernel and plain version by the tensor's
device. Modules are imported by path; nothing here builds at import.
"""
