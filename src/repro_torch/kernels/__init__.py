"""The port's kernels and the fused-program compiler around them.

Hand-written CUDA kernels, each with its plain PyTorch version beside it:

* ``bit_transpose`` — 32x32 bit-matrix transpose (``csrc/bit_transpose.cu``);
* ``codegen`` — the fused-program kernel, generated per program;
* ``maj_n`` — MAJ-N over packed planes (``csrc/maj_n.cu``), the replica
  vote of the reliability plane and the chip model's charge sharing;
* ``bitserial_add`` — the vertical ripple add (``csrc/bitserial_add.cu``);
* ``charge_share`` — the bitline deviation of the analog Monte-Carlo
  (``csrc/charge_share.cu``).

``ops`` dispatches between kernel and plain version by the tensor's
device; nothing is built at import. The package exports the dispatch
surface of the reference's ``repro.kernels``: ``bit_transpose32``,
``bitserial_add``, ``run_fused_program``, ``FusedOp``, ``FusedProgram`` and
``get_pipeline``. ``maj_n`` and ``charge_share`` name the kernel modules
here; their dispatchers are ``ops.maj_n`` and ``ops.charge_share``. (The
``bitserial_add`` module is reached by its full path,
``from repro_torch.kernels.bitserial_add import ...``.)
"""

from repro_torch.kernels.fused_program import (FusedOp, FusedProgram,  # noqa: F401
                                               get_pipeline)
from repro_torch.kernels.ops import (bit_transpose32, bitserial_add,  # noqa: F401
                                    run_fused_program)
