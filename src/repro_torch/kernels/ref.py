"""Plain PyTorch versions of the port's kernels (the semantics anchor).

* :func:`bit_transpose32` — the plain version of the bit-transpose kernel
  (``kernels/bit_transpose.py``);
* the vertical plane algebra (``plane_add``/``sub``/``mul``/``divmod``/
  ``popcount``/``reduce``) — the building blocks of the fused-program
  kernel's plain version (``fused_program.run_program_ref``) *and* of its
  CUDA source: the code generator traces these same functions over
  symbolic planes (``kernels/codegen.py``).

Lanes and planes are int32 tensors carrying unsigned 32-bit words
bit-for-bit (torch has no CPU ``>>`` on ``uint32``), so every logical right
shift is masked (:func:`lsr`). The plane algebra uses only ``& | ^ ~``,
which mean the same on signed and unsigned words.
"""

from __future__ import annotations

import torch


def s32(value: int) -> int:
    """An unsigned 32-bit constant as the signed int with the same bits
    (what an int32 tensor holds for it)."""
    value &= 0xFFFFFFFF
    return value - (1 << 32) if value >> 31 else value


def lsr(x: torch.Tensor, k: int) -> torch.Tensor:
    """Logical right shift of int32 words by a constant ``k`` in [0, 31]:
    torch's ``>>`` is arithmetic on signed lanes, so mask the sign fill."""
    if k == 0:
        return x
    return (x >> k) & ((1 << (32 - k)) - 1)


def bit_transpose32(x: torch.Tensor) -> torch.Tensor:
    """32x32 bit-matrix transpose (horizontal <-> vertical layout).

    x: [32, G] int32 — row k holds word k of G independent 32x32 tiles.
    Returns [32, G]: out[j] bit i == x[i] bit j (per tile).
    Hacker's Delight masked-swap network; the HD form transposes with both
    axes bit-reversed, so rows are loaded and stored in reversed order to
    obtain LSB-first semantics.
    """
    if x.dim() != 2 or x.shape[0] != 32:
        raise ValueError(f"expected a [32, G] tensor, got {tuple(x.shape)}")
    rows = [x[31 - k] for k in range(32)]
    m = 0x0000FFFF
    j = 16
    while j != 0:
        mask = s32(m)
        k = 0
        while k < 32:
            t = (rows[k] ^ lsr(rows[k + j], j)) & mask
            rows[k] = rows[k] ^ t
            rows[k + j] = rows[k + j] ^ (t << j)
            k = (k + j + 1) & ~j
        j >>= 1
        m = (m ^ (m << j)) & 0xFFFFFFFF if j else m
    return torch.stack(rows[::-1])


# --------------------------------------------------------------------- #
# Vertical-layout plane algebra (fused-program building blocks)
#
# A *value* is a list of ``width`` same-shaped bit planes (plane j = bit j
# of every element). The helpers use only & | ^ ~ on the planes, so the
# same code runs on int32 tensors (the plain version) and on the symbolic
# planes the CUDA code generator traces (kernels/codegen.py).
# --------------------------------------------------------------------- #


def _full_add(x, y, carry):
    """One full-adder plane step: (sum, carry-out); carry may be None
    (treated as zero without emitting ops)."""
    axb = x ^ y
    s = axb if carry is None else axb ^ carry
    c = x & y
    return s, (c if carry is None else c | (carry & axb))


def plane_add(a: list, b: list) -> list:
    """Ripple add, modulo 2^width (carry-out dropped)."""
    out, carry = [], None
    for x, y in zip(a, b):
        s, carry = _full_add(x, y, carry)
        out.append(s)
    return out


def plane_sub(a: list, b: list) -> tuple[list, object]:
    """Borrow-ripple subtract modulo 2^width. Returns (difference planes,
    final borrow plane) — the borrow is the unsigned a < b predicate."""
    out, borrow = [], None
    for x, y in zip(a, b):
        xxy = x ^ y
        out.append(xxy if borrow is None else xxy ^ borrow)
        nb = ~x & y
        borrow = nb if borrow is None else nb | (borrow & ~xxy)
    return out, borrow


def plane_popcount(planes: list) -> list:
    """Per-element popcount over ``planes`` (each a 1-bit vertical number):
    pairwise carry-save adder tree -> ceil(log2(n+1)) count planes."""
    nums = [[p] for p in planes]
    while len(nums) > 1:
        nxt = []
        for i in range(0, len(nums) - 1, 2):
            a, b = nums[i], nums[i + 1]
            out, carry = [], None
            for j in range(max(len(a), len(b))):
                x = a[j] if j < len(a) else None
                y = b[j] if j < len(b) else None
                if y is None:
                    x, y = y, x
                if x is None:  # single operand + carry: half add
                    if carry is None:
                        out.append(y)
                    else:
                        out.append(y ^ carry)
                        carry = y & carry
                else:
                    s, carry = _full_add(x, y, carry)
                    out.append(s)
            if carry is not None:
                out.append(carry)
            nxt.append(out)
        if len(nums) % 2:
            nxt.append(nums[-1])
        nums = nxt
    return nums[0]


def plane_reduce(planes: list, kind: str):
    """AND/OR/XOR fold across an element's planes -> one 0/1 plane."""
    acc = planes[0]
    for p in planes[1:]:
        acc = acc & p if kind == "and" else \
            acc | p if kind == "or" else acc ^ p
    return acc


def plane_mul(a: list, b: list) -> list:
    """Shift-add multiply modulo 2^width: for each set bit j of ``b`` add
    ``a << j`` into the accumulator, restricted to the planes that survive
    the modulo-2^width truncation."""
    width = len(a)
    acc = [x & b[0] for x in a]
    for j in range(1, width):
        partial = [x & b[j] for x in a[:width - j]]
        acc = acc[:j] + plane_add(acc[j:], partial)
    return acc


def divmod_step(rem: list, a_bit, b: list) -> tuple[object, list]:
    """One MSB-first restoring-division step: shift the partial remainder
    left one plane (tracking the bit shifted out of plane width-1 — if set,
    the remainder already exceeds any width-bit divisor), bring in the
    dividend bit ``a_bit``, and select per lane between the restored and
    the subtracted remainder with plane_sub's borrow as the
    ``remainder >= divisor`` predicate. Returns (quotient bit, remainder).
    """
    hi = rem[-1]                       # bit shifted out: rem >= 2**width
    rem = [a_bit] + rem[:-1]           # rem = (rem << 1) | dividend bit
    diff, borrow = plane_sub(rem, b)
    qbit = hi | ~borrow                # rem >= b  (per lane)
    return qbit, [(qbit & d) | (~qbit & r) for d, r in zip(diff, rem)]


def plane_divmod(a: list, b: list) -> tuple[list, list]:
    """Restoring long division on plane lists: (quotient, remainder).

    Division by zero follows the eager NumPy semantics the engine exposes
    (``x // 0 == 0`` and ``x % 0 == 0`` for unsigned ints): lanes whose
    divisor is zero are masked to zero in both outputs.
    """
    width = len(a)
    zero = a[0] ^ a[0]
    rem = [zero] * width
    quot: list = [None] * width
    for i in reversed(range(width)):
        quot[i], rem = divmod_step(rem, a[i], b)
    nonzero = plane_reduce(b, "or")    # per-lane divisor != 0 mask
    return ([q & nonzero for q in quot], [r & nonzero for r in rem])
