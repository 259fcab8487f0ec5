"""Plain PyTorch versions of the port's kernels (the semantics anchor).

* :func:`bit_transpose32` — the plain version of the bit-transpose kernel
  (``kernels/bit_transpose.py``);
* the vertical plane algebra (``plane_add``/``sub``/``mul``/``divmod``/
  ``popcount``/``reduce``) — the building blocks of the fused-program
  kernel's plain version (``fused_program.run_program_ref``) *and* of its
  CUDA source: the code generator traces these same functions over
  symbolic planes (``kernels/codegen.py``);
* :func:`maj_n` / :func:`maj_n_fast` — the plain versions of the MAJ-N
  kernel (``kernels/maj_n.py``); :func:`maj_n_grouped` — its split into
  row groups, for the tests;
* :func:`charge_share` — the plain version of the charge-sharing kernel
  (``kernels/charge_share.py``);
* :func:`bitserial_add` — the plain version of the bit-serial add kernel
  (``kernels/bitserial_add.py``), the ripple add over plane stacks.

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


def _check_threshold(x: torch.Tensor, threshold: int) -> int:
    if x.dim() != 2:
        raise ValueError(f"expected [N, W] planes, got {tuple(x.shape)}")
    n = x.shape[0]
    if not 1 <= threshold <= n:
        raise ValueError(f"threshold {threshold} not in [1,{n}]")
    return n


def maj_n(x: torch.Tensor, threshold: int) -> torch.Tensor:
    """Packed-word majority: out bit = (popcount over N rows >= threshold).

    x: [N, W] int32 bit-planes. Returns [W] int32. The bit-unpacking
    oracle: counts every bit position separately.
    """
    _check_threshold(x, threshold)
    out = torch.zeros_like(x[0])
    for b in range(32):
        count = ((x >> b) & 1).sum(dim=0)
        out = out | ((count >= threshold).to(x.dtype) << b)
    return out


def maj_n_fast(x: torch.Tensor, threshold: int) -> torch.Tensor:
    """Bit-sliced carry-save form of :func:`maj_n` (the kernel's
    algorithm): a K-bit counter per bit lane, K = bit_length(N), starts at
    ``2^K - threshold``; after the N planes are added, the lanes whose
    count reached ``threshold`` have carried out of the counter, and the
    OR of those carries is the majority plane."""
    n = _check_threshold(x, threshold)
    k = max(1, n.bit_length())
    init = (1 << k) - threshold
    zero = torch.zeros_like(x[0])
    planes = [zero - 1 if (init >> j) & 1 else zero for j in range(k)]
    overflow = zero
    for i in range(n):
        carry = x[i]
        for j in range(k):
            t = planes[j] ^ carry
            carry = planes[j] & carry
            planes[j] = t
        overflow = overflow | carry
    return overflow


def _ripple_add(a: list, b: list) -> torch.Tensor:
    """``a += b`` on bit-sliced counters (planes LSB first), in place;
    returns the carry out of the top plane."""
    carry = torch.zeros_like(a[0])
    for j in range(len(a)):
        t = a[j] ^ b[j]
        a[j], carry = t ^ carry, (a[j] & b[j]) | (carry & t)
    return carry


def maj_n_grouped(x: torch.Tensor, threshold: int, groups: int
                  ) -> torch.Tensor:
    """:func:`maj_n_fast` as the CUDA kernel decomposes it: group g of
    ``groups`` counts planes ``[g*N//groups, (g+1)*N//groups)`` in its own
    K-bit counter (group 0's seeded with ``2^K - threshold``, the others
    at 0), the counters meet in the kernel's tree of ripple adders
    (stride 1, 2, 4, ...), and the result is the OR of every carry out of
    the top plane. Exact because ``init + count < 2^(K+1)`` carries out
    at most once (``csrc/maj_n.cu``)."""
    n = _check_threshold(x, threshold)
    if not 1 <= groups <= n:
        raise ValueError(f"groups {groups} not in [1,{n}]")
    k = max(1, n.bit_length())
    init = (1 << k) - threshold
    zero = torch.zeros_like(x[0])
    overflow = zero
    counters = []
    for g in range(groups):
        seed = init if g == 0 else 0
        planes = [zero - 1 if (seed >> j) & 1 else zero for j in range(k)]
        for i in range(g * n // groups, (g + 1) * n // groups):
            carry = x[i]
            for j in range(k):
                planes[j], carry = planes[j] ^ carry, planes[j] & carry
            overflow = overflow | carry
        counters.append(planes)
    s = 1
    while s < groups:
        for g in range(0, groups - s, 2 * s):
            overflow = overflow | _ripple_add(counters[g], counters[g + s])
        s *= 2
    return overflow


def charge_share(v: torch.Tensor, caps: torch.Tensor, *, vdd: float,
                 c_bl: float) -> torch.Tensor:
    """Bitline deviation ``sum_i C_i (V_i - VDD/2) / (C_bl + sum_i C_i)``.

    v: [N, B] or [P, N, B] float32 cell voltages, caps: [N, B] float32
    cell capacitances (shared by the P patterns). Returns [B] or [P, B].
    """
    num = (caps * (v - 0.5 * vdd)).sum(dim=-2)
    den = c_bl + caps.sum(dim=0)
    return num / den


def multi_row_broadcast(src: torch.Tensor, n: int) -> torch.Tensor:
    """Multi-RowInit dataplane: one row plane -> n identical planes (a
    broadcast view, as the reference's ``jnp.broadcast_to``)."""
    return src[None].expand((n,) + tuple(src.shape))


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


def bitserial_add(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Vertical-layout ripple add: a, b [width, W] int32 bit-planes ->
    [width, W] sum planes modulo 2^width. The carry runs across planes:
    the PuM full-adder loop (``core/alu.py``) fused into one pass, carry =
    MAJ3(a, b, carry), the paper's own carry identity."""
    if a.shape != b.shape:
        raise ValueError("shape mismatch")
    if a.dim() != 2 or a.shape[0] < 1:
        raise ValueError(f"expected [width >= 1, W] planes, got "
                         f"{tuple(a.shape)}")
    return torch.stack(plane_add(list(a), list(b)))


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
