"""Real-world application kernels on the PuM engine (paper Appendix B, Fig 20).

The port's copy of ``repro.core.realworld``. Each kernel returns
(result, pum_latency_ms, cpu_latency_ms): results are verified against
direct NumPy inside the kernel; the PuM latency comes from the device's
cost plane, the CPU number is the measured NumPy wall time on this host (a
*context* number — the paper measured a Skylake with AVX-512).

Kernels consume the public :mod:`repro_torch.pum` API: each takes a
:class:`~repro_torch.pum.Device` (a ``PulsarEngine`` is coerced via
``pum.as_device``) and computes through ``PumArray`` operators. Every
kernel runs unchanged on an eager (``fuse=False``) or fused
(``fuse=True``) device, on the CPU or a CUDA card, and produces identical
results and EngineStats: the packed-bitmap set intersections (BMI/TC/KCS)
route through the raw planewise path (64-bit words split into two 32-bit
dataplane lanes), the arithmetic kernels (BW/KNN/IMS) through the
value-mode fused ISA.

Kernels (paper's nine, the bitwise-dominated seven implemented end-to-end;
the two XNOR-CNNs are modeled at op-count level — their conv loops reduce to
XNOR+popcount+add on the same primitives):
  BMI  — bitmap-index query: users active on all of the past D days,
  BW   — BitWeaving scan: count elements with c1 <= v <= c2,
  TC   — triangle counting on bit-packed adjacency,
  KCS  — k-clique-star set intersections,
  KNN  — quantized-L2 k-nearest-neighbour distance sweep,
  IMS  — image segmentation by per-pixel nearest color,
  XNOR — binarized conv layer (XNOR + popcount) op-count model.
"""

from __future__ import annotations

import time

import numpy as np

from repro_torch.core.engine import _vec_popcount
from repro_torch.pum import Device, as_device


def _timed(fn):
    t0 = time.perf_counter()
    out = fn()
    return out, (time.perf_counter() - t0) * 1e3


def bmi_active_users(dev: Device, daily_bitmaps: np.ndarray,
                     verify: bool = True) -> tuple[int, float, float]:
    """daily_bitmaps: [days, n_users/64] packed uint64. Query: how many users
    were active every day (Fig 20's BMI query). With ``verify=False`` the
    NumPy oracle and the assertion are skipped and cpu_ms reads 0.0 —
    benchmark harnesses verify once, then time the device path alone."""
    dev = as_device(dev)
    days = daily_bitmaps.shape[0]

    def cpu():
        acc = daily_bitmaps[0]
        for d in range(1, days):
            acc = acc & daily_bitmaps[d]
        return int(_vec_popcount(acc).sum())

    want, cpu_ms = _timed(cpu) if verify else (None, 0.0)
    dev.reset_stats()
    acc = dev.asarray(daily_bitmaps[0])
    for d in range(1, days):
        acc = acc & daily_bitmaps[d]
    # Popcount over the 64-bit words' planes (bit-serial adder tree) runs
    # on-device — on a fused device it joins the AND chain in the single
    # compiled pass — and charges the same cost-plane row either way; the
    # host only sums the per-word counts.
    got = int(acc.popcount(width=64).to_numpy().sum())
    if verify:
        assert got == want
    return got, dev.latency_ms, cpu_ms


def bitweaving_scan(dev: Device, column: np.ndarray, c1: int,
                    c2: int) -> tuple[int, float, float]:
    """select count(*) from T where c1 <= col <= c2 (BitWeaving [62])."""
    dev = as_device(dev)

    def cpu():
        return int(((column >= c1) & (column <= c2)).sum())

    want, cpu_ms = _timed(cpu)
    dev.reset_stats()
    col = dev.asarray(column)
    # Strict-compare sentinels (c1-1 < v < c2+1) with the trivially-true
    # bounds short-circuited: c1 == 0 would underflow the lower sentinel
    # to 2**64-1 and a c2 at the width max would overflow the upper one
    # out of width — in both cases the predicate is always true and a
    # real scan would skip the compare pass entirely.
    ge = dev.asarray(np.ones_like(column)) if c1 <= 0 \
        else np.full_like(column, c1 - 1) < col
    le = dev.asarray(np.ones_like(column)) \
        if c2 >= (1 << dev.width) - 1 \
        else col < np.full_like(column, c2 + 1)
    both = ge & le
    dev.charge("popcount", both.size, n_planes=1)
    got = int(both.sum())
    assert got == want
    return got, dev.latency_ms, cpu_ms


def triangle_count(dev: Device, adj_bits: np.ndarray
                   ) -> tuple[int, float, float]:
    """adj_bits: [n, n] {0,1} adjacency (undirected, no self-loops).
    Triangles = sum_{u<v, (u,v) in E} |N(u) & N(v)| / 3 via bitwise AND of
    packed adjacency rows (set-centric SISA style [10])."""
    dev = as_device(dev)
    n = adj_bits.shape[0]
    packed = np.packbits(adj_bits, axis=1, bitorder="little")
    packed64 = np.zeros((n, (packed.shape[1] + 7) // 8 * 8), np.uint8)
    packed64[:, :packed.shape[1]] = packed
    packed64 = packed64.view(np.uint64)

    def cpu():
        tot = 0
        for u in range(n):
            for v in range(u + 1, n):
                if adj_bits[u, v]:
                    tot += int(_vec_popcount(packed64[u] & packed64[v]).sum())
        return tot // 3

    want, cpu_ms = _timed(cpu)
    dev.reset_stats()
    tot = 0
    edges = [(u, v) for u in range(n) for v in range(u + 1, n)
             if adj_bits[u, v]]
    for u, v in edges:
        inter = dev.asarray(packed64[u]) & packed64[v]
        dev.charge("popcount", inter.size, n_planes=64)
        tot += int(_vec_popcount(inter.to_numpy()).sum())
    got = tot // 3
    assert got == want
    return got, dev.latency_ms, cpu_ms


_KCS_MEMO: dict = {}


def _kcs_operands(adj_bits: np.ndarray, cliques: list[tuple[int, ...]]):
    """Packed adjacency rows plus, for uniform-k clique lists, one stacked
    operand per clique position (the j-th members' rows concatenated across
    all cliques). Memoized per (adjacency, clique list): repeat calls return
    the *same* arrays, so the engine's pointer+fingerprint leaf cache serves
    the already-uploaded device buffers with zero bytes staged. The memo
    holds strong references to its keys (ids stay valid) and samples the
    adjacency contents like the engine's leaf fingerprint, so an in-place
    rewrite of the adjacency invalidates the entry; mutating the clique
    *list* in place between calls is outside the contract."""
    key = (adj_bits.__array_interface__["data"][0], adj_bits.shape,
           id(cliques))
    hit = _KCS_MEMO.get(key)
    if (hit is not None and hit[0] is adj_bits and hit[1] is cliques
            and np.array_equal(adj_bits.ravel()[hit[2]], hit[3])):
        return hit[4], hit[5]
    n = adj_bits.shape[0]
    packed = np.packbits(adj_bits, axis=1, bitorder="little")
    pad = np.zeros((n, (packed.shape[1] + 7) // 8 * 8), np.uint8)
    pad[:, :packed.shape[1]] = packed
    rows = pad.view(np.uint64)
    k = len(cliques[0]) if cliques else 0
    stacks = None
    if k and all(len(cl) == k for cl in cliques):
        idx = np.asarray(cliques, dtype=np.intp)
        stacks = tuple(rows[idx[:, j]].reshape(-1) for j in range(k))
    flat = adj_bits.ravel()
    fp_idx = np.linspace(0, flat.size - 1,
                         min(flat.size, 257)).astype(np.int64)
    if len(_KCS_MEMO) >= 4:
        _KCS_MEMO.clear()
    _KCS_MEMO[key] = (adj_bits, cliques, fp_idx, flat[fp_idx].copy(),
                      rows, stacks)
    return rows, stacks


def kclique_star(dev: Device, adj_bits: np.ndarray,
                 cliques: list[tuple[int, ...]],
                 verify: bool = True) -> tuple[int, float, float]:
    """Count vertices adjacent to every member of each k-clique (the star
    extension step of KCS [10]): AND-reduce clique members' adjacency rows.

    Uniform-k clique lists run PULSAR-style as one bulk program: the j-th
    members' rows are stacked into a single operand per clique position and
    the k-1 ANDs execute over all cliques at once (a single flush on a
    fused device); the stacks are memoized (see :func:`_kcs_operands`) so
    repeat calls are pointer-stable and hit the leaf cache. Ragged clique
    lists fall back to the per-clique loop. With ``verify=False`` the NumPy
    oracle and assertion are skipped and cpu_ms reads 0.0."""
    dev = as_device(dev)
    rows, stacks = _kcs_operands(adj_bits, cliques)

    def cpu():
        tot = 0
        for cl in cliques:
            acc = rows[cl[0]]
            for v in cl[1:]:
                acc = acc & rows[v]
            tot += int(_vec_popcount(acc).sum())
        return tot

    want, cpu_ms = _timed(cpu) if verify else (None, 0.0)
    dev.reset_stats()
    if stacks is not None:
        acc = dev.asarray(stacks[0])
        for s in stacks[1:]:
            acc = acc & s
        got = int(acc.popcount(width=64).to_numpy().sum())
    else:
        tot = 0
        for cl in cliques:
            acc = dev.asarray(rows[cl[0]])
            for v in cl[1:]:
                acc = acc & rows[v]
            tot += int(acc.popcount(width=64).to_numpy().sum())
        got = tot
    if verify:
        assert got == want
    return got, dev.latency_ms, cpu_ms


def knn_distances(dev: Device, queries: np.ndarray,
                  refs: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Quantized (8-bit) squared-L2 distances, kNN front half: for each query
    compute distances to all refs; argmin on host (as in the paper, the
    host reads back and selects)."""
    dev = as_device(dev)
    q = queries.astype(np.int64)
    r = refs.astype(np.int64)

    def cpu():
        return (((q[:, None, :] - r[None, :, :]) ** 2).sum(-1)).argmin(1)

    want, cpu_ms = _timed(cpu)
    dev.reset_stats()
    n_q, n_r, f = q.shape[0], r.shape[0], r.shape[1]
    dists = np.zeros((n_q, n_r), np.uint64)
    for j in range(f):
        a = np.repeat(q[:, j], n_r)
        b = np.tile(r[:, j], n_q)
        d = dev.asarray(a.astype(np.uint64)) - b.astype(np.uint64)
        # |a-b|^2 == ((a-b) mod 2^w)^2 mod 2^w needs sign handling; engine
        # works mod 2^width — use the identity (a-b)^2 = (b-a)^2 and mask.
        d2 = d * d
        dists += d2.reshape(n_q, n_r)
    got = dists.argmin(1)
    np.testing.assert_array_equal(got, want)
    return got, dev.latency_ms, cpu_ms


def image_segmentation(dev: Device, img: np.ndarray,
                       colors: np.ndarray) -> tuple[np.ndarray, float, float]:
    """Assign each pixel the nearest of C colors (1-D intensity model,
    per-pixel |p - c| compare network), PuM-side compares + mux."""
    dev = as_device(dev)
    p = img.ravel().astype(np.int64)

    def cpu():
        return np.abs(p[:, None] - colors[None, :].astype(np.int64)).argmin(1)

    want, cpu_ms = _timed(cpu)
    dev.reset_stats()
    # Width-max sentinel (not uint64-max): distances are in-width values,
    # so the compare network works identically on eager and fused devices.
    best = np.full(p.shape, (1 << dev.width) - 1, np.uint64)
    label = np.zeros(p.shape, np.uint64)
    pix = dev.asarray(p.astype(np.uint64))
    for ci, c in enumerate(colors):
        cvec = np.full_like(best, c)
        d1 = pix - cvec
        d2 = dev.asarray(cvec) - pix
        mask_neg = dev.asarray(np.full_like(best, int(c))) < pix
        d = np.where(mask_neg.astype(bool), np.asarray(d1), np.asarray(d2))
        better = dev.asarray(d) < best
        best = np.where(better.astype(bool), d, best)
        label = np.where(better.astype(bool), ci, label)
    np.testing.assert_array_equal(label, want)
    return label, dev.latency_ms, cpu_ms


def xnor_conv_cost(dev: Device, in_ch: int, out_ch: int,
                   kh: int, kw: int, oh: int, ow: int) -> float:
    """Op-count latency model of one binarized conv layer (XNOR-Net [92]):
    per output: XNOR over in_ch*kh*kw bits + popcount + sign. Returns ms."""
    dev = as_device(dev)
    dev.reset_stats()
    n_out = out_ch * oh * ow
    bits = in_ch * kh * kw
    dev.charge("xor2", n_out)                   # fused XNOR plane op
    dev.charge("popcount", n_out, n_planes=min(bits, 64))
    dev.charge("compare", n_out, width=16)
    return dev.latency_ms
