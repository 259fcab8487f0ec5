"""Roofline analysis: three-term model per (arch x shape).

The port's copy of ``repro.launch.roofline``. Consumes dry-run records
(``launch/dryrun.py`` JSONL) and produces the roofline table. The
analytic model is the reference's, term for term:

  * an ANALYTIC per-cell FLOPs/bytes model (exact layer arithmetic from
    the configs) gives the compute and memory terms; the dry run's own
    FLOP count is reported beside it as a cross-check ("hlo_flops_raw");
  * collective bytes come from a record's ``collectives`` census (the
    reference's post-SPMD HLO), the loop-body bucket multiplied by the
    cell's dominant loop trip count (the layer scan). The port's census
    (a DTensor trace, ``launch/dryrun.py``) traces every layer, so its
    loop-body bucket is 0 and the trip count multiplies nothing; a record
    without a census has a collective term of 0.

Terms (per device, with the card's constants below):
    compute_s    = analytic_FLOPs / (n_devices * PEAK_FLOPS)
    memory_s     = analytic_HBM_bytes_per_device / HBM_BW
    collective_s = (main + trip*region weighted bytes) / ICI_BW
"""

from __future__ import annotations

import argparse
import dataclasses
import json

from repro_torch.config.base import LM_SHAPES, get_config
from repro_torch.models.model import uniform_serving

# NVIDIA H100 80GB HBM3 (SXM) at its 700 W power limit, per card (NVIDIA's
# data sheet, dense rates). The reference's names carry TPU v5e values.
PEAK_FLOPS = 989.4e12      # bf16 tensor-core peak, FLOP/s
HBM_BW = 3.35e12           # device memory, bytes/s
# One 400 Gb/s NDR InfiniBand port per GPU, bytes/s: a 16x16 mesh of
# 8-GPU nodes crosses nodes on both axes, so the collective term is priced
# at the inter-node link, not at NVLink's 450 GB/s a direction.
ICI_BW = 50e9


# --------------------------------------------------------------------- #
# Analytic FLOPs model (forward, per token, per layer)
# --------------------------------------------------------------------- #

def _attn_flops_per_token(cfg, ctx: float) -> float:
    d = cfg.d_model
    if cfg.attn_free:
        return 0.0
    if cfg.attn_kind == "mla":
        dq, dkv = cfg.q_lora_rank, cfg.kv_lora_rank
        dn, dr, dv = (cfg.qk_nope_head_dim, cfg.qk_rope_head_dim,
                      cfg.v_head_dim)
        h = cfg.n_heads
        proj = (2 * d * dq + 2 * dq * h * (dn + dr)
                + 2 * d * (dkv + dr) + 2 * dkv * h * (dn + dv)
                + 2 * h * dv * d)
        attn = 2 * ctx * h * (dn + dr) + 2 * ctx * h * dv
        return proj + attn
    h, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    proj = 2 * d * dh * (h + 2 * hkv) + 2 * h * dh * d
    attn = 4 * ctx * h * dh  # scores + probs*V
    return proj + attn


def _ffn_flops_per_token(cfg) -> float:
    d = cfg.d_model
    if cfg.moe:
        f = cfg.moe_d_ff
        routed = cfg.top_k * 6 * d * f * cfg.capacity_factor
        shared = cfg.n_shared_experts * 6 * d * f
        return 2 * d * cfg.n_experts + routed + shared
    if cfg.d_ff:
        return 6 * d * cfg.d_ff
    return 0.0


def _ssm_flops_per_token(cfg) -> float:
    if not cfg.ssm:
        return 0.0
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n = cfg.ssm_state
    h = di // cfg.ssm_head_dim
    q = cfg.ssm_chunk
    proj = 2 * d * (2 * di + 2 * n + h) + 2 * di * d
    conv = 2 * cfg.ssm_conv_width * (di + 2 * n)
    # SSD: intra-chunk (C.B weights + weighted x) + state build/read.
    ssd = 2 * q * n + 2 * q * di + 4 * n * di
    return proj + conv + ssd


def _layer_flops_per_token(cfg, layer: int, ctx: float) -> float:
    from repro_torch.models.model import _window_schedule
    w = _window_schedule(cfg)[layer]
    lctx = min(ctx, float(w)) if w > 0 else ctx
    total = 0.0
    if cfg.hybrid_parallel:
        total += _attn_flops_per_token(cfg, lctx) + _ssm_flops_per_token(cfg)
    elif cfg.ssm:
        total += _ssm_flops_per_token(cfg)
    else:
        total += _attn_flops_per_token(cfg, lctx)
    if layer < cfg.first_dense_layers and cfg.moe:
        total += 6 * cfg.d_model * cfg.d_ff  # leading dense layer
    else:
        total += _ffn_flops_per_token(cfg)
    return total


def analytic_flops(arch: str, shape_name: str) -> float:
    """Global FLOPs for one step of the cell."""
    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    s, b = shape.seq_len, shape.global_batch
    if shape.kind == "train":
        tokens, ctx = b * s, s / 2
        mult = 3.0 + (1.0 if cfg.remat == "full" else 0.0)  # fwd+bwd+remat
        head = 2 * cfg.d_model * cfg.padded_vocab * tokens * 3.0
        enc = cfg.n_encoder_layers if cfg.encoder_decoder else 0
    elif shape.kind == "prefill":
        tokens, ctx = b * s, s / 2
        mult, head = 1.0, 0.0
        enc = cfg.n_encoder_layers if cfg.encoder_decoder else 0
    else:  # decode: one token, full cache context
        tokens, ctx = b * 1, float(s)
        mult = 1.0
        head = 2 * cfg.d_model * cfg.padded_vocab * tokens
        enc = 0
    per_tok = sum(_layer_flops_per_token(cfg, i, ctx)
                  for i in range(cfg.n_layers))
    if enc:
        per_tok += enc * (_attn_flops_per_token(cfg, ctx)
                          + 6 * cfg.d_model * cfg.d_ff)
    return per_tok * tokens * mult + head


def analytic_bytes_per_chip(arch: str, shape_name: str, n_dev: int,
                            msize: int = 16) -> float:
    """Dominant HBM traffic per chip per step (params/optimizer, caches,
    layer activations)."""
    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    s, b = shape.seq_len, shape.global_batch
    n = cfg.param_count()
    d, nl = cfg.d_model, cfg.n_layers
    if shape.kind == "train":
        fsdp = n * 12 / msize > 12e9
        shard = n_dev if fsdp else msize
        # fwd + remat reads of bf16 weights, fp32 grad write + AdamW
        # read/modify/write of params and both moments.
        param_traffic = (2 * 2 + 4 * 7) * n / shard
        tokens_local = b * s / (n_dev / msize)
        act = tokens_local * d * nl * 2 * 6  # rd+wr, fwd+bwd+remat
        return param_traffic + act
    # serving: bf16 params; TP-only unless huge
    serve_fsdp = n * 2 / msize > 12e9
    shard = n_dev if serve_fsdp else msize
    params_b = 2 * n / shard
    if shape.kind == "prefill":
        tokens_local = b * s / (n_dev / msize)
        act = tokens_local * d * nl * 2 * 3
        cache = _cache_bytes(cfg, b, s) / n_dev
        return params_b + act + cache
    # decode: read whole cache + params each step
    cache = _cache_bytes(cfg, b, s) / n_dev
    return params_b + 2 * cache / 2 + b * d * nl * 2 / n_dev


def _cache_bytes(cfg, b: int, max_len: int) -> float:
    from repro_torch.models.model import _window_schedule
    total = 0.0
    windows = _window_schedule(cfg)
    for i in range(cfg.n_layers):
        if not cfg.attn_free:
            if cfg.attn_kind == "mla":
                total += b * max_len * (cfg.kv_lora_rank
                                        + cfg.qk_rope_head_dim) * 2
            else:
                size = max_len if windows[i] == 0 else min(
                    max_len, int(windows[i]))
                total += 2 * b * size * cfg.n_kv_heads * \
                    cfg.resolved_head_dim * 2
        if cfg.ssm:
            di = cfg.ssm_expand * cfg.d_model
            h = di // cfg.ssm_head_dim
            total += b * h * cfg.ssm_state * cfg.ssm_head_dim * 4
    return total


def loop_trip(arch: str, shape_name: str) -> int:
    """Dominant while-loop trip count for region-collective correction."""
    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    n_scan = cfg.n_layers - cfg.first_dense_layers
    if shape.kind == "train":
        return n_scan
    if uniform_serving(cfg):
        return n_scan
    if shape.kind == "prefill":
        return max(1, shape.seq_len // 1024)  # chunked-attention scan
    return 1  # unrolled decode


# --------------------------------------------------------------------- #

@dataclasses.dataclass
class RooflinePoint:
    arch: str
    shape: str
    mesh: str
    compute_s: float
    memory_s: float
    collective_s: float
    model_flops: float
    analytic_flops_total: float
    hlo_flops_raw: float
    status: str = "ok"

    @property
    def dominant(self) -> str:
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        return max(terms, key=terms.get)

    @property
    def bound_s(self) -> float:
        return max(self.compute_s, self.memory_s, self.collective_s)

    @property
    def useful_ratio(self) -> float:
        """MODEL_FLOPS / analytic compiled FLOPs — remat/dispatch waste."""
        return (self.model_flops / self.analytic_flops_total
                if self.analytic_flops_total > 0 else 0.0)

    @property
    def roofline_fraction(self) -> float:
        """Useful-compute time / bound time: the score the perf loop
        maximizes."""
        if self.bound_s <= 0:
            return 0.0
        n_dev = 512 if self.mesh == "2x16x16" else 256
        useful_s = self.model_flops / (n_dev * PEAK_FLOPS)
        return useful_s / self.bound_s


def model_flops(arch: str, shape_name: str) -> float:
    """Classic estimator: train 6*N*D tokens; prefill 2*N*D; decode 2*N/tok
    (N = active params for MoE)."""
    cfg = get_config(arch)
    shape = LM_SHAPES[shape_name]
    n = cfg.active_param_count() if cfg.moe else cfg.param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def analyze_record(rec: dict) -> RooflinePoint:
    n_dev = rec.get("n_devices", 512 if rec["mesh"] == "2x16x16" else 256)
    af = analytic_flops(rec["arch"], rec["shape"])
    ab = analytic_bytes_per_chip(rec["arch"], rec["shape"], n_dev)
    coll = rec.get("collectives") or {}  # null where the census failed
    main_w = coll.get("total_weighted", 0.0) - coll.get("region_weighted", 0.0)
    region_w = coll.get("region_weighted", 0.0)
    coll_bytes = main_w + region_w * loop_trip(rec["arch"], rec["shape"])
    return RooflinePoint(
        arch=rec["arch"], shape=rec["shape"], mesh=rec["mesh"],
        compute_s=af / (n_dev * PEAK_FLOPS),
        memory_s=ab / HBM_BW,
        collective_s=coll_bytes / ICI_BW,
        model_flops=model_flops(rec["arch"], rec["shape"]),
        analytic_flops_total=af,
        hlo_flops_raw=rec.get("flops", -1.0),
        status=rec.get("status", "ok"),
    )


FIX_HINTS = {
    "compute": "cut recompute (remat policy) or raise per-chip tile "
               "efficiency (fusion, larger microbatch)",
    "memory": "keep weights/KV resident (TP split), bf16 caches, fuse "
              "elementwise chains, bigger attention blocks",
    "collective": "reshard (align TP with heads/latent), hierarchical DP "
                  "reduce, async overlap, int8 gradient compression",
}


def to_markdown(points: list) -> str:
    lines = [
        "| arch | shape | mesh | compute_s | memory_s | collective_s | "
        "dominant | MODEL_FLOPS | useful % | roofline frac | what moves it |",
        "|---|---|---|---|---|---|---|---|---|---|---|",
    ]
    for p in points:
        if p.status != "ok":
            lines.append(f"| {p.arch} | {p.shape} | {p.mesh} "
                         f"| - | - | - | FAILED | - | - | - | - |")
            continue
        lines.append(
            f"| {p.arch} | {p.shape} | {p.mesh} | {p.compute_s:.2e} | "
            f"{p.memory_s:.2e} | {p.collective_s:.2e} | {p.dominant} | "
            f"{p.model_flops:.2e} | {100*p.useful_ratio:.0f}% | "
            f"{100*p.roofline_fraction:.1f}% | {FIX_HINTS[p.dominant]} |")
    return "\n".join(lines)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("records", nargs="+", help="dry-run JSONL file(s)")
    ap.add_argument("--md", default=None)
    args = ap.parse_args()
    points = []
    for path in args.records:
        with open(path) as f:
            for line in f:
                rec = json.loads(line)
                if rec.get("status") == "ok" and "flops" in rec:
                    points.append(analyze_record(rec))
    md = to_markdown(points)
    print(md)
    if args.md:
        with open(args.md, "w") as f:
            f.write(md + "\n")


if __name__ == "__main__":
    main()
