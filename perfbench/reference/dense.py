"""Plain float32 reference of a dense GQA decoder (Qwen2 / Qwen3): its
logits, its training loss and gradients, and AdamW.

Written from the published architecture (``configs/*.json``): pre-norm
RMSNorm with the published eps; attention with optional q/k/v biases
and optional RMSNorm of each query and key head before RoPE (rotate-half
convention, ``rope_theta``); grouped KV heads, head ``h`` reading KV head
``h // (heads / kv_heads)``; causal softmax at ``1 / sqrt(head_dim)``;
SwiGLU MLP; the LM head over the real vocabulary, tied to the embedding
or not. Weights are read from the benchmark's parameter tree (the
layout the port also takes: ``wq [d, H, dh]``, ``wo [H, dh, d]``,
``w_down [d_ff, d]``, layers stacked on a leading axis) one layer at a
time and computed in float32 with TF32 off, so a 32B model fits beside
its bfloat16 weights.

``precision="fp8"`` is the control: every matrix product's two inputs
rounded to float8 e4m3 with one scale a tensor (products accumulate in
float32), the step below the bfloat16 the configurations state.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

E4M3_MAX = 448.0


def strict_fp32() -> None:
    """float32 products stay float32 (no TF32 on the card)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def fp8(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to e4m3 at one scale for the tensor; the gradient
    passes straight through."""
    scale = x.detach().abs().amax().clamp(min=1e-30) / E4M3_MAX
    y = (x.detach() / scale).to(torch.float8_e4m3fn).to(torch.float32) * scale
    return x + (y - x).detach()


def mm(x: torch.Tensor, w: torch.Tensor, precision: str) -> torch.Tensor:
    if precision == "fp8":
        x, w = fp8(x), fp8(w)
    return x @ w


def rms_norm(x, w, eps):
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: [T, H, dh] at positions 0..T-1."""
    t, _, dh = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dh, 2, dtype=torch.float64,
                                        device=x.device) / dh))
    ang = torch.arange(t, dtype=torch.float64, device=x.device)[:, None] * inv
    cos = torch.cos(ang).float()[:, None, :]
    sin = torch.sin(ang).float()[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def layer_weights(params: dict, l: int, device=None) -> dict:
    """Layer ``l``'s leaves as float32 tensors (flat names)."""
    lay = params["layers"]
    out = {"ln1": lay["ln1"]["scale"][l], "ln2": lay["ln2"]["scale"][l]}
    out.update({k: v[l] for k, v in lay["attn"].items()})
    out.update({k: v[l] for k, v in lay["mlp"].items()})
    return {k: v.to(device=device, dtype=torch.float32) for k, v in out.items()}


def layer(a: dict, w: dict, x: torch.Tensor, precision: str = "fp32"
          ) -> torch.Tensor:
    """One decoder layer over one sequence ``x`` [T, d]."""
    t, d = x.shape
    hq, hkv, dh = a["heads"], a["kv_heads"], a["head_dim"]
    h = rms_norm(x, w["ln1"], a["eps"])
    q = mm(h, w["wq"].reshape(d, hq * dh), precision).reshape(t, hq, dh)
    k = mm(h, w["wk"].reshape(d, hkv * dh), precision).reshape(t, hkv, dh)
    v = mm(h, w["wv"].reshape(d, hkv * dh), precision).reshape(t, hkv, dh)
    if a["qkv_bias"]:
        q, k, v = q + w["bq"], k + w["bk"], v + w["bv"]
    if a["qk_norm"]:
        q = rms_norm(q, w["q_norm"], a["eps"])
        k = rms_norm(k, w["k_norm"], a["eps"])
    q, k = rope(q, a["rope_theta"]), rope(k, a["rope_theta"])
    g = hq // hkv
    k = k.repeat_interleave(g, dim=1)
    v = v.repeat_interleave(g, dim=1)
    qh, kh, vh = q.transpose(0, 1), k.transpose(0, 1), v.transpose(0, 1)
    scores = mm(qh, kh.transpose(1, 2), precision) / math.sqrt(dh)
    causal = torch.ones(t, t, dtype=torch.bool, device=x.device).tril()
    probs = torch.softmax(scores.masked_fill(~causal, float("-inf")), dim=-1)
    o = mm(probs, vh, precision).transpose(0, 1).reshape(t, hq * dh)
    x = x + mm(o, w["wo"].reshape(hq * dh, d), precision)
    h = rms_norm(x, w["ln2"], a["eps"])
    gate = mm(h, w["w_gate"], precision)
    up = mm(h, w["w_up"], precision)
    return x + mm(F.silu(gate) * up, w["w_down"], precision)


def head_weight(a: dict, params: dict) -> torch.Tensor:
    """The LM head's rows over the real vocabulary, as stored."""
    emb = params["embed"]
    w = emb["embedding"] if a["tied"] else emb["unembed"]
    return w[:a["vocab"]]


def logits_at(a: dict, params: dict, seqs: list[torch.Tensor],
              positions: list[torch.Tensor], precision: str = "fp32",
              vocab_block: int = 32768) -> list[torch.Tensor]:
    """Float32 logits [len(pos), vocab] of each sequence (int64 ids) at
    its ``positions``, computed one layer at a time over all sequences."""
    dev = seqs[0].device
    emb = params["embed"]["embedding"]
    xs = [emb[s].to(torch.float32) for s in seqs]
    with torch.no_grad():
        for l in range(a["layers"]):
            w = layer_weights(params, l, dev)
            xs = [layer(a, w, x, precision) for x in xs]
            del w
        fn = params["final_norm"]["scale"].to(dev, torch.float32)
        hs = [rms_norm(x[p], fn, a["eps"]) for x, p in zip(xs, positions)]
        del xs
        head = head_weight(a, params)
        out = [[] for _ in hs]
        for v0 in range(0, a["vocab"], vocab_block):
            wb = head[v0:v0 + vocab_block].to(dev, torch.float32).t()
            for i, h in enumerate(hs):
                out[i].append(mm(h, wb, precision))
        return [torch.cat(o, dim=1) for o in out]


# ---------------------------------------------------------------------- #
# Training
# ---------------------------------------------------------------------- #

def row_loss(a: dict, p: dict, row: torch.Tensor, z_loss: float,
             precision: str) -> torch.Tensor:
    """Next-token cross entropy of one row (``T + 1`` ids) plus
    ``z_loss`` times the mean squared log-partition, each a mean over the
    row's ``T`` positions. ``p``: flat float32 leaves, layers as lists."""
    inp, labels = row[:-1], row[1:]
    emb = p["embed.embedding"]
    x = emb[inp]
    for l in range(a["layers"]):
        w = {k: p[f"layers.{k}"][l] for k in LAYER_KEYS if f"layers.{k}" in p}
        x = checkpoint(lambda x, *vals, keys=tuple(w): layer(
            a, dict(zip(keys, vals)), x, precision),
            x, *w.values(), use_reentrant=False)
    h = rms_norm(x, p["final_norm.scale"], a["eps"])
    head = (emb if a["tied"] else p["embed.unembed"])[:a["vocab"]]
    logits = mm(h, head.t(), precision)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(1, labels[:, None])[:, 0]
    return (logz - gold).mean() + z_loss * (logz ** 2).mean()


LAYER_KEYS = ("ln1", "ln2", "wq", "wk", "wv", "wo", "bq", "bk", "bv",
              "q_norm", "k_norm", "w_gate", "w_up", "w_down")
TREE_NAMES = {"ln1": ("ln1", "scale"), "ln2": ("ln2", "scale"),
              "w_gate": ("mlp", "w_gate"), "w_up": ("mlp", "w_up"),
              "w_down": ("mlp", "w_down")}


def tree_path(flat: str) -> tuple:
    """The parameter tree's path of a flat reference name."""
    if flat.startswith("layers."):
        k = flat.split(".", 1)[1]
        return ("layers",) + TREE_NAMES.get(k, ("attn", k))
    return tuple(flat.split("."))


def flat_params(a: dict, leaves: dict) -> dict:
    """Trainable float32 copies of ``leaves`` (tree path -> stacked
    tensor): layer leaves as lists of per-layer tensors."""
    out = {}
    for path, t in leaves.items():
        if path[0] == "layers":
            name = "layers." + (path[2] if path[1] in ("attn", "mlp")
                                else path[1])
            out[name] = [t[l].detach().clone().float().requires_grad_()
                         for l in range(a["layers"])]
        else:
            out[".".join(path)] = t.detach().clone().float().requires_grad_()
    return out


def _tensors(p: dict) -> list[torch.Tensor]:
    out = []
    for v in p.values():
        out.extend(v if isinstance(v, list) else [v])
    return out


def leaf_norm(v) -> float:
    if isinstance(v, list):
        return math.sqrt(sum(float(torch.linalg.vector_norm(x)) ** 2
                             for x in v))
    return float(torch.linalg.vector_norm(v))


def lr_scale(step: int, warmup: int, total: int, floor: float = 0.1) -> float:
    """Linear warmup from 0, then cosine decay to ``floor`` (``step``
    counts the steps taken before this one)."""
    if step < warmup:
        return step / max(1.0, warmup)
    prog = min(max((step - warmup) / max(1.0, total - warmup), 0.0), 1.0)
    return floor + (1 - floor) * 0.5 * (1 + math.cos(math.pi * prog))


def adamw_(opt: dict, s: int, x, g, m, v) -> None:
    """AdamW's step ``s`` (counting from 0) of leaf ``x`` with gradient
    ``g`` and moments ``m``, ``v``, all updated in place."""
    b1, b2 = opt["beta1"], opt["beta2"]
    lr = opt["learning_rate"] * lr_scale(s, opt["warmup_steps"],
                                         opt["total_steps"])
    bc1, bc2 = 1 - b1 ** (s + 1), 1 - b2 ** (s + 1)
    m.mul_(b1).add_((1 - b1) * g)
    v.mul_(b2).add_((1 - b2) * g * g)
    upd = (m / bc1) / (torch.sqrt(v / bc2) + opt["eps"])
    x.sub_(lr * (upd + opt["weight_decay"] * x))


def train(a: dict, opt: dict, leaves: dict, batches: list[torch.Tensor],
          precision: str = "fp32", rows: slice = slice(None)) -> dict:
    """AdamW steps from ``leaves`` over ``batches`` ([B, T+1] each; the
    loss is the mean over ``rows`` of each): each step's loss; per tree
    leaf the first step's clipped gradient (``first``) and its norm, and
    the norm of the change after all steps."""
    p = flat_params(a, leaves)
    start = {k: ([x.detach().clone() for x in v] if isinstance(v, list)
                 else v.detach().clone()) for k, v in p.items()}
    params = _tensors(p)
    mu = [torch.zeros_like(x) for x in params]
    nu = [torch.zeros_like(x) for x in params]
    losses, first_grad = [], None
    for s, batch in enumerate(batches):
        picked = batch[rows]
        total = 0.0
        for row in picked:
            loss = row_loss(a, p, row, opt["z_loss"], precision) / len(picked)
            loss.backward()
            total += float(loss.detach())
        losses.append(total)
        with torch.no_grad():
            grads = [x.grad for x in params]
            norm = math.sqrt(sum(float(torch.sum(g * g)) for g in grads))
            clip = min(1.0, opt["grad_clip"] / (norm + 1e-9))
            grads = [g * clip for g in grads]
            if first_grad is None:
                it = iter(grads)
                first_grad = {k: (torch.stack([next(it) for _ in v])
                                  if isinstance(v, list) else next(it).clone())
                              for k, v in p.items()}
            for x, g, m, v in zip(params, grads, mu, nu):
                adamw_(opt, s, x, g, m, v)
                x.grad = None
    with torch.no_grad():
        change = {}
        for k, v in p.items():
            if isinstance(v, list):
                change[k] = leaf_norm([x - x0 for x, x0 in zip(v, start[k])])
            else:
                change[k] = leaf_norm(v - start[k])
    return {"losses": losses,
            "grad": {tree_path(k): leaf_norm(g) for k, g in first_grad.items()},
            "first": {tree_path(k): g for k, g in first_grad.items()},
            "change": {tree_path(k): n for k, n in change.items()}}
