"""Plain PyTorch reference of the decoder the cells serve, in float32.

A dense GQA decoder with QKV biases, rotary positions (the rotate-half
form), RMSNorm, a SwiGLU FFN and a tied or separate LM head.  Its
weights are the same f32 weights the benchmark hands the program,
quantized here once more as the configuration states: the attention and
FFN gate / up projections to 4-bit codes of the ``q4_0`` grid in (2, 16)
tiles with one f16 scale each, the FFN down projection to int8 in groups
of 32 along its input with one f16 scale each.  The KV cache is int8 in
(2 heads, 16 dims) tiles with f16 scales, as the configuration's pool
stores it.

``sequence_logits`` runs one prompt with its served tokens and returns
the logits at the positions that sampled them, with the semantics of the
served path: prompt positions attend over fresh keys and values (over
the stored, quantized ones for a cached prefix of ``cached`` tokens);
every served position attends over the stored ones, its own included.
A model whose dims carry ``windows`` (one per layer, 0 for full
attention) attends in each layer over its window only.

``act`` rounds every activation that enters a matrix product (the
control runs the reference so, one precision below the configuration's).
"""
from __future__ import annotations

import math

import torch

Q4_GRID = 8.0     # |q4_0| grid: integers -8 .. 7, scale = absmax / 8
Q8_MAX = 127.0


def _tile_scale(x: torch.Tensor, absmax: torch.Tensor, qmax: float):
    return torch.clamp_min((absmax / qmax).to(torch.float16).float(), 1e-8)


def q4_tile(w: torch.Tensor) -> torch.Tensor:
    """(K, N) f32 -> its 4-bit (2, 16)-tile dequantization, f32.  Nearest
    grid point, the lower one on an exact tie."""
    K, N = w.shape
    t = w.reshape(K // 2, 2, N // 16, 16)
    s = _tile_scale(t, t.abs().amax(dim=(1, 3), keepdim=True), Q4_GRID)
    codes = torch.clamp(torch.ceil(t / s - 0.5), -8, 7)
    return (codes * s).reshape(K, N)


def q8_groups(w: torch.Tensor, group: int = 32) -> torch.Tensor:
    """(K, N) f32 -> int8 groups of ``group`` along K, dequantized, f32."""
    K, N = w.shape
    t = w.reshape(K // group, group, N)
    s = _tile_scale(t, t.abs().amax(dim=1, keepdim=True), Q8_MAX)
    return (torch.clamp(torch.round(t / s), -127, 127) * s).reshape(K, N)


def kv_q8(x: torch.Tensor) -> torch.Tensor:
    """(..., H, D) f32 -> int8 in (2 heads, 16 dims) tiles per token,
    dequantized, f32 (one head per tile for an odd H)."""
    *lead, H, D = x.shape
    gr = 2 if H % 2 == 0 else 1
    gc = 16
    while D % gc:
        gc //= 2
    t = x.reshape(*lead, H // gr, gr, D // gc, gc)
    s = _tile_scale(t, t.abs().amax(dim=(-3, -1), keepdim=True), Q8_MAX)
    return (torch.clamp(torch.round(t / s), -127, 127) * s).reshape(x.shape)


def prepare(top: dict, layers) -> dict:
    """The dequantized f32 weights of a family's (top, layers): the
    non-layer leaves and an iterable of per-layer dicts, taken a layer
    at a time."""

    def layer(lay):
        a, f = lay["attn"], lay["ffn"]
        p = {"attn_norm": lay["attn_norm"]["scale"],
             "ffn_norm": lay["ffn_norm"]["scale"]}
        for name in ("wq", "wk", "wv", "wo"):
            p[name] = q4_tile(a[name]["w"])
            if "b" in a[name]:
                p[name + "_b"] = a[name]["b"]
        p["gate"] = q4_tile(f["gate"]["w"])
        p["up"] = q4_tile(f["up"]["w"])
        p["down"] = q8_groups(f["down"]["w"])
        return p

    head = top.get("lm_head", top["embedding"])["table"]
    return {"layers": list(map(layer, layers)),
            "table": top["embedding"]["table"], "head": head,
            "final_norm": top["final_norm"]["scale"]}


def rmsnorm(x, scale, eps):
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    half = x.shape[-1] // 2
    freq = torch.exp(-math.log(theta) * torch.arange(
        half, dtype=torch.float32, device=x.device) / half)
    ang = pos[:, None].float() * freq
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attend(q, k, v, kq, vq, n_prompt, cached, act, window=0):
    """q (T, Hq, D); k, v fresh and kq, vq stored, (T, Hkv, D); with a
    ``window`` > 0 a query sees only the ``window`` latest positions,
    its own included."""
    T, Hq, D = q.shape
    Hkv = k.shape[1]
    G = Hq // Hkv
    qh = act(q).reshape(T, Hkv, G, D).permute(1, 2, 0, 3)    # Hkv G T D

    def keys(x):
        return act(x).permute(1, 2, 0)[:, None]              # Hkv 1 D T

    i = torch.arange(T, device=q.device)[:, None]
    j = torch.arange(T, device=q.device)[None]
    stored = ((j < cached) & (i >= cached)) | (i >= n_prompt)
    s = torch.where(stored, qh @ keys(kq), qh @ keys(k)) / math.sqrt(D)
    hidden = (j > i) | (i - j >= window) if window > 0 else j > i
    s = s.masked_fill(hidden, float("-inf"))
    p = torch.softmax(s, dim=-1)

    def vals(x):
        return act(x).permute(1, 0, 2)[:, None]              # Hkv 1 T D

    o = (torch.where(stored, 0.0, p) @ vals(v)
         + torch.where(stored, p, 0.0) @ vals(vq))
    return o.permute(2, 0, 1, 3).reshape(T, Hq * D)


def _exact(x):
    return x


def sequence_logits(w: dict, model: dict, tokens: torch.Tensor,
                    n_prompt: int, cached: int, rows, act=_exact):
    """Logits (len(rows), V) f32 at sequence positions ``rows`` of one
    sequence ``tokens`` (T,) whose first ``n_prompt`` tokens are the
    prompt, the first ``cached`` of them served from stored KV."""
    hq, hkv, hd = model["n_heads"], model["n_kv_heads"], model["head_dim"]
    eps, theta = model["norm_eps"], model["rope_theta"]
    T = tokens.shape[0]
    pos = torch.arange(T, device=tokens.device)
    x = w["table"][tokens.long()].float()
    windows = model.get("windows") or [0] * len(w["layers"])
    for p, window in zip(w["layers"], windows):
        h = act(rmsnorm(x, p["attn_norm"], eps))

        def proj(name):
            y = h @ p[name]
            return y + p[name + "_b"] if name + "_b" in p else y

        q = rope(proj("wq").reshape(T, hq, hd), pos, theta)
        k = rope(proj("wk").reshape(T, hkv, hd), pos, theta)
        v = proj("wv").reshape(T, hkv, hd)
        o = _attend(q, k, v, kv_q8(k), kv_q8(v), n_prompt, cached, act,
                    window)
        x = x + act(o) @ p["wo"]
        h = act(rmsnorm(x, p["ffn_norm"], eps))
        g = torch.nn.functional.silu(h @ p["gate"]) * (h @ p["up"])
        x = x + act(g) @ p["down"]
    idx = torch.as_tensor(rows, device=x.device, dtype=torch.long)
    xo = act(rmsnorm(x[idx], w["final_norm"], eps))
    return xo @ w["head"].float().t()


def fp8_rows(x: torch.Tensor) -> torch.Tensor:
    """float8 e4m3 with one scale per row (absmax onto 448)."""
    s = torch.clamp_min(x.abs().amax(dim=-1, keepdim=True), 1e-12) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


def bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).float()


# the control's rounding, one precision below the configuration's
BELOW = {"bfloat16": fp8_rows, "float32": bf16}
