"""GQA attention with RoPE, sliding-window masks, and KV-cache decode.

Entry points per layer:
  * ``attention``        — full-sequence (prefill), causal (+window)
  * ``attention_decode`` — one new token against a cached K/V history
Cross-attention (enc-dec) reuses ``attention`` with the encoder memory as
``kv_src`` and no causal mask.

The scores are computed as the reference computes them: f32 logits, the
``hd**-0.5`` scale, the optional softcap, a ``finfo(float32).min`` fill,
then softmax and a cast back to the compute dtype.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import nn

from .config import ModelConfig
from .layers import Linear, apply_rope, cdtype, linear, rope_angles

_F32_MIN = torch.finfo(torch.float32).min


class Attention(nn.Module):
    def __init__(self, cfg: ModelConfig, gen=None, device=None):
        super().__init__()
        hd, bias = cfg.head_dim, cfg.attn_qkv_bias
        self.q = Linear(cfg.d_model, cfg.n_heads * hd, cfg, gen, device, bias)
        self.k = Linear(cfg.d_model, cfg.n_kv_heads * hd, cfg, gen, device,
                        bias)
        self.v = Linear(cfg.d_model, cfg.n_kv_heads * hd, cfg, gen, device,
                        bias)
        self.o = Linear(cfg.n_heads * hd, cfg.d_model, cfg, gen, device)


def _split_heads(x: torch.Tensor, n: int, hd: int) -> torch.Tensor:
    return x.reshape(*x.shape[:-1], n, hd)


def _repeat_kv(k: torch.Tensor, groups: int) -> torch.Tensor:
    """(B, S, Hkv, hd) -> (B, S, Hkv*groups, hd) for GQA: each kv head
    repeated ``groups`` times in place (``jnp.repeat`` on axis 2)."""
    if groups == 1:
        return k
    B, S, H, hd = k.shape
    return k[:, :, :, None].expand(B, S, H, groups, hd).reshape(
        B, S, H * groups, hd)


def _causal_window_mask(q_len: int, kv_len: int, window: Optional[int],
                        q_offset: int = 0, device=None) -> torch.Tensor:
    """True = attend. q positions are offset (prefill continuation)."""
    qi = torch.arange(q_len, device=device)[:, None] + q_offset
    kj = torch.arange(kv_len, device=device)[None, :]
    mask = kj <= qi
    if window is not None:
        mask = mask & (kj > qi - window)
    return mask


def _scores(logits: torch.Tensor, valid: Optional[torch.Tensor],
            cfg: ModelConfig, hd: int) -> torch.Tensor:
    """f32 logits (B, H, S, T) -> probabilities; ``valid`` broadcasts."""
    logits = logits.float() * (hd ** -0.5)
    if cfg.attn_logit_softcap:
        c = cfg.attn_logit_softcap
        logits = c * torch.tanh(logits / c)
    if valid is not None:
        logits = torch.where(valid, logits, _F32_MIN)
    return torch.softmax(logits, dim=-1)


def _sdpa(q, k, v, mask, cfg: ModelConfig):
    """q: (B,S,H,hd) k/v: (B,T,H,hd); mask (S,T) or (B,S,T) or None."""
    if mask is not None:
        mask = mask[None, None] if mask.ndim == 2 else mask[:, None]
    logits = torch.einsum("bshd,bthd->bhst", q, k)
    probs = _scores(logits, mask, cfg, q.shape[-1]).to(q.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v)


# query-chunk size above which the S^2 logits are never materialized at once
_CHUNK_Q = 512


def _sdpa_chunked(q, k, v, cfg: ModelConfig, causal: bool,
                  window: Optional[int], chunk: int = _CHUNK_Q):
    """Query-chunked attention: O(chunk * T) live logits. Same math as
    ``_sdpa``, one chunk of queries at a time."""
    B, S, H, hd = q.shape
    T = k.shape[1]
    if S % chunk != 0 or S <= chunk:
        mask = (_causal_window_mask(S, T, window, device=q.device)
                if causal else None)
        return _sdpa(q, k, v, mask, cfg)
    out = []
    for off in range(0, S, chunk):
        mask = (_causal_window_mask(chunk, T, window, q_offset=off,
                                    device=q.device) if causal else None)
        out.append(_sdpa(q[:, off:off + chunk], k, v, mask, cfg))
    return torch.cat(out, dim=1)


def attention(p: Attention, x: torch.Tensor, cfg: ModelConfig,
              window: Optional[int] = None,
              kv_src: Optional[torch.Tensor] = None,
              causal: bool = True,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Full-sequence attention. kv_src enables cross-attention (no RoPE/mask)."""
    B, S, _ = x.shape
    hd = cfg.head_dim
    groups = cfg.n_heads // cfg.n_kv_heads
    src = x if kv_src is None else kv_src
    q = _split_heads(linear(p.q, x, cfg), cfg.n_heads, hd)
    k = _split_heads(linear(p.k, src, cfg), cfg.n_kv_heads, hd)
    v = _split_heads(linear(p.v, src, cfg), cfg.n_kv_heads, hd)
    if kv_src is None:  # self-attention: RoPE
        if positions is None:
            positions = torch.arange(S, device=x.device)[None, :]
        cos, sin = rope_angles(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos, sin)
        k = apply_rope(k, cos, sin)
    k = _repeat_kv(k, groups)
    v = _repeat_kv(v, groups)
    out = _sdpa_chunked(q, k, v, cfg, causal=causal, window=window)
    return linear(p.o, out.reshape(B, S, cfg.n_heads * hd), cfg)


# ------------------------------------------------------------ KV caching --

class LayerKVCache(NamedTuple):
    """Ring-buffer cache for one attention layer (window == capacity).

    int8 mode: k/v stored int8 with per-(B, slot, head) f32 absmax scales —
    half the bytes per decoded token of a bf16 cache.
    """
    k: torch.Tensor          # (B, W, Hkv, hd) compute dtype or int8
    v: torch.Tensor          # (B, W, Hkv, hd)
    k_scale: torch.Tensor    # (B, W, Hkv) f32; ones when not quantized
    v_scale: torch.Tensor


def init_layer_cache(cfg: ModelConfig, batch: int, capacity: int,
                     dtype=None, device=None) -> LayerKVCache:
    quant = cfg.kv_cache_dtype == "int8"
    dt = torch.int8 if quant else (dtype or cdtype(cfg))
    shape = (batch, capacity, cfg.n_kv_heads, cfg.head_dim)
    sshape = (batch, capacity, cfg.n_kv_heads)
    return LayerKVCache(
        k=torch.zeros(shape, dtype=dt, device=device),
        v=torch.zeros(shape, dtype=dt, device=device),
        k_scale=torch.ones(sshape, dtype=torch.float32, device=device),
        v_scale=torch.ones(sshape, dtype=torch.float32, device=device))


def _quantize_kv(x: torch.Tensor):
    """x (B, 1, Hkv, hd) -> (int8 values, (B, 1, Hkv) scales)."""
    xf = x.float()
    scale = torch.clamp_min(torch.amax(torch.abs(xf), dim=-1) / 127.0, 1e-10)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def _dequantize_kv(q: torch.Tensor, scale: torch.Tensor, dtype):
    return (q.float() * scale[..., None]).to(dtype)


def _ring(pos: torch.Tensor, W: int, window: Optional[int],
          cfg: ModelConfig):
    """What a decode step derives from the positions alone for a ring of W
    slots: the RoPE angles, each row's slot (pos % W) and the mask of the
    slots that hold positions in (pos - W, pos] (and inside ``window``)."""
    cos, sin = rope_angles(pos[:, None], cfg.head_dim, cfg.rope_theta)
    slot = torch.remainder(pos, W)                             # (B,)
    idx = torch.arange(W, device=pos.device)
    age = torch.remainder(slot[:, None] - idx[None, :], W)    # (B,W) 0=newest
    valid = age <= torch.clamp_max(pos, W - 1)[:, None]
    if window is not None:
        valid = valid & (age < window)
    rows = torch.arange(pos.shape[0], device=pos.device)
    return cos, sin, rows, slot, valid


def attention_decode(p: Attention, x: torch.Tensor, cache: LayerKVCache,
                     pos: torch.Tensor, cfg: ModelConfig,
                     window: Optional[int] = None, rings: Optional[dict] = None
                     ) -> tuple[torch.Tensor, LayerKVCache]:
    """One-token decode: x (B, 1, D), pos (B,) int per-batch-slot current
    index. Writes the new key and value into ``cache`` in place and returns
    it.

    The cache is a ring buffer of length W (= capacity for global layers,
    the sliding window for local layers): slot_b = pos_b % W. Positions are
    per batch element so a continuous-batching engine can run each slot's
    request from its own position 0 — the validity mask then hides
    whatever a previous occupant left in the ring. ``rings``, a dict one
    decode step shares across its layers, keeps what ``_ring`` derives
    from the positions for each (W, window), so it is made once a step.
    """
    B = x.shape[0]
    hd = cfg.head_dim
    groups = cfg.n_heads // cfg.n_kv_heads
    W = cache.k.shape[1]
    rings = {} if rings is None else rings
    if (W, window) not in rings:
        rings[W, window] = _ring(pos.long(), W, window, cfg)
    cos, sin, rows, slot, valid = rings[W, window]
    q = _split_heads(linear(p.q, x, cfg), cfg.n_heads, hd)     # (B,1,H,hd)
    k = _split_heads(linear(p.k, x, cfg), cfg.n_kv_heads, hd)
    v = _split_heads(linear(p.v, x, cfg), cfg.n_kv_heads, hd)
    q = apply_rope(q, cos, sin)
    k = apply_rope(k, cos, sin)
    quant = cache.k.dtype == torch.int8
    if quant:
        kq, ks_new = _quantize_kv(k)
        vq, vs_new = _quantize_kv(v)
        cache.k[rows, slot] = kq[:, 0]
        cache.v[rows, slot] = vq[:, 0]
        cache.k_scale[rows, slot] = ks_new[:, 0]
        cache.v_scale[rows, slot] = vs_new[:, 0]
    else:
        cache.k[rows, slot] = k[:, 0].to(cache.k.dtype)
        cache.v[rows, slot] = v[:, 0].to(cache.v.dtype)
    if quant:
        kk = _repeat_kv(_dequantize_kv(cache.k, cache.k_scale, x.dtype),
                        groups)
        vv = _repeat_kv(_dequantize_kv(cache.v, cache.v_scale, x.dtype),
                        groups)
    else:
        kk = _repeat_kv(cache.k, groups)
        vv = _repeat_kv(cache.v, groups)
    logits = torch.einsum("bshd,bthd->bhst", q, kk)
    probs = _scores(logits, valid[:, None, None, :], cfg, hd).to(x.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, vv)
    y = linear(p.o, out.reshape(B, 1, cfg.n_heads * hd), cfg)
    return y, cache
