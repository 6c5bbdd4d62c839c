"""Attention of the port: the blockwise (flash-style) prefill path and the
O(S) decode path, with GQA/MQA, sliding windows, soft-capping and the
non-causal form (whisper's encoder and cross attention), and DeepSeek's
multi-head latent attention (MLA).

The JAX package runs both on XLA (a ``lax.scan`` over KV blocks and
einsums), not on a Pallas kernel, and so does the port: plain tensor ops
on the card too — per KV block two ``einsum``s and the elementwise online
softmax, the (Sq, Skv) score matrix never materialised.  All score math
is float32; the output is cast to q's dtype.  Under autograd (training)
each KV block is checkpointed, as the reference's ``remat_blocks``.  GQA
reshapes q to ``(B, Sq, Hkv, rep, dh)``: query head ``h`` reads kv head
``h // rep``.
MLA's prefill expands its latent into per-head K/V (:func:`mla_expand`)
for :func:`flash_attention`; its decode attends in the latent space
(:func:`mla_decode_scores`).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
from torch.utils.checkpoint import checkpoint

from .common import soft_cap

__all__ = ["flash_attention", "decode_attention", "mla_expand",
           "mla_decode_scores"]

_NEG_INF = -1e30


def _block_mask(q_pos, k_pos, *, causal: bool, window: Optional[int]):
    """(Sq, Bk) mask from absolute positions: q − k >= 0 when ``causal``,
    q − k < window with a window."""
    rel = q_pos[:, None] - k_pos[None, :]
    mask = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
    if causal:
        mask &= rel >= 0
    if window is not None:
        mask &= rel < window
    return mask


def _block(qf, k_blk, v_blk, mask, m_run, l_run, acc, softcap):
    """One KV block of the online softmax: the new (max, denominator,
    accumulator).  A row the mask leaves empty keeps max -1e30 and adds 0;
    its ``torch.where`` guards pick finite branches only, so no NaN or inf
    reaches a gradient through the branch they discard."""
    s = torch.einsum("bqhrd,bkhd->bhrqk", qf, k_blk)  # (B,Hkv,rep,Sq,Bk)
    s = soft_cap(s, softcap)  # before the mask, as the reference
    s = torch.where(mask, s, _NEG_INF)
    m_new = torch.maximum(m_run, s.amax(-1))
    # guard fully-masked rows (m_new == -1e30)
    m_safe = torch.where(m_new <= _NEG_INF, 0.0, m_new)
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(mask, p, 0.0)
    corr = torch.exp(torch.where(m_run <= _NEG_INF, _NEG_INF,
                                 m_run - m_safe))
    l_new = l_run * corr + p.sum(-1)
    acc = acc * corr[..., None] + torch.einsum("bhrqk,bkhd->bhrqd", p, v_blk)
    return m_new, l_new, acc


def flash_attention(q, k, v, *, causal: bool = True,
                    window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None, block_k: int = 1024):
    """Blockwise attention with an online softmax: causal for the
    decoders' self-attention, ``causal=False`` for whisper's encoder and
    its cross attention.

    q: (B, Sq, Hq, dh); k, v: (B, Skv, Hkv, dh) with Hq % Hkv == 0, query
    ``i`` at position ``i``.  Returns (B, Sq, Hq, dv) in q.dtype.  The KV
    axis is padded to a multiple of ``block_k`` and the padded positions
    masked.
    """
    b, sq, hq, dh = q.shape
    skv_orig, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)
    dev = q.device

    block_k = min(block_k, skv_orig)
    n_blocks = -(-skv_orig // block_k)
    qf = (q.float() * scale).reshape(b, sq, hkv, rep, dh)
    q_pos = torch.arange(sq, device=dev)

    m_run = torch.full((b, hkv, rep, sq), _NEG_INF, dtype=torch.float32,
                       device=dev)
    l_run = torch.zeros((b, hkv, rep, sq), dtype=torch.float32, device=dev)
    acc = torch.zeros((b, hkv, rep, sq, dv), dtype=torch.float32, device=dev)
    # under autograd each block is checkpointed, as the reference's
    # remat_blocks: the backward recomputes a block's scores instead of
    # keeping the (Sq, Skv) probabilities
    grad = torch.is_grad_enabled()
    for blk in range(n_blocks):
        lo = blk * block_k
        k_blk = k[:, lo:lo + block_k].float()
        v_blk = v[:, lo:lo + block_k].float()
        pad = block_k - k_blk.shape[1]
        if pad:  # the tail block, padded to block_k; its pad is masked
            k_blk = torch.nn.functional.pad(k_blk, (0, 0, 0, 0, 0, pad))
            v_blk = torch.nn.functional.pad(v_blk, (0, 0, 0, 0, 0, pad))
        k_pos = lo + torch.arange(block_k, device=dev)
        mask = _block_mask(q_pos, k_pos, causal=causal, window=window)
        mask &= (k_pos < skv_orig)[None, :]
        args = (qf, k_blk, v_blk, mask, m_run, l_run, acc, softcap)
        m_run, l_run, acc = (checkpoint(_block, *args, use_reentrant=False)
                             if grad else _block(*args))
    out = acc / torch.clamp(l_run, min=1e-30)[..., None]  # (B,Hkv,rep,Sq,dv)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv)
    return out.to(q.dtype)


def decode_attention(q, k_cache, v_cache, cur_pos: int, *,
                     window: Optional[int] = None,
                     softcap: Optional[float] = None,
                     scale: Optional[float] = None):
    """One-token attention against a (possibly partially filled) KV cache.

    q: (B, 1, Hq, dh); caches: (B, S, Hkv, dh); cur_pos: the position of
    the new token (cache slots at positions <= cur_pos are valid, and
    inside the window when one is given).
    """
    b, _, hq, dh = q.shape
    s, hkv = k_cache.shape[1], k_cache.shape[2]
    rep = hq // hkv
    scale = scale if scale is not None else 1.0 / math.sqrt(dh)

    qf = (q.float() * scale).reshape(b, hkv, rep, dh)
    scores = torch.einsum("bhrd,bkhd->bhrk", qf, k_cache.float())
    scores = soft_cap(scores, softcap)
    k_pos = torch.arange(s, device=q.device)
    valid = k_pos <= cur_pos
    if window is not None:
        valid &= (cur_pos - k_pos) < window
    scores = torch.where(valid, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhrk,bkhd->bhrd", p, v_cache.float())
    return out.reshape(b, 1, hq, -1).to(q.dtype)


# ---------------------------------------------------------------------------
# DeepSeek-V2 multi-head latent attention
# ---------------------------------------------------------------------------


def mla_expand(c_kv, w_uk, w_uv):
    """Expand the compressed KV latent into per-head K (nope part) and V.

    c_kv: (B, S, R); w_uk: (R, H, dn); w_uv: (R, H, dv).  Returns k_nope
    (B, S, H, dn) and v (B, S, H, dv).
    """
    k_nope = torch.einsum("bsr,rhd->bshd", c_kv, w_uk)
    v = torch.einsum("bsr,rhd->bshd", c_kv, w_uv)
    return k_nope, v


def mla_decode_scores(q_nope, q_rope, ckv_cache, krope_cache, w_uk, w_uv,
                      cur_pos: int, *, scale: float):
    """Weight-absorbed MLA decode (arXiv:2405.04434 §2.1.3), in float32.

    q_nope: (B, H, dn); q_rope: (B, H, dr); ckv_cache: (B, S, R);
    krope_cache: (B, S, dr).  Scores are taken in the latent space (q_c =
    q_nope · W_uk, (B, H, R)) against slots at positions <= ``cur_pos``,
    and the context is expanded back through W_uv.  Returns (B, 1, H, dv)
    in q_nope's dtype.
    """
    ckv = ckv_cache.float()
    q_c = torch.einsum("bhd,rhd->bhr", q_nope.float(), w_uk.float())
    s_c = torch.einsum("bhr,bsr->bhs", q_c, ckv)
    s_r = torch.einsum("bhd,bsd->bhs", q_rope.float(), krope_cache.float())
    scores = (s_c + s_r) * scale
    valid = torch.arange(ckv.shape[1], device=ckv.device) <= cur_pos
    scores = torch.where(valid, scores, _NEG_INF)
    p = torch.softmax(scores, dim=-1)
    ctx_c = torch.einsum("bhs,bsr->bhr", p, ckv)
    ctx = torch.einsum("bhr,rhd->bhd", ctx_c, w_uv.float())
    return ctx[:, None].to(q_nope.dtype)
