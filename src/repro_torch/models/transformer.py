"""Model assembly of the port: the SSM (Mamba-2), dense decoder, MoE,
Griffin (RG-LRU + local attention) and frontend-stub (whisper's
encoder-decoder, qwen2-vl's embedding input with M-RoPE) families.

Entry points as in the JAX package's ``models/transformer.py``:

* :func:`init_params` — the model's parameters (an ``nn.Module``), drawn
  from a seeded ``torch.Generator`` on the device;
* :func:`prefill` — the full-sequence pass that also builds the decode
  cache (the SSM family's through the SSD chunk kernels);
* :func:`decode_step` — one token against the cache (the serving step);
* :func:`init_cache` — a zero decode cache (:func:`grow_cache` places a
  prefill's in a longer one);
* :func:`init_hotness_state` — the MoE layers' zero FISH hotness;
* :func:`forward_train` — the full-sequence loss under autograd, with the
  MoE aux loss and the FISH hotness carried through the MoE layers.

The dense family (qwen1.5, starcoder2, olmo, gemma2: GQA/MQA, QKV bias,
sliding windows on a local/global pattern, soft-capping, post-norms,
tied heads) runs its attention in plain tensor ops
(:mod:`repro_torch.models.attention`), as the JAX package runs it on XLA.
The MoE family (deepseek-v2-lite with MLA, kimi-k2 with GQA) runs
``first_dense_layers`` dense ``prefix`` layers, then layers whose FFN is
:func:`repro_torch.models.moe.moe_ffn` with FISH expert routing; prefill
and decode pass zero hotness, as the reference does, while
:func:`forward_train` hands MoE layer ``i`` row ``i`` of the carried
hotness and returns the new rows.  The Griffin family (recurrentgemma)
runs (rec, rec, attn) groups and a tail of rec layers: a rec layer is an
RG-LRU block (:mod:`repro_torch.models.ssm`) and an MLP, an attn layer
local MQA over ``rglru.local_window`` keys and an MLP; its decode keeps a
ring buffer of the last ``window`` keys per attention layer.  The
frontend stubs take what their stubbed frontends would give: qwen2-vl a
batch's ``embeds`` (B, S, D) and its (3, B, S) M-RoPE ``positions``
(temporal, height, width; a decode step puts its position on all three,
as the reference does) in place of token embeddings, and whisper an
``enc_embeds`` (B, encoder_seq, D) that a stack of non-causal encoder
layers (``enc_stack``, then ``enc_final_norm``) turns into the states
each decoder layer's cross attention reads; whisper adds no positional
signal on either side (``rope_kind="none"``), as the reference.

The JAX package scans over layers stacked on a leading axis; here the
layers are an ``nn.ModuleList`` walked by a Python loop.  The decode
cache keeps the stacked layout: the SSM family's ``conv``
(L, B, d_conv−1, C) and ``ssm`` (L, B, H, N, P); the dense family's
(k, v), each (L, B, S, Hkv, dh), or (L//pat, pat, B, S, Hkv, dh) with a
local/global pattern of ``pat`` layers.  An MoE model's stack holds its
L − nd MoE layers and a ``prefix`` list holds one entry per dense prefix
layer: (k, v) of (B, S, Hkv, dh) under GQA; under MLA the compressed
(c_kv, k_rope), (L − nd, B, S, R) and (L − nd, B, S, dr) in the stack and
(B, S, R), (B, S, dr) in the prefix.  Griffin's cache is the reference's:
``rec`` ``{"conv": (G, 2, B, K−1, W), "h": (G, 2, B, W)}`` float32 for
the G groups' rec layers, ``attn`` (k, v) each (G, B, w, Hkv, dh) for
their attention layers (w = the window, or fewer positions), ``tail`` a
``{"conv", "h"}`` per tail layer.  Whisper's is ((k, v), (cross_k,
cross_v)): the self-attention's (L, B, S, H, dh) and the cross
attention's (L, B, encoder_seq, H, dh), made by the prefill once (or
zero by :func:`init_cache`) and only read by the decode.  Where the
reference's optimizer and
checkpoints need its stacked leaves (a norm scale stacked over the layers
is one (L, D) leaf; Griffin's ``rec_stack`` leaves lead with (G, 2),
``attn_stack``'s with (G,), ``rec_tail``'s with (tail,), whisper's
``enc_stack``'s with (encoder_layers,)), :func:`reference_leaves` names
them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from .._device import resolve_device
from ..configs.base import ModelConfig
from . import moe as moe_mod
from . import ssm as ssm_mod
from .attention import (decode_attention, flash_attention, mla_decode_scores,
                        mla_expand)
from .common import (activation_fn, apply_mrope, apply_norm, apply_rope,
                     dtype_of, rms_norm, soft_cap)
from .moe import moe_ffn

__all__ = ["Model", "padded_vocab", "init_params", "prefill", "decode_step",
           "init_cache", "grow_cache", "init_hotness_state", "num_params",
           "forward_train", "reference_leaves", "param_tree",
           "load_param_tree"]

BLOCK_K = 1024  # the KV block of the prefill's online softmax


def padded_vocab(cfg: ModelConfig) -> int:
    """Vocab rows padded to a multiple of 128 (Megatron-style); pad logits
    are masked to -1e30."""
    return -(-cfg.vocab_size // 128) * 128


def _pattern(cfg: ModelConfig) -> int:
    return len(cfg.local_global_pattern) if cfg.local_global_pattern else 1


def _num_prefix(cfg: ModelConfig) -> int:
    """The dense layers ahead of an MoE model's MoE stack."""
    return cfg.moe.first_dense_layers if cfg.moe is not None else 0


def _griffin_layout(cfg: ModelConfig) -> Tuple[int, int]:
    """(full rec-rec-attn groups, trailing rec layers)."""
    every = cfg.rglru.attention_every
    if every != 3:
        raise ValueError("the Griffin layout assumes (rec, rec, attn)")
    n_groups = cfg.num_layers // every
    return n_groups, cfg.num_layers - n_groups * every


def _stack_index(cfg: ModelConfig, i: int) -> Tuple[str, Tuple[int, ...]]:
    """The reference's stack that holds layer ``i`` (of ``Model.layers``)
    and the layer's index on its leading axes: ``stack`` ``(i,)``, or
    ``(i // pat, i % pat)`` under a local/global pattern; Griffin's
    ``rec_stack`` ``(g, j)`` for layer ``3g + j``, ``attn_stack`` ``(g,)``
    for layer ``3g + 2`` and ``rec_tail`` ``(t,)`` for layer ``3G + t``."""
    if cfg.rglru is not None:
        n_groups, _ = _griffin_layout(cfg)
        g, j = divmod(i, 3)
        if g >= n_groups:
            return "rec_tail", (i - 3 * n_groups,)
        return ("rec_stack", (g, j)) if j < 2 else ("attn_stack", (g,))
    pat = _pattern(cfg)
    return "stack", ((i // pat, i % pat) if pat > 1 else (i,))


def _stack_leads(cfg: ModelConfig, n: int) -> Dict[str, Tuple[int, ...]]:
    """The leading (layer) shape of each stack of a model of ``n`` stacked
    layers (whisper's ``enc_stack`` too)."""
    if cfg.rglru is not None:
        n_groups, tail = _griffin_layout(cfg)
        return {"rec_stack": (n_groups, 2), "attn_stack": (n_groups,),
                "rec_tail": (tail,)}
    pat = _pattern(cfg)
    return {"stack": (n // pat, pat) if pat > 1 else (n,),
            "enc_stack": (cfg.encoder_layers,)}


def _windows(cfg: ModelConfig):
    """The attention window of each layer of a pattern group."""
    pat = cfg.local_global_pattern
    return [cfg.sliding_window if (pat and pat[i] == "local") else None
            for i in range(_pattern(cfg))]


def _param(shape, dtype, device):
    return nn.Parameter(torch.empty(shape, dtype=dtype, device=device),
                        requires_grad=False)


class Norm(nn.Module):
    """A norm's weights, as the JAX package's ``_norm_params``: ``scale``
    (rmsnorm, rmsnorm_plus_one), ``scale`` and ``bias`` (layernorm), none
    (nonparametric)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        has = cfg.norm != "nonparametric"
        self.scale = _param(cfg.d_model, dtype, device) if has else None
        self.bias = (_param(cfg.d_model, dtype, device)
                     if cfg.norm == "layernorm" else None)


class Attention(nn.Module):
    """``wq`` (D, Hq·dh), ``wk``/``wv`` (D, Hkv·dh), ``wo`` (Hq·dh, D), and
    ``bq``/``bk``/``bv`` with ``qkv_bias``."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, hq, hkv, dh = (cfg.d_model, cfg.num_heads, cfg.num_kv_heads,
                          cfg.head_dim)
        self.wq = _param((d, hq * dh), dtype, device)
        self.wk = _param((d, hkv * dh), dtype, device)
        self.wv = _param((d, hkv * dh), dtype, device)
        self.wo = _param((hq * dh, d), dtype, device)
        if cfg.qkv_bias:
            self.bq = _param(hq * dh, dtype, device)
            self.bk = _param(hkv * dh, dtype, device)
            self.bv = _param(hkv * dh, dtype, device)


class KVNorm(nn.Module):
    """MLA's latent norm: always an RMS norm, ``scale`` (R,)."""

    def __init__(self, dim: int, dtype, device):
        super().__init__()
        self.scale = _param(dim, dtype, device)


class MLA(nn.Module):
    """DeepSeek-V2 multi-head latent attention: ``w_q_mla`` (D,
    H·(dn+dr)), ``w_dkv`` (D, R+dr), ``kv_norm``, ``w_uk`` (R, H, dn),
    ``w_uv`` (R, H, dv), ``w_o_mla`` (H·dv, D)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        m, d, h = cfg.mla, cfg.d_model, cfg.num_heads
        dn, dr, dv, r = (m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim,
                         m.kv_lora_rank)
        self.w_q_mla = _param((d, h * (dn + dr)), dtype, device)
        self.w_dkv = _param((d, r + dr), dtype, device)
        self.kv_norm = KVNorm(r, dtype, device)
        self.w_uk = _param((r, h, dn), dtype, device)
        self.w_uv = _param((r, h, dv), dtype, device)
        self.w_o_mla = _param((h * dv, d), dtype, device)


class MLP(nn.Module):
    """Gated (``w_gate``, ``w_up``, ``w_down``: swiglu, geglu) or plain
    (``w_in``, ``b_in``, ``w_out``, ``b_out``: starcoder2)."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        d, f = cfg.d_model, cfg.d_ff  # an MoE model's prefix layers too
        if cfg.mlp_kind in ("swiglu", "geglu"):
            self.w_gate = _param((d, f), dtype, device)
            self.w_up = _param((d, f), dtype, device)
            self.w_down = _param((f, d), dtype, device)
        else:
            self.w_in = _param((d, f), dtype, device)
            self.b_in = _param(f, dtype, device)
            self.w_out = _param((f, d), dtype, device)
            self.b_out = _param(d, dtype, device)


class RecLayer(nn.Module):
    """Griffin's rec layer: norm → RG-LRU block → residual, norm → MLP →
    residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg, dtype, device)
        self.ln2 = Norm(cfg, dtype, device)
        if cfg.post_norms:
            self.ln1_post = Norm(cfg, dtype, device)
            self.ln2_post = Norm(cfg, dtype, device)
        self.rec = ssm_mod.RGLRU(cfg.d_model, cfg.rglru, dtype, device)
        self.mlp = MLP(cfg, dtype, device)
        self.moe = None


class MambaLayer(nn.Module):
    """norm → Mamba-2 mixer → residual."""

    def __init__(self, cfg: ModelConfig, dtype, device):
        super().__init__()
        self.ln1 = Norm(cfg, dtype, device)
        self.mamba = ssm_mod.Mamba2(cfg.d_model, cfg.ssm, dtype, device)


class DecoderLayer(nn.Module):
    """norm → attention (GQA, or MLA with ``cfg.mla``) → residual, norm →
    MLP, or with ``moe`` the MoE FFN → residual; with ``post_norms``
    (gemma2) each sub-block's output is normed too.  With ``cross``
    (whisper's decoder layer) a cross attention (``cross``, its norm
    ``ln_cross``) follows the self-attention.  Whisper's encoder layer is
    this layer's plain form, run non-causally."""

    def __init__(self, cfg: ModelConfig, dtype, device, *, moe: bool = False,
                 cross: bool = False):
        super().__init__()
        self.ln1 = Norm(cfg, dtype, device)
        self.ln2 = Norm(cfg, dtype, device)
        if cfg.post_norms:
            self.ln1_post = Norm(cfg, dtype, device)
            self.ln2_post = Norm(cfg, dtype, device)
        self.attn = (MLA if cfg.mla is not None else Attention)(cfg, dtype,
                                                                device)
        self.mlp = None if moe else MLP(cfg, dtype, device)
        self.moe = (moe_mod.MoE(cfg.d_model, cfg.moe, dtype, device) if moe
                    else None)
        self.cross = Attention(cfg, dtype, device) if cross else None
        self.ln_cross = Norm(cfg, dtype, device) if cross else None


class Model(nn.Module):
    """The parameters of a model, in the JAX package's layout (``embed``
    (PV, D), ``head`` (D, PV), layer ``i`` = its ``stack`` leaves' row
    ``i``, or ``[i // pat, i % pat]`` under a local/global pattern; an MoE
    model's ``prefix.<j>`` = the reference's ``prefix[j]``, and its
    ``layers`` are the MoE layers after them; Griffin's ``layers`` are its
    rec and attention layers in order, each at :func:`_stack_index` of
    the reference's stacks; whisper's ``enc_stack.<i>`` = its
    ``enc_stack`` leaves' row ``i``, and ``enc_final_norm``).
    Uninitialised:
    :func:`init_params` draws them, or
    :func:`repro_torch.convert.model_params_from_reference` copies them."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        dtype = dtype_of(cfg.dtype)
        pv = padded_vocab(cfg)
        self.cfg = cfg
        self.embed = _param((pv, cfg.d_model), dtype, device)
        self.final_norm = Norm(cfg, dtype, device)
        self.head = (None if cfg.tie_embeddings
                     else _param((cfg.d_model, pv), dtype, device))
        nd = _num_prefix(cfg)
        self.prefix = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                    for _ in range(nd))
        if cfg.ssm is not None:
            self.layers = nn.ModuleList(MambaLayer(cfg, dtype, device)
                                        for _ in range(cfg.num_layers))
        elif cfg.rglru is not None:
            self.layers = nn.ModuleList(
                (DecoderLayer if _stack_index(cfg, i)[0] == "attn_stack"
                 else RecLayer)(cfg, dtype, device)
                for i in range(cfg.num_layers))
        else:
            self.layers = nn.ModuleList(
                DecoderLayer(cfg, dtype, device, moe=cfg.moe is not None,
                             cross=bool(cfg.encoder_layers))
                for _ in range(cfg.num_layers - nd))
        self.enc_stack = nn.ModuleList(DecoderLayer(cfg, dtype, device)
                                       for _ in range(cfg.encoder_layers))
        self.enc_final_norm = (Norm(cfg, dtype, device) if cfg.encoder_layers
                               else None)


def init_params(cfg: ModelConfig, seed: int = 0, device=None) -> Model:
    """Random-init parameters on ``device`` (``None`` = ``cuda``), drawn
    from ``torch.Generator(device).manual_seed(seed)``: not the JAX
    package's numbers (its PRNG differs), the same distributions."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    model = Model(cfg, device=dev)

    def normal(t, std):
        t.copy_(torch.randn(t.shape, generator=gen, device=dev,
                            dtype=torch.float32) * std)

    def norm(n: Norm):
        if n.scale is not None:
            n.scale.fill_(0.0 if cfg.norm == "rmsnorm_plus_one" else 1.0)
        if n.bias is not None:
            n.bias.zero_()

    def dense(sub):
        # as _init_attn / _init_mlp / _init_mla: every matrix N(0,
        # 1/fan_in), with fan_in its rows (MLA's (R, H, d) too); every bias
        # zero, MLA's latent norm one
        for w in sub.parameters():
            if w.dim() >= 2:
                normal(w, 1.0 / math.sqrt(w.shape[0]))
            else:
                w.zero_()
        if isinstance(sub, MLA):
            sub.kv_norm.scale.fill_(1.0)

    with torch.no_grad():
        normal(model.embed, 0.02)
        for n in (model.final_norm, model.enc_final_norm):
            if n is not None:
                norm(n)
        if model.head is not None:
            normal(model.head, 0.02)
        for layer in [*model.prefix, *model.layers, *model.enc_stack]:
            for child in layer.children():
                if isinstance(child, Norm):
                    norm(child)
            if cfg.ssm is not None:
                ssm_mod._init_mamba2_(layer.mamba, gen)
                continue
            if isinstance(layer, RecLayer):
                ssm_mod._init_rglru_(layer.rec, gen)
            else:
                dense(layer.attn)
            if getattr(layer, "cross", None) is not None:
                dense(layer.cross)
            if layer.moe is not None:  # the experts have their own draws
                moe_mod._init_moe_(layer.moe, gen)
            else:
                dense(layer.mlp)
    return model


def init_hotness_state(cfg: ModelConfig, device=None):
    """Zero FISH hotness for each MoE layer, (L − nd, E) float32 on
    ``device`` (``None`` = ``cuda``); ``None`` for a model without MoE."""
    if cfg.moe is None:
        return None
    return torch.zeros((cfg.num_layers - _num_prefix(cfg),
                        cfg.moe.num_experts), dtype=torch.float32,
                       device=resolve_device(device))


def num_params(model: Model) -> int:
    return sum(p.numel() for p in model.parameters())


def reference_leaves(params: Model
                     ) -> List[Tuple[str, List[str], Tuple[int, ...]]]:
    """The reference's parameter leaves: each leaf's path
    (``stack/attn/wq``, ``prefix/0/ln1/scale``, ``rec_stack/rec/lambda``,
    ``enc_stack/attn/wq``, ``embed``), the names of the port parameters it
    holds (one per layer, in layer order, for a stacked leaf; one else)
    and its leading layer shape (``(L,)``, ``(L // pat, pat)`` under a
    local/global pattern, Griffin's ``(G, 2)``, ``(G,)`` and ``(tail,)``,
    whisper's encoder ``(E,)``, ``()`` unstacked)."""
    cfg = params.cfg
    leads = _stack_leads(cfg, len(params.layers))
    leaves: Dict[str, Tuple[List[str], Tuple[int, ...]]] = {}
    for name, _ in params.named_parameters():
        head, *rest = name.split(".")
        if head in ("layers", "enc_stack"):
            stack = (_stack_index(cfg, int(rest[0]))[0] if head == "layers"
                     else head)
            path = "/".join([stack, *rest[1:]])
            leaves.setdefault(path, ([], leads[stack]))[0].append(name)
        else:
            leaves[name.replace(".", "/")] = ([name], ())
    return [(path, names, shape) for path, (names, shape) in leaves.items()]


def param_tree(params: Model, device=None) -> Dict[str, torch.Tensor]:
    """The parameters as the reference's leaves, ``{path: tensor}``, each
    ``stack`` leaf stacked on its leading layer shape; copies on ``device``
    (``None``: where the parameters are)."""
    named = dict(params.named_parameters())
    out = {}
    for path, names, lead in reference_leaves(params):
        ts = [named[n].detach().to(device, copy=True) for n in names]
        out[path] = (torch.stack(ts).reshape(lead + ts[0].shape) if lead
                     else ts[0])
    return out


@torch.no_grad()
def load_param_tree(params: Model, tree: Dict[str, torch.Tensor]) -> None:
    """Copy a :func:`param_tree` (the reference's leaves) into the
    parameters, layer ``i`` of a ``stack`` leaf into layer ``i``'s."""
    named = dict(params.named_parameters())
    for path, names, lead in reference_leaves(params):
        rows = tree[path].reshape(-1, *named[names[0]].shape) if lead else \
            tree[path][None]
        for name, row in zip(names, rows):
            named[name].copy_(row)


def _norm(cfg: ModelConfig, n: Norm, x):
    return apply_norm(x, n.scale, cfg.norm, cfg.norm_eps, bias=n.bias)


def _embed(params: Model, tokens, cfg: ModelConfig, embeds=None):
    """The input stream: ``embeds`` cast to the model's dtype (a frontend
    stub's input, when the config takes embeddings and they are given),
    else the token embeddings."""
    if cfg.embeds_input and embeds is not None:
        h = embeds.to(dtype_of(cfg.dtype))
    else:
        h = params.embed[tokens.long()]
    if cfg.scale_embeddings:
        h = h * math.sqrt(cfg.d_model)
    return h


def _batch_input(params: Model, batch, cfg: ModelConfig):
    """A prefill or train batch's input stream (B, S, D) and positions:
    the batch's (3, B, S) ``positions`` under M-RoPE, else 0..S−1."""
    h = _embed(params, batch.get("tokens"), cfg, batch.get("embeds"))
    b, s, _ = h.shape
    if cfg.rope_kind == "mrope":
        return h, batch["positions"]
    return h, torch.arange(s, device=h.device).expand(b, s)


def _head_matrix(params: Model, cfg: ModelConfig):
    return params.embed.T if cfg.tie_embeddings else params.head


def _masked_logits(h_last, params: Model, cfg: ModelConfig):
    logits = soft_cap((h_last @ _head_matrix(params, cfg)).float(),
                      cfg.logit_softcap)
    pv = padded_vocab(cfg)
    if pv != cfg.vocab_size:
        pad = torch.arange(pv, device=logits.device) >= cfg.vocab_size
        logits = torch.where(pad, -1e30, logits)
    return logits


# ---------------------------------------------------------------------------
# Layer bodies
# ---------------------------------------------------------------------------


def _qkv(p: Attention, h, cfg: ModelConfig, positions, rope: bool = True):
    """Projections (+ bias), heads split, RoPE (M-RoPE with positions (3,
    B, S); none with ``rope=False`` or ``rope_kind="none"``).  h: (B, S,
    D)."""
    b, s, _ = h.shape
    q, k, v = h @ p.wq, h @ p.wk, h @ p.wv
    if cfg.qkv_bias:
        q, k, v = q + p.bq, k + p.bk, v + p.bv
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k = k.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    v = v.reshape(b, s, cfg.num_kv_heads, cfg.head_dim)
    if rope and cfg.rope_kind == "mrope":
        q, k = apply_mrope(q, k, positions, cfg.mrope_sections,
                           theta=cfg.rope_theta)
    elif rope and cfg.rope_kind == "rope":
        q, k = apply_rope(q, k, positions, theta=cfg.rope_theta)
    return q, k, v


def _attn_block(p: Attention, h, cfg: ModelConfig, *, positions, window,
                causal: bool = True, rope: bool = True):
    """Full-sequence attention sub-block.  Returns (out, (k_rot, v)); the
    cache keeps the unrepeated kv heads."""
    b, s, _ = h.shape
    q, k, v = _qkv(p, h, cfg, positions, rope)
    out = flash_attention(q, k, v, causal=causal, window=window,
                          softcap=cfg.attn_softcap, scale=cfg.query_scale,
                          block_k=BLOCK_K)
    out = out.reshape(b, s, -1) @ p.wo
    return out.to(h.dtype), (k, v)


def _cross_kv(p: Attention, enc_h, cfg: ModelConfig):
    """Whisper's cross-attention keys and values from the encoder's output,
    each (B, encoder_seq, H, dh)."""
    b, se, _ = enc_h.shape
    k, v = enc_h @ p.wk, enc_h @ p.wv
    if cfg.qkv_bias:
        k, v = k + p.bk, v + p.bv
    return (k.reshape(b, se, cfg.num_heads, cfg.head_dim),
            v.reshape(b, se, cfg.num_heads, cfg.head_dim))


def _cross_attn_block(p: Attention, h, enc_kv, cfg: ModelConfig):
    """Decoder → encoder cross attention: every query sees every encoder
    position (non-causal, KV blocks of min(512, encoder_seq))."""
    b, s, _ = h.shape
    q = h @ p.wq
    if cfg.qkv_bias:
        q = q + p.bq
    q = q.reshape(b, s, cfg.num_heads, cfg.head_dim)
    k, v = enc_kv
    out = flash_attention(q, k, v, causal=False,
                          block_k=min(512, k.shape[1]))
    return (out.reshape(b, s, -1) @ p.wo).to(h.dtype)


def _mlp_block(p: MLP, h, cfg: ModelConfig):
    if cfg.mlp_kind in ("swiglu", "geglu"):
        act = activation_fn("silu" if cfg.mlp_kind == "swiglu"
                            else "gelu_tanh")
        return ((act(h @ p.w_gate) * (h @ p.w_up)) @ p.w_down).to(h.dtype)
    act = activation_fn(cfg.activation)
    return (act(h @ p.w_in + p.b_in) @ p.w_out + p.b_out).to(h.dtype)


def _mla_block(p: MLA, h, cfg: ModelConfig, *, positions):
    """DeepSeek-V2 MLA, expanded (prefill) form.  Returns (out, (c_kv,
    k_rope)), the compressed cache entries (B, S, R) and (B, S, dr)."""
    m, hq = cfg.mla, cfg.num_heads
    b, s, _ = h.shape
    dn, dr, dv, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    q = (h @ p.w_q_mla).reshape(b, s, hq, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    dkv = h @ p.w_dkv
    c_kv = rms_norm(dkv[..., :r], p.kv_norm.scale, cfg.norm_eps)
    k_rope = dkv[..., r:].reshape(b, s, 1, dr)  # one head, broadcast
    q_rope, k_rope = apply_rope(q_rope, k_rope, positions,
                                theta=cfg.rope_theta)
    k_nope, v = mla_expand(c_kv, p.w_uk, p.w_uv)
    k = torch.cat([k_nope, k_rope.expand(b, s, hq, dr)], dim=-1)
    out = flash_attention(torch.cat([q_nope, q_rope], dim=-1), k, v,
                          scale=1.0 / math.sqrt(dn + dr), block_k=BLOCK_K)
    out = out.reshape(b, s, hq * dv) @ p.w_o_mla
    return out.to(h.dtype), (c_kv, k_rope[:, :, 0])


def _residual(cfg: ModelConfig, layer: DecoderLayer, name: str, h, out):
    """Residual add, with gemma2's post-norm sandwich if configured."""
    if cfg.post_norms:
        out = _norm(cfg, getattr(layer, f"{name}_post"), out)
    return h + out


def _attn_half(layer: DecoderLayer, h, cfg: ModelConfig, positions, window,
               enc_h=None):
    """norm → attention (MLA or GQA) → residual; whisper's decoder layer:
    norm → causal self-attention → residual, norm → cross attention to
    ``enc_h`` → residual, no positional signal.  Returns (h, the layer's
    cache entries: whisper's ((k, v), (cross_k, cross_v)))."""
    hin = _norm(cfg, layer.ln1, h)
    if layer.cross is not None:
        out, kv = _attn_block(layer.attn, hin, cfg, positions=positions,
                              window=None, rope=False)
        h = h + out
        ckv = _cross_kv(layer.cross, enc_h, cfg)
        h = h + _cross_attn_block(layer.cross,
                                  _norm(cfg, layer.ln_cross, h), ckv, cfg)
        return h, (kv, ckv)
    if cfg.mla is not None:
        out, kv = _mla_block(layer.attn, hin, cfg, positions=positions)
    else:
        out, kv = _attn_block(layer.attn, hin, cfg, positions=positions,
                              window=window)
    return _residual(cfg, layer, "ln1", h, out), kv


def _ffn_half(layer: DecoderLayer, h, cfg: ModelConfig, hot_row=None):
    """norm → MLP, or the MoE FFN → residual.  Returns (h, new hotness row,
    aux loss); the last two are ``None`` for a dense layer.  An MoE layer
    given no hotness routes from zero hotness, statelessly, as prefill and
    decode do in the reference."""
    hin = _norm(cfg, layer.ln2, h)
    new_hot = aux = None
    if layer.moe is None:
        out = _mlp_block(layer.mlp, hin, cfg)
    else:
        b, s, d = hin.shape
        hot = hot_row if hot_row is not None else torch.zeros(
            (cfg.moe.num_experts,), dtype=torch.float32, device=h.device)
        y, new_hot, aux, _ = moe_ffn(layer.moe, hin.reshape(b * s, d),
                                     cfg.moe, hot)
        out = y.reshape(b, s, d)
    return _residual(cfg, layer, "ln2", h, out), new_hot, aux


def _cache_view(cache_t, i: int, pat: int):
    """Layer ``i``'s slice of a stacked cache tensor (a view)."""
    return cache_t[i] if pat == 1 else cache_t[i // pat, i % pat]


def _layer_entries(cfg: ModelConfig, cache: Dict):
    """Each attention layer's two cache tensors (views), prefix first, in
    the order of ``[*params.prefix, *params.layers]``; whisper's layer
    ``i``: ((k, v), (cross_k, cross_v)) at row ``i``."""
    if cfg.encoder_layers:
        (k, v), (ck, cv) = cache["layers"]
        return [((k[i], v[i]), (ck[i], cv[i]))
                for i in range(cfg.num_layers)]
    pat = _pattern(cfg)
    first, second = cache["layers"]
    return list(cache.get("prefix", [])) + [
        (_cache_view(first, i, pat), _cache_view(second, i, pat))
        for i in range(cfg.num_layers - _num_prefix(cfg))]


def _layer_windows(cfg: ModelConfig):
    """Each attention layer's window, prefix first (the prefix has none)."""
    windows, pat = _windows(cfg), _pattern(cfg)
    return [None] * _num_prefix(cfg) + [
        windows[i % pat] for i in range(cfg.num_layers - _num_prefix(cfg))]


def _fill(dst, src) -> None:
    """Copy a layer's cache entries (tensors, or tuples of them) into the
    cache's views."""
    if isinstance(dst, torch.Tensor):
        dst.copy_(src)
        return
    for d, x in zip(dst, src, strict=True):
        _fill(d, x)


def _enc_layer(layer: DecoderLayer, h, *, cfg: ModelConfig):
    """One whisper encoder layer: norm → non-causal self-attention →
    residual, norm → MLP → residual; no positional signal."""
    out, _ = _attn_block(layer.attn, _norm(cfg, layer.ln1, h), cfg,
                         positions=None, window=None, causal=False,
                         rope=False)
    h = h + out
    return h + _mlp_block(layer.mlp, _norm(cfg, layer.ln2, h), cfg)


def _encode(params: Model, enc_embeds, cfg: ModelConfig):
    """Whisper's encoder over the stubbed frontend's frame embeddings (B,
    encoder_seq, D): each layer checkpointed under autograd when
    ``cfg.remat`` is set (the reference checkpoints its scan body), then
    ``enc_final_norm``."""
    h = enc_embeds.to(dtype_of(cfg.dtype))
    for layer in params.enc_stack:
        h = (_remat(_enc_layer, layer, h, cfg=cfg) if cfg.remat
             else _enc_layer(layer, h, cfg=cfg))
    return _norm(cfg, params.enc_final_norm, h)


@torch.no_grad()
def prefill(params: Model, batch, cfg: ModelConfig):
    """Full-sequence pass building the decode cache.

    batch: ``{"tokens": (B, S) int}``; with ``cfg.embeds_input``
    ``{"embeds": (B, S, D)}`` instead, and under M-RoPE ``"positions"``
    (3, B, S) int; whisper also ``{"enc_embeds": (B, encoder_seq, D)}``.
    Returns (cache dict, last-token logits (B, PV) f32); an attention
    model's cache is sized to the prompt, with ``pos = S - 1`` (whisper's
    cross part to the encoder's ``encoder_seq``); Griffin's attention
    cache holds the last min(S, window) positions.
    """
    h, positions = _batch_input(params, batch, cfg)
    if cfg.ssm is not None:
        return _mamba_prefill(params, h, cfg)
    if cfg.rglru is not None:
        return _griffin_prefill(params, h, cfg, positions)
    enc_h = (_encode(params, batch["enc_embeds"], cfg)
             if cfg.encoder_layers else None)
    b, s, _ = h.shape
    cache = _new_cache(cfg, b, s, h.dtype, h.device, torch.empty)
    for layer, entry, window in zip([*params.prefix, *params.layers],
                                    _layer_entries(cfg, cache),
                                    _layer_windows(cfg)):
        h, kv = _attn_half(layer, h, cfg, positions, window, enc_h)
        _fill(entry, kv)
        h = _ffn_half(layer, h, cfg)[0]
    h = _norm(cfg, params.final_norm, h)
    cache["pos"] = s - 1
    return cache, _masked_logits(h[:, -1], params, cfg)


def _mamba_prefill(params: Model, h, cfg: ModelConfig):
    convs, ssms = [], []
    for layer in params.layers:
        out, st = ssm_mod.mamba2_block(layer.mamba, _norm(cfg, layer.ln1, h),
                                       cfg.ssm)
        h = h + out
        convs.append(st["conv"])
        ssms.append(st["ssm"])
    h = _norm(cfg, params.final_norm, h)
    logits = _masked_logits(h[:, -1], params, cfg)
    cache = {"pos": h.shape[1] - 1,
             "layers": {"conv": torch.stack(convs), "ssm": torch.stack(ssms)}}
    return cache, logits


def _rec_half(layer: RecLayer, h, cfg: ModelConfig):
    """norm → RG-LRU block → residual.  Returns (h, the block's decode
    state after the last token)."""
    out, state = ssm_mod.rglru_block(layer.rec, _norm(cfg, layer.ln1, h),
                                     cfg.rglru)
    return _residual(cfg, layer, "ln1", h, out), state


def _griffin_prefill(params: Model, h, cfg: ModelConfig, positions):
    """The layers in order (attention over ``rglru.local_window`` keys);
    the cache keeps each rec layer's state and each attention layer's last
    ``window`` keys and values in sequence order (slots 0..w−1), as the
    reference clips them.  A decode writes slot ``pos % w``
    (:func:`_attn_decode_ring`), so it continues this ring exactly only
    when S is a multiple of the window, and with S < window the ring is S
    slots long: the reference's quirk, kept."""
    b, s, _ = h.shape
    window = cfg.rglru.local_window
    cache = _griffin_cache(cfg, b, s, h.dtype, h.device)
    for i, layer in enumerate(params.layers):
        stack, idx = _stack_index(cfg, i)
        if stack == "attn_stack":
            h, kv = _attn_half(layer, h, cfg, positions, window)
            for dst, src in zip(cache["attn"], kv):
                dst[idx].copy_(src[:, -window:])
        else:
            h, state = _rec_half(layer, h, cfg)
            for k, dst in _rec_state(cache, stack, idx).items():
                dst.copy_(state[k])
        h = _ffn_half(layer, h, cfg)[0]
    h = _norm(cfg, params.final_norm, h)
    cache["pos"] = s - 1
    return cache, _masked_logits(h[:, -1], params, cfg)


def _rec_state(cache: Dict, stack: str, idx) -> Dict:
    """A rec layer's ``{"conv", "h"}`` in a Griffin cache (views)."""
    if stack == "rec_tail":
        return cache["tail"][idx[0]]
    return {k: x[idx] for k, x in cache["rec"].items()}


def _seq_axis(cfg: ModelConfig) -> int:
    """The position axis of an attention cache tensor: (…, S, R) and
    (…, S, dr) under MLA, (…, S, Hkv, dh) else; the batch is the axis
    before it."""
    return -2 if cfg.mla is not None else -3


def _new_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype, device,
               alloc):
    """An attention model's cache, its tensors made by ``alloc``
    (``torch.zeros`` or ``torch.empty``); whisper's cross part once, at
    ``encoder_seq`` positions."""
    if cfg.encoder_layers:
        L, h, dh = cfg.num_layers, cfg.num_heads, cfg.head_dim
        return {"pos": 0, "layers": tuple(
            tuple(alloc((L, batch, n, h, dh), dtype=dtype, device=device)
                  for _ in range(2)) for n in (max_seq, cfg.encoder_seq))}
    if cfg.mla is not None:
        shapes = ((batch, max_seq, cfg.mla.kv_lora_rank),
                  (batch, max_seq, cfg.mla.qk_rope_dim))
    else:
        shapes = ((batch, max_seq, cfg.num_kv_heads, cfg.head_dim),) * 2
    pat, nd = _pattern(cfg), _num_prefix(cfg)
    ls = cfg.num_layers - nd
    lead = (ls // pat, pat) if pat > 1 else (ls,)
    cache = {"pos": 0, "layers": tuple(
        alloc(lead + sh, dtype=dtype, device=device) for sh in shapes)}
    if nd:
        cache["prefix"] = [tuple(alloc(sh, dtype=dtype, device=device)
                                 for sh in shapes) for _ in range(nd)]
    return cache


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device=None) -> Dict:
    """Zero decode cache (the SSM family's state is O(1): ``max_seq`` is
    unused there; Griffin's attention keeps a ring of min(``max_seq``,
    ``local_window``) slots; whisper's cross part holds ``encoder_seq``
    positions, whatever ``max_seq``)."""
    dev = resolve_device(device)
    dtype = dtype_of(cfg.dtype)
    if cfg.rglru is not None:
        return _griffin_cache(cfg, batch, max_seq, dtype, dev)
    if cfg.ssm is None:
        return _new_cache(cfg, batch, max_seq, dtype, dev, torch.zeros)
    _, n_heads, conv_dim, _ = ssm_mod._mamba2_dims(cfg.d_model, cfg.ssm)
    L = cfg.num_layers
    return {
        "pos": 0,
        "layers": {
            "conv": torch.zeros((L, batch, cfg.ssm.d_conv - 1, conv_dim),
                                dtype=dtype, device=dev),
            "ssm": torch.zeros((L, batch, n_heads, cfg.ssm.d_state,
                                cfg.ssm.head_dim), dtype=torch.float32,
                               device=dev),
        },
    }


def _griffin_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
                   device) -> Dict:
    n_groups, tail = _griffin_layout(cfg)
    rg = cfg.rglru
    w = min(max_seq, rg.local_window)
    kv = (n_groups, batch, w, cfg.num_kv_heads, cfg.head_dim)
    state = ssm_mod.init_rglru_state(cfg.d_model, rg, batch, device)
    return {
        "pos": 0,
        "rec": {k: torch.zeros((n_groups, 2) + x.shape, dtype=x.dtype,
                               device=device) for k, x in state.items()},
        "attn": tuple(torch.zeros(kv, dtype=dtype, device=device)
                      for _ in range(2)),
        "tail": [ssm_mod.init_rglru_state(cfg.d_model, rg, batch, device)
                 for _ in range(tail)],
    }


def grow_cache(cfg: ModelConfig, cache: Dict, max_seq: int) -> Dict:
    """An attention cache (a prefill's, sized to its prompt) placed at the
    head of a zero cache of ``max_seq`` positions, so that decoding can go
    on past the prompt.  The position axis is the layout's
    (:func:`_seq_axis`): an MLA tensor has one axis fewer than a GQA one.
    Whisper's cross part has no decode positions: its tensors are kept."""
    axis = _seq_axis(cfg)

    def grow(kv):
        out = []
        for x in kv:
            shape = list(x.shape)
            shape[axis] = max_seq
            big = x.new_zeros(shape)
            big.narrow(axis, 0, x.shape[axis]).copy_(x)
            out.append(big)
        return tuple(out)

    if cfg.encoder_layers:
        self_kv, cross_kv = cache["layers"]
        layers = (grow(self_kv), cross_kv)
    else:
        layers = grow(cache["layers"])
    out = {"pos": cache["pos"], "layers": layers}
    if "prefix" in cache:
        out["prefix"] = [grow(kv) for kv in cache["prefix"]]
    return out


@torch.no_grad()
def decode_step(params: Model, cache: Dict, tokens, cfg: ModelConfig,
                embeds=None):
    """One decode step.  tokens: (B, 1) int, or, for a config that takes
    embeddings, ``embeds`` (B, 1, D) (the token table when it is None).
    Under M-RoPE the token's position is ``pos`` on all three streams, as
    in the JAX package.

    Returns (logits (B, PV) f32, new cache).  The SSM family's is
    functional, as in the JAX package: the cache passed in is left as it
    was.  An attention model writes the new token's K/V (MLA: c_kv,
    k_rope) into the cache's tensors in place (the returned cache holds
    the same tensors, with ``pos`` one on), unlike the JAX package's
    functional cache: a copy would move the whole cache every step.
    Griffin's too, its rec states included.
    """
    pos = cache["pos"] + 1
    h = _embed(params, tokens, cfg, embeds)
    if cfg.ssm is not None:
        h, layers = _mamba_decode_stack(params, h, cache["layers"], cfg)
        new = {"pos": pos, "layers": layers}
    elif cfg.rglru is not None:
        h = _griffin_decode_stack(params, h, cache, cfg, pos)
        new = dict(cache, pos=pos)
    else:
        h = _attn_decode_stack(params, h, cache, cfg, pos)
        new = dict(cache, pos=pos)
    h = _norm(cfg, params.final_norm, h)
    return _masked_logits(h[:, 0], params, cfg), new


def _mamba_decode_stack(params: Model, h, states, cfg: ModelConfig):
    conv, ssm = [], []
    for i, layer in enumerate(params.layers):
        st = {"conv": states["conv"][i], "ssm": states["ssm"][i]}
        out, new = ssm_mod.mamba2_decode(layer.mamba,
                                         _norm(cfg, layer.ln1, h), st,
                                         cfg.ssm)
        conv.append(new["conv"])
        ssm.append(new["ssm"])
        h = h + out
    return h, {"conv": torch.stack(conv), "ssm": torch.stack(ssm)}


def _attn_decode_stack(params: Model, h, cache: Dict, cfg: ModelConfig,
                       pos: int):
    for layer, entry, window in zip([*params.prefix, *params.layers],
                                    _layer_entries(cfg, cache),
                                    _layer_windows(cfg)):
        hin = _norm(cfg, layer.ln1, h)
        if layer.cross is not None:  # whisper: self, then cross attention
            self_kv, cross_kv = entry
            h = h + _attn_decode_full(layer.attn, hin, self_kv, pos, cfg,
                                      window=None)
            out = _cross_decode(layer.cross, _norm(cfg, layer.ln_cross, h),
                                cross_kv, cfg)
            h = _ffn_half(layer, h + out, cfg)[0]
            continue
        if cfg.mla is not None:
            out = _mla_decode(layer.attn, hin, entry, pos, cfg)
        else:
            out = _attn_decode_full(layer.attn, hin, entry, pos, cfg,
                                    window=window)
        h = _ffn_half(layer, _residual(cfg, layer, "ln1", h, out), cfg)[0]
    return h


def _griffin_decode_stack(params: Model, h, cache: Dict, cfg: ModelConfig,
                          pos: int):
    """The layers in order; each rec layer's state and each attention
    layer's ring slot are written in place."""
    kc, vc = cache["attn"]
    for i, layer in enumerate(params.layers):
        stack, idx = _stack_index(cfg, i)
        hin = _norm(cfg, layer.ln1, h)
        if stack == "attn_stack":
            out = _attn_decode_ring(layer.attn, hin, (kc[idx], vc[idx]), pos,
                                    cfg)
        else:
            state = _rec_state(cache, stack, idx)
            out, new = ssm_mod.rglru_decode(layer.rec, hin, state, cfg.rglru)
            for k, x in new.items():
                state[k].copy_(x)
        h = _ffn_half(layer, _residual(cfg, layer, "ln1", h, out), cfg)[0]
    return h


def _attn_decode_ring(p: Attention, h, kv_cache, pos: int, cfg: ModelConfig):
    """Decode against a ring-buffer cache of w slots: the token's K/V go
    to slot ``pos % w`` in place, and every slot up to ``min(pos, w − 1)``
    is attended (no window mask: the ring holds only the window)."""
    b = h.shape[0]
    posv = torch.full((b, 1), pos, device=h.device)
    q, k, v = _qkv(p, h, cfg, posv)
    kc, vc = kv_cache
    w = kc.shape[1]
    kc[:, pos % w] = k[:, 0].to(kc.dtype)
    vc[:, pos % w] = v[:, 0].to(vc.dtype)
    out = decode_attention(q, kc, vc, cur_pos=min(pos, w - 1),
                           softcap=cfg.attn_softcap, scale=cfg.query_scale)
    return (out.reshape(b, 1, -1) @ p.wo).to(h.dtype)


def _cross_decode(p: Attention, h, cross_kv, cfg: ModelConfig):
    """One token's cross attention against the cached encoder keys and
    values: every encoder position valid (``cur_pos = encoder_seq − 1``)."""
    b = h.shape[0]
    q = (h @ p.wq).reshape(b, 1, cfg.num_heads, cfg.head_dim)
    if cfg.qkv_bias:
        q = q + p.bq.reshape(1, 1, cfg.num_heads, cfg.head_dim)
    ck, cv = cross_kv
    out = decode_attention(q, ck, cv, cur_pos=ck.shape[1] - 1)
    return (out.reshape(b, 1, -1) @ p.wo).to(h.dtype)


def _cache_slot(pos: int, size: int) -> int:
    """The slot a decode at ``pos`` writes: ``pos`` clamped into the
    cache, as the JAX package's ``lax.dynamic_update_slice`` clamps its
    start."""
    return min(max(pos, 0), size - 1)


def _mla_decode(p: MLA, h, cache, pos: int, cfg: ModelConfig):
    """MLA decode against the compressed cache, written in place at the
    clamped slot; the weight-absorbed scores in float32."""
    m, hq = cfg.mla, cfg.num_heads
    b = h.shape[0]
    dn, dr, dv, r = m.qk_nope_dim, m.qk_rope_dim, m.v_head_dim, m.kv_lora_rank
    q = (h @ p.w_q_mla).reshape(b, 1, hq, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]
    dkv = h @ p.w_dkv
    c_kv = rms_norm(dkv[..., :r], p.kv_norm.scale, cfg.norm_eps)
    k_rope = dkv[..., r:].reshape(b, 1, 1, dr)
    posv = torch.full((b, 1), pos, device=h.device)
    q_rope, k_rope = apply_rope(q_rope, k_rope, posv, theta=cfg.rope_theta)
    ckv_c, krope_c = cache
    slot = _cache_slot(pos, ckv_c.shape[1])
    ckv_c[:, slot] = c_kv[:, 0].to(ckv_c.dtype)
    krope_c[:, slot] = k_rope[:, 0, 0].to(krope_c.dtype)
    ctx = mla_decode_scores(q_nope[:, 0], q_rope[:, 0], ckv_c, krope_c,
                            p.w_uk, p.w_uv, cur_pos=pos,
                            scale=1.0 / math.sqrt(dn + dr))
    out = ctx.reshape(b, 1, hq * dv) @ p.w_o_mla
    return out.to(h.dtype)


def _attn_decode_full(p: Attention, h, kv_cache, pos: int, cfg: ModelConfig,
                      *, window):
    """Decode against a full-length cache (windowing by mask); writes the
    token's K/V into ``kv_cache`` in place.

    The slot is ``pos`` clamped into the cache, as the JAX package's
    ``lax.dynamic_update_slice`` clamps its start: a decode at
    ``pos >= S`` overwrites slot ``S - 1``, while the mask, at
    ``cur_pos = pos``, takes every slot as valid.  The port keeps that
    quirk of the reference (its serving runs into it: one cache of
    ``max_seq`` 128 for every slot of a replica).  Under M-RoPE the token
    takes ``pos`` on all three position streams, as the reference.
    """
    b = h.shape[0]
    posv = torch.full((3, b, 1) if cfg.rope_kind == "mrope" else (b, 1),
                      pos, device=h.device)
    q, k, v = _qkv(p, h, cfg, posv)
    kc, vc = kv_cache
    slot = _cache_slot(pos, kc.shape[1])
    kc[:, slot] = k[:, 0].to(kc.dtype)
    vc[:, slot] = v[:, 0].to(vc.dtype)
    out = decode_attention(q, kc, vc, cur_pos=pos, window=window,
                           softcap=cfg.attn_softcap, scale=cfg.query_scale)
    out = out.reshape(b, 1, -1) @ p.wo
    return out.to(h.dtype)


# ---------------------------------------------------------------------------
# Training: the full-sequence loss under autograd
# ---------------------------------------------------------------------------


def _check_train(cfg: ModelConfig) -> None:
    """The dense, MoE, Griffin and frontend-stub families train; the SSM
    family raises, with why."""
    if cfg.ssm is not None:
        raise NotImplementedError(
            f"{cfg.name}: SSM training is not ported: its layers run the SSD "
            "chunk kernels (K4/K5), for which neither package has a "
            "backward (the JAX package defines no custom_vjp, and jax.grad "
            "cannot differentiate the Pallas call), so the reference trains "
            "mamba2 only through its plain jnp scan off the TPU")


def _remat(fn, *args, **kwargs):
    """``fn(*args, **kwargs)``, checkpointed (non-reentrant: the backward
    recomputes it, the forward keeps only its inputs) while autograd
    records; the outputs are always the first forward's."""
    if not torch.is_grad_enabled():
        return fn(*args, **kwargs)
    return checkpoint(fn, *args, use_reentrant=False, **kwargs)


def _train_layer(layer: DecoderLayer, h, positions, hot_row, enc_h=None, *,
                 cfg: ModelConfig, window):
    """One decoder layer (whisper's with its cross attention to
    ``enc_h``): (h, new hotness row, aux loss)."""
    h, _ = _attn_half(layer, h, cfg, positions, window, enc_h)
    return _ffn_half(layer, h, cfg, hot_row)


def _train_group(group, h, positions, *, cfg: ModelConfig):
    """Griffin layers in order: a (rec, rec, attn) group, or the
    tail's rec layers."""
    for layer in group:
        if isinstance(layer, RecLayer):
            h, _ = _rec_half(layer, h, cfg)
        else:
            h, _ = _attn_half(layer, h, cfg, positions,
                              cfg.rglru.local_window)
        h = _ffn_half(layer, h, cfg)[0]
    return h


def _griffin_train_stack(params: Model, h, cfg: ModelConfig, positions):
    """Each (rec, rec, attn) group checkpointed as one unit when
    ``cfg.remat`` is set (the reference checkpoints its scan body), then
    the tail's rec layers, not checkpointed (the reference runs them
    outside the scan)."""
    n_groups, _ = _griffin_layout(cfg)
    layers = list(params.layers)
    for g in range(n_groups):
        group = layers[3 * g:3 * g + 3]
        h = (_remat(_train_group, group, h, positions, cfg=cfg) if cfg.remat
             else _train_group(group, h, positions, cfg=cfg))
    return _train_group(layers[3 * n_groups:], h, positions, cfg=cfg)


def _train_stack(params: Model, h, cfg: ModelConfig, positions, hotness,
                 enc_h=None):
    """The prefix layers, then the stack, each checkpointed when
    ``cfg.remat`` is set (the reference checkpoints each scan step: a layer,
    or a pattern group; Griffin's: :func:`_griffin_train_stack`).  MoE
    layer ``i`` takes hotness row ``i``; the aux losses are summed in layer
    order; whisper's layers read the encoder's output ``enc_h``.  Returns
    (h, the new hotness (L − nd, E) or ``None`` without hotness, aux)."""
    aux = torch.zeros((), dtype=torch.float32, device=h.device)
    if cfg.rglru is not None:
        return _griffin_train_stack(params, h, cfg, positions), None, aux
    rows = []
    layers = [*params.prefix, *params.layers]
    hot_rows = [None] * len(params.prefix) + (
        list(hotness) if hotness is not None else [None] * len(params.layers))
    for layer, window, hot in zip(layers, _layer_windows(cfg), hot_rows):
        if cfg.remat:
            h, new_hot, a = _remat(_train_layer, layer, h, positions, hot,
                                   enc_h, cfg=cfg, window=window)
        else:
            h, new_hot, a = _train_layer(layer, h, positions, hot, enc_h,
                                         cfg=cfg, window=window)
        if a is not None:
            aux = aux + a
        if hot is not None:
            rows.append(new_hot)
    return h, (torch.stack(rows) if rows else None), aux


def _chunk_nll(hx, lx, head, cfg: ModelConfig):
    """One chunk's summed negative log-likelihood and label count: float32
    logits, the padded vocab masked to -1e30, ``logsumexp`` minus the gold
    logit, labels < 0 masked."""
    logits = soft_cap((hx @ head).float(), cfg.logit_softcap)
    pad = torch.arange(logits.shape[-1], device=logits.device) >= \
        cfg.vocab_size
    logits = torch.where(pad, -1e30, logits)
    logz = torch.logsumexp(logits, dim=-1)
    gold = logits.gather(-1, lx.clamp(min=0).long()[..., None])[..., 0]
    mask = (lx >= 0).float()
    return ((logz - gold) * mask).sum(), mask.sum()


def _lm_loss(params: Model, h, labels, cfg: ModelConfig, *,
             loss_chunks: int = 8):
    """Chunked cross-entropy over the sequence (``loss_chunks`` chunks when
    S allows, each checkpointed, so the (B, S, PV) float32 logits are never
    kept whole)."""
    b, s, _ = h.shape
    head = _head_matrix(params, cfg)
    chunks = loss_chunks if s % loss_chunks == 0 and s >= loss_chunks else 1
    sc = s // chunks
    loss_sum = torch.zeros((), dtype=torch.float32, device=h.device)
    count = torch.zeros((), dtype=torch.float32, device=h.device)
    for c in range(chunks):
        nll, n = _remat(_chunk_nll, h[:, c * sc:(c + 1) * sc],
                        labels[:, c * sc:(c + 1) * sc], head, cfg)
        loss_sum = loss_sum + nll
        count = count + n
    return loss_sum / torch.clamp(count, min=1.0)


def forward_train(params: Model, batch, cfg: ModelConfig, hotness=None):
    """The training loss: ``batch`` holds ``tokens`` and ``labels``, (B, S)
    int (labels < 0 are ignored), and the frontend stubs' inputs as
    :func:`prefill` takes them (``embeds`` in place of ``tokens``,
    ``positions``, ``enc_embeds``); ``hotness`` is the MoE layers' carried
    FISH hotness, (L − nd, E) float32, or ``None`` (MoE layers then route
    from zero hotness and no new hotness is returned).

    Returns (CE + aux, {"ce_loss", "aux_loss", "new_hotness"}), as the
    reference's ``forward_train``.  Gradients flow to every parameter that
    requires one (``params.requires_grad_(True)``); the hotness carries
    none.  An SSM config raises ``NotImplementedError``."""
    _check_train(cfg)
    h, positions = _batch_input(params, batch, cfg)
    enc_h = (_encode(params, batch["enc_embeds"], cfg)
             if cfg.encoder_layers else None)
    h, new_hot, aux = _train_stack(params, h, cfg, positions, hotness, enc_h)
    h = _norm(cfg, params.final_norm, h)
    loss = _lm_loss(params, h, batch["labels"], cfg)
    return loss + aux, {"ce_loss": loss, "aux_loss": aux,
                        "new_hotness": new_hot}
