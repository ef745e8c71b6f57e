"""Model assembly: config -> init / prefill forward / decode.

Port of ``repro/models/model.py``, every mixer and modality of it:
attention (with gemma's local / global windows), Mamba, mLSTM and sLSTM
mixers; dense, MoE and MoE-plus-dense-residual (arctic) FFNs; whisper's
encoder and decoder cross-attention; llava's patch stub.  The reference
stacks each period group's parameters into (n_groups, ...) leaves for
``lax.scan``; here the model is an ``nn.Module`` whose ``layers`` list
holds layer ``g * period + j`` (sublayer ``sub{j}`` of group ``g``) as an
``nn.ModuleDict`` with the reference's names (``ln1``, one of ``attn`` /
``mamba`` / ``mlstm`` / ``slstm``, then ``ln_x`` and ``cross``, ``ln2`` and
``mlp`` / ``moe`` / ``dense_mlp`` as the layer has them), each weight in
the reference's layout; an encoder-decoder model also has ``encoder``
(layer l of the reference's stacked ``encoder``) and ``enc_norm``.  PyTorch
runs the layers eagerly, so there is no scan and no remat (remat matters
only to a backward pass, which the port does not have yet).

The uniform API, as in the reference:
  init_params(cfg, generator, device, dtype) -> LM
  forward(model, tokens, extras) -> logits          # prefill path
  encode(model, enc_input) -> memory                # whisper's encoder
  init_cache(model, batch, max_seq) -> cache
  decode_step(model, token, cache, pos, extras) -> (logits, cache)

``extras``: ``enc_input`` (B, S_enc, d) frame embeddings for an
encoder-decoder forward, ``patches`` (B, n_patches, d) embeddings that
overwrite the first token embeddings of a vision-stub model, and in decode
``enc_memory``, the encoder's output for cross-attention (without it a
decoder layer skips its cross-attention, as the reference's does: its
``ServeEngine`` passes no extras).  The training half (``loss_fn``, the
``*_axes`` functions) waits for the training slice (ROADMAP queue 1,
item 10).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import xlstm as xlstm_lib


@dataclasses.dataclass(frozen=True)
class LayerKind:
    mixer: str          # 'attn' | 'mamba' | 'mlstm' | 'slstm'
    window: int = 0     # 0 = global attention
    moe: bool = False
    mlp: bool = True    # has an FFN sublayer (False for xlstm blocks)
    cross: bool = False


def layer_plan(cfg: ArchConfig) -> list[LayerKind]:
    """The repeating pattern of one period group."""
    plan = []
    for j in range(cfg.period):
        # mixer choice
        if cfg.ssm == "xlstm":
            mixer = ("slstm" if cfg.slstm_period and
                     (j % cfg.slstm_period == cfg.slstm_period - 1)
                     else "mlstm")
        elif cfg.ssm == "mamba":
            is_attn = cfg.attn_period and (
                j % cfg.attn_period == cfg.attn_period // 2)
            mixer = "attn" if is_attn else "mamba"
        else:
            mixer = "attn"
        # local/global window pattern (gemma: global every p-th layer)
        window = 0
        if cfg.local_global_period and mixer == "attn":
            if j % cfg.local_global_period != cfg.local_global_period - 1:
                window = cfg.window
        elif cfg.window and not cfg.local_global_period:
            window = cfg.window
        moe = bool(cfg.n_experts) and (j % cfg.moe_period
                                       == cfg.moe_period - 1)
        mlp = cfg.d_ff > 0 and not (mixer in ("mlstm",))
        plan.append(LayerKind(mixer=mixer, window=window, moe=moe, mlp=mlp,
                              cross=cfg.is_encdec))
    return plan


class LM(nn.Module):
    """A decoder LM of ``layer_plan``'s sublayers, with whisper's encoder
    when the config is an encoder-decoder."""

    def __init__(self, cfg: ArchConfig, embed: nn.ParameterDict,
                 layers: list[nn.ModuleDict],
                 final_norm: nn.ParameterDict,
                 encoder: list[nn.ModuleDict] | None = None,
                 enc_norm: nn.ParameterDict | None = None):
        super().__init__()
        self.cfg = cfg
        self.plan = layer_plan(cfg)
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm
        self.encoder = None if encoder is None else nn.ModuleList(encoder)
        self.enc_norm = enc_norm

    @property
    def device(self) -> torch.device:
        return self.embed["emb"].device

    def kind(self, i: int) -> LayerKind:
        return self.plan[i % self.cfg.period]

    def forward(self, tokens, *, extras=None, pos0=0):
        return forward(self, tokens, extras=extras, pos0=pos0)


# --------------------------------------------------------------- init -------
def _init_sublayer(gen, cfg: ArchConfig, kind: LayerKind, *, device,
                   dtype) -> nn.ModuleDict:
    """One sublayer's parameters, named and shaped as the reference's
    ``_init_sublayer`` (``repro/models/model.py:75-104``)."""
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p = {"ln1": L.init_rmsnorm(d, **kw)}
    if kind.mixer == "attn":
        p["attn"] = L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                     cfg.head_dim, **kw)
    elif kind.mixer == "mamba":
        p["mamba"] = mamba_lib.init_mamba(gen, d, d_state=cfg.d_state, **kw)
    elif kind.mixer == "mlstm":
        p["mlstm"] = xlstm_lib.init_mlstm(gen, d, cfg.n_heads, **kw)
    else:
        p["slstm"] = xlstm_lib.init_slstm(gen, d, cfg.n_heads, **kw)
    if kind.cross:
        p["ln_x"] = L.init_rmsnorm(d, **kw)
        p["cross"] = L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                      cfg.head_dim, **kw)
    if kind.moe:
        p["ln2"] = L.init_rmsnorm(d, **kw)
        p["moe"] = moe_lib.init_moe(gen, d, cfg.d_ff, cfg.n_experts,
                                    cfg.act, **kw)
        if cfg.dense_residual:
            p["dense_mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act, **kw)
    elif kind.mlp:
        p["ln2"] = L.init_rmsnorm(d, **kw)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act, **kw)
    elif kind.mixer == "slstm":
        p["ln2"] = L.init_rmsnorm(d, **kw)
        p["mlp"] = L.init_mlp(gen, d, max(1, 4 * d // 3), cfg.act, **kw)
    return nn.ModuleDict(p)


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device: "str | torch.device" = "cuda",
                dtype: torch.dtype = torch.float32) -> LM:
    """The model with every random weight drawn from ``generator`` (a
    ``torch.Generator`` on ``device``) at the reference's scales, in fp32,
    then cast to ``dtype``; the reference's constants (norm scales, Mamba's
    ``dt_bias`` / ``A_log`` / ``D`` / ``conv_b``, mLSTM's ``fb``, sLSTM's
    bias) are set as it sets them.  The draws differ from jax's for any
    seed: to compare the two packages, convert the reference's tree
    instead (``core/convert.lm_params_from_numpy``).  ``generator=None``
    leaves the random weights uninitialized for the converter to fill."""
    dev = resolve_device(device)
    plan = layer_plan(cfg)
    kw = dict(device=dev, dtype=dtype)
    embed = L.init_embed(generator, cfg.vocab, cfg.d_model,
                         tie=cfg.tie_embeddings, **kw)
    layers = [_init_sublayer(generator, cfg, plan[i % cfg.period], **kw)
              for i in range(cfg.n_groups * cfg.period)]
    encoder = enc_norm = None
    if cfg.is_encdec:
        encoder = [_init_sublayer(generator, cfg, LayerKind(mixer="attn"),
                                  **kw) for _ in range(cfg.n_enc_layers)]
        enc_norm = L.init_rmsnorm(cfg.d_model, **kw)
    return LM(cfg, embed, layers, L.init_rmsnorm(cfg.d_model, **kw),
              encoder, enc_norm)


# ------------------------------------------------------------ sublayer ------
def _ffn(p, x, cfg: ArchConfig, kind: LayerKind):
    """The FFN half of a sublayer (MoE over the flattened tokens, with
    arctic's dense residual; a dense FFN; or none), residual added."""
    if kind.moe:
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        t = h.reshape(-1, cfg.d_model)
        y = moe_lib.moe_ffn(p["moe"], t, n_experts=cfg.n_experts,
                            top_k=cfg.experts_per_tok, act=cfg.act,
                            capacity_factor=cfg.moe_capacity_factor)
        if cfg.dense_residual:
            y = y + L.mlp(p["dense_mlp"], t, cfg.act)
        return x + y.reshape(x.shape).to(x.dtype)
    if "mlp" in p:
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        return x + L.mlp(p["mlp"], h, cfg.act).to(x.dtype)
    return x


def _apply_sublayer(p, x, cfg: ArchConfig, kind: LayerKind, *,
                    memory=None, pos0=0):
    """One sublayer of the prefill forward (``model.py:205-243``)."""
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    if kind.mixer == "attn":
        mix = L.attention_train(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            d_head=cfg.head_dim, causal=True, window=kind.window,
            softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta, pos0=pos0)
    elif kind.mixer == "mamba":
        mix = mamba_lib.mamba_forward(p["mamba"], h, d_state=cfg.d_state)
    elif kind.mixer == "mlstm":
        mix = xlstm_lib.mlstm_forward(p["mlstm"], h)
    else:
        mix = xlstm_lib.slstm_forward(p["slstm"], h)
    x = x + mix.to(x.dtype)
    if kind.cross and memory is not None:
        h = L.rmsnorm(p["ln_x"], x, cfg.norm_eps)
        x = x + L.attention_train(
            p["cross"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            d_head=cfg.head_dim, causal=False, memory=memory).to(x.dtype)
    return _ffn(p, x, cfg, kind)


# ---------------------------------------------------------------- forward ---
@torch.no_grad()
def encode(model: LM, enc_input) -> torch.Tensor:
    """Whisper's encoder over stubbed frame embeddings (B, S_enc, d):
    non-causal self-attention (one flash launch a layer) and the GELU
    FFN, then ``enc_norm`` (``model.py:245-262``)."""
    cfg = model.cfg
    x = torch.as_tensor(enc_input, device=model.device)
    for p in model.encoder:
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + L.attention_train(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            d_head=cfg.head_dim, causal=False)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, cfg.act)
    return L.rmsnorm(model.enc_norm, x, cfg.norm_eps)


@torch.no_grad()
def forward(model: LM, tokens, *, extras=None, pos0=0) -> torch.Tensor:
    """Prefill forward: tokens (B, S) -> logits (B, S, V), one flash
    attention launch per attention layer on the card (and per encoder
    layer and cross-attention of an encoder-decoder).  An
    encoder-decoder needs ``extras["enc_input"]``."""
    cfg = model.cfg
    extras = extras or {}
    tokens = torch.as_tensor(tokens, device=model.device).long()
    x = L.embed(model.embed, tokens)
    if cfg.vision_stub and "patches" in extras:
        patches = torch.as_tensor(extras["patches"], device=model.device)
        x[:, :patches.shape[1]] = patches.to(x.dtype)
    memory = None
    if cfg.is_encdec:
        if "enc_input" not in extras:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             f"extras['enc_input'] (B, S_enc, d_model)")
        memory = encode(model, extras["enc_input"])
    for i, p in enumerate(model.layers):
        x = _apply_sublayer(p, x, cfg, model.kind(i), memory=memory,
                            pos0=pos0)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg.logit_softcap)


# ----------------------------------------------------------------- decode ---
def _init_sublayer_cache(p, cfg: ArchConfig, kind: LayerKind, batch: int,
                         max_seq: int, kv_dtype: torch.dtype,
                         device: torch.device) -> dict:
    if kind.mixer == "attn":
        shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
        return {"k": torch.zeros(shape, dtype=kv_dtype, device=device),
                "v": torch.zeros(shape, dtype=kv_dtype, device=device)}
    if kind.mixer == "mamba":
        return mamba_lib.init_mamba_cache(p["mamba"], batch)
    if kind.mixer == "mlstm":
        return xlstm_lib.init_mlstm_cache(p["mlstm"], batch)
    return xlstm_lib.init_slstm_cache(p["slstm"], batch)


def init_cache(model: LM, batch: int, max_seq: int,
               kv_dtype: torch.dtype = torch.float32) -> list[dict]:
    """One state dict per layer: layer g * period + j holds the
    reference's cache["sub{j}"][...][g].  Attention: ``k``, ``v`` of
    (batch, max_seq, n_kv, dh) in ``kv_dtype``; Mamba: ``h``, ``conv``;
    mLSTM: ``c``, ``n``, ``m``; sLSTM: ``c``, ``n``, ``m``, ``h``; the
    recurrent states in fp32 whatever the weights' dtype."""
    return [_init_sublayer_cache(p, model.cfg, model.kind(i), batch,
                                 max_seq, kv_dtype, model.device)
            for i, p in enumerate(model.layers)]


def _decode_sublayer(sp, x, c: dict, cfg: ArchConfig, kind: LayerKind,
                     pos: int, memory=None):
    """One sublayer of one-token decode (``model.py:333-383``); updates
    the layer's state dict ``c`` in place and returns x."""
    h = L.rmsnorm(sp["ln1"], x, cfg.norm_eps)
    if kind.mixer == "attn":
        mix, c["k"], c["v"] = L.attention_decode(
            sp["attn"], h, c["k"], c["v"], pos, n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, window=kind.window,
            softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)
    elif kind.mixer == "mamba":
        mix, new = mamba_lib.mamba_decode_step(sp["mamba"], h, c,
                                               d_state=cfg.d_state)
        c.update(new)
    elif kind.mixer == "mlstm":
        mix, new = xlstm_lib.mlstm_decode_step(sp["mlstm"], h, c)
        c.update(new)
    else:
        mix, new = xlstm_lib.slstm_decode_step(sp["slstm"], h, c)
        c.update(new)
    x = x + mix.to(x.dtype)
    if kind.cross and memory is not None:
        h = L.rmsnorm(sp["ln_x"], x, cfg.norm_eps)
        y, _, _ = L.attention_decode(
            sp["cross"], h, c.get("k"), c.get("v"), pos,
            n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads, d_head=cfg.head_dim,
            memory=memory)
        x = x + y.to(x.dtype)
    return _ffn(sp, x, cfg, kind)


@torch.no_grad()
def decode_step(model: LM, token, cache: list[dict], pos: int, *,
                extras=None):
    """One-token decode. token: (B, 1) ints; pos: the shared position;
    ``extras["enc_memory"]``: the encoder's output for cross-attention.

    Updates ``cache`` in place and returns (logits (B, 1, V), cache)."""
    cfg = model.cfg
    memory = (extras or {}).get("enc_memory")
    if memory is not None:
        memory = torch.as_tensor(memory, device=model.device)
    token = torch.as_tensor(token, device=model.device).long()
    x = L.embed(model.embed, token)
    for i, (sp, c) in enumerate(zip(model.layers, cache)):
        x = _decode_sublayer(sp, x, c, cfg, model.kind(i), int(pos), memory)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg.logit_softcap), cache
