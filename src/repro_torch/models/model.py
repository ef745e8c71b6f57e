"""Model assembly, dense-attention half: config -> init / forward / decode.

Port of ``repro/models/model.py``.  The reference stacks each period
group's parameters into (n_groups, ...) leaves for ``lax.scan``; here the
model is an ``nn.Module`` whose ``layers`` list holds layer
``g * period + j`` (sublayer ``sub{j}`` of group ``g``) as an
``nn.ModuleDict`` of ``ln1``, ``attn``, ``ln2`` and ``mlp``, each weight in
the reference's layout.  PyTorch runs the layers eagerly, so there is no
scan and no remat (remat matters only to a backward pass, which the port
does not have yet).

The uniform API, as in the reference:
  init_params(cfg, generator, device, dtype) -> LM
  forward(model, tokens) -> logits                  # prefill path
  init_cache(model, batch, max_seq) -> cache
  decode_step(model, token, cache, pos) -> (logits, cache)

Only attention mixers with dense FFNs are ported.  Mamba, MoE, mLSTM /
sLSTM, cross-attention (whisper) and the vision stub (llava's patches)
raise ``NotImplementedError`` naming ROADMAP queue 1, item 16.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.models import layers as L

_TODO = "not ported yet: ROADMAP queue 1, item 16"


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


def _check_ported(cfg: ArchConfig) -> list[LayerKind]:
    plan = layer_plan(cfg)
    for kind in plan:
        if kind.mixer != "attn":
            raise NotImplementedError(
                f"{cfg.name}: the {kind.mixer} mixer is {_TODO} "
                f"(models/{'mamba' if kind.mixer == 'mamba' else 'xlstm'}.py)")
        if kind.moe:
            raise NotImplementedError(f"{cfg.name}: the MoE FFN is {_TODO} "
                                      f"(models/moe.py)")
        if kind.cross:
            raise NotImplementedError(
                f"{cfg.name}: the encoder and cross-attention are {_TODO}")
    return plan


class LM(nn.Module):
    """A decoder-only LM of attention and dense-FFN layers."""

    def __init__(self, cfg: ArchConfig, embed: nn.ParameterDict,
                 layers: list[nn.ModuleDict],
                 final_norm: nn.ParameterDict):
        super().__init__()
        self.cfg = cfg
        self.plan = _check_ported(cfg)
        self.embed = embed
        self.layers = nn.ModuleList(layers)
        self.final_norm = final_norm

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
    d = cfg.d_model
    kw = dict(device=device, dtype=dtype)
    p = {"ln1": L.init_rmsnorm(d, **kw),
         "attn": L.init_attention(gen, d, cfg.n_heads, cfg.n_kv_heads,
                                  cfg.head_dim, **kw)}
    if kind.mlp:
        p["ln2"] = L.init_rmsnorm(d, **kw)
        p["mlp"] = L.init_mlp(gen, d, cfg.d_ff, cfg.act, **kw)
    return nn.ModuleDict(p)


def init_params(cfg: ArchConfig, generator: torch.Generator | None,
                device: "str | torch.device" = "cuda",
                dtype: torch.dtype = torch.float32) -> LM:
    """The model with every weight drawn from ``generator`` (a
    ``torch.Generator`` on ``device``) at the reference's scales, in fp32,
    then cast to ``dtype``.  The draws differ from jax's for any seed: to
    compare the two packages, convert the reference's tree instead
    (``core/convert.lm_params_from_numpy``).  ``generator=None`` leaves the
    weights uninitialized for the converter to fill."""
    dev = resolve_device(device)
    plan = _check_ported(cfg)
    kw = dict(device=dev, dtype=dtype)
    embed = L.init_embed(generator, cfg.vocab, cfg.d_model,
                         tie=cfg.tie_embeddings, **kw)
    layers = [_init_sublayer(generator, cfg, plan[i % cfg.period], **kw)
              for i in range(cfg.n_groups * cfg.period)]
    return LM(cfg, embed, layers, L.init_rmsnorm(cfg.d_model, **kw))


# ---------------------------------------------------------------- forward ---
def _no_extras(cfg: ArchConfig, extras) -> None:
    if extras:
        raise NotImplementedError(
            f"{cfg.name}: extras {sorted(extras)} (the vision stub's patch "
            f"embeddings, the encoder's input or memory) are {_TODO}")


def _apply_sublayer(p, x, cfg: ArchConfig, kind: LayerKind, *, pos0=0):
    h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
    mix = L.attention_train(
        p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
        d_head=cfg.head_dim, causal=True, window=kind.window,
        softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta, pos0=pos0)
    x = x + mix.to(x.dtype)
    if "mlp" in p:
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, cfg.act).to(x.dtype)
    return x


@torch.no_grad()
def forward(model: LM, tokens, *, extras=None, pos0=0) -> torch.Tensor:
    """Prefill forward: tokens (B, S) -> logits (B, S, V), one flash
    attention launch per layer on the card."""
    cfg = model.cfg
    _no_extras(cfg, extras)
    tokens = torch.as_tensor(tokens, device=model.device).long()
    x = L.embed(model.embed, tokens)
    for i, p in enumerate(model.layers):
        x = _apply_sublayer(p, x, cfg, model.kind(i), pos0=pos0)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg.logit_softcap)


# ----------------------------------------------------------------- decode ---
def init_cache(model: LM, batch: int, max_seq: int,
               kv_dtype: torch.dtype = torch.float32) -> list[dict]:
    """One {"k", "v"} pair of (batch, max_seq, n_kv, dh) zeros per layer:
    layer g * period + j holds the reference's cache["sub{j}"][...][g]."""
    cfg = model.cfg
    shape = (batch, max_seq, cfg.n_kv_heads, cfg.head_dim)
    return [{"k": torch.zeros(shape, dtype=kv_dtype, device=model.device),
             "v": torch.zeros(shape, dtype=kv_dtype, device=model.device)}
            for _ in model.layers]


@torch.no_grad()
def decode_step(model: LM, token, cache: list[dict], pos: int, *,
                extras=None):
    """One-token decode. token: (B, 1) ints; pos: the shared position.

    Updates ``cache`` in place and returns (logits (B, 1, V), cache)."""
    cfg = model.cfg
    _no_extras(cfg, extras)
    token = torch.as_tensor(token, device=model.device).long()
    x = L.embed(model.embed, token)
    for i, (sp, c) in enumerate(zip(model.layers, cache)):
        kind = model.kind(i)
        h = L.rmsnorm(sp["ln1"], x, cfg.norm_eps)
        mix, c["k"], c["v"] = L.attention_decode(
            sp["attn"], h, c["k"], c["v"], int(pos), n_heads=cfg.n_heads,
            n_kv=cfg.n_kv_heads, d_head=cfg.head_dim, window=kind.window,
            softcap=cfg.attn_softcap, rope_theta=cfg.rope_theta)
        x = x + mix.to(x.dtype)
        if "mlp" in sp:
            h = L.rmsnorm(sp["ln2"], x, cfg.norm_eps)
            x = x + L.mlp(sp["mlp"], h, cfg.act).to(x.dtype)
    x = L.rmsnorm(model.final_norm, x, cfg.norm_eps)
    return L.unembed(model.embed, x, cfg.logit_softcap), cache
