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
runs the layers eagerly, so there is no scan; remat checkpoints each
sublayer (``torch.utils.checkpoint``, non-reentrant), which on one device
keeps what the reference's ``save_only_these_names("tp_reduced")`` policy
keeps: the sublayers' outputs, everything inside recomputed.

The uniform API, as in the reference:
  init_params(cfg, generator, device, dtype) -> LM
  forward(model, tokens, extras) -> logits          # prefill path
  encode(model, enc_input) -> memory                # whisper's encoder
  init_cache(model, batch, max_seq) -> cache
  loss_fn(params, cfg, batch, remat) -> loss        # training path
  decode_step(model, token, cache, pos, extras) -> (logits, cache)

The training path (``train/train_loop.py``) keeps its parameters as the
reference's flat leaves (``stacked_params``: ``blocks/sub{j}/...`` and
``encoder/...`` stacked to (n_groups, ...) / (n_enc_layers, ...)), so the
optimizer's decay rank, the compressions' per-leaf scales and the
checkpoint keys act on the reference's leaves; ``layer_tree`` views them
as the per-layer dicts the forward reads, and gradients flow back into
the stacked leaves.  ``forward`` and ``encode`` are the no-grad prefill
entry points; ``loss_fn`` runs the same bodies with gradients.

``extras``: ``enc_input`` (B, S_enc, d) frame embeddings for an
encoder-decoder forward, ``patches`` (B, n_patches, d) embeddings that
overwrite the first token embeddings of a vision-stub model, and in decode
``enc_memory``, the encoder's output for cross-attention (without it a
decoder layer skips its cross-attention, as the reference's does: its
``ServeEngine`` passes no extras).

``param_axes`` and ``cache_axes`` give the logical sharding axes of the
reference's trees (``distributed/sharding.py`` maps them onto a mesh);
``flat_param_axes`` keys ``param_axes`` by the paths ``stacked_params``
uses.  The reference's ``constrain`` hint at the end of each prefill
sublayer stands here too (a no-op without an active mesh).
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig
from repro_torch.distributed import dtensor_ops as dt
from repro_torch.distributed.sharding import constrain
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
    return _build(cfg, generator, resolve_device(device), dtype)


def _build(cfg: ArchConfig, generator: torch.Generator | None,
           dev: torch.device, dtype: torch.dtype) -> LM:
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


def _named(mod, prefix: str = ""):
    """(path, tensor) of a module tree's parameters, in insertion order."""
    for name, t in mod.items():
        if isinstance(t, torch.Tensor):
            yield f"{prefix}{name}", t
        else:
            yield from _named(t, f"{prefix}{name}/")


def init_leaf_parts(cfg: ArchConfig, generator: torch.Generator, take,
                    device: "str | torch.device" = "cuda") -> None:
    """``stacked_params(init_params(cfg, generator, device))`` a weight at
    a time: ``take(path, index, tensor)`` gets each random weight as soon
    as it is drawn, in ``init_params``' order and from the same generator
    (so with the same values), and a layer's constants after them;
    ``tensor`` is the whole fp32 leaf ``path`` (index None) or its slice
    ``index`` along the stacked dimension.  No more than one drawn weight
    is held here at once, if ``take`` keeps none."""
    dev = resolve_device(device)
    plan = layer_plan(cfg)
    held = []                         # the placeholders, kept apart by id

    def run(build, top: str, index: int | None) -> None:
        order: list = []
        with L.draws_to(lambda p: order.append(p) or p):
            ids = {id(p): path for path, p in
                   _named(build(None, torch.device("meta")))}
        names = iter([ids[id(p)] for p in order])
        placeholders: set[int] = set()

        def sink(p):
            take(f"{top}/{next(names)}", index, p.detach())
            held.append(nn.Parameter(torch.empty(0, device=dev),
                                     requires_grad=False))
            placeholders.add(id(held[-1]))
            return held[-1]
        with L.draws_to(sink):
            mod = build(generator, dev)
        for path, t in _named(mod):
            if id(t) not in placeholders:
                take(f"{top}/{path}", index, t.detach())
        held.clear()

    kw = dict(dtype=torch.float32)
    run(lambda g, d: L.init_embed(g, cfg.vocab, cfg.d_model,
                                  tie=cfg.tie_embeddings, device=d, **kw),
        "embed", None)
    for i in range(cfg.n_groups * cfg.period):
        j = i % cfg.period
        run(lambda g, d: _init_sublayer(g, cfg, plan[j], device=d, **kw),
            f"blocks/sub{j}", i // cfg.period)
    if cfg.is_encdec:
        for i in range(cfg.n_enc_layers):
            run(lambda g, d: _init_sublayer(g, cfg, LayerKind(mixer="attn"),
                                            device=d, **kw), "encoder", i)
        run(lambda g, d: L.init_rmsnorm(cfg.d_model, device=d, **kw),
            "enc_norm", None)
    run(lambda g, d: L.init_rmsnorm(cfg.d_model, device=d, **kw),
        "final_norm", None)


# ---------------------------------------------------------- logical axes ----
def _sublayer_axes(cfg: ArchConfig, kind: LayerKind) -> dict:
    ax: dict = {"ln1": L.rmsnorm_axes()}
    if kind.mixer == "attn":
        ax["attn"] = L.attention_axes()
    elif kind.mixer == "mamba":
        ax["mamba"] = mamba_lib.mamba_axes()
    elif kind.mixer == "mlstm":
        ax["mlstm"] = xlstm_lib.mlstm_axes()
    elif kind.mixer == "slstm":
        ax["slstm"] = xlstm_lib.slstm_axes()
    if kind.cross:
        ax["ln_x"] = L.rmsnorm_axes()
        ax["cross"] = L.attention_axes()
    if kind.moe:
        ax["ln2"] = L.rmsnorm_axes()
        ax["moe"] = moe_lib.moe_axes(cfg.act)
        if cfg.dense_residual:
            ax["dense_mlp"] = L.mlp_axes(cfg.act)
    elif kind.mlp or kind.mixer == "slstm":
        ax["ln2"] = L.rmsnorm_axes()
        ax["mlp"] = L.mlp_axes(cfg.act)
    return ax


def _stack_axes(tree):
    if isinstance(tree, dict):
        return {k: _stack_axes(v) for k, v in tree.items()}
    return ("layers", *tree)


def param_axes(cfg: ArchConfig) -> dict:
    """Logical-axis names mirroring the reference's ``init_params`` tree
    (stacked leaves: a leading "layers")."""
    plan = layer_plan(cfg)
    blocks = {f"sub{j}": _sublayer_axes(cfg, plan[j])
              for j in range(len(plan))}
    axes = {
        "embed": L.embed_axes(tie=cfg.tie_embeddings),
        "blocks": _stack_axes(blocks),
        "final_norm": L.rmsnorm_axes(),
    }
    if cfg.is_encdec:
        enc = _sublayer_axes(cfg, LayerKind(mixer="attn"))
        axes["encoder"] = _stack_axes(enc)
        axes["enc_norm"] = L.rmsnorm_axes()
    return axes


def flat_param_axes(cfg: ArchConfig) -> dict[str, tuple]:
    """``param_axes`` keyed by ``stacked_params``' paths, sorted."""
    flat: dict[str, tuple] = {}

    def walk(tree, prefix):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = v
    walk(param_axes(cfg), "")
    return dict(sorted(flat.items()))


def cache_axes(cfg: ArchConfig) -> dict:
    """Logical-axis names of the reference's decode cache (keyed by
    ``sub{j}``, leaves stacked over period groups: a leading "layers";
    layer g * period + j of ``init_cache`` holds row g of them)."""
    plan = layer_plan(cfg)
    c = {}
    for j, kind in enumerate(plan):
        if kind.mixer == "attn":
            kv = ("layers", "batch", "kv_seq", "kv_heads", "head_dim")
            c[f"sub{j}"] = {"k": kv, "v": kv}
        elif kind.mixer == "mamba":
            c[f"sub{j}"] = {"h": ("layers", "batch", "mlp", "state"),
                            "conv": ("layers", "batch", "conv", "mlp")}
        elif kind.mixer == "mlstm":
            c[f"sub{j}"] = {"c": ("layers", "batch", "heads", None, None),
                            "n": ("layers", "batch", "heads", "head_dim"),
                            "m": ("layers", "batch", "heads")}
        else:
            ax = ("layers", "batch", "heads", "head_dim")
            c[f"sub{j}"] = {"c": ax, "n": ax, "m": ax, "h": ax}
    return c


# ------------------------------------------------------------ sublayer ------
def _ffn(p, x, cfg: ArchConfig, kind: LayerKind):
    """The FFN half of a sublayer (MoE over the flattened tokens, with
    arctic's dense residual; a dense FFN; or none), residual added."""
    if kind.moe:
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        t = dt.reshape(h, -1, cfg.d_model)
        y = moe_lib.moe_ffn(p["moe"], t, n_experts=cfg.n_experts,
                            top_k=cfg.experts_per_tok, act=cfg.act,
                            capacity_factor=cfg.moe_capacity_factor)
        if cfg.dense_residual:
            y = y + L.mlp(p["dense_mlp"], t, cfg.act)
        return x + dt.reshape(y, x.shape).to(x.dtype)
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
    return constrain(_ffn(p, x, cfg, kind), "batch", "seq", "embed")


# ---------------------------------------------------------------- forward ---
def _tree(model: "LM | dict") -> dict:
    """The layer tree the bodies read: an LM's own modules, or a dict
    from ``layer_tree``."""
    if isinstance(model, dict):
        return model
    return {"embed": model.embed, "layers": list(model.layers),
            "final_norm": model.final_norm,
            "encoder": None if model.encoder is None else list(model.encoder),
            "enc_norm": model.enc_norm}


def _encode(cfg: ArchConfig, tree: dict, enc_input) -> torch.Tensor:
    """The encoder's body (``model.py:245-262``), with gradients when grad
    mode is on."""
    dev = tree["embed"]["emb"].device
    x = torch.as_tensor(enc_input, device=dev)
    for p in tree["encoder"]:
        h = L.rmsnorm(p["ln1"], x, cfg.norm_eps)
        x = x + L.attention_train(
            p["attn"], h, n_heads=cfg.n_heads, n_kv=cfg.n_kv_heads,
            d_head=cfg.head_dim, causal=False)
        h = L.rmsnorm(p["ln2"], x, cfg.norm_eps)
        x = x + L.mlp(p["mlp"], h, cfg.act)
    return L.rmsnorm(tree["enc_norm"], x, cfg.norm_eps)


def _forward(cfg: ArchConfig, tree: dict, tokens, *, extras=None, pos0=0,
             remat: bool = False) -> torch.Tensor:
    """The forward's body (``model.py:265-290``), with gradients when
    grad mode is on; ``remat`` checkpoints each decoder sublayer."""
    extras = extras or {}
    dev = tree["embed"]["emb"].device
    plan = layer_plan(cfg)
    tokens = torch.as_tensor(tokens, device=dev).long()
    x = L.embed(tree["embed"], tokens)
    if cfg.vision_stub and "patches" in extras:
        patches = torch.as_tensor(extras["patches"], device=dev)
        x[:, :patches.shape[1]] = patches.to(x.dtype)
    memory = None
    if cfg.is_encdec:
        if "enc_input" not in extras:
            raise ValueError(f"{cfg.name}: an encoder-decoder forward needs "
                             f"extras['enc_input'] (B, S_enc, d_model)")
        memory = _encode(cfg, tree, extras["enc_input"])
    for i, p in enumerate(tree["layers"]):
        kind = plan[i % cfg.period]
        if remat:
            x = checkpoint(_apply_sublayer, p, x, cfg, kind, memory=memory,
                           pos0=pos0, use_reentrant=False)
        else:
            x = _apply_sublayer(p, x, cfg, kind, memory=memory, pos0=pos0)
    x = L.rmsnorm(tree["final_norm"], x, cfg.norm_eps)
    return L.unembed(tree["embed"], x, cfg.logit_softcap)


@torch.no_grad()
def encode(model: LM, enc_input) -> torch.Tensor:
    """Whisper's encoder over stubbed frame embeddings (B, S_enc, d):
    non-causal self-attention (one flash launch a layer) and the GELU
    FFN, then ``enc_norm``."""
    return _encode(model.cfg, _tree(model), enc_input)


@torch.no_grad()
def forward(model: LM, tokens, *, extras=None, pos0=0) -> torch.Tensor:
    """Prefill forward: tokens (B, S) -> logits (B, S, V), one flash
    attention launch per attention layer on the card (and per encoder
    layer and cross-attention of an encoder-decoder).  An
    encoder-decoder needs ``extras["enc_input"]``."""
    return _forward(model.cfg, _tree(model), tokens, extras=extras,
                    pos0=pos0)


def loss_fn(params: "LM | dict", cfg: ArchConfig, batch: dict, *,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token NLL (``model.py:293-302``): logits in fp32, then
    ``log_softmax``; labels < 0 are masked; sum / max(count, 1).  The
    batch's keys other than ``tokens`` and ``labels`` are the forward's
    ``extras``.  ``params``: an LM, or a ``layer_tree``."""
    logits = _forward(cfg, _tree(params), batch["tokens"],
                      extras={k: v for k, v in batch.items()
                              if k not in ("tokens", "labels")},
                      remat=remat)
    labels = torch.as_tensor(batch["labels"], device=logits.device).long()
    logp = torch.log_softmax(logits.to(torch.float32), dim=-1)
    nll = -torch.take_along_dim(logp, labels.clamp(min=0)[..., None],
                                dim=-1)[..., 0]
    mask = (labels >= 0).to(torch.float32)
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)


# ------------------------------------------------ the reference's leaves ---
def _leaf_sources(model: LM) -> dict[str, list[torch.Tensor]]:
    """Each reference leaf's path -> the port parameters it stacks (one
    for an unstacked leaf), in stacking order."""
    cfg = model.cfg
    src: dict[str, list[torch.Tensor]] = {}
    for top, mod in (("embed", model.embed), ("final_norm", model.final_norm),
                     ("enc_norm", model.enc_norm)):
        if mod is not None:
            for name, t in mod.items():
                src[f"{top}/{name}"] = [t]

    def stacked(top: str, layers: list) -> None:
        for sub, params in layers[0].items():
            for name in params.keys():
                src[f"{top}/{sub}/{name}"] = [layer[sub][name]
                                              for layer in layers]

    for j in range(cfg.period):
        stacked(f"blocks/sub{j}", list(model.layers)[j::cfg.period])
    if model.encoder is not None:
        stacked("encoder", list(model.encoder))
    return dict(sorted(src.items()))


def leaf_shapes(cfg: ArchConfig) -> dict[str, tuple[int, ...]]:
    """The reference's leaf paths for ``cfg``, sorted, each with its shape
    as ``stacked_params`` gives it, read off the model built on the meta
    device: no weight is allocated, at any width."""
    model = _build(cfg, None, torch.device("meta"), torch.float32)
    top_level = ("embed/", "final_norm/", "enc_norm/")
    return {path: (tuple(ts[0].shape) if path.startswith(top_level)
                   else (len(ts), *ts[0].shape))
            for path, ts in _leaf_sources(model).items()}


def stacked_params(model: LM) -> dict[str, torch.Tensor]:
    """The model's parameters as the reference's flat leaves, sorted by
    path (jax's leaf order): ``embed/emb``, ``final_norm/scale``, ...;
    sublayer j's weights of every period group stacked under
    ``blocks/sub{j}/...`` to (n_groups, ...), the encoder's under
    ``encoder/...`` to (n_enc_layers, ...).  New tensors (copies)."""
    top_level = ("embed/", "final_norm/", "enc_norm/")
    return {path: (ts[0].detach().clone() if path.startswith(top_level)
                   else torch.stack([t.detach() for t in ts]))
            for path, ts in _leaf_sources(model).items()}


def layer_tree(flat: dict[str, torch.Tensor], cfg: ArchConfig) -> dict:
    """The reference's flat leaves -> the layer tree the forward reads:
    leaf ``blocks/sub{j}/m/w`` [g] becomes ``layers[g * period + j][m][w]``
    and ``encoder/m/w`` [l] ``encoder[l][m][w]``, as views (``unbind``), so
    a gradient taken through the tree lands on the stacked leaf."""
    tree: dict = {"embed": {}, "final_norm": {}, "enc_norm": None,
                  "layers": [{} for _ in range(cfg.n_groups * cfg.period)],
                  "encoder": ([{} for _ in range(cfg.n_enc_layers)]
                              if cfg.is_encdec else None)}
    for path, t in flat.items():
        parts = path.split("/")
        if parts[0] == "blocks":
            j = int(parts[1][len("sub"):])
            for g, view in enumerate(t.unbind(0)):
                layer = tree["layers"][g * cfg.period + j]
                layer.setdefault(parts[2], {})[parts[3]] = view
        elif parts[0] == "encoder":
            for i, view in enumerate(t.unbind(0)):
                tree["encoder"][i].setdefault(parts[1], {})[parts[2]] = view
        else:
            tree[parts[0]] = tree[parts[0]] or {}
            tree[parts[0]][parts[1]] = t
    return tree


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
    return _decode(model.cfg, _tree(model), token, cache, pos,
                   extras=extras), cache


def _decode(cfg: ArchConfig, tree: dict, token, cache: list[dict], pos: int,
            *, extras=None) -> torch.Tensor:
    """The decode step's body over a layer tree: logits (B, 1, V)."""
    dev = tree["embed"]["emb"].device
    plan = layer_plan(cfg)
    memory = (extras or {}).get("enc_memory")
    if memory is not None:
        memory = torch.as_tensor(memory, device=dev)
    token = torch.as_tensor(token, device=dev).long()
    x = L.embed(tree["embed"], token)
    for i, (sp, c) in enumerate(zip(tree["layers"], cache)):
        x = _decode_sublayer(sp, x, c, cfg, plan[i % cfg.period], int(pos),
                             memory)
    x = L.rmsnorm(tree["final_norm"], x, cfg.norm_eps)
    return L.unembed(tree["embed"], x, cfg.logit_softcap)
