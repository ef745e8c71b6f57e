"""Architecture configuration schema + shape registry.

The port's own copy of ``repro/configs/base.py`` (pure data; the port
imports nothing of the reference).  Every assigned architecture is a frozen
``ArchConfig``; the four input shapes (train_4k / prefill_32k / decode_32k
/ long_500k) are global constants.  ``smoke()`` derives the reduced
same-family config used by the CPU parity tests.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: int = 0             # 0 -> d_model // n_heads
    # --- MoE ---
    n_experts: int = 0
    experts_per_tok: int = 2
    moe_period: int = 1         # MoE every `moe_period` layers (if experts>0)
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    moe_capacity_factor: float = 1.25  # train-time drop policy (GShard)
    # --- attention pattern ---
    window: int = 0             # sliding-window size for local layers
    local_global_period: int = 0  # every p-th layer is global (others local)
    attn_softcap: float = 0.0
    logit_softcap: float = 0.0
    # --- hybrid / ssm ---
    attn_period: int = 0        # jamba: 1 attention layer per `attn_period`
    ssm: str = ""               # '' | 'mamba' | 'xlstm'
    slstm_period: int = 0       # xlstm: 1 sLSTM per `slstm_period` blocks
    d_state: int = 16
    # --- enc-dec / multimodal ---
    is_encdec: bool = False
    n_enc_layers: int = 0
    enc_seq: int = 1500         # whisper audio frames (stubbed embeddings)
    vision_stub: bool = False
    n_patches: int = 0
    # --- misc ---
    act: str = "swiglu"
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    tie_embeddings: bool = False
    sub_quadratic: bool = False  # eligible for long_500k
    notes: str = ""

    @property
    def head_dim(self) -> int:
        return self.d_head or self.d_model // self.n_heads

    @property
    def period(self) -> int:
        """Length of the repeating layer pattern (scan group size)."""
        p = 1
        for v in (self.moe_period, self.local_global_period, self.attn_period,
                  self.slstm_period):
            if v:
                p = _lcm(p, v)
        return p

    @property
    def n_groups(self) -> int:
        assert self.n_layers % self.period == 0, (self.name, self.n_layers,
                                                  self.period)
        return self.n_layers // self.period

    def _period_params(self) -> int:
        """Analytic parameter count of one period of layers."""
        d, f = self.d_model, self.d_ff
        dh = self.head_dim
        n_attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
        n_mlp = d * f * (3 if self.act == "swiglu" else 2)
        total = 0
        for kind in _plan(self):
            if kind.mixer == "attn":
                total += n_attn
            elif kind.mixer == "mamba":
                di = 2 * d
                total += (d * 2 * di + di * d
                          + di * (d // 16 + 2 * self.d_state)
                          + (d // 16) * di)
            elif kind.mixer == "mlstm":
                di = 2 * d
                total += d * 2 * di + di * d + 3 * di * di + 2 * di
            elif kind.mixer == "slstm":
                total += 4 * d * d + d * d + 4 * d * (d // self.n_heads)
            if kind.moe:
                total += self.n_experts * n_mlp + d * self.n_experts
                if self.dense_residual:
                    total += n_mlp
            elif kind.mlp:
                total += n_mlp
        return total

    def total_params(self) -> int:
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        enc = 0
        if self.is_encdec:
            dh = self.head_dim
            n_attn = d * dh * (self.n_heads * 2 + self.n_kv_heads * 2)
            n_mlp = d * self.d_ff * (3 if self.act == "swiglu" else 2)
            enc = self.n_enc_layers * (n_attn + n_mlp)
            emb += self.n_layers * n_attn            # decoder cross-attn
        return emb + enc + self._period_params() * self.n_groups

    def active_params_per_token(self) -> int:
        """N_active for the 6*N*D MoE roofline convention."""
        if not self.n_experts:
            return self.total_params()
        d, f = self.d_model, self.d_ff
        n_mlp = d * f * (3 if self.act == "swiglu" else 2)
        moe_layers = sum(1 for k in _plan(self) if k.moe) * self.n_groups
        inactive = moe_layers * (self.n_experts - self.experts_per_tok) * n_mlp
        return self.total_params() - inactive

    def smoke(self) -> "ArchConfig":
        """Reduced same-family config for CPU smoke tests."""
        return dataclasses.replace(
            self,
            name=self.name + "-smoke",
            n_layers=self.period * (2 if self.period <= 4 else 1),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2),
            d_head=16,
            d_ff=128 if self.d_ff else 0,
            vocab=256,
            n_experts=min(self.n_experts, 4),
            window=min(self.window, 32) if self.window else 0,
            enc_seq=24,
            n_enc_layers=min(self.n_enc_layers, 2),
            n_patches=min(self.n_patches, 8),
        )


def _lcm(a: int, b: int) -> int:
    import math
    return a * b // math.gcd(a, b)


def _plan(cfg):
    from repro_torch.models.model import layer_plan
    return layer_plan(cfg)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str                   # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
