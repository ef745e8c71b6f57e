"""grok-1-314b [moe]: 8 experts top-2. [hf:xai-org/grok-1; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok_1_314b", family="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=32768, vocab=131072,
    n_experts=8, experts_per_tok=2, moe_period=1,
    attn_softcap=30.0,
    sub_quadratic=False,
    notes="8 experts < TP axis: experts replicate, expert d_ff TP-shards",
)
