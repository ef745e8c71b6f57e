"""jamba-v0.1-52b [hybrid]: mamba+attn 1:7 interleave, 16-expert MoE.
[arXiv:2403.19887; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="jamba_v01_52b", family="hybrid",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab=65536,
    n_experts=16, experts_per_tok=2, moe_period=2,
    ssm="mamba", attn_period=8, d_state=16,
    sub_quadratic=True,
    notes="period 8: 1 attention + 7 mamba; MoE every 2nd layer",
)
