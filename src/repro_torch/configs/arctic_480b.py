"""arctic-480b [moe]: 128 experts top-2 + dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="arctic_480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=4864, vocab=32000,
    n_experts=128, experts_per_tok=2, moe_period=1, dense_residual=True,
    sub_quadratic=False,
    notes="dense-MoE hybrid: dense FFN residual in parallel with MoE",
)
