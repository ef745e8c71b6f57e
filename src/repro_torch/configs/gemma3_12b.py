"""gemma3-12b [dense]: 5:1 local:global, 128k context.
[hf:google/gemma-3-1b-pt; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma3_12b", family="dense",
    n_layers=48, d_model=3840, n_heads=16, n_kv_heads=8,
    d_ff=15360, vocab=262144,
    window=1024, local_global_period=6,
    act="swiglu", tie_embeddings=True, rope_theta=1e6,
    sub_quadratic=True,   # 5/6 of layers sliding-window
    notes="5 local : 1 global per period of 6",
)
