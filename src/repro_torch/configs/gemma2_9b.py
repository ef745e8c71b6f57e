"""gemma2-9b [dense]: local+global alternating attention, logit softcap.
[arXiv:2408.00118; hf]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma2_9b", family="dense",
    n_layers=42, d_model=3584, n_heads=16, n_kv_heads=8,
    d_ff=14336, vocab=256000,
    window=4096, local_global_period=2,
    attn_softcap=50.0, logit_softcap=30.0,
    act="swiglu", tie_embeddings=True,
    sub_quadratic=True,   # half the layers are sliding-window
    notes="1:1 local:global alternation; softcaps per gemma2",
)
