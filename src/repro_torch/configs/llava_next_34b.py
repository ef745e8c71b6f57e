"""llava-next-34b [vlm]: yi-34b backbone, anyres patch embeddings stubbed.
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="llava_next_34b", family="vlm",
    n_layers=60, d_model=7168, n_heads=56, n_kv_heads=8,
    d_ff=20480, vocab=64000,
    vision_stub=True, n_patches=1152,
    rope_theta=5e6,
    sub_quadratic=False,
    notes="anyres tiling stub: input_specs provides patch embeddings",
)
