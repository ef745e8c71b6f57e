"""whisper-small [audio]: enc-dec, conv frontend stubbed as precomputed
frame embeddings. 12L decoder + 12L encoder, MHA (kv=12).
[arXiv:2212.04356; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper_small", family="audio",
    n_layers=12, d_model=768, n_heads=12, n_kv_heads=12,
    d_ff=3072, vocab=51865,
    is_encdec=True, n_enc_layers=12, enc_seq=1500,
    act="gelu", tie_embeddings=True,
    sub_quadratic=False,
    notes="audio frontend stub: input_specs provides frame embeddings",
)
