"""xlstm-350m [ssm]: sLSTM + mLSTM blocks (7:1). [arXiv:2405.04517; unverified]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="xlstm_350m", family="ssm",
    n_layers=24, d_model=1024, n_heads=4, n_kv_heads=4,
    d_ff=0, vocab=50304,
    ssm="xlstm", slstm_period=8,
    tie_embeddings=True,
    sub_quadratic=True,
    notes="mLSTM blocks (pf=2 internal) + 1 sLSTM per 8 with 4/3 FFN",
)
