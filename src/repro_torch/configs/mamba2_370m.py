"""mamba2-370m [ssm]: 48 attention-free Mamba-2 layers, d_model 1024,
vocab 50280; 32 SSD heads of 64 (expand 2, d_inner 2048), state 128, one
group, chunk 64; tied embeddings.  368,338,432 parameters.
[arXiv:2405.21060]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="mamba2-370m", arch_type="ssm",
    n_layers=48, d_model=1024, n_heads=0, n_kv_heads=0,
    d_ff=0, vocab=50280,
    ssm_state=128, ssm_heads=32, ssm_head_dim=64, ssm_chunk=64,
    tie_embeddings=True,
)
