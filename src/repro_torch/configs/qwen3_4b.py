"""qwen3-4b [dense]: 36 layers, d_model 2560, 32 query heads over 8 KV
heads (head_dim 128), d_ff 9728, vocab 151936; RMS norm on each query
and key head (qk-norm), RoPE theta 1e6, tied embeddings.  4,022,468,096
parameters.  [hf:Qwen/Qwen3-4B]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen3-4b", arch_type="dense",
    n_layers=36, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=128,
    d_ff=9728, vocab=151936,
    qk_norm=True, tie_embeddings=True,
    rope_theta=1e6,
)
