"""grok-1-314b [moe]: 64 layers, d_model 6144, 48 query heads over 8 KV
heads (head_dim 128), vocab 131072; each layer's FFN is a top-2 mixture of
8 GeGLU experts of width 32768.  316,489,340,928 parameters, 84,561,106,944
of them touched per token (about 633 GB in bf16: more than one card holds).
[hf:xai-org/grok-1]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="grok-1-314b", arch_type="moe",
    n_layers=64, d_model=6144, n_heads=48, n_kv_heads=8, head_dim=128,
    d_ff=32768, vocab=131072,
    n_experts=8, top_k=2,
    activation="gelu",
    rope_theta=1e4,
)
