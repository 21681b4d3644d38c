"""granite-moe-3b-a800m [moe]: 32 layers, d_model 1536, 24 query heads over
8 KV heads (head_dim 64), vocab 49155, tied embeddings; each layer's FFN is
a token-choice top-8 mixture of 40 SwiGLU experts of width 512.
3,298,793,472 parameters, 882,874,368 of them touched per token.
[hf:ibm-granite/granite-3.0-1b-a400m-base family]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="granite-moe-3b-a800m", arch_type="moe",
    n_layers=32, d_model=1536, n_heads=24, n_kv_heads=8, head_dim=64,
    d_ff=512, vocab=49155,
    n_experts=40, top_k=8,
    tie_embeddings=True,
    moe_token_parallel=True,
)
