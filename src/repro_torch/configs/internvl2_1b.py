"""internvl2-1b [vlm]: a Qwen2-0.5B-style decoder, 24 layers, d_model 896,
14 query heads over 2 KV heads (head_dim 64), d_ff 4864, vocab 151655, QKV
bias, RoPE theta 1e6, tied embeddings, reading 256 stub vision tokens (the
InternViT frontend is not modelled: its patch embeddings are inputs)
ahead of the text.  493,780,992 parameters.  [arXiv:2404.16821]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-1b", arch_type="vlm",
    n_layers=24, d_model=896, n_heads=14, n_kv_heads=2, head_dim=64,
    d_ff=4864, vocab=151655,
    qkv_bias=True, tie_embeddings=True,
    vision_tokens=256,
    blockwise_train=False,
    rope_theta=1e6,
)
