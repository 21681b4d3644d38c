"""qwen1.5-110b [dense]: 80 layers, d_model 8192, 64 query heads over 8 KV
heads (head_dim 128), d_ff 49152, vocab 152064, QKV bias, RoPE theta 1e6.
111,209,914,368 parameters (about 222 GB in bf16: more than one card
holds).  [hf:Qwen/Qwen1.5-0.5B scaled per assignment]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="qwen1.5-110b", arch_type="dense",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8, head_dim=128,
    d_ff=49152, vocab=152064,
    qkv_bias=True,
    rope_theta=1e6,
)
