"""hymba-1.5b [hybrid]: 32 layers, d_model 1600, 25 query heads over 5 KV
heads (head_dim 64), d_ff 5504, vocab 32001; each layer runs attention
and 25 Mamba-2 heads (state 16) in parallel on the same input, with
sliding-window attention (1024).  Meta-tokens are omitted, as in the
reference.  1,393,625,120 parameters.  [arXiv:2411.13676]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="hymba-1.5b", arch_type="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5, head_dim=64,
    d_ff=5504, vocab=32001,
    ssm_state=16, ssm_heads=25, ssm_head_dim=64, ssm_chunk=64,
    sliding_window=1024,
)
