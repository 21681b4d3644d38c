"""h2o-danube-1.8b [dense]: 24 layers, d_model 2560, 32 query heads over
8 KV heads (head_dim 80), d_ff 6912, vocab 32000; Llama layers with
Mistral's sliding-window attention (window 4096).  1,831,201,280
parameters.  [arXiv:2401.16818]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="h2o-danube-1.8b", arch_type="dense",
    n_layers=24, d_model=2560, n_heads=32, n_kv_heads=8, head_dim=80,
    d_ff=6912, vocab=32000,
    sliding_window=4096,
)
