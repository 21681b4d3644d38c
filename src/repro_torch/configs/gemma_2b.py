"""gemma-2b [dense]: 18 layers, d_model 2048, 8 query heads over one KV
head (MQA, head_dim 256), d_ff 16384, vocab 256000; GeGLU, embeddings
scaled by sqrt(d) and tied to the output head.  2,506,172,416
parameters.  [arXiv:2403.08295]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="gemma-2b", arch_type="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, head_dim=256,
    d_ff=16384, vocab=256000,
    activation="gelu",
    tie_embeddings=True, embed_scale=True,
    blockwise_train=False,
)
