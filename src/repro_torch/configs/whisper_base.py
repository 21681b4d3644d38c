"""whisper-base [audio]: an encoder of 6 layers over 1,536 stub frame
embeddings (the mel-spectrogram and conv frontend are not modelled; 1,500
frames padded to 1,536) and a decoder of 6 layers that cross-attends to
it; d_model 512, 8 heads (MHA, head_dim 64), d_ff 2048 (a biased GELU
MLP), vocab 51865, LayerNorm, learned positions, tied embeddings.
73,542,144 parameters with learned positions for 4,096 decoder slots.
[arXiv:2212.04356]"""
from repro_torch.configs.base import ArchConfig

CONFIG = ArchConfig(
    name="whisper-base", arch_type="audio",
    n_layers=6, encoder_layers=6,
    d_model=512, n_heads=8, n_kv_heads=8, head_dim=64,
    d_ff=2048, vocab=51865,
    norm="ln", pos="learned", tie_embeddings=True,
    source_positions=1536,
    blockwise_train=False,
)
