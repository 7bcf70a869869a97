"""gemma-7b [dense] — 28L d_model=3072 16H (kv=16) d_ff=24576 vocab=256000;
GeGLU, head_dim=256.  [arXiv:2403.08295; hf]

A copy of ``src/repro/configs/gemma_7b.py`` with torch dtypes (the port
imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig

ARCH_ID = "gemma-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=28,
        d_model=3072,
        d_ff=24576,
        vocab_size=256000,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=256,
                        rope_theta=10000.0),
        gated_mlp=True,
        activation="gelu",           # GeGLU
        tie_embeddings=True,
        embed_scale=True,
        subquadratic=False,          # pure full attention: long_500k skipped
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=64,
        d_ff=256,
        vocab_size=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=32),
        gated_mlp=True,
        activation="gelu",
        tie_embeddings=True,
        embed_scale=True,
    )
