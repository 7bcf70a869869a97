"""seamless-m4t-large-v2 [audio] — enc-dec, 24L d_model=1024 16H (kv=16)
d_ff=8192 vocab=256206; multimodal.  [arXiv:2308.11596; hf]

The speech frontend (conformer feature extractor) is a stub, as in the
reference: the encoder takes precomputed frame embeddings (``enc_embeds``).

A copy of ``src/repro/configs/seamless_m4t_large_v2.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig

ARCH_ID = "seamless-m4t-large-v2"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="audio",
        n_layers=24,                 # decoder layers
        n_encoder_layers=24,
        encdec=True,
        d_model=1024,
        d_ff=8192,
        vocab_size=256206,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=64,
                        rope_theta=10000.0),
        gated_mlp=False,
        activation="gelu",
        subquadratic=False,
        max_seq_len=8192,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="audio",
        n_layers=2,
        n_encoder_layers=2,
        encdec=True,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        gated_mlp=False,
        activation="gelu",
    )
