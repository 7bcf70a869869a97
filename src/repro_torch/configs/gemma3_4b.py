"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144; 5:1 local:global attention, 128k context.
[hf:google/gemma-3-1b-pt; unverified]

long_500k RUNS: 5/6 of layers use a 1024-token sliding window (O(S*w)) and
the global layers are linear-in-KV at decode.

A copy of ``src/repro/configs/gemma3_4b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig

ARCH_ID = "gemma3-4b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=34,
        d_model=2560,
        d_ff=10240,
        vocab_size=262144,
        attn=AttnConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                        rope_theta=10000.0, window=1024, pattern_period=6,
                        qk_norm=True),
        gated_mlp=True,
        activation="gelu",
        tie_embeddings=True,
        embed_scale=True,
        subquadratic=True,
        max_seq_len=524288,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=6,                  # one full local:global period
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, window=8,
                        pattern_period=6, qk_norm=True),
        gated_mlp=True,
        activation="gelu",
        tie_embeddings=True,
        embed_scale=True,
        subquadratic=True,
    )
