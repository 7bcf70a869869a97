"""granite-34b [dense] — 88L d_model=6144 48H (MQA kv=1) d_ff=24576
vocab=49152; code model.  [arXiv:2405.04324; hf]

MQA (kv=1): KV projections are replicated across the TP axis (they are tiny)
while Q heads shard 48/16; the decode KV cache seq-shards over "model".

A copy of ``src/repro/configs/granite_34b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig

ARCH_ID = "granite-34b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=88,
        d_model=6144,
        d_ff=24576,
        vocab_size=49152,
        attn=AttnConfig(n_heads=48, n_kv_heads=1, head_dim=128,
                        rope_theta=10000.0),
        gated_mlp=False,             # GPT-BigCode style 4x plain MLP
        activation="gelu",
        subquadratic=False,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=3,
        d_model=64,
        d_ff=256,
        vocab_size=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=1, head_dim=16),
        gated_mlp=False,
        activation="gelu",
    )
