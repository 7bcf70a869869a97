"""rwkv6-1.6b [ssm] — 24L d_model=2048 (attention-free) d_ff=7168
vocab=65536; Finch, data-dependent decay.  [arXiv:2404.05892; unverified]

long_500k RUNS: the WKV matrix state is O(1) per token.

A copy of ``src/repro/configs/rwkv6_1_6b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import ModelConfig, RWKVConfig

ARCH_ID = "rwkv6-1.6b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="ssm",
        n_layers=24,
        d_model=2048,
        d_ff=7168,
        vocab_size=65536,
        attn=None,
        rwkv=RWKVConfig(head_dim=64),
        gated_mlp=False,
        activation="silu",
        subquadratic=True,
        max_seq_len=524288,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="ssm",
        n_layers=2,
        d_model=64,
        d_ff=224,
        vocab_size=256,
        attn=None,
        rwkv=RWKVConfig(head_dim=16),
        gated_mlp=False,
        activation="silu",
        subquadratic=True,
    )
