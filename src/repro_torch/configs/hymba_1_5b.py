"""hymba-1.5b [hybrid] — 32L d_model=1600 25H (GQA kv=5) d_ff=5504
vocab=32001, ssm_state=16; parallel attention + Mamba heads.
[arXiv:2411.13676; hf]

Layers combine attention and SSM head outputs (mean), with sliding-window
attention on most layers (1 global layer per 16 approximates Hymba's three
full-attention layers).  long_500k RUNS (SSM state is O(1), window is
bounded).

A copy of ``src/repro/configs/hymba_1_5b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig, SSMConfig

ARCH_ID = "hymba-1.5b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="hybrid",
        n_layers=32,
        d_model=1600,
        d_ff=5504,
        vocab_size=32001,
        attn=AttnConfig(n_heads=25, n_kv_heads=5, head_dim=64,
                        rope_theta=10000.0, window=1024, pattern_period=16),
        ssm=SSMConfig(state_dim=16, conv_width=4, expand=2),
        gated_mlp=True,
        activation="silu",
        subquadratic=True,
        max_seq_len=524288,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="hybrid",
        n_layers=2,
        d_model=80,                  # 5 heads x 16
        d_ff=128,
        vocab_size=256,
        attn=AttnConfig(n_heads=5, n_kv_heads=1, head_dim=16, window=8),
        ssm=SSMConfig(state_dim=4, conv_width=4, expand=2),
        gated_mlp=True,
        activation="silu",
        subquadratic=True,
    )
