"""olmoe-1b-7b [moe] — 16L d_model=2048 16H (GQA kv=16) d_ff=1024
vocab=50304, MoE 64 experts top-8.  [arXiv:2409.02060; hf]

A copy of ``src/repro/configs/olmoe_1b_7b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig

ARCH_ID = "olmoe-1b-7b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=16,
        d_model=2048,
        d_ff=1024,
        vocab_size=50304,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                        rope_theta=10000.0, qk_norm=True),
        moe=MoEConfig(n_experts=64, top_k=8, d_expert=1024),
        gated_mlp=True,
        activation="silu",
        subquadratic=False,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=2,
        d_model=64,
        d_ff=32,
        vocab_size=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16, qk_norm=True),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=32),
        gated_mlp=True,
        activation="silu",
    )
