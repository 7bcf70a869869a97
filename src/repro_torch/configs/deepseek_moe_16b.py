"""deepseek-moe-16b [moe] — 28L d_model=2048 16H (GQA kv=16) d_ff=1408
vocab=102400, MoE 64 routed top-6 + 2 shared, fine-grained; first layer
dense.  [arXiv:2401.06066; hf]

A copy of ``src/repro/configs/deepseek_moe_16b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig, MoEConfig

ARCH_ID = "deepseek-moe-16b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="moe",
        n_layers=28,
        d_model=2048,
        d_ff=1408,
        vocab_size=102400,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                        rope_theta=10000.0),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      first_k_dense=1),
        gated_mlp=True,
        activation="silu",
        subquadratic=False,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="moe",
        n_layers=3,
        d_model=64,
        d_ff=48,
        vocab_size=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=48, n_shared=2,
                      first_k_dense=1),
        gated_mlp=True,
        activation="silu",
    )
