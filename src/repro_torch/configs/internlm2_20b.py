"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544.  [arXiv:2403.17297; hf]

A copy of ``src/repro/configs/internlm2_20b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig

ARCH_ID = "internlm2-20b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="dense",
        n_layers=48,
        d_model=6144,
        d_ff=16384,
        vocab_size=92544,
        attn=AttnConfig(n_heads=48, n_kv_heads=8, head_dim=128,
                        rope_theta=1000000.0),
        gated_mlp=True,
        activation="silu",
        subquadratic=False,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="dense",
        n_layers=2,
        d_model=96,
        d_ff=256,
        vocab_size=256,
        attn=AttnConfig(n_heads=6, n_kv_heads=2, head_dim=16),
        gated_mlp=True,
        activation="silu",
    )
