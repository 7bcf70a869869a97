"""qwen2-vl-2b [vlm] — 28L d_model=1536 12H (GQA kv=2) d_ff=8960
vocab=151936; M-RoPE, dynamic resolution.  [arXiv:2409.12191; hf]

The vision frontend (ViT patch encoder) is a stub, as in the reference:
the model takes precomputed patch/text embeddings (``input_embeds``) and
the three M-RoPE position streams (t, h, w) as ``positions`` (3, B, S).

A copy of ``src/repro/configs/qwen2_vl_2b.py`` on the port's ``ModelConfig`` (the
port imports nothing of the JAX package)."""

from repro_torch.models.config import AttnConfig, ModelConfig

ARCH_ID = "qwen2-vl-2b"


def config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID,
        family="vlm",
        n_layers=28,
        d_model=1536,
        d_ff=8960,
        vocab_size=151936,
        attn=AttnConfig(n_heads=12, n_kv_heads=2, head_dim=128,
                        rope_theta=1000000.0, mrope=True,
                        mrope_sections=(16, 24, 24)),
        gated_mlp=True,
        activation="silu",
        subquadratic=False,
        max_seq_len=32768,
    )


def smoke_config() -> ModelConfig:
    return ModelConfig(
        name=ARCH_ID + "-smoke",
        family="vlm",
        n_layers=2,
        d_model=64,
        d_ff=128,
        vocab_size=256,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16, mrope=True,
                        mrope_sections=(2, 3, 3)),
        gated_mlp=True,
        activation="silu",
    )
