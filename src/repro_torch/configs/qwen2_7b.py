"""qwen2-7b — GQA + QKV bias [arXiv:2407.10671]."""
from repro_torch.models.model import ArchConfig

ID = "qwen2-7b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=3584,
        n_layers=28,
        n_heads=28,
        n_kv_heads=4,
        d_ff=18944,
        vocab=152064,
        attn_bias=True,
        rope_theta=1e6,
        norm_eps=1e-6,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=3,
        n_heads=4,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        attn_bias=True,
    )
