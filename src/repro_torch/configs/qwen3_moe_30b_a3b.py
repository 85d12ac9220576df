"""qwen3-moe-30b-a3b — 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B]."""
from repro_torch.models.model import ArchConfig
from repro_torch.models.moe import MoEParams

ID = "qwen3-moe-30b-a3b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=2048,
        n_layers=48,
        n_heads=32,
        n_kv_heads=4,
        head_dim=128,
        d_ff=768,
        vocab=151936,
        pattern=("attn",),
        moe=MoEParams(n_experts=128, top_k=8, d_ff=768),
        rope_theta=1e6,
        norm_eps=1e-6,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=2,
        n_heads=4,
        n_kv_heads=2,
        head_dim=16,
        d_ff=32,
        vocab=256,
        pattern=("attn",),
        moe=MoEParams(n_experts=8, top_k=2, d_ff=32, capacity_factor=4.0),
        rope_theta=1e6,
    )
