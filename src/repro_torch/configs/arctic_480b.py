"""arctic-480b — 128 experts top-2 + dense residual [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.models.model import ArchConfig
from repro_torch.models.moe import MoEParams

ID = "arctic-480b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=7168,
        n_layers=35,
        n_heads=56,
        n_kv_heads=8,
        d_ff=4864,
        vocab=32000,
        pattern=("attn",),
        moe=MoEParams(n_experts=128, top_k=2, d_ff=4864, dense_residual=True),
        rope_theta=1e6,
        norm_eps=1e-5,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=2,
        n_heads=7,  # keeps the non-divisible-heads (seq-parallel) path honest
        n_kv_heads=1,
        head_dim=16,
        d_ff=48,
        vocab=256,
        pattern=("attn",),
        moe=MoEParams(n_experts=8, top_k=2, d_ff=48, dense_residual=True, capacity_factor=4.0),
    )
