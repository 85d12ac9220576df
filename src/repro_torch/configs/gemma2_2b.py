"""gemma2-2b — local/global alternating attention + logit softcaps [arXiv:2408.00118]."""
from repro_torch.models.model import ArchConfig

ID = "gemma2-2b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=2304,
        n_layers=26,
        n_heads=8,
        n_kv_heads=4,
        head_dim=256,
        d_ff=9216,
        vocab=256000,
        pattern=("local", "attn"),
        window=4096,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        mlp_act="gelu",
        rope_theta=10000.0,
        norm_eps=1e-6,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=4,
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab=256,
        pattern=("local", "attn"),
        window=16,
        attn_softcap=50.0,
        final_softcap=30.0,
        post_norms=True,
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        mlp_act="gelu",
    )
