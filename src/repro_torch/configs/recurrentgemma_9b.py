"""recurrentgemma-9b — RG-LRU + local attention, 1 attn : 2 recurrent
[arXiv:2402.19427]."""
from repro_torch.models.model import ArchConfig
from repro_torch.models.rglru import RGLRUParams

ID = "recurrentgemma-9b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=4096,
        n_layers=38,
        n_heads=16,
        n_kv_heads=1,
        head_dim=256,
        d_ff=12288,
        vocab=256000,
        pattern=("rec", "rec", "local"),
        window=2048,
        rglru=RGLRUParams(d_rnn=4096, conv_width=4, n_blocks=16),
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        mlp_act="gelu",
        norm_eps=1e-6,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=5,  # 1 full group + tail of 2 — exercises the tail path
        n_heads=2,
        n_kv_heads=1,
        head_dim=32,
        d_ff=128,
        vocab=256,
        pattern=("rec", "rec", "local"),
        window=16,
        rglru=RGLRUParams(d_rnn=64, conv_width=4, n_blocks=4),
        norm_plus_one=True,
        embed_scale=True,
        tie_embeddings=True,
        mlp_act="gelu",
    )
