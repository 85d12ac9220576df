"""pixtral-12b — pixtral-ViT frontend (STUB: precomputed patch embeddings)
+ mistral-nemo decoder [hf:mistralai/Pixtral-12B-2409]."""
from repro_torch.models.model import ArchConfig

ID = "pixtral-12b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=5120,
        n_layers=40,
        n_heads=32,
        n_kv_heads=8,
        head_dim=128,
        d_ff=14336,
        vocab=131072,
        frontend="patches",
        frontend_len=1024,
        rope_theta=1e9,
        norm_eps=1e-5,
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
        frontend="patches",
        frontend_len=8,
    )
