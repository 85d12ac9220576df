"""mistral-large-123b [hf:mistralai/Mistral-Large-Instruct-2407]."""
from repro_torch.models.model import ArchConfig

ID = "mistral-large-123b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=12288,
        n_layers=88,
        n_heads=96,
        n_kv_heads=8,
        head_dim=128,
        d_ff=28672,
        vocab=32768,
        rope_theta=1e6,
        norm_eps=1e-5,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=4,
        n_heads=8,
        n_kv_heads=2,
        head_dim=8,
        d_ff=128,
        vocab=256,
    )
