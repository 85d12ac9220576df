"""yi-6b — llama-arch GQA [arXiv:2403.04652]."""
from repro_torch.models.model import ArchConfig

ID = "yi-6b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=4096,
        n_layers=32,
        n_heads=32,
        n_kv_heads=4,
        d_ff=11008,
        vocab=64000,
        rope_theta=5e6,
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
    )
