"""mamba2-2.7b — SSD (state-space duality) [arXiv:2405.21060]."""
from repro_torch.models.model import ArchConfig
from repro_torch.models.ssm import SSMParams

ID = "mamba2-2.7b"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=2560,
        n_layers=64,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=50280,
        pattern=("ssm",),
        mlp_kind="none",
        ssm=SSMParams(d_inner=5120, head_dim=64, state_dim=128, n_groups=1, chunk=256),
        tie_embeddings=True,
        norm_eps=1e-5,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=4,
        n_heads=0,
        n_kv_heads=0,
        d_ff=0,
        vocab=256,
        pattern=("ssm",),
        mlp_kind="none",
        ssm=SSMParams(d_inner=128, head_dim=32, state_dim=16, n_groups=1, chunk=16),
        tie_embeddings=True,
        norm_eps=1e-5,
    )
