"""whisper-tiny — enc-dec; conv frontend STUB (precomputed frame
embeddings) [arXiv:2212.04356]."""
from repro_torch.models.model import ArchConfig

ID = "whisper-tiny"


def config() -> ArchConfig:
    return ArchConfig(
        name=ID,
        d_model=384,
        n_layers=4,
        n_heads=6,
        n_kv_heads=6,
        d_ff=1536,
        vocab=51865,
        pattern=("encdec",),
        enc_dec=True,
        enc_layers=4,
        enc_seq=1500,
        frontend="frames",
        norm="ln",
        mlp_kind="plain",
        mlp_act="gelu",
        learned_pos=True,
        max_learned_pos=32768,
        tie_embeddings=True,
        norm_eps=1e-5,
    )


def reduced_config() -> ArchConfig:
    return ArchConfig(
        name=ID + "-smoke",
        d_model=64,
        n_layers=2,
        n_heads=2,
        n_kv_heads=2,
        d_ff=128,
        vocab=256,
        pattern=("encdec",),
        enc_dec=True,
        enc_layers=2,
        enc_seq=24,
        frontend="frames",
        norm="ln",
        mlp_kind="plain",
        mlp_act="gelu",
        learned_pos=True,
        max_learned_pos=128,
        tie_embeddings=True,
        norm_eps=1e-5,
    )
