"""The LM zoo of the port, counterpart of ``repro.models``: the dense, moe,
ssm, hybrid (Zamba2) and encoder-decoder (Whisper) families, for training
and serving."""
from repro_torch.models.api import (
    EncDecConfig,
    HybridConfig,
    ModelConfig,
    MoEConfig,
    SSMConfig,
)
from repro_torch.models.transformer import (
    Model,
    abstract_params,
    build_model,
    model_spec,
    params_from_reference,
)

__all__ = [
    "EncDecConfig",
    "HybridConfig",
    "ModelConfig",
    "MoEConfig",
    "SSMConfig",
    "Model",
    "build_model",
    "model_spec",
    "abstract_params",
    "params_from_reference",
]
