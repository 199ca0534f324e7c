"""repro_torch.models — the LM scaffold's dense decoder-only LM (port of
``repro.models``): configs, attention, layers, the LM and the model bundle
(``init``, ``loss_fn``, ``prefill``, ``init_cache``, ``decode_step``)."""
from .config import INPUT_SHAPES, ArchConfig, InputShape, MoEConfig
from .model import ModelBundle, build_model

__all__ = ["ArchConfig", "MoEConfig", "InputShape", "INPUT_SHAPES",
           "ModelBundle", "build_model"]
