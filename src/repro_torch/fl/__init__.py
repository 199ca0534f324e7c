"""repro_torch.fl — Generalized AsyncSGD training on the event engine (port
of ``repro.fl``): the models, the lane trainer, the host reference loop,
the strategy factory and the strategy lanes."""
from .engine import (DeviceTrainer, DeviceTrainLog, PaddedClientData,
                     StrategyGridResult, pad_client_data, run_strategy_grid)
from .models import (CNNClassifier, MLPClassifier, cnn_classifier,
                     mlp_classifier)
from .strategies import (ClusterSpec, build_network_params,
                         build_power_profile, make_strategies, strategy_batch)
from .trainer import AsyncFLConfig, AsyncFLTrainer, TrainLog

__all__ = [
    "AsyncFLTrainer", "AsyncFLConfig", "TrainLog",
    "DeviceTrainer", "DeviceTrainLog", "PaddedClientData",
    "StrategyGridResult", "run_strategy_grid", "pad_client_data",
    "ClusterSpec", "build_network_params", "build_power_profile",
    "make_strategies", "strategy_batch",
    "CNNClassifier", "MLPClassifier", "cnn_classifier", "mlp_classifier",
]
