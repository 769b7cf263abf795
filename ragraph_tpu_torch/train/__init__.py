"""Training, evaluation and checkpoints of the port."""
from ragraph_tpu_torch.train.checkpoint import (  # noqa: F401
    BestCheckpointKeeper, restore_checkpoint, save_checkpoint)
from ragraph_tpu_torch.train.metrics import RankingEvaluator  # noqa: F401
from ragraph_tpu_torch.train.trainer import EdgeTrainer, TrainResult  # noqa: F401
