"""Training, evaluation, checkpoints, logging and profiling of the port."""
from ragraph_tpu_torch.train.checkpoint import (  # noqa: F401
    BestCheckpointKeeper, restore_checkpoint, restore_sharded,
    save_checkpoint)
from ragraph_tpu_torch.train.logging import RunLogger, log_exceptions  # noqa: F401
from ragraph_tpu_torch.train.metrics import RankingEvaluator  # noqa: F401
from ragraph_tpu_torch.train.prefetch import PrefetchIterator, prefetch  # noqa: F401
from ragraph_tpu_torch.train.profiling import (  # noqa: F401
    assert_all_finite, count, phase_totals, recorded, span, start_trace,
    stop_trace, tree_all_finite)
from ragraph_tpu_torch.train.torch_import import (  # noqa: F401
    load_torch_state_dict, tables_from_torch)
from ragraph_tpu_torch.train.trainer import EdgeTrainer, TrainResult  # noqa: F401
