"""Typed experiment configuration (counterpart of ``ragraph_tpu/config.py``).

:class:`ExperimentConfig` binds the task, model and training knobs with the
port's :class:`~ragraph_tpu_torch.rag.library.LibraryConfig` and
:class:`~ragraph_tpu_torch.models.edge.base.EdgeModelConfig` into one record
that round-trips through JSON. Its fields, defaults and JSON are the JAX
package's, so a file written by either loads in the other.
"""

from __future__ import annotations

import dataclasses
import json

from ragraph_tpu_torch.models.edge.base import EdgeModelConfig
from ragraph_tpu_torch.rag.library import LibraryConfig


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
    """One experiment: task, model, library and training knobs."""

    task: str = "node"            # node | graph | fewshot | edge
    dataset: str = "SYNTH"
    seed: int = 42
    # model
    emb_size: int = 256
    encoder_layers: int = 1
    num_class: int = 3
    retrieve_weight: float = 0.5
    label_weight: float = 0.5
    query_graph_hop: int = 3
    finetune: bool = True
    noise_finetune: bool = False
    # training
    batch_size: int = 16
    epochs: int = 50
    pretrain_epochs: int = 30
    lr: float = 1e-3
    test_times: int = 5
    library_capacity: int = 65536
    # nested component configs
    library: LibraryConfig = dataclasses.field(default_factory=LibraryConfig)
    edge: EdgeModelConfig = dataclasses.field(default_factory=EdgeModelConfig)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def to_json(self, path: str | None = None) -> str:
        s = json.dumps(self.to_dict(), indent=2)
        if path:
            with open(path, "w") as f:
                f.write(s)
        return s

    @classmethod
    def from_dict(cls, d: dict) -> "ExperimentConfig":
        d = dict(d)
        if isinstance(d.get("library"), dict):
            d["library"] = LibraryConfig(**d["library"])
        if isinstance(d.get("edge"), dict):
            ed = dict(d["edge"])
            for k in ("metrics", "metrics_k"):
                if isinstance(ed.get(k), list):
                    ed[k] = tuple(ed[k])
            d["edge"] = EdgeModelConfig(**ed)
        return cls(**d)

    @classmethod
    def from_json(cls, s_or_path: str) -> "ExperimentConfig":
        """From a JSON string or the path of a JSON file."""
        if s_or_path.strip().startswith("{"):
            return cls.from_dict(json.loads(s_or_path))
        with open(s_or_path) as f:
            return cls.from_dict(json.load(f))

    def replace(self, **kwargs) -> "ExperimentConfig":
        return dataclasses.replace(self, **kwargs)
