"""The port's bench scripts, each run as ``python -m
ragraph_tpu_torch.bench.<name>``: ``exact_phases``, ``packed_table_gather``,
``onehot_gather`` (the counterparts of the JAX package's three probe
scripts) and ``main_path`` (train steps and the exact top-k beside plain
PyTorch ops). Shared timing helpers are in ``timing``."""
