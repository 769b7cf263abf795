"""PyTorch/CUDA port of ``ragraph_tpu`` for one NVIDIA H100.

The package mirrors the JAX package's layout (``ops/``, ``models/edge/``,
``train/``, ``data/``, ``cli/``) so each module's counterpart is easy to
find. It imports ``torch`` and never ``jax`` or ``ragraph_tpu``.

Ported so far: the RAGraph-edge pipeline, serving (``generate`` ->
``make_resource_graph`` -> ``generate`` with RAG fusion -> ranking eval and
``recommend_from``) and training (``cal_loss``, ``EdgeTrainer``,
``staged_finetune``, the ``pretrain``/``finetune``/``vanilla`` CLI); the
static node pipeline, node and graph level, with its pretraining
(``cli/node.py`` ``pretrain``, ``vanilla``, ``finetune``, ``--level``;
``models/preprompt.py``, ``models/ragraph_node.py``,
``models/ragraph_graph.py``, ``rag/library.py``, ``rag/pretrain_aug.py``);
the host data path (the C++ parser and sampler of ``csrc/fastgraph.cpp``
through ``utils/native.py``, prefetch in the trainer) and the
single-device utilities (``rag/ivf.py``, ``data/planetoid.py``,
``train/torch_import.py``, ``train/logging.py``, ``train/profiling.py``,
``utils/seed.py``, ``config.py``); and the bench scripts in ``bench/``.
Each subpackage re-exports its public names. Its twelve hand-written CUDA
kernels live in ``csrc/`` and are built lazily by
:mod:`ragraph_tpu_torch.native` on the first call that needs them, as the
C++ host library is by :mod:`ragraph_tpu_torch.utils.native`; importing
this package builds and loads nothing.

Entry points take ``device`` (default ``"cuda"``) and raise when no card is
present unless the caller asks for ``device="cpu"``, where every kernel
wrapper runs its plain PyTorch version instead.
"""

from ragraph_tpu_torch.core.graph import DenseGraph, EdgeGraph  # noqa: F401
