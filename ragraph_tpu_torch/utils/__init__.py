"""Host utilities of the port: the C++ data kernels and seeding."""

from ragraph_tpu_torch.utils.native import (  # noqa: F401
    build_csr_native, native_available, negative_sample_native,
    parse_edge_file_native)
from ragraph_tpu_torch.utils.seed import seed_everything  # noqa: F401
