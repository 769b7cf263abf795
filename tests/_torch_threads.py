"""How many CPU threads a port test process gives torch.

Under pytest-xdist every worker shares the machine's cores with the others,
and torch's default of one thread a core then leaves the workers' threads
waiting on each other far longer than the small CPU operations of the parity
tests take. Each process therefore takes its share of the cores it may run
on: ``max(1, cores // (workers * processes))``, where ``workers`` is xdist's
worker count (1 without xdist) and ``processes`` how many processes the
caller starts at once (1 for itself; the ranks for a gloo world or
``torch.distributed.run``).

Importing this module gives the importing process its share: torch's thread
pool, and ``OMP_NUM_THREADS`` and ``MKL_NUM_THREADS`` for every child it
starts. An ``OMP_NUM_THREADS`` set before the import wins over the share,
in this process and in the children started with :func:`env`. Every port
test file imports this module, and xdist workers import every test module
while they collect, so a worker holds its share from its first test on.
"""

import os

import torch

# the caller's own choice, read before this module sets the variable
_CHOSEN = os.environ.get("OMP_NUM_THREADS")


def share(processes: int = 1) -> int:
    """Threads for each of ``processes`` processes started at once."""
    cores = len(os.sched_getaffinity(0))
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    return max(1, cores // (workers * processes))


def env(processes: int = 1) -> dict:
    """The thread variables for each of ``processes`` child processes
    started at once: the caller's ``OMP_NUM_THREADS``, else the share."""
    n = _CHOSEN or str(share(processes))
    return {"OMP_NUM_THREADS": n, "MKL_NUM_THREADS": n}


for _k, _v in env().items():
    os.environ.setdefault(_k, _v)
torch.set_num_threads(int(os.environ["OMP_NUM_THREADS"]))
