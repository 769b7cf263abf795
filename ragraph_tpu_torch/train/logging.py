"""Run logging (counterpart of ``ragraph_tpu/train/logging.py``): a console
and file logger that echoes the PID and command line, loss and evaluation
lines, and a decorator that logs an exception before it propagates.
"""

from __future__ import annotations

import datetime
import functools
import logging
import os
import sys

_FORMAT = "%(asctime)s %(message)s"


def log_exceptions(fn):
    """Log the traceback of an exception raised by ``fn``, then re-raise."""

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except Exception:
            logging.getLogger("ragraph_tpu_torch").exception(
                "exception in %s", fn.__name__)
            raise

    return wrapper


class RunLogger:
    """Console logger of a run, and with ``save_dir`` also the file
    ``<save_dir>/train_log_<stamp>.txt``. Callable: ``log(msg)``."""

    def __init__(self, save_dir: str | None = None, exp_name: str = "run",
                 echo_argv: bool = True):
        self.logger = logging.getLogger(f"ragraph_tpu_torch.{exp_name}")
        self.logger.setLevel(logging.INFO)
        self.close()
        self.logger.propagate = False

        console = logging.StreamHandler(sys.stderr)
        console.setFormatter(logging.Formatter(_FORMAT))
        self.logger.addHandler(console)

        self.log_path = None
        if save_dir is not None:
            stamp = datetime.datetime.now().strftime("%b-%d-%Y_%H-%M-%S")
            os.makedirs(save_dir, exist_ok=True)
            self.log_path = os.path.join(save_dir, f"train_log_{stamp}.txt")
            fh = logging.FileHandler(self.log_path)
            fh.setFormatter(logging.Formatter(_FORMAT))
            self.logger.addHandler(fh)

        if echo_argv:
            self.log(f"PID: {os.getpid()}")
            self.log("CMD: python " + " ".join(sys.argv))

    def __call__(self, msg):
        self.log(msg)

    def log(self, msg):
        self.logger.info(msg)

    def log_loss(self, epoch: int, loss_dict: dict):
        parts = " ".join(f"{k}={v:.5f}" if isinstance(v, float)
                         else f"{k}={v}" for k, v in loss_dict.items())
        self.log(f"[epoch {epoch}] {parts}")

    def log_eval(self, result: dict, ks):
        parts = []
        for metric, vals in result.items():
            if metric == "eval_time":
                parts.append(f"eval_time={vals}")
                continue
            for i, k in enumerate(ks):
                parts.append(f"{metric}@{k}={float(vals[i]):.5f}")
        self.log("[eval] " + " ".join(parts))

    def close(self):
        """Close and detach this logger's handlers (its file among them)."""
        for h in list(self.logger.handlers):
            self.logger.removeHandler(h)
            h.close()
