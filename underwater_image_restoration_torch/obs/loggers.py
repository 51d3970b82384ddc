"""Stdout tee logger (reference ``src/utils/loggers.py:10-41``), the port's
own copy of the JAX package's ``obs/loggers.py``: everything written to
stdout is duplicated into a log file with flush+fsync, without the
reference's bug of closing ``sys.stdout`` itself in ``close()``.
"""
from __future__ import annotations

import os
import sys


class Logger:
    def __init__(self, fpath: str | None = None):
        self.console = sys.stdout
        self.file = None
        if fpath is not None:
            d = os.path.dirname(fpath)
            if d:
                os.makedirs(d, exist_ok=True)
            self.file = open(fpath, "w")

    def __enter__(self):
        self._prev = sys.stdout
        sys.stdout = self
        return self

    def __exit__(self, *args):
        sys.stdout = self._prev
        self.close()

    def write(self, msg):
        self.console.write(msg)
        if self.file is not None:
            self.file.write(msg)

    def flush(self):
        self.console.flush()
        if self.file is not None:
            self.file.flush()
            os.fsync(self.file.fileno())

    def close(self):
        if self.file is not None:
            self.file.close()
            self.file = None

    def __del__(self):
        self.close()
