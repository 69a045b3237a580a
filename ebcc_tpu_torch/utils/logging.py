"""Logging with EBCC_LOG_LEVEL env semantics.

Copy of ``ebcc_tpu.utils.logging`` under the port's logger name.  Mirrors
the reference logger's contract (log.h:31-47 and
``log_set_level_from_env``, j2k_codec.h:223-235): integer levels
0=TRACE 1=DEBUG 2=INFO 3=WARN(default) 4=ERROR 5=FATAL.
"""

from __future__ import annotations

import logging
import os
import sys

_LEVELS = [5, 10, 20, 30, 40, 50]  # TRACE..FATAL -> python levels

logger = logging.getLogger("ebcc_tpu_torch")
if not logger.handlers:
    _h = logging.StreamHandler(sys.stderr)
    _h.setFormatter(logging.Formatter(
        "%(asctime)s %(levelname)-5s ebcc_tpu_torch: %(message)s", "%H:%M:%S"))
    logger.addHandler(_h)
    logger.propagate = False


def set_level_from_env():
    raw = os.environ.get("EBCC_LOG_LEVEL")
    level = 3
    if raw is not None:
        try:
            level = max(0, min(5, int(raw)))
        except ValueError:
            pass
    logger.setLevel(_LEVELS[level])


set_level_from_env()

trace = lambda *a, **k: logger.log(5, *a, **k)  # noqa: E731
debug = logger.debug
info = logger.info
warn = logger.warning
error = logger.error
