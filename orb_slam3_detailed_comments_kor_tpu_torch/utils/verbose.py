"""Leveled logger (reference ``Verbose``, ``include/System.h:46-71``).

The port's own copy of ``orb_slam3_detailed_comments_kor_tpu/utils/
verbose.py``: the reference's 5-level static logger, set to QUIET at
startup (``System.cc:147``), printing through the standard library.
"""

from __future__ import annotations

import sys
import time


class Verbose:
    VERBOSITY_QUIET = 0
    VERBOSITY_NORMAL = 1
    VERBOSITY_VERBOSE = 2
    VERBOSITY_VERY_VERBOSE = 3
    VERBOSITY_DEBUG = 4

    _level = VERBOSITY_QUIET

    @classmethod
    def set_th_verbosity(cls, level: int) -> None:
        cls._level = level

    @classmethod
    def print_mess(cls, msg: str, level: int = VERBOSITY_NORMAL) -> None:
        if level <= cls._level:
            print(f"[{time.strftime('%H:%M:%S')}] {msg}", file=sys.stderr,
                  flush=True)

    # convenience aliases
    @classmethod
    def normal(cls, msg: str) -> None:
        cls.print_mess(msg, cls.VERBOSITY_NORMAL)

    @classmethod
    def verbose(cls, msg: str) -> None:
        cls.print_mess(msg, cls.VERBOSITY_VERBOSE)

    @classmethod
    def debug(cls, msg: str) -> None:
        cls.print_mess(msg, cls.VERBOSITY_DEBUG)
