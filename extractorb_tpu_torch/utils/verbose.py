"""Leveled console logging (a copy of ``extractorb_tpu/utils/verbose.py``).

Replaces the reference's Verbose class (inc/System.h:47-72:
VERBOSITY_QUIET/NORMAL/VERBOSE/VERY_VERBOSE/DEBUG with PrintMess).
"""

from __future__ import annotations

import enum
import sys


class Verbosity(enum.IntEnum):
    QUIET = 0
    NORMAL = 1
    VERBOSE = 2
    VERY_VERBOSE = 3
    DEBUG = 4


_level = Verbosity.QUIET  # reference default (src/System.cc:218)


def set_verbosity(level: Verbosity):
    global _level
    _level = level


def print_mess(msg: str, level: Verbosity = Verbosity.NORMAL):
    if level <= _level:
        print(msg, file=sys.stderr)
