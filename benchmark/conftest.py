"""Settings of every benchmark test: the CPU cut (``tests/tiny.py``'s
``TINY``) of each configuration that ``TINY`` does not name, so that the
tests parametrised over every cell find it whichever files are collected."""

import pathlib
import sys

TESTS = pathlib.Path(__file__).resolve().parent / "tests"
if str(TESTS) not in sys.path:
    sys.path.insert(0, str(TESTS))

import tiny  # noqa: E402

# 7 block rows, 1 source block (64 right-hand sides), 19 pairs
tiny.TINY.setdefault("fd64_z", {"rsb": 1.75, "rtb": 4.75})
