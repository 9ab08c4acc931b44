"""Status codes and error taxonomy.

The same integer codes and line/char payload encoding as the reference C
API (tfQMRgpu/include/tfqmrgpu.h:160-181, tfqmrgpu_error_tool.cxx:33-65)
and as ``tfqmrgpu_tpu.errors``, so both packages report identical codes.
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    SUCCESS = 0
    LAUNCH_FAILED = 2
    NO_INFO_PASSED = 3
    ALLOCATION_FAILED = 4
    RANDOM_GEN_FAILED = 5
    BREAKDOWN = 6
    POINTER_INVALID = 7
    MAX_ITERATIONS = 9
    B_HAS_A_ZERO_COLUMN = 11
    BLOCKSIZE_MISSING = 12
    B_IS_NOT_SUBSET_OF_X = 13
    UNDOCUMENTED_ERROR = 14
    DATALAYOUT_UNKNOWN = 15
    PRECISION_MISSMATCH = 16
    TANSPOSITION_UNKNOWN = 17
    VARIABLENAME_UNKNOWN = 18
    NO_IMPLEMENTATION = 19


# tfqmrgpu.h:179-181: the lowest 3 decimal digits carry the error code, the
# middle 4 a source line, the upper 3 an ASCII char.
CODE_LINE = 1000
CODE_CHAR = 10000 * 1000

_MESSAGES = {
    Status.SUCCESS: "success",
    Status.LAUNCH_FAILED: "kernel launch failed",
    Status.NO_INFO_PASSED: "no info passed",
    Status.ALLOCATION_FAILED: "allocation failed",
    Status.RANDOM_GEN_FAILED: "random number generation failed",
    Status.BREAKDOWN: "all right-hand sides broke down",
    Status.POINTER_INVALID: "pointer invalid",
    Status.MAX_ITERATIONS: "max iterations reached without convergence",
    Status.B_HAS_A_ZERO_COLUMN: "B has a zero column",
    Status.BLOCKSIZE_MISSING: "block size not in the allowed list",
    Status.B_IS_NOT_SUBSET_OF_X: "sparsity pattern of B is not a subset of X",
    Status.UNDOCUMENTED_ERROR: "undocumented error",
    Status.DATALAYOUT_UNKNOWN: "unknown data layout",
    Status.PRECISION_MISSMATCH: "precision mismatch",
    Status.TANSPOSITION_UNKNOWN: "unknown transposition",
    Status.VARIABLENAME_UNKNOWN: "unknown variable name",
    Status.NO_IMPLEMENTATION: "not implemented",
}


def encode_status(code: int, line: int = 0, char: str | int = 0) -> int:
    """Pack (code, source line, char payload) into one int, reference-style."""
    ch = ord(char) if isinstance(char, str) else int(char)
    return int(code) + CODE_LINE * int(line) + CODE_CHAR * ch


def decode_status(status: int) -> tuple[int, int, int]:
    """Unpack a packed status into (code, line, char)."""
    status = int(status)
    return status % CODE_LINE, (status // CODE_LINE) % 10000, status // CODE_CHAR


def get_error_string(status: int) -> str:
    """Human-readable decoding (tfqmrgpu_error_tool.cxx:33-65)."""
    code, line, char = decode_status(status)
    try:
        msg = _MESSAGES[Status(code)]
    except ValueError:
        msg = f"unknown status code {code}"
    parts = [msg]
    if line:
        parts.append(f"(source line {line})")
    if char:
        parts.append(f"(payload {chr(char)!r})")
    return " ".join(parts)


class TfqmrgpuError(RuntimeError):
    """Raised where the C API would return a nonzero status."""

    def __init__(self, status: int, detail: str = ""):
        self.status = int(status)
        self.code, self.line, self.char = decode_status(self.status)
        msg = get_error_string(self.status)
        if detail:
            msg = f"{msg}: {detail}"
        super().__init__(msg)


class TfqmrgpuValueError(TfqmrgpuError, ValueError):
    """A ``TfqmrgpuError`` for an argument that the JAX package refuses
    with ``ValueError``, so that a caller's ``except ValueError`` catches
    it in both packages."""
