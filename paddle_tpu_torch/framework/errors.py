"""Typed error framework: the enforce / error-code surface + op provenance.

Port of ``paddle_tpu/framework/errors.py``; it holds no device code,
so only the package name changed.

Counterpart of Paddle's paddle/fluid/platform/enforce.h (the
PADDLE_ENFORCE* macro family, 885 LoC) + platform/error_codes.proto
(typed `errors::*` constructors) + errors.cc + op_call_stack.{h,cc}
(InsertCallStackInfo: every enforce failure names the op and the Python
line that built it). The reference renders demangled C++ + Python
stacks; here the Python traceback IS the stack, so what this module adds
is the reference's CONTRACT: one exception type per error code
(catchable individually or via EnforceError), the errors.* constructor
namespace, the enforce_* comparison helpers ops/framework code uses
instead of bare asserts, and OpProvenance — the "which op, which
program, built where" identity that executor/registry failures carry
(the same identity the metrics registry labels by).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional, Sequence, Tuple


@dataclass(frozen=True)
class OpProvenance:
    """Where an op lives and where Python built it (reference
    framework/op_call_stack.cc InsertCallStackInfo)."""

    op_type: str
    block_idx: Optional[int] = None
    op_idx: Optional[int] = None
    callstack: Tuple[str, ...] = field(default_factory=tuple)

    def render(self) -> str:
        where = f"op {self.op_type!r}"
        if self.op_idx is not None:
            where += f" (#{self.op_idx}"
            where += f" in block {self.block_idx})" if self.block_idx is not None else ")"
        elif self.block_idx is not None:
            where += f" (block {self.block_idx})"
        lines = [f"  [operator < {self.op_type} > error] at {where}"]
        if self.callstack:
            lines.append("  Op built at (most recent call last):")
            lines += [f"    {frame}" for frame in self.callstack]
        return "\n".join(lines)


class EnforceError(RuntimeError):
    """Base of every paddle_tpu_torch typed error (reference
    platform::EnforceNotMet)."""

    code = "LEGACY"

    def __init__(self, message: str = ""):
        super().__init__(f"[{self.code}] {message}" if message else self.code)
        self.message = message
        self.op_provenance: Optional[OpProvenance] = None

    def set_op_provenance(self, prov: OpProvenance) -> "EnforceError":
        """Attach (once) the op identity + build-site stack; the rendered
        provenance becomes part of str(exc)."""
        if self.op_provenance is None:
            self.op_provenance = prov
            self.args = (f"{self.args[0] if self.args else self.code}"
                         f"\n{prov.render()}",)
        return self


class InvalidArgumentError(EnforceError):
    code = "INVALID_ARGUMENT"


class NotFoundError(EnforceError):
    code = "NOT_FOUND"


class OutOfRangeError(EnforceError):
    code = "OUT_OF_RANGE"


class AlreadyExistsError(EnforceError):
    code = "ALREADY_EXISTS"


class ResourceExhaustedError(EnforceError):
    code = "RESOURCE_EXHAUSTED"


class PreconditionNotMetError(EnforceError):
    code = "PRECONDITION_NOT_MET"


class PermissionDeniedError(EnforceError):
    code = "PERMISSION_DENIED"


class ExecutionTimeoutError(EnforceError):
    code = "EXECUTION_TIMEOUT"


class UnimplementedError(EnforceError, NotImplementedError):
    code = "UNIMPLEMENTED"


class UnavailableError(EnforceError):
    code = "UNAVAILABLE"


class FatalError(EnforceError):
    code = "FATAL"


class ExternalError(EnforceError):
    code = "EXTERNAL"


class errors:
    """Constructor namespace mirroring reference platform::errors::*
    (errors.InvalidArgument("...") -> exception instance)."""

    InvalidArgument = InvalidArgumentError
    NotFound = NotFoundError
    OutOfRange = OutOfRangeError
    AlreadyExists = AlreadyExistsError
    ResourceExhausted = ResourceExhaustedError
    PreconditionNotMet = PreconditionNotMetError
    PermissionDenied = PermissionDeniedError
    ExecutionTimeout = ExecutionTimeoutError
    Unimplemented = UnimplementedError
    Unavailable = UnavailableError
    Fatal = FatalError
    External = ExternalError


def _fmt(msg: str, args) -> str:
    return msg % args if args else msg


def enforce(cond: Any, msg: str = "enforce failed", *args,
            exc: type = PreconditionNotMetError) -> None:
    """PADDLE_ENFORCE: raise `exc` unless cond."""
    if not cond:
        raise exc(_fmt(msg, args))


def enforce_not_none(val: Any, msg: str = "value is None", *args) -> Any:
    if val is None:
        raise NotFoundError(_fmt(msg, args))
    return val


def _cmp(name, op):
    def check(a, b, msg: str = "", *args, exc: type = InvalidArgumentError):
        if not op(a, b):
            detail = f"expected {a!r} {name} {b!r}"
            if msg:
                detail = f"{_fmt(msg, args)} ({detail})"
            raise exc(detail)
    return check


enforce_eq = _cmp("==", lambda a, b: a == b)
enforce_ne = _cmp("!=", lambda a, b: a != b)
enforce_gt = _cmp(">", lambda a, b: a > b)
enforce_ge = _cmp(">=", lambda a, b: a >= b)
enforce_lt = _cmp("<", lambda a, b: a < b)
enforce_le = _cmp("<=", lambda a, b: a <= b)


# ---------------------------------------------------------------------------
# op provenance plumbing (reference op_call_stack.cc)
# ---------------------------------------------------------------------------


def capture_build_callstack(skip: int = 2, limit: int = 8) -> Tuple[str, ...]:
    """Python frames at op build time, innermost first, preferring frames
    OUTSIDE paddle_tpu_torch (the user line that asked for the op — what the
    reference records via the `op_callstack` attr). Falls back to the
    innermost frames when everything is framework-internal (e.g. ops
    appended by append_backward). Raw frame-pointer walk; strings are
    formatted only for the frames actually kept, so the per-Operator
    cost stays ~1-2us."""
    import sys

    try:
        f = sys._getframe(skip)
    except ValueError:
        return ()
    user: list = []
    fallback: list = []
    n = 0
    while f is not None and n < 4 * limit and len(user) < limit:
        code = f.f_code
        fname = code.co_filename
        if "paddle_tpu_torch" not in fname:
            user.append((fname, f.f_lineno, code.co_name))
        elif len(fallback) < limit:
            fallback.append((fname, f.f_lineno, code.co_name))
        f = f.f_back
        n += 1
    frames = user or fallback
    return tuple(
        f'File "{fn}", line {ln}, in {co}' for fn, ln, co in reversed(frames)
    )


def provenance_of(op, block_idx: Optional[int] = None,
                  op_idx: Optional[int] = None) -> OpProvenance:
    """OpProvenance for a framework Operator, reading the `op_callstack`
    attr Operator.__init__ recorded."""
    stack: Sequence[str] = ()
    try:
        stack = tuple(op.attr("op_callstack") or ())
    except Exception:
        pass
    if block_idx is None:
        blk = getattr(op, "block", None)
        if blk is not None:
            block_idx = getattr(getattr(blk, "desc", None), "idx", None)
    return OpProvenance(op_type=op.type, block_idx=block_idx,
                        op_idx=op_idx, callstack=tuple(stack))


def attach_op_provenance(exc: BaseException, op, *,
                         block_idx: Optional[int] = None,
                         op_idx: Optional[int] = None) -> EnforceError:
    """Return a typed error carrying the op's provenance. An EnforceError
    gets the provenance attached in place (its concrete type — and thus
    catchability — is preserved); any other exception is wrapped in the
    base EnforceError with the original as __cause__, mirroring the
    reference where every op failure surfaces as EnforceNotMet with the
    op call stack appended."""
    prov = provenance_of(op, block_idx=block_idx, op_idx=op_idx)
    if isinstance(exc, EnforceError):
        return exc.set_op_provenance(prov)
    # a NotImplementedError loud guard must STAY catchable as
    # NotImplementedError after wrapping (fallback probes rely on it) —
    # UnimplementedError inherits both
    cls = UnimplementedError if isinstance(exc, NotImplementedError) \
        else EnforceError
    wrapped = cls(f"{type(exc).__name__}: {exc}")
    wrapped.set_op_provenance(prov)
    wrapped.__cause__ = exc
    return wrapped
