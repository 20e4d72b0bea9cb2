"""UDF compiler — the counterpart of spark_rapids_tpu/udf_compiler, the
analog of the reference's udf-compiler module (LambdaReflection.scala:34,
CFG.scala:131, Instruction.scala, CatalystExpressionBuilder.scala:45):
instead of decompiling JVM lambda bytecode into Catalyst expressions, it
decompiles CPython bytecode (`dis`) into the port's own expression
tree, so a `udf(lambda x: ...)` becomes device expressions with no host
round trip at all.

Symbolic execution of the bytecode over an operand stack of Expression
nodes; a conditional jump forks both paths, which reconverge as
`If(cond, then, else)` (the reference's CFG and its Catalyst expressions).
Loops, exceptions and unknown calls raise UdfCompileError, and the caller
keeps the host round-trip PythonUDF for those, as the reference keeps the
JVM UDF when compilation fails.

A compiled UDF follows Spark SQL's null semantics (NULL propagates
through operators) where the Python function would raise on None: only
functions whose authors expect SQL semantics should compile, which is
why spark.rapids.sql.udfCompiler.enabled gates the rewrite. The bytecode
walked is CPython 3.12's, as on both machines that run the port.
"""

from __future__ import annotations

import dis
import types
from typing import Dict, List, Optional, Sequence

from ..expr import arithmetic as A
from ..expr import conditional as C
from ..expr import predicates as P
from ..expr import stringexprs as S
from ..expr.core import Expression, Literal, lit
from ..types import BooleanType, StringType

MAX_FORKS = 200


class UdfCompileError(Exception):
    pass


def _is_stringy(e: Expression) -> bool:
    try:
        return isinstance(e.data_type, StringType)
    except (TypeError, NotImplementedError):
        return False


class _Callable:
    """Marker for a resolved callable sitting on the symbolic stack."""

    def __init__(self, kind: str, target=None):
        self.kind = kind      # builtin name or "method"
        self.target = target  # method receiver Expression


_BIN_OPS = {
    "+": lambda a, b: S.Concat(a, b) if _is_stringy(a) or _is_stringy(b)
    else A.Add(a, b),
    "-": A.Subtract,
    "*": A.Multiply,
    "/": A.Divide,
    "//": A.IntegralDivide,
    "%": A.Remainder,
    "**": lambda a, b: _pow(a, b),
}

_CMP_OPS = {
    "<": P.LessThan, "<=": P.LessThanOrEqual, ">": P.GreaterThan,
    ">=": P.GreaterThanOrEqual, "==": P.EqualTo,
    "!=": lambda a, b: P.Not(P.EqualTo(a, b)),
}


def _pow(a, b):
    from ..expr.math import Pow
    return Pow(a, b)


def _call_builtin(name: str, args: List[Expression]) -> Expression:
    if name == "abs" and len(args) == 1:
        return A.Abs(args[0])
    if name == "len" and len(args) == 1:
        return S.Length(args[0])
    if name == "min" and len(args) >= 2:
        return A.Least(*args)
    if name == "max" and len(args) >= 2:
        return A.Greatest(*args)
    if name in ("float", "int", "str", "bool") and len(args) == 1:
        from ..types import BOOLEAN, DOUBLE, LONG, STRING
        to = {"float": DOUBLE, "int": LONG, "str": STRING,
              "bool": BOOLEAN}[name]
        return args[0].cast(to)
    if name in ("sqrt", "exp", "log", "sin", "cos", "tan", "floor",
                "ceil") and len(args) == 1:
        from ..expr import math as M
        cls = {"sqrt": M.Sqrt, "exp": M.Exp, "log": M.Log, "sin": M.Sin,
               "cos": M.Cos, "tan": M.Tan, "floor": M.Floor,
               "ceil": M.Ceil}[name]
        return cls(args[0])
    # NOTE: Python round() is banker's rounding; the engine's Round is
    # Spark HALF_UP — compiling it would silently change results, so it
    # stays a host callback.
    raise UdfCompileError(f"cannot compile call to {name!r}")


def _call_method(recv: Expression, name: str, args: List[Expression]
                 ) -> Expression:
    def _litval(e):
        if not isinstance(e, Literal):
            raise UdfCompileError(
                f"str.{name} argument must be a constant")
        return e.value

    if name == "upper" and not args:
        return S.Upper(recv)
    if name == "lower" and not args:
        return S.Lower(recv)
    if name == "strip" and not args:
        return S.StringTrim(recv)
    if name == "lstrip" and not args:
        return S.StringTrimLeft(recv)
    if name == "rstrip" and not args:
        return S.StringTrimRight(recv)
    if name == "startswith" and len(args) == 1:
        return S.StartsWith(recv, _litval(args[0]))
    if name == "endswith" and len(args) == 1:
        return S.EndsWith(recv, _litval(args[0]))
    if name == "replace" and len(args) == 2:
        return S.StringReplace(recv, _litval(args[0]), _litval(args[1]))
    raise UdfCompileError(f"cannot compile method .{name}()")


class _Compiler:
    def __init__(self, fn, arg_exprs: Sequence[Expression]):
        self.fn = fn
        code = fn.__code__
        if code.co_argcount != len(arg_exprs):
            raise UdfCompileError(
                f"udf takes {code.co_argcount} args, given {len(arg_exprs)}")
        self.instrs = list(dis.get_instructions(fn))
        self.by_offset = {i.offset: idx for idx, i in enumerate(self.instrs)}
        self.locals: Dict[str, Expression] = {
            code.co_varnames[i]: e for i, e in enumerate(arg_exprs)}
        self.forks = 0

    def _global(self, name: str):
        if name in self.fn.__globals__:
            return self.fn.__globals__[name]
        import builtins
        if hasattr(builtins, name):
            return getattr(builtins, name)
        raise UdfCompileError(f"unresolved global {name!r}")

    def run(self) -> Expression:
        return self._run(0, [])

    def _run(self, idx: int, stack: List) -> Expression:
        """Symbolically execute from instruction `idx` until RETURN."""
        self.forks += 1
        if self.forks > MAX_FORKS:
            raise UdfCompileError("control flow too complex")
        instrs = self.instrs
        while idx < len(instrs):
            ins = instrs[idx]
            op = ins.opname
            if op in ("RESUME", "NOP", "PRECALL", "CACHE", "PUSH_NULL",
                      "MAKE_CELL", "COPY_FREE_VARS"):
                if op == "PUSH_NULL":
                    stack.append(None)
                idx += 1
                continue
            if op == "LOAD_CONST":
                try:
                    stack.append(lit(ins.argval))
                except TypeError:
                    stack.append(_Const(ins.argval))  # e.g. tuple for `in`
                idx += 1
                continue
            if op in ("LOAD_FAST", "LOAD_FAST_CHECK"):
                if ins.argval not in self.locals:
                    raise UdfCompileError(
                        f"local {ins.argval!r} read before assignment")
                stack.append(self.locals[ins.argval])
                idx += 1
                continue
            if op == "STORE_FAST":
                self.locals[ins.argval] = stack.pop()
                idx += 1
                continue
            if op == "LOAD_GLOBAL":
                # 3.11+: low bit of arg pushes NULL before the global
                if ins.arg & 1:
                    stack.append(None)
                obj = self._global(ins.argval)
                name = getattr(obj, "__name__", ins.argval)
                stack.append(_Callable(name))
                idx += 1
                continue
            if op == "LOAD_DEREF":
                # closure constant (captured value)
                for cname, cell in zip(
                        self.fn.__code__.co_freevars,
                        self.fn.__closure__ or ()):
                    if cname == ins.argval:
                        v = cell.cell_contents
                        if callable(v) or isinstance(v, types.ModuleType):
                            stack.append(_Callable(
                                getattr(v, "__name__", ins.argval)))
                        else:
                            try:
                                stack.append(lit(v))
                            except TypeError as e:
                                raise UdfCompileError(str(e))
                        break
                else:
                    raise UdfCompileError(
                        f"unresolved closure var {ins.argval!r}")
                idx += 1
                continue
            if op in ("LOAD_ATTR", "LOAD_METHOD"):
                recv = stack.pop()
                if not isinstance(recv, Expression):
                    raise UdfCompileError(
                        f"attribute on non-expression: {ins.argval}")
                stack.append(_Callable("method", recv))
                stack.append(_MethodName(ins.argval))
                idx += 1
                continue
            if op == "CALL":
                n = ins.arg
                args = [stack.pop() for _ in range(n)][::-1]
                tos = stack.pop()
                callee = None
                if isinstance(tos, _MethodName):
                    callee = stack.pop()  # the _Callable("method")
                    result = _call_method(callee.target, tos.name, args)
                elif isinstance(tos, _Callable):
                    if stack and stack[-1] is None:
                        stack.pop()  # the PUSH_NULL slot
                    result = _call_builtin(tos.kind, args)
                else:
                    raise UdfCompileError("cannot compile dynamic call")
                stack.append(result)
                idx += 1
                continue
            if op == "BINARY_OP":
                b = stack.pop()
                a = stack.pop()
                fn = _BIN_OPS.get(ins.argrepr.rstrip("="))
                if fn is None:
                    raise UdfCompileError(
                        f"unsupported operator {ins.argrepr!r}")
                stack.append(fn(_as_expr(a), _as_expr(b)))
                idx += 1
                continue
            if op == "COMPARE_OP":
                b = stack.pop()
                a = stack.pop()
                fn = _CMP_OPS.get(ins.argval)
                if fn is None:
                    raise UdfCompileError(
                        f"unsupported comparison {ins.argval!r}")
                stack.append(fn(_as_expr(a), _as_expr(b)))
                idx += 1
                continue
            if op == "IS_OP":
                b = stack.pop()
                a = stack.pop()
                if isinstance(b, Literal) and b.value is None:
                    e = P.IsNotNull(a) if ins.arg else P.IsNull(a)
                    stack.append(e)
                    idx += 1
                    continue
                raise UdfCompileError("`is` supported only against None")
            if op == "CONTAINS_OP":
                b = stack.pop()
                a = stack.pop()
                if isinstance(b, _Const) \
                        and isinstance(b.value, (tuple, list, frozenset,
                                                 set)):
                    e = P.In(_as_expr(a), list(b.value))
                elif isinstance(b, Expression) and _is_stringy(b) \
                        and isinstance(a, Literal):
                    e = S.Contains(b, a.value)
                else:
                    raise UdfCompileError("unsupported `in` operands")
                if ins.arg:
                    e = P.Not(e)
                stack.append(e)
                idx += 1
                continue
            if op == "UNARY_NEGATIVE":
                stack.append(A.UnaryMinus(_as_expr(stack.pop())))
                idx += 1
                continue
            if op == "UNARY_NOT":
                stack.append(P.Not(_as_expr(stack.pop())))
                idx += 1
                continue
            if op in ("COPY",):
                stack.append(stack[-ins.arg])
                idx += 1
                continue
            if op in ("SWAP",):
                stack[-1], stack[-ins.arg] = stack[-ins.arg], stack[-1]
                idx += 1
                continue
            if op == "POP_TOP":
                stack.pop()
                idx += 1
                continue
            if op in ("POP_JUMP_IF_FALSE", "POP_JUMP_IF_TRUE",
                      "POP_JUMP_IF_NONE", "POP_JUMP_IF_NOT_NONE"):
                cond = _as_expr(stack.pop())
                target = self.by_offset[ins.argval]
                if op == "POP_JUMP_IF_NONE":
                    cond = P.IsNotNull(cond)      # fallthrough if not None
                elif op == "POP_JUMP_IF_NOT_NONE":
                    cond = P.IsNull(cond)
                elif op == "POP_JUMP_IF_TRUE":
                    cond = P.Not(_boolify(cond))
                else:
                    cond = _boolify(cond)
                # Fork locals per path like the operand stack: STORE_FAST in
                # the then-branch must not leak into the else-branch.
                saved_locals = dict(self.locals)
                then_r = self._run(idx + 1, list(stack))
                self.locals = dict(saved_locals)
                else_r = self._run(target, list(stack))
                self.locals = saved_locals
                return C.If(cond, then_r, else_r)
            if op in ("JUMP_FORWARD",):
                idx = self.by_offset[ins.argval]
                continue
            if op in ("JUMP_BACKWARD", "JUMP_BACKWARD_NO_INTERRUPT",
                      "FOR_ITER"):
                raise UdfCompileError("loops cannot be compiled")
            if op == "RETURN_VALUE":
                return _as_expr(stack.pop())
            if op == "RETURN_CONST":
                return lit(ins.argval)
            raise UdfCompileError(f"unsupported opcode {op}")
        raise UdfCompileError("fell off end of bytecode")


class _MethodName:
    def __init__(self, name: str):
        self.name = name


class _Const:
    """Non-expressible constant (tuple/set for `in`, etc.)."""

    def __init__(self, value):
        self.value = value


def _as_expr(v) -> Expression:
    if isinstance(v, Expression):
        return v
    raise UdfCompileError(f"non-expression on stack: {v!r}")


def _boolify(e: Expression) -> Expression:
    """Python truthiness -> SQL boolean where safe (booleans pass through;
    anything else must already be a predicate)."""
    try:
        if isinstance(e.data_type, BooleanType):
            return e
    except (TypeError, NotImplementedError):
        return e  # unresolved reference: assume caller passed a predicate
    raise UdfCompileError(
        "non-boolean condition (Python truthiness on "
        f"{e.data_type.simple_name()} is not SQL semantics)")


def compile_udf(fn, arg_exprs: Sequence[Expression]) -> Expression:
    """Python function + argument expressions -> expression tree.
    Raises UdfCompileError when any construct has no SQL equivalent."""
    if not isinstance(fn, types.FunctionType):
        raise UdfCompileError("only plain Python functions compile")
    if fn.__code__.co_flags & 0x20:  # generator
        raise UdfCompileError("generators cannot be compiled")
    return _Compiler(fn, arg_exprs).run()


def maybe_compile_plan_udfs(plan, conf):
    """Logical-plan rewrite (reference LogicalPlanRules.scala:29): replace
    host-callback PythonUDF expressions with compiled device expressions
    wherever compilation succeeds. Project/Filter nodes only — the UDF
    call sites Spark's rule covers too."""
    from ..config import UDF_COMPILER_ENABLED
    from ..expr.udf import PythonUDF
    from ..plan import logical as L
    if not conf.get(UDF_COMPILER_ENABLED):
        return plan

    def rewrite_expr(e: Expression) -> Expression:
        def fn(node):
            if isinstance(node, PythonUDF):
                try:
                    compiled = compile_udf(node.fn, list(node.children))
                    return compiled.cast(node.return_type)
                except UdfCompileError:
                    return node
            return node
        return e.transform_up(fn)

    def walk(p):
        kids = [walk(c) for c in p.children]
        if isinstance(p, L.LogicalProject):
            return L.LogicalProject([rewrite_expr(e) for e in p.exprs],
                                    kids[0])
        if isinstance(p, L.LogicalFilter):
            return L.LogicalFilter(rewrite_expr(p.condition), kids[0])
        if kids != list(p.children):
            import copy
            q = copy.copy(p)
            q.children = kids
            return q
        return p

    return walk(plan)
