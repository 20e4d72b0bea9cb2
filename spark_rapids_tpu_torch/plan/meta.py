"""Meta wrap/tag framework — the counterpart of spark_rapids_tpu/plan/meta.py
(the reference's RapidsMeta.scala:83): every plan node and expression is
wrapped in a meta object that records whether (and why not) it can run on
the card, powers the explain output ("will/will not run on TPU because
..."), and performs the conversion.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Type

from ..config import DECIMAL_ENABLED, RapidsConf
from ..expr.core import Expression, resolve
from ..types import DecimalType
from .typesig import TypeSig, commonly_supported


class BaseMeta:
    def __init__(self):
        self._reasons: List[str] = []

    def will_not_work_on_tpu(self, reason: str):
        if reason not in self._reasons:
            self._reasons.append(reason)

    @property
    def can_run_on_tpu(self) -> bool:
        return not self._reasons

    @property
    def reasons(self) -> List[str]:
        return list(self._reasons)


class ExprRule:
    """Registry entry for one expression class (reference GpuOverrides
    `expr[...]` rules, GpuOverrides.scala:919)."""

    def __init__(self, cls: Type[Expression], desc: str,
                 input_sig: TypeSig = commonly_supported,
                 output_sig: TypeSig = commonly_supported,
                 tag_fn: Optional[Callable[["ExprMeta"], None]] = None):
        self.cls = cls
        self.desc = desc
        self.input_sig = input_sig
        self.output_sig = output_sig
        self.tag_fn = tag_fn

    @property
    def name(self) -> str:
        return self.cls.__name__


class ExprMeta(BaseMeta):
    def __init__(self, expr: Expression, rule: Optional[ExprRule],
                 conf: RapidsConf, input_schema):
        super().__init__()
        self.expr = expr
        self.rule = rule
        self.conf = conf
        self.input_schema = input_schema
        self.children = [ExprMeta.wrap(c, conf, input_schema)
                         for c in expr.children]

    @staticmethod
    def wrap(expr: Expression, conf: RapidsConf, input_schema) -> "ExprMeta":
        from .overrides import expression_rules
        if input_schema is not None:
            # bind column references so type-signature checks see real
            # types (reference tags over resolved Catalyst expressions)
            try:
                expr = resolve(expr, input_schema)
            except (KeyError, TypeError):
                pass  # unresolvable here (e.g. join pair scope)
        rules = expression_rules()
        rule = None
        for cls in type(expr).__mro__:
            rule = rules.get(cls)
            if rule is not None:
                break
        return ExprMeta(expr, rule, conf, input_schema)

    def tag_for_tpu(self):
        for c in self.children:
            c.tag_for_tpu()
            if not c.can_run_on_tpu:
                self.will_not_work_on_tpu(
                    f"child {type(c.expr).__name__} cannot run on TPU")
        if self.rule is None:
            self.will_not_work_on_tpu(
                f"no TPU implementation for expression "
                f"{type(self.expr).__name__}")
            return
        key = f"spark.rapids.sql.expression.{self.rule.name}"
        if str(self.conf._settings.get(key, "true")).lower() == "false":
            self.will_not_work_on_tpu(
                f"expression {self.rule.name} disabled by {key}")
        # decimal gating (reference decimalType.enabled): this node's own
        # output type (its children tag themselves)
        if not self.conf.get(DECIMAL_ENABLED):
            try:
                is_dec = isinstance(self.expr.data_type, DecimalType)
            except TypeError:
                is_dec = False
            if is_dec:
                self.will_not_work_on_tpu(
                    "decimal disabled by "
                    "spark.rapids.sql.decimalType.enabled")
        # type checks: children output types against the input signature
        for c in self.children:
            try:
                dt = c.expr.data_type
            except TypeError:
                continue  # unresolved; checked post-bind
            reason = self.rule.input_sig.reason_not_supported(dt)
            if reason:
                self.will_not_work_on_tpu(
                    f"input to {self.rule.name}: {reason}")
        try:
            out_dt = self.expr.data_type
            reason = self.rule.output_sig.reason_not_supported(out_dt)
            if reason:
                self.will_not_work_on_tpu(
                    f"output of {self.rule.name}: {reason}")
        except TypeError:
            pass
        if self.rule.tag_fn is not None:
            self.rule.tag_fn(self)

    def collect_reasons(self, out: List[str], prefix: str = ""):
        for r in self._reasons:
            out.append(f"{prefix}{type(self.expr).__name__}: {r}")
        for c in self.children:
            c.collect_reasons(out, prefix)
