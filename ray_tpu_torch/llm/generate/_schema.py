"""JSON-schema -> regex compiler for guided decoding.

A copy of `ray_tpu/llm/generate/_schema.py` (the port imports nothing of
ray_tpu).

The Outlines approach (docs/divergences.md): a schema lowers to ONE regex
over the canonical compact JSON rendering (no whitespace), which then rides
the shared `_fsm` byte-DFA machinery — schema-guided and regex-guided
requests are the same thing by the time they reach the engine.

Supported subset (documented in docs/generation.md):

- primitives: string (with optional `pattern`), integer, number, boolean,
  null, enum, const
- objects with a fixed `properties` map: required properties emit in
  declaration order; optional properties (absent from `required`) may be
  skipped, provided the FIRST declared property is required
- arrays with an `items` schema and optional minItems/maxItems
- anyOf / oneOf as alternation

Anything outside the subset raises `SchemaError` at compile time — a
constraint that cannot be enforced must never silently degrade to
unconstrained sampling.
"""

from __future__ import annotations

import json
from typing import Any

from ray_tpu_torch.llm.generate._fsm import escape_literal

_INTEGER = r"-?(?:0|[1-9][0-9]*)"
_NUMBER = r"-?(?:0|[1-9][0-9]*)(?:\.[0-9]+)?(?:[eE][+-]?[0-9]+)?"
# JSON string body: unescaped chars (no quote/backslash/control bytes) or a
# standard escape. Multi-byte UTF-8 runs through the byte-class transitions.
_STRING_CHAR = r'(?:[^\x00-\x1f"\\]|\\(?:["\\/bfnrt]|u[0-9a-fA-F]{4}))'
_STRING = f'"{_STRING_CHAR}*"'


class SchemaError(ValueError):
    """The schema uses a shape outside the supported guided-decoding subset."""


def _literal(value: Any) -> str:
    return escape_literal(json.dumps(value, separators=(",", ":")))


def schema_to_regex(schema: Any) -> str:
    """Compile a JSON schema (dict, or bool for any/never) to a regex over
    its compact JSON rendering."""
    if schema is True or schema == {}:
        # Unrestricted value: any primitive (nested any-value would need an
        # unbounded recursive grammar; see grammar_to_regex for bounded depth).
        return f"(?:{_STRING}|{_NUMBER}|true|false|null)"
    if not isinstance(schema, dict):
        raise SchemaError(f"unsupported schema {schema!r}")
    if "enum" in schema:
        return "(?:" + "|".join(_literal(v) for v in schema["enum"]) + ")"
    if "const" in schema:
        return _literal(schema["const"])
    for key in ("anyOf", "oneOf"):
        if key in schema:
            return "(?:" + "|".join(
                schema_to_regex(s) for s in schema[key]
            ) + ")"
    typ = schema.get("type")
    if typ == "string":
        if "pattern" in schema:
            return f'"(?:{schema["pattern"]})"'
        return _STRING
    if typ == "integer":
        return _INTEGER
    if typ == "number":
        return _NUMBER
    if typ == "boolean":
        return "(?:true|false)"
    if typ == "null":
        return "null"
    if typ == "array":
        item = schema_to_regex(schema.get("items", True))
        lo = int(schema.get("minItems", 0))
        hi = schema.get("maxItems")
        if hi is not None:
            hi = int(hi)
            if hi < lo:
                raise SchemaError("maxItems < minItems")
            if hi == 0:
                return r"\[\]"
            tail = f"(?:,{item}){{{max(0, lo - 1)},{hi - 1}}}"
            body = f"{item}{tail}"
            return rf"\[{body}\]" if lo > 0 else rf"\[(?:{body})?\]"
        if lo > 0:
            return rf"\[{item}(?:,{item}){{{lo - 1},}}\]"
        return rf"\[(?:{item}(?:,{item})*)?\]"
    if typ == "object":
        props = schema.get("properties", {})
        if not props:
            return r"\{\}"
        required = set(schema.get("required", list(props)))
        parts = []
        first = True
        for name, sub in props.items():
            piece = f'"{escape_literal(name)}":{schema_to_regex(sub)}'
            if first:
                if name not in required:
                    raise SchemaError(
                        "the first declared property must be required "
                        "(supported-subset limit; see docs/generation.md)"
                    )
                parts.append(piece)
                first = False
            elif name in required:
                parts.append("," + piece)
            else:
                parts.append(f"(?:,{piece})?")
        return r"\{" + "".join(parts) + r"\}"
    raise SchemaError(f"unsupported schema type {typ!r}")


__all__ = ["SchemaError", "schema_to_regex"]
