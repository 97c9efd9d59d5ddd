"""The YAML that `configs/*.yaml` are written in, read without a YAML
package.

The subset, with the values `yaml.safe_load` gives for it:

  - block mappings by indentation (`KEY: value`, or `KEY:` followed by a
    more-indented block; `KEY:` alone is None), keys plain identifiers;
  - flow sequences `[...]`, nested, of scalars;
  - double- and single-quoted scalars (escapes backslash, quote, slash,
    n, t, r);
  - plain scalars, resolved as YAML 1.1 resolves them: null (`~`, `null`,
    empty), booleans (true/false, yes/no, on/off in their three cases),
    decimal integers, floats with a point (and `.inf`, `.nan`), everything
    else a string (so `(608, 1216)` stays the string CfgNode._decode turns
    into a tuple);
  - comments, whole-line or after a space.

Anything else raises ValueError naming the file and line: block sequences,
flow mappings, anchors, aliases, tags, block and multi-line scalars,
documents, and plain scalars that YAML 1.1 would read as octal, hex, binary
or sexagesimal numbers, timestamps, or merge keys.
"""

from __future__ import annotations

import re
from typing import Any, List, Optional, Tuple

_KEY = re.compile(r"[A-Za-z_][A-Za-z0-9_.\-]*\Z")
_NULL = re.compile(r"(?:~|null|Null|NULL|)\Z")
_BOOL_TRUE = re.compile(r"(?:yes|Yes|YES|true|True|TRUE|on|On|ON)\Z")
_BOOL_FALSE = re.compile(r"(?:no|No|NO|false|False|FALSE|off|Off|OFF)\Z")
_INT = re.compile(r"[-+]?(?:0|[1-9][0-9]*)\Z")
_FLOAT = re.compile(r"(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?\Z")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)\Z")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)\Z")
# what YAML 1.1 (PyYAML's resolver) reads as a number, a timestamp or a
# merge/value key: outside the subset unless matched above
_YAML11_OTHER = re.compile(
    r"""(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+
        |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+
        |[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
        |[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*|<<|=)\Z""",
    re.X,
)
_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r"}
_INDICATORS = "&*!|>%@`{"


class _Error(ValueError):
    pass


def _resolve_plain(text: str) -> Any:
    """A plain scalar's value (YAML 1.1 implicit types, in the subset)."""
    if _NULL.match(text):
        return None
    if _BOOL_TRUE.match(text):
        return True
    if _BOOL_FALSE.match(text):
        return False
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    m = _INF.match(text)
    if m:
        return float(f"{m.group(1)}inf")
    if _NAN.match(text):
        return float("nan")
    if _YAML11_OTHER.match(text):
        raise _Error(f"{text!r} is a YAML 1.1 number, timestamp or merge key outside the subset")
    return text


def _quoted(text: str, i: int) -> Tuple[str, int]:
    """The quoted scalar starting at text[i] -> (value, index after it)."""
    q = text[i]
    out: List[str] = []
    j = i + 1
    while j < len(text):
        c = text[j]
        if q == "'" and c == "'":
            if text[j + 1 : j + 2] == "'":
                out.append("'")
                j += 2
                continue
            return "".join(out), j + 1
        if q == '"' and c == '"':
            return "".join(out), j + 1
        if q == '"' and c == "\\":
            esc = text[j + 1 : j + 2]
            if esc not in _ESCAPES:
                raise _Error(f"escape \\{esc} is outside the subset")
            out.append(_ESCAPES[esc])
            j += 2
            continue
        out.append(c)
        j += 1
    raise _Error("unterminated quoted scalar (multi-line scalars are outside the subset)")


def _strip_comment(text: str) -> str:
    """`text` without a trailing comment (a # at the start or after
    whitespace, outside quotes)."""
    i = 0
    while i < len(text):
        c = text[i]
        if c in "\"'" and (i == 0 or text[i - 1] in " \t[,"):
            i = _quoted(text, i)[1]
            continue
        if c == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
        i += 1
    return text.rstrip()


def _flow_sequence(text: str, i: int) -> Tuple[list, int]:
    """The flow sequence starting at text[i] == "[" -> (list, index after)."""
    items: list = []
    j = i + 1
    expect_item = True
    while True:
        while j < len(text) and text[j] in " \t":
            j += 1
        if j >= len(text):
            raise _Error("unterminated flow sequence (multi-line sequences are outside the subset)")
        c = text[j]
        if c == "]":
            return items, j + 1
        if c == ",":
            if expect_item:
                raise _Error("empty entry in a flow sequence")
            expect_item = True
            j += 1
            continue
        if not expect_item:
            raise _Error(f"expected ',' or ']' at column {j + 1}")
        if c == "[":
            value, j = _flow_sequence(text, j)
        elif c in "\"'":
            value, j = _quoted(text, j)
        elif c in _INDICATORS or c == "}":
            raise _Error(f"{c!r} in a flow sequence is outside the subset")
        else:
            k = j
            while k < len(text) and text[k] not in ",[]{}":
                k += 1
            plain = text[j:k].rstrip()
            if ": " in plain or plain.endswith(":"):
                raise _Error("a mapping inside a flow sequence is outside the subset")
            value, j = _resolve_plain(plain), k
        items.append(value)
        expect_item = False


def _value(text: str) -> Any:
    """A mapping value (the line's text after `KEY:`, comment stripped)."""
    c = text[0]
    if c == "[":
        value, end = _flow_sequence(text, 0)
    elif c in "\"'":
        value, end = _quoted(text, 0)
    elif c in _INDICATORS or text.startswith("- ") or text == "-":
        raise _Error(f"a value starting with {c!r} is outside the subset")
    else:
        if ": " in text or text.endswith(":"):
            raise _Error("a mapping value on the line of its key is outside the subset")
        return _resolve_plain(text)
    if text[end:].strip():
        raise _Error(f"unexpected text after the value: {text[end:].strip()!r}")
    return value


def _split_key(body: str) -> Tuple[str, str]:
    """`KEY: rest` -> (KEY, rest)."""
    m = re.match(r"([^:\s]+):(?:\s+(.*))?\Z", body)
    if not m or not _KEY.match(m.group(1)):
        raise _Error(f"expected `KEY: value` with a plain key, got {body!r}")
    return m.group(1), (m.group(2) or "")


def loads(text: str, name: str = "<string>") -> Optional[dict]:
    """Parse `text` (the subset of the module docstring). An empty document
    is None, as yaml.safe_load gives it."""
    root: Optional[dict] = None
    stack: List[list] = []  # [indent, mapping] from the root down
    pending: Optional[tuple] = None  # (mapping, key, indent) of a `KEY:` line
    for lineno, raw in enumerate(text.splitlines(), start=1):
        try:
            if "\t" in raw[: len(raw) - len(raw.lstrip())]:
                raise _Error("tab in indentation")
            body = _strip_comment(raw.strip())
            if not body:
                continue
            if body in ("---", "...") or body.startswith(("--- ", "%")):
                raise _Error("documents and directives are outside the subset")
            if body.startswith("- ") or body == "-":
                raise _Error("block sequences are outside the subset")
            indent = len(raw) - len(raw.lstrip(" "))
            if root is None:
                root = {}
                stack.append([indent, root])
            elif pending is not None:
                mapping, key, parent_indent = pending
                pending = None
                if indent > parent_indent:
                    mapping[key] = {}
                    stack.append([indent, mapping[key]])
            while indent < stack[-1][0]:
                stack.pop()
                if not stack:
                    raise _Error("indentation below the document's")
            if indent != stack[-1][0]:
                raise _Error(f"indentation {indent} matches no enclosing mapping ({stack[-1][0]})")
            key, rest = _split_key(body)
            mapping = stack[-1][1]
            if key in mapping:
                raise _Error(f"duplicate key {key!r}")
            if rest:
                mapping[key] = _value(rest)
            else:
                mapping[key] = None
                pending = (mapping, key, indent)
        except _Error as e:
            raise ValueError(f"{name}:{lineno}: {e}: {raw.strip()!r}") from None
    return root


def load(path: str) -> Optional[dict]:
    """Parse the file at `path`."""
    with open(path) as f:
        return loads(f.read(), path)
