"""The subset of YAML that the config files use, read without PyYAML.

Covers block mappings nested by indentation, plain and quoted scalars,
inline lists (``[a, b]``, also nested) and ``#`` comments. Scalars resolve
as YAML 1.1's ``safe_load`` resolves them: ``yes/no/on/off/true/false``
are booleans, ``~``/``null``/empty are ``None``, an int needs no dot
(``0x``/``0o``/``0b`` prefixes and ``_`` separators allowed), a float needs
a dot (and an exponent needs a sign: ``1e-3`` stays a string). Anything
else (block lists, anchors, multi-line strings) raises ``ValueError``.
"""

from __future__ import annotations

import re

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_INT = re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                  r"|[-+]?0x[0-9a-fA-F_]+)$")
_FLOAT = re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")


def _int(text: str) -> int:
    t = text.replace("_", "")
    sign = -1 if t.startswith("-") else 1
    t = t.lstrip("+-")
    if t.startswith("0b"):
        return sign * int(t[2:], 2)
    if t.startswith("0x"):
        return sign * int(t[2:], 16)
    if len(t) > 1 and t.startswith("0"):
        return sign * int(t, 8)
    return sign * int(t)


def _float(text: str) -> float:
    t = text.replace("_", "").lower()
    if t.endswith("inf"):
        return float("-inf") if t.startswith("-") else float("inf")
    if t.endswith("nan"):
        return float("nan")
    return float(t)


def parse_scalar(text: str):
    """One plain or quoted scalar, resolved as ``yaml.safe_load`` does."""
    t = text.strip()
    if len(t) >= 2 and t[0] == t[-1] == "'":
        return t[1:-1].replace("''", "'")
    if len(t) >= 2 and t[0] == t[-1] == '"':
        return bytes(t[1:-1], "utf-8").decode("unicode_escape")
    if _NULL.match(t):
        return None
    if _BOOL.match(t):
        return t.lower() in _TRUE
    if _INT.match(t):
        return _int(t)
    if _FLOAT.match(t):
        return _float(t)
    return t


def _split_top(body: str) -> list[str]:
    """Split an inline list's body at top-level commas."""
    parts, depth, quote, cur = [], 0, "", ""
    for ch in body:
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "[":
            depth += 1
        elif ch == "]":
            depth -= 1
        elif ch == "," and depth == 0:
            parts.append(cur)
            cur = ""
            continue
        cur += ch
    if cur.strip() or parts:
        parts.append(cur)
    return parts


def parse_value(text: str):
    """A scalar or an inline list."""
    t = text.strip()
    if t.startswith("["):
        if not t.endswith("]"):
            raise ValueError(f"unterminated inline list: {text!r}")
        return [parse_value(p) for p in _split_top(t[1:-1])]
    if t.startswith(("{", "&", "*", "!", "|", ">", "- ")) or t == "-":
        raise ValueError(f"unsupported YAML construct: {text!r}")
    return parse_scalar(t)


def _strip_comment(line: str) -> str:
    quote = ""
    for i, ch in enumerate(line):
        if quote:
            quote = "" if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def loads(text: str):
    """Parse a document of nested block mappings; empty text gives None."""
    lines = []
    for raw in text.splitlines():
        line = _strip_comment(raw).rstrip()
        if line.strip():
            if "\t" in line[: len(line) - len(line.lstrip())]:
                raise ValueError("tabs are not allowed in YAML indentation")
            lines.append((len(line) - len(line.lstrip(" ")), line.strip()))
    if not lines:
        return None
    root: dict = {}
    stack = [(-1, root)]  # (indent of the mapping's keys, mapping)
    pending = None  # (indent, parent mapping, key) awaiting a nested block
    for indent, content in lines:
        key, sep, rest = content.partition(":")
        if not sep or (rest and not rest.startswith(" ")):
            raise ValueError(f"expected 'key: value', got {content!r}")
        if pending is not None:
            p_indent, parent, p_key = pending
            if indent > p_indent:
                child: dict = {}
                parent[p_key] = child
                stack.append((indent, child))
            else:
                parent[p_key] = None
            pending = None
        while stack and indent < stack[-1][0]:
            stack.pop()
        if not stack or indent != stack[-1][0]:
            if stack[-1][0] == -1 and not stack[-1][1]:
                stack[-1] = (indent, root)
            else:
                raise ValueError(f"bad indentation at {content!r}")
        mapping = stack[-1][1]
        key = parse_scalar(key)
        if rest.strip():
            mapping[key] = parse_value(rest)
        else:
            pending = (indent, mapping, key)
    if pending is not None:
        pending[1][pending[2]] = None
    return root
