"""A reader for the subset of YAML the config files use, and for JSON.

The port needs no PyYAML (the card's machine has none) and takes this path
everywhere, so every machine reads a config the same way. It reads:

  - block mappings and block sequences (a sequence may sit at its key's
    indent), ``- key: value`` items;
  - flow sequences and flow mappings, nested and spanning lines
    (``map_to_reduced: {-2: 51, -1: 51, ...}``), a plain scalar in them
    folding a line break into a space (``office\n    chair``);
  - single- and double-quoted scalars, plain scalars, comments;
  - PyYAML's YAML 1.1 resolution of plain scalars: null (``~``, ``null``,
    empty), bools (``true`` / ``yes`` / ``on`` and their opposites, three
    casings), ints (decimal, ``0x``, ``0b``, leading-0 octal, underscores),
    floats (a dot required, signed exponent, ``.inf``, ``.nan``); anything
    else is a string;
  - JSON documents (what the port writes as ``config.yaml``).

Anything else -- anchors, aliases, tags, block scalars (``|``, ``>``),
document markers, multi-line block scalars, sexagesimal numbers, dates,
complex keys -- raises ``ValueError`` naming ``file:line``; it never
guesses.
"""
from __future__ import annotations

import json
import re
from pathlib import Path
from typing import Any, List, Tuple, Union

_NULL = {"~", "null", "Null", "NULL", ""}
_TRUE = {"yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"}
_FALSE = {"no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"}
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
    |[-+]?0[0-7_]+
    |[-+]?(?:0|[1-9][0-9_]*)
    |[-+]?0x[0-9a-fA-F_]+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
# resolved by PyYAML but not taken here: sexagesimal numbers, timestamps,
# the merge key and the value key
_REFUSED = re.compile(r"""^(?:[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?
    |[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?.*
    |<<|=)$""", re.X)
_INDICATORS = "&*!|>%@`"


def _fail(where: str, line: int, msg: str):
    raise ValueError(f"{where}:{line}: {msg}")


def resolve_plain(text: str, where: str = "<yaml>", line: int = 0) -> Any:
    """A plain scalar as PyYAML's safe loader resolves it."""
    if text in _NULL:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text[0] in _INDICATORS or _REFUSED.match(text):
        _fail(where, line, f"unsupported YAML scalar {text!r}")
    if _INT.match(text):
        t = text.replace("_", "")
        sign = -1 if t[0] == "-" else 1
        t = t.lstrip("+-")
        if t.startswith("0b"):
            return sign * int(t[2:], 2)
        if t.startswith("0x"):
            return sign * int(t[2:], 16)
        if len(t) > 1 and t[0] == "0":
            return sign * int(t, 8)
        return sign * int(t)
    if _FLOAT.match(text):
        t = text.replace("_", "").lower()
        if t.endswith(".inf"):
            return float("-inf") if t[0] == "-" else float("inf")
        if t.endswith(".nan"):
            return float("nan")
        return float(t)
    return text


# ---------------------------------------------------------------------------
# lines
# ---------------------------------------------------------------------------

def _strip_comment(text: str) -> str:
    """The line without its comment (a '#' at the start or after a blank,
    outside quotes), right-stripped."""
    quote = None
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or text[i - 1] in " \t[{,:"):
            quote = ch
        elif ch == "#" and (i == 0 or text[i - 1] in " \t"):
            return text[:i].rstrip()
    return text.rstrip()


class _Lines:
    def __init__(self, text: str, where: str):
        self.where = where
        self.items: List[Tuple[int, int, str]] = []   # (line, indent, text)
        for n, raw in enumerate(text.splitlines(), 1):
            if "\t" in raw[:len(raw) - len(raw.lstrip())]:
                _fail(where, n, "tab in indentation")
            body = _strip_comment(raw)
            if not body.strip():
                continue
            stripped = body.lstrip(" ")
            if stripped in ("---", "...") or stripped.startswith("%"):
                _fail(where, n, "document markers and directives are not "
                                "supported")
            self.items.append((n, len(body) - len(stripped), stripped))

    def fail(self, i: int, msg: str):
        line = self.items[i][0] if i < len(self.items) else (
            self.items[-1][0] if self.items else 0)
        _fail(self.where, line, msg)


def _key_split(text: str):
    """(key text, rest) if the line is a ``key: value`` entry, else None."""
    quote = None
    depth = 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
            continue
        if ch in "'\"" and i == 0:
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and depth == 0 and (i + 1 == len(text)
                                            or text[i + 1] == " "):
            return text[:i].rstrip(), text[i + 1:].strip()
    return None


def _is_seq_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


# ---------------------------------------------------------------------------
# block structure
# ---------------------------------------------------------------------------

class _Parser:
    def __init__(self, lines: _Lines):
        self.lines = lines
        self.items = lines.items

    def node(self, i: int) -> Tuple[Any, int]:
        _, ind, text = self.items[i]
        if _is_seq_item(text):
            return self.seq(i, ind)
        if _key_split(text) is not None and text[0] not in "[{":
            return self.mapping(i, ind)
        return self.inline(text, i)

    def key(self, text: str, i: int) -> Any:
        if not text or text[0] in "[{?":
            self.lines.fail(i, f"unsupported mapping key {text!r}")
        if text[0] in "'\"":
            value, end = _Flow(text, self.lines, i).scalar(0, ())
            if text[end:].strip():
                self.lines.fail(i, f"bad quoted key {text!r}")
            return value
        return resolve_plain(text, self.lines.where, self.items[i][0])

    def child(self, i: int, ind: int, key: bool) -> Tuple[Any, int]:
        """The value of an entry with nothing after its ':' or '-': a block
        nested deeper (or, under a key, a sequence at the key's indent),
        else null."""
        nxt = i + 1
        if nxt < len(self.items):
            _, nind, ntext = self.items[nxt]
            if nind > ind or (key and nind == ind and _is_seq_item(ntext)):
                return self.node(nxt)
        return None, nxt

    def mapping(self, i: int, ind: int) -> Tuple[dict, int]:
        out: dict = {}
        n = len(self.items)
        while i < n and self.items[i][1] == ind:
            text = self.items[i][2]
            split = _key_split(text)
            if split is None or _is_seq_item(text):
                self.lines.fail(i, f"expected 'key: value', got {text!r}")
            key = self.key(split[0], i)
            if split[1]:
                value, i = self.inline(split[1], i)
            else:
                value, i = self.child(i, ind, True)
            out[key] = value
        if i < n and self.items[i][1] > ind:
            self.lines.fail(i, "unexpected indentation")
        return out, i

    def seq(self, i: int, ind: int) -> Tuple[list, int]:
        out: list = []
        n = len(self.items)
        while i < n and self.items[i][1] == ind and _is_seq_item(
                self.items[i][2]):
            line, _, text = self.items[i]
            rest = text[1:].lstrip(" ")
            if not rest:
                value, i = self.child(i, ind, False)
            elif _is_seq_item(rest) or (_key_split(rest) is not None
                                        and rest[0] not in "[{'\""):
                # an inline block: re-read this line as its first entry
                col = ind + len(text) - len(rest)
                self.items[i] = (line, col, rest)
                value, i = self.node(i)
            else:
                value, i = self.inline(rest, i)
            out.append(value)
        if i < n and self.items[i][1] > ind:
            self.lines.fail(i, "unexpected indentation")
        return out, i

    def inline(self, text: str, i: int) -> Tuple[Any, int]:
        """A value on the line of its key / dash: a flow collection (which
        may run over the following lines), a quoted or a plain scalar."""
        if text[0] in "[{":
            parts, j = [text], i
            flow = _Flow(text, self.lines, i)
            while not flow.balanced():
                j += 1
                if j >= len(self.items):
                    self.lines.fail(i, "unterminated flow collection")
                parts.append(self.items[j][2])
                flow = _Flow("\n".join(parts), self.lines, i)
            value, end = flow.value(0)
            if flow.text[end:].strip():
                self.lines.fail(j, f"text after a flow collection: "
                                   f"{flow.text[end:].strip()!r}")
            return value, j + 1
        if text[0] in "'\"":
            flow = _Flow(text, self.lines, i)
            value, end = flow.scalar(0, ())
            if text[end:].strip():
                self.lines.fail(i, f"text after a quoted scalar: {text!r}")
            return value, i + 1
        nxt = i + 1
        if nxt < len(self.items) and self.items[nxt][1] > self.items[i][1] \
                and _key_split(text) is None:
            self.lines.fail(nxt, "multi-line plain scalars are not supported")
        return resolve_plain(text, self.lines.where, self.items[i][0]), i + 1


# ---------------------------------------------------------------------------
# flow collections and quoted scalars
# ---------------------------------------------------------------------------

class _Flow:
    def __init__(self, text: str, lines: _Lines, i: int):
        self.text = text
        self.lines = lines
        self.i = i

    def fail(self, pos: int, msg: str):
        line = self.lines.items[self.i][0] + self.text.count("\n", 0, pos)
        _fail(self.lines.where, line, msg)

    def balanced(self) -> bool:
        depth, quote = 0, None
        for ch in self.text:
            if quote:
                if ch == quote:
                    quote = None
            elif ch in "'\"":
                quote = ch
            elif ch in "[{":
                depth += 1
            elif ch in "]}":
                depth -= 1
        return depth <= 0 and quote is None

    def ws(self, pos: int) -> int:
        while pos < len(self.text) and self.text[pos] in " \n":
            pos += 1
        return pos

    def value(self, pos: int, stops=(",", "]", "}")) -> Tuple[Any, int]:
        pos = self.ws(pos)
        if pos >= len(self.text):
            self.fail(pos, "unexpected end of a flow collection")
        ch = self.text[pos]
        if ch == "[":
            return self.seq(pos + 1)
        if ch == "{":
            return self.mapping(pos + 1)
        return self.scalar(pos, stops)

    def seq(self, pos: int) -> Tuple[list, int]:
        out = []
        while True:
            pos = self.ws(pos)
            if pos < len(self.text) and self.text[pos] == "]":
                return out, pos + 1
            value, pos = self.value(pos)
            pos = self.ws(pos)
            if pos < len(self.text) and self.text[pos] == ":":
                self.fail(pos, "single-pair mappings in a flow sequence are "
                               "not supported")
            out.append(value)
            if pos < len(self.text) and self.text[pos] == ",":
                pos += 1
            elif pos >= len(self.text) or self.text[pos] != "]":
                self.fail(pos, "expected ',' or ']'")

    def mapping(self, pos: int) -> Tuple[dict, int]:
        out = {}
        while True:
            pos = self.ws(pos)
            if pos < len(self.text) and self.text[pos] == "}":
                return out, pos + 1
            if pos < len(self.text) and self.text[pos] in "[{?":
                self.fail(pos, "complex mapping keys are not supported")
            key, pos = self.scalar(pos, (":", ",", "}"), key=True)
            pos = self.ws(pos)
            if pos >= len(self.text) or self.text[pos] != ":":
                self.fail(pos, "expected ':' after a flow mapping key")
            value, pos = self.value(pos + 1)
            out[key] = value
            pos = self.ws(pos)
            if pos < len(self.text) and self.text[pos] == ",":
                pos += 1
            elif pos >= len(self.text) or self.text[pos] != "}":
                self.fail(pos, "expected ',' or '}'")

    def scalar(self, pos: int, stops, key: bool = False) -> Tuple[Any, int]:
        text = self.text
        ch = text[pos]
        if ch == "'":
            out, pos = [], pos + 1
            while True:
                end = text.find("'", pos)
                if end < 0:
                    self.fail(pos, "unterminated single-quoted scalar")
                out.append(text[pos:end])
                if text[end + 1:end + 2] == "'":
                    out.append("'")
                    pos = end + 2
                    continue
                if "\n" in "".join(out):
                    self.fail(pos, "multi-line quoted scalars are not "
                                   "supported")
                return "".join(out), end + 1
        if ch == '"':
            end = pos + 1
            while end < len(text) and text[end] != '"':
                end += 2 if text[end] == "\\" else 1
            if end >= len(text):
                self.fail(pos, "unterminated double-quoted scalar")
            raw = text[pos:end + 1]
            if "\n" in raw:
                self.fail(pos, "multi-line quoted scalars are not supported")
            try:
                return json.loads(raw), end + 1
            except json.JSONDecodeError:
                self.fail(pos, f"unsupported escape in {raw}")
        end = pos
        while end < len(text) and text[end] not in stops:
            if text[end] == ":" and (end + 1 == len(text)
                                     or text[end + 1] in " \n,[]{}"):
                if key:
                    break
                self.fail(end, "':' in a plain flow scalar")
            end += 1
        # a plain scalar over several lines of a flow collection folds each
        # line break (and the indentation around it) into one space
        plain = " ".join(part.strip() for part in text[pos:end].split("\n"))
        plain = plain.strip()
        if not plain and not key and end < len(text) and text[end] in ",]}":
            return None, end
        line = self.lines.items[self.i][0] + text.count("\n", 0, pos)
        return resolve_plain(plain, self.lines.where, line), end


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def loads(text: str, where: str = "<yaml>") -> Any:
    """The document in ``text`` (YAML subset or JSON); None when empty."""
    body = text.lstrip()
    if body[:1] in ("{", "["):
        try:
            return json.loads(text)
        except json.JSONDecodeError:
            pass
    lines = _Lines(text, where)
    if not lines.items:
        return None
    parser = _Parser(lines)
    if lines.items[0][1] != 0:
        lines.fail(0, "the document must start at column 0")
    value, i = parser.node(0)
    if i < len(lines.items):
        lines.fail(i, f"unexpected content {lines.items[i][2]!r}")
    return value


def load(path: Union[str, Path]) -> Any:
    path = Path(path)
    return loads(path.read_text(), str(path))
