"""A small HCL1 reader.

The reference parses jobspecs with hashicorp/hcl (HCL1) into an AST that
``jobspec/parse.go:27 Parse`` walks.  We implement the same surface here from
scratch: a hand-written lexer + recursive-descent parser producing plain
Python structures that ``nomad_tpu_torch/jobspec/parse.py`` maps onto structs.

Supported HCL1 surface (everything jobspecs use):

* attributes  ``key = value``
* blocks      ``key "label" "label2" { ... }`` (labels optional, repeatable)
* values: quoted strings (with Go escape sequences; ``${...}`` interpolation
  is preserved verbatim — interpolation happens later, at task-env time, as in
  the reference), heredocs (``<<EOF`` and indented ``<<-EOF``), integers
  (decimal/hex), floats, booleans, lists ``[a, b,]``, and objects
  ``{ k = v }``
* comments: ``#``, ``//`` and ``/* ... */``

The parse result models HCL1's object semantics: a *body* is an ``HCLObject``
— an ordered multi-map, because the same key may repeat (``group "a" {}``
``group "b" {}``) and order matters for merging.  A block with labels becomes
nested single-key objects, exactly like HCL1's JSON form:
``job "x" { ... }`` → ``("job", HCLObject[("x", HCLObject[...])])``.

Copied from ``nomad_tpu/jobspec/hcl.py`` into the PyTorch port, which imports
nothing of ``nomad_tpu``.
"""

from __future__ import annotations

from typing import Any, Iterator, List, Optional, Tuple


class HCLError(ValueError):
    def __init__(self, msg: str, line: int) -> None:
        super().__init__(f"{msg} (line {line})")
        self.line = line


class HCLObject:
    """Ordered multi-map of key → value (value: scalar, list, HCLObject)."""

    __slots__ = ("items",)

    def __init__(self, items: Optional[List[Tuple[str, Any]]] = None) -> None:
        self.items: List[Tuple[str, Any]] = items if items is not None else []

    def add(self, key: str, value: Any) -> None:
        self.items.append((key, value))

    def get_all(self, key: str) -> List[Any]:
        return [v for k, v in self.items if k == key]

    def get(self, key: str, default: Any = None) -> Any:
        """Last value wins for scalar attributes (HCL1 semantics)."""
        out = default
        for k, v in self.items:
            if k == key:
                out = v
        return out

    def keys(self) -> List[str]:
        seen: List[str] = []
        for k, _ in self.items:
            if k not in seen:
                seen.append(k)
        return seen

    def __contains__(self, key: str) -> bool:
        return any(k == key for k, _ in self.items)

    def __iter__(self) -> Iterator[Tuple[str, Any]]:
        return iter(self.items)

    def __len__(self) -> int:
        return len(self.items)

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"HCLObject({self.items!r})"

    def to_plain(self) -> Any:
        """Collapse to plain dicts/lists (repeated keys -> list)."""
        out: dict = {}
        for k in self.keys():
            vals = [
                v.to_plain() if isinstance(v, HCLObject) else v
                for v in self.get_all(k)
            ]
            out[k] = vals[0] if len(vals) == 1 else vals
        return out


# ---------------------------------------------------------------------------
# Lexer
# ---------------------------------------------------------------------------

_IDENT_START = set("abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ_")
_IDENT_CHARS = _IDENT_START | set("0123456789-.")


class _Token:
    __slots__ = ("kind", "value", "line")

    def __init__(self, kind: str, value: Any, line: int) -> None:
        self.kind = kind  # IDENT STRING NUMBER LBRACE RBRACE LBRACK RBRACK EQ COMMA COLON EOF
        self.value = value
        self.line = line

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return f"_Token({self.kind}, {self.value!r}, line={self.line})"


_ESCAPES = {
    "n": "\n",
    "t": "\t",
    "r": "\r",
    '"': '"',
    "\\": "\\",
    "'": "'",
    "a": "\a",
    "b": "\b",
    "f": "\f",
    "v": "\v",
    "0": "\0",
}


def _lex(src: str) -> List[_Token]:
    toks: List[_Token] = []
    i, n, line = 0, len(src), 1
    while i < n:
        c = src[i]
        if c == "\n":
            line += 1
            i += 1
            continue
        if c in " \t\r":
            i += 1
            continue
        if c == "#" or src.startswith("//", i):
            while i < n and src[i] != "\n":
                i += 1
            continue
        if src.startswith("/*", i):
            end = src.find("*/", i + 2)
            if end < 0:
                raise HCLError("unterminated block comment", line)
            line += src.count("\n", i, end)
            i = end + 2
            continue
        if c == "{":
            toks.append(_Token("LBRACE", "{", line))
            i += 1
            continue
        if c == "}":
            toks.append(_Token("RBRACE", "}", line))
            i += 1
            continue
        if c == "[":
            toks.append(_Token("LBRACK", "[", line))
            i += 1
            continue
        if c == "]":
            toks.append(_Token("RBRACK", "]", line))
            i += 1
            continue
        if c == "=":
            toks.append(_Token("EQ", "=", line))
            i += 1
            continue
        if c == ",":
            toks.append(_Token("COMMA", ",", line))
            i += 1
            continue
        if c == ":":
            toks.append(_Token("COLON", ":", line))
            i += 1
            continue
        if src.startswith("<<", i):
            i, line, text = _lex_heredoc(src, i, line)
            toks.append(_Token("STRING", text, line))
            continue
        if c == '"':
            i, line, text = _lex_string(src, i, line)
            toks.append(_Token("STRING", text, line))
            continue
        if c.isdigit() or (c == "-" and i + 1 < n and src[i + 1].isdigit()):
            i, num = _lex_number(src, i, line)
            toks.append(_Token("NUMBER", num, line))
            continue
        if c in _IDENT_START:
            j = i
            while j < n and src[j] in _IDENT_CHARS:
                j += 1
            toks.append(_Token("IDENT", src[i:j], line))
            i = j
            continue
        raise HCLError(f"unexpected character {c!r}", line)
    toks.append(_Token("EOF", None, line))
    return toks


def _lex_string(src: str, i: int, line: int) -> Tuple[int, int, str]:
    # i points at the opening quote
    out: List[str] = []
    i += 1
    n = len(src)
    while i < n:
        c = src[i]
        if c == '"':
            return i + 1, line, "".join(out)
        if c == "\n":
            raise HCLError("newline in string", line)
        if c == "\\":
            if i + 1 >= n:
                raise HCLError("unterminated escape", line)
            e = src[i + 1]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
                continue
            if e == "u" and i + 5 < n:
                out.append(chr(int(src[i + 2 : i + 6], 16)))
                i += 6
                continue
            # Unknown escape: keep verbatim (lenient, like HCL1 printer round-trips)
            out.append(c + e)
            i += 2
            continue
        if c == "$" and i + 1 < n and src[i + 1] == "{":
            # Preserve interpolation expressions verbatim, including nested braces.
            depth = 0
            j = i
            while j < n:
                if src[j] == "{":
                    depth += 1
                elif src[j] == "}":
                    depth -= 1
                    if depth == 0:
                        break
                j += 1
            if j >= n:
                raise HCLError("unterminated interpolation", line)
            out.append(src[i : j + 1])
            i = j + 1
            continue
        out.append(c)
        i += 1
    raise HCLError("unterminated string", line)


def _lex_heredoc(src: str, i: int, line: int) -> Tuple[int, int, str]:
    # i points at "<<"; optionally "<<-" for indented heredoc
    j = i + 2
    indented = j < len(src) and src[j] == "-"
    if indented:
        j += 1
    k = j
    while k < len(src) and src[k] not in "\n\r":
        k += 1
    marker = src[j:k].strip()
    if not marker:
        raise HCLError("heredoc missing marker", line)
    if k < len(src) and src[k] == "\r":
        k += 1
    if k >= len(src) or src[k] != "\n":
        raise HCLError("heredoc marker must end the line", line)
    k += 1
    start_line = line
    line += 1
    lines: List[str] = []
    while True:
        if k >= len(src):
            raise HCLError("unterminated heredoc", start_line)
        end = src.find("\n", k)
        if end < 0:
            end = len(src)
        raw = src[k:end]
        if raw.strip() == marker:
            k = end + 1 if end < len(src) else end
            line += 1
            break
        lines.append(raw)
        k = end + 1 if end < len(src) else end
        line += 1
    if indented and lines:
        # Strip the smallest common leading whitespace (HCL1 <<- semantics)
        def indent_of(s: str) -> int:
            return len(s) - len(s.lstrip()) if s.strip() else 1 << 30

        pad = min((indent_of(s) for s in lines), default=0)
        if pad and pad < (1 << 30):
            lines = [s[pad:] if s.strip() else s for s in lines]
    text = "\n".join(lines)
    if text:
        text += "\n"
    return k, line, text


def _lex_number(src: str, i: int, line: int) -> Tuple[int, Any]:
    j = i
    n = len(src)
    if src[j] == "-":
        j += 1
    if src.startswith("0x", j) or src.startswith("0X", j):
        k = j + 2
        while k < n and src[k] in "0123456789abcdefABCDEF":
            k += 1
        return k, int(src[i:k], 16)
    k = j
    isfloat = False
    while k < n and (src[k].isdigit() or src[k] in ".eE+-"):
        if src[k] in ".eE":
            isfloat = True
        if src[k] in "+-" and src[k - 1] not in "eE":
            break
        k += 1
    text = src[i:k]
    try:
        return k, float(text) if isfloat else int(text)
    except ValueError:
        raise HCLError(f"bad number literal {text!r}", line)


# ---------------------------------------------------------------------------
# Parser
# ---------------------------------------------------------------------------


class _Parser:
    def __init__(self, toks: List[_Token]) -> None:
        self.toks = toks
        self.pos = 0

    def peek(self) -> _Token:
        return self.toks[self.pos]

    def next(self) -> _Token:
        t = self.toks[self.pos]
        self.pos += 1
        return t

    def expect(self, kind: str) -> _Token:
        t = self.next()
        if t.kind != kind:
            raise HCLError(f"expected {kind}, got {t.kind} {t.value!r}", t.line)
        return t

    def parse_body(self, top: bool = False) -> HCLObject:
        obj = HCLObject()
        while True:
            t = self.peek()
            if t.kind == "EOF":
                if not top:
                    raise HCLError("unexpected end of input, missing '}'", t.line)
                return obj
            if t.kind == "RBRACE":
                if top:
                    raise HCLError("unexpected '}'", t.line)
                self.next()
                return obj
            if t.kind == "COMMA":  # stray commas between object items are legal
                self.next()
                continue
            if t.kind not in ("IDENT", "STRING"):
                raise HCLError(f"expected key, got {t.kind} {t.value!r}", t.line)
            key = self.next().value
            labels: List[str] = []
            while self.peek().kind in ("STRING", "IDENT") and self.peek().kind != "EOF":
                labels.append(self.next().value)
            t = self.peek()
            if t.kind == "EQ":
                if labels:
                    raise HCLError("unexpected '=' after block labels", t.line)
                self.next()
                obj.add(key, self.parse_value())
            elif t.kind == "LBRACE":
                self.next()
                body = self.parse_body()
                # Nest labels: job "x" {..} -> job: { x: {..} }
                for label in reversed(labels):
                    wrapper = HCLObject()
                    wrapper.add(label, body)
                    body = wrapper
                obj.add(key, body)
            else:
                raise HCLError(
                    f"expected '=' or '{{' after {key!r}, got {t.kind}", t.line
                )

    def parse_value(self) -> Any:
        t = self.next()
        if t.kind in ("STRING", "NUMBER"):
            return t.value
        if t.kind == "IDENT":
            if t.value == "true":
                return True
            if t.value == "false":
                return False
            raise HCLError(f"unexpected identifier {t.value!r} as value", t.line)
        if t.kind == "LBRACK":
            out: List[Any] = []
            while True:
                nt = self.peek()
                if nt.kind == "RBRACK":
                    self.next()
                    return out
                out.append(self.parse_value())
                nt = self.peek()
                if nt.kind == "COMMA":
                    self.next()
                elif nt.kind != "RBRACK":
                    raise HCLError("expected ',' or ']' in list", nt.line)
        if t.kind == "LBRACE":
            return self.parse_body()
        raise HCLError(f"unexpected token {t.kind} {t.value!r}", t.line)


def parse(src: str) -> HCLObject:
    """Parse HCL1 source into an :class:`HCLObject` tree."""
    return _Parser(_lex(src)).parse_body(top=True)
