"""-json / -t output formatting for status commands.

Mirrors reference ``command/data_format.go``: ``DataFormat("json", ...)``
pretty-prints the API payload with 4-space indentation;
``DataFormat("template", tmpl)`` renders a Go text/template over it.
This implementation covers the template subset operators actually script
against the CLI with (the patterns in the reference's docs and tests):

  - ``{{.Field.Sub}}``   dotted field access on the API JSON shape
  - ``{{.}}``            the current value
  - ``{{range .X}}...{{end}}``  iteration (over lists or map values),
    rebinding ``.`` to each element; nests arbitrarily
  - ``{{if .X}}...{{else}}...{{end}}``  truthiness guard
  - ``{{"..."}}``        string literals (``{{"\\n"}}`` newlines)
  - ``{{len .X}}``       length

Unsupported constructs raise a formatting error (exit 1) rather than
printing wrong data — matching the reference's behavior of surfacing
template errors verbatim.

Copied from ``nomad_tpu/cli/data_format.py`` into the PyTorch port,
which imports nothing of ``nomad_tpu``. No change.
"""
from __future__ import annotations

import json
import re
from typing import Any, List, Tuple


class FormatError(Exception):
    pass


def format_data(use_json: bool, tmpl: str, data: Any) -> str:
    """The Format() helper every status command shares
    (data_format.go:76): -json and -t are mutually exclusive; -json
    matches the reference's 4-space-indent codec config."""
    if use_json and tmpl:
        raise FormatError("json format does not support template option.")
    if use_json:
        return json.dumps(data, indent=4, sort_keys=True)
    if tmpl:
        return render_template(tmpl, data)
    raise FormatError("no format specified")


# ---------------------------------------------------------------------------
# Go text/template subset
# ---------------------------------------------------------------------------

_ACTION = re.compile(r"\{\{(.*?)\}\}", re.DOTALL)

# AST nodes: ("text", str) | ("expr", str) | ("range", str, body)
#          | ("if", str, body, else_body)


def _parse(tmpl: str) -> List[tuple]:
    tokens: List[tuple] = []
    pos = 0
    for m in _ACTION.finditer(tmpl):
        if m.start() > pos:
            tokens.append(("text", tmpl[pos:m.start()]))
        tokens.append(("action", m.group(1).strip()))
        pos = m.end()
    if pos < len(tmpl):
        tokens.append(("text", tmpl[pos:]))

    def build(i: int, closers: Tuple[str, ...]) -> Tuple[List[tuple], int, str]:
        nodes: List[tuple] = []
        while i < len(tokens):
            kind, val = tokens[i]
            if kind == "text":
                nodes.append(("text", val))
                i += 1
                continue
            word = val.split(None, 1)[0] if val else ""
            if word in closers:
                return nodes, i, word
            if word == "range":
                body, i, closer = build(i + 1, ("end",))
                nodes.append(("range", val[len("range"):].strip(), body))
                i += 1
            elif word == "if":
                body, i, closer = build(i + 1, ("else", "end"))
                else_body: List[tuple] = []
                if closer == "else":
                    else_body, i, _ = build(i + 1, ("end",))
                nodes.append(("if", val[len("if"):].strip(), body, else_body))
                i += 1
            elif word in ("end", "else"):
                raise FormatError(f"template: unexpected {{{{{word}}}}}")
            else:
                nodes.append(("expr", val))
                i += 1
        if closers:
            raise FormatError("template: unclosed block (missing {{end}})")
        return nodes, i, ""

    nodes, _, _ = build(0, ())
    return nodes


# Backslash escape sequences in template string literals. Only these are
# rewritten; every other character passes through verbatim — a blanket
# unicode_escape decode of the whole literal mojibake'd non-ASCII text
# (each UTF-8 byte of "café" decoded as its own latin-1 codepoint).
_ESCAPE_SEQ = re.compile(
    r"\\(?:u[0-9a-fA-F]{4}|U[0-9a-fA-F]{8}|x[0-9a-fA-F]{2}|[0-7]{1,3}|.)",
    re.DOTALL,
)


def _unescape_literal(raw: str) -> str:
    def repl(m: "re.Match[str]") -> str:
        seq = m.group(0)
        try:
            # unicode_escape is safe HERE: the match is pure ASCII
            return seq.encode("ascii").decode("unicode_escape")
        except UnicodeEncodeError:
            raise FormatError(f"template: bad escape sequence {seq!r}")

    return _ESCAPE_SEQ.sub(repl, raw)


def _resolve(expr: str, scope: Any) -> Any:
    expr = expr.strip()
    if expr == ".":
        return scope
    if len(expr) >= 2 and expr[0] == '"' and expr[-1] == '"':
        return _unescape_literal(expr[1:-1])
    if expr.startswith("len "):
        v = _resolve(expr[4:], scope)
        try:
            return len(v)
        except TypeError:
            raise FormatError(f"template: len of non-collection {expr!r}")
    if expr.startswith("."):
        cur = scope
        for part in expr[1:].split("."):
            if not part:
                continue
            if isinstance(cur, dict):
                cur = cur.get(part)
            elif cur is None:
                return None
            else:
                cur = getattr(cur, part, None)
        return cur
    raise FormatError(f"template: unsupported expression {expr!r}")


def _stringify(v: Any) -> str:
    if v is None:
        return "<no value>"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (dict, list)):
        return json.dumps(v, sort_keys=True)
    return str(v)


def _render(nodes: List[tuple], scope: Any, out: List[str]) -> None:
    for node in nodes:
        kind = node[0]
        if kind == "text":
            out.append(node[1])
        elif kind == "expr":
            out.append(_stringify(_resolve(node[1], scope)))
        elif kind == "range":
            coll = _resolve(node[1], scope)
            if coll is None:
                continue
            items = list(coll.values()) if isinstance(coll, dict) else list(coll)
            for item in items:
                _render(node[2], item, out)
        elif kind == "if":
            v = _resolve(node[1], scope)
            _render(node[2] if v else node[3], scope, out)


def render_template(tmpl: str, data: Any) -> str:
    out: List[str] = []
    _render(_parse(tmpl), data, out)
    return "".join(out)
