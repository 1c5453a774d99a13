"""Recursive-descent parser for the condition grammar.

Reference parity (grammar, ``json-el/.../JsonConditionParser.scala:37-52``):

    condition   = disjunction
    disjunction = conjunction { '||' conjunction }
    conjunction = comparison  { '&&' comparison }
    comparison  = literal ('=='|'!=') literal
                | (number|jsonpath) ('<'|'<='|'>'|'>=') (number|jsonpath)
                | '(' condition ')'
    literal     = jsonpath | string | number | 'true' | 'false' | 'null'
"""

from __future__ import annotations

import re
from typing import List, NamedTuple, Optional, Union

from zeebe_tpu_torch.models.el.ast import (
    Comparison,
    Condition,
    Conjunction,
    Disjunction,
    JsonPathLiteral,
    Literal,
)


class ConditionParseError(ValueError):
    pass


class Token(NamedTuple):
    kind: str
    text: str
    pos: int


_TOKEN_RE = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<jsonpath>\$[^\s()&|=!<>]*)
  | (?P<number>-?(\d+\.\d*|\d*\.\d+)([eE][+-]?\d+)?[fFdD]?|-?\d+)
  | (?P<dqstring>"([^"\\]|\\.)*")
  | (?P<sqstring>'([^'\\]|\\.)*')
  | (?P<op>==|!=|<=|>=|<|>|&&|\|\||[()])
  | (?P<word>[A-Za-z_][A-Za-z0-9_]*)
""",
    re.VERBOSE,
)

_ESCAPES = {"\\": "\\", "'": "'", '"': '"', "b": "\b", "f": "\f", "n": "\n", "r": "\r", "t": "\t"}


def _unescape(body: str) -> str:
    out = []
    i = 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and i + 1 < len(body):
            nxt = body[i + 1]
            if nxt == "u" and i + 5 < len(body):
                out.append(chr(int(body[i + 2 : i + 6], 16)))
                i += 6
                continue
            out.append(_ESCAPES.get(nxt, nxt))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _tokenize(text: str) -> List[Token]:
    tokens = []
    pos = 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            raise ConditionParseError(f"unexpected character {text[pos]!r} at {pos}")
        kind = m.lastgroup
        if kind != "ws":
            tokens.append(Token(kind, m.group(), pos))
        pos = m.end()
    return tokens


class _Parser:
    def __init__(self, tokens: List[Token], source: str):
        self.tokens = tokens
        self.i = 0
        self.source = source

    def peek(self) -> Optional[Token]:
        return self.tokens[self.i] if self.i < len(self.tokens) else None

    def take(self) -> Token:
        tok = self.peek()
        if tok is None:
            raise ConditionParseError(f"unexpected end of condition: {self.source!r}")
        self.i += 1
        return tok

    def expect_op(self, *texts: str) -> Token:
        tok = self.take()
        if tok.kind != "op" or tok.text not in texts:
            raise ConditionParseError(
                f"expected one of {texts} at {tok.pos}, got {tok.text!r}"
            )
        return tok

    # grammar ------------------------------------------------------------
    def condition(self) -> Condition:
        return self.disjunction()

    def disjunction(self) -> Condition:
        left = self.conjunction()
        while (tok := self.peek()) is not None and tok.text == "||":
            self.take()
            left = Disjunction(left, self.conjunction())
        return left

    def conjunction(self) -> Condition:
        left = self.comparison()
        while (tok := self.peek()) is not None and tok.text == "&&":
            self.take()
            left = Conjunction(left, self.comparison())
        return left

    def comparison(self) -> Condition:
        tok = self.peek()
        if tok is not None and tok.text == "(":
            self.take()
            inner = self.condition()
            self.expect_op(")")
            return inner
        left = self.literal()
        op_tok = self.take()
        if op_tok.kind != "op" or op_tok.text not in ("==", "!=", "<", "<=", ">", ">="):
            raise ConditionParseError(
                "expected comparison operator ('==', '!=', '<', '<=', '>', '>=') "
                f"at {op_tok.pos}"
            )
        right = self.literal()
        if op_tok.text in ("<", "<=", ">", ">="):
            for side in (left, right):
                if isinstance(side, Literal) and not isinstance(side.value, (int, float)):
                    raise ConditionParseError(
                        f"expected number or JSON path for ordering comparison, got {side.value!r}"
                    )
                if isinstance(side, Literal) and isinstance(side.value, bool):
                    raise ConditionParseError(
                        "expected number or JSON path for ordering comparison, got bool"
                    )
        return Comparison(op_tok.text, left, right)

    def literal(self) -> Union[Literal, JsonPathLiteral]:
        tok = self.take()
        if tok.kind == "jsonpath":
            return JsonPathLiteral(tok.text)
        if tok.kind == "number":
            text = tok.text.rstrip("fFdD")
            if "." in text or "e" in text or "E" in text:
                return Literal(float(text))
            return Literal(int(text))
        if tok.kind == "dqstring" or tok.kind == "sqstring":
            return Literal(_unescape(tok.text[1:-1]))
        if tok.kind == "word":
            if tok.text == "true":
                return Literal(True)
            if tok.text == "false":
                return Literal(False)
            if tok.text == "null":
                return Literal(None)
        raise ConditionParseError(
            f"expected literal (JSON path, string, number, boolean, null) at {tok.pos}"
        )


def parse_condition(text: str) -> Condition:
    parser = _Parser(_tokenize(text), text)
    result = parser.condition()
    if parser.peek() is not None:
        tok = parser.peek()
        raise ConditionParseError(f"trailing input at {tok.pos}: {tok.text!r}")
    return result
