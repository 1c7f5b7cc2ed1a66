"""Pure-Python ARFF parser implementing the reference libarff dialect.

Dialect (SURVEY.md §3.4, libarff/arff_parser.cpp:23-153, arff_lexer.cpp:60-203):

- ``@relation <name>``, then ``@attribute <name> <type>`` lines, then ``@data``
  followed by one comma-separated row per line. Keywords are case-insensitive
  (arff_utils.cpp:29-43).
- Attribute types: NUMERIC | REAL | STRING | DATE | nominal ``{v1,v2,...}``
  (arff_parser.cpp:69-119). INTEGER is additionally accepted as numeric.
- ``%``-comment lines (arff_lexer.cpp:60-78).
- Single- or double-quoted values, which may contain spaces/commas
  (arff_lexer.cpp:159-188). Deliberate deviation: the reference's instance
  reader silently drops every data row containing a quoted value (the
  STRING-typed token breaks its row loop — verified against the built
  reference binary, which reports 0 rows for ``'1','2'``); here quoted data
  cells parse normally, with quoted content preserved verbatim.
- ``?`` denotes a missing value (arff_parser.cpp:139-141) → NaN.
- A partial row at EOF is discarded (arff_parser.cpp:130-133,149-151).
- Sparse ARFF (``{index value, ...}`` rows) is NOT supported, matching the
  reference.
- STRING/DATE data cells parse into per-attribute interned float32 codes
  (first-seen order, table on ``Attribute.string_values``). The reference
  stores them as heap strings (arff_value.cpp:33-48) and only fails when KNN
  reads one as float (arff_value.cpp:121), so such files LOAD there; here the
  numeric-only requirement is deferred to ``Dataset.validate_for_knn``.
- A quoted value may span physical lines, preserving the newline inside the
  value (``_read_str`` reads to the matching quote through newlines,
  arff_lexer.cpp:159-188), and an open ``{`` nominal list continues on the
  following line(s) — newlines are ordinary inter-token whitespace to the
  reference lexer. An unterminated quote at EOF is a located error.

Errors carry ``file:line`` context like libarff's THROW (arff_utils.cpp:8-20);
tokens carried across physical lines by multi-line rows are reported with the
line they appeared on, not the line that completed the row.

The port's copy of the JAX package's pure-Python parser, so the arrays are
byte-equal to it (and to its native C++ parser, which shares the strtof
rule). The port's binding of that native parser is ROADMAP A1.
"""

from __future__ import annotations

import math
import re
from typing import Iterable, Optional

import numpy as np

from knn_tpu_torch.data.dataset import Attribute, Dataset
from knn_tpu_torch.resilience.errors import DataError

_NUMERIC_TYPES = {"numeric", "real", "integer"}

# The ASCII whitespace set the native parser strips (arff_c.cc::strip);
# using str.strip() default would also eat Unicode whitespace (\x0c, NBSP)
# and silently diverge from the C++ implementation.
_WS = " \t\r\n"


# Numeric cells must parse bit-identically to the native parser, which uses C
# strtof with a full-consumption check (arff_c.cc::cell_to_float). Python's
# float() diverges three ways: acceptance (digit-group underscores, non-ASCII
# digits accepted; hex floats, nan(...) rejected), rounding (decimal → float64
# → float32 double-rounds near-halfway tokens where strtof single-rounds to
# float32), and NaN sign/payload. So the primary path calls libc strtof itself
# via ctypes; the regex path below is the fallback for platforms where libc
# isn't loadable by name and matches strtof's acceptance set (though not its
# last-ulp rounding).
_STRTOF_RE = re.compile(
    r"[ \t\n\v\f\r]*"
    r"[+-]?"
    r"(?:"
    r"(?:\d+\.?\d*|\.\d+)(?:[eE][+-]?\d+)?"
    r"|(?P<hex>0[xX](?:[0-9a-fA-F]+\.?[0-9a-fA-F]*|\.[0-9a-fA-F]+)(?:[pP][+-]?\d+)?)"
    r"|inf(?:inity)?"
    r"|nan(?:\([0-9a-zA-Z_]*\))?"
    r")\Z",
    re.ASCII | re.IGNORECASE,
)


def _load_libc_strtof():
    import ctypes

    try:
        fn = ctypes.CDLL(None).strtof
    except (OSError, AttributeError):
        return None
    fn.restype = ctypes.c_float
    fn.argtypes = [ctypes.c_char_p, ctypes.POINTER(ctypes.c_char_p)]
    return fn


_LIBC_STRTOF = _load_libc_strtof()


def _strtof(tok: str) -> float:
    """Parse `tok` exactly as the native parser does (C strtof + "entire token
    consumed" check, arff_c.cc::cell_to_float) or raise ValueError."""
    if _LIBC_STRTOF is not None:
        import ctypes

        raw = tok.encode("utf-8")
        buf = ctypes.create_string_buffer(raw)
        endp = ctypes.c_char_p()
        val = _LIBC_STRTOF(buf, ctypes.byref(endp))
        consumed = ctypes.cast(endp, ctypes.c_void_p).value - ctypes.addressof(buf)
        # Mirror the native parser's full-consumption rule on the token's
        # EXPLICIT length: a token with an embedded NUL is rejected (strtof
        # stops at the NUL, so it can never consume the whole view) —
        # ADVICE r2: the two parsers previously disagreed here.
        if consumed != len(raw) or consumed == 0:
            raise ValueError(tok)
        return val
    m = _STRTOF_RE.match(tok)
    if m is None:
        raise ValueError(tok)
    s = tok.lstrip(" \t\n\v\f\r")
    if m.group("hex") is not None:
        return float.fromhex(s)
    if s.lower().lstrip("+-").startswith("nan"):
        return math.nan
    return float(s)


class ArffError(DataError):
    """Parse error with file:line context, mirroring libarff's THROW style.
    A :class:`knn_tpu_torch.resilience.errors.DataError` (and still a ValueError),
    so resilience-aware callers branch on the taxonomy while pre-existing
    ``except ValueError`` handling keeps working."""

    def __init__(self, path: str, line: int, msg: str):
        super().__init__(f"{path}:{line}: {msg}")
        self.path = path
        self.line = line


def _split_csv(line: str, path: str, lineno: int) -> list:
    """Tokenize a data/nominal segment the way the reference lexer does:
    unquoted whitespace and commas BOTH end a token (next_token skips
    whitespace between tokens, arff_lexer.cpp:93-97; a comma terminates
    ``_read_str``, :190), so ``1 2`` and ``1,2`` are the same two tokens and
    several rows may share one physical line. Quoted content is preserved
    verbatim (``' '`` is the one-space token, not empty). A comma with no
    token since the previous comma yields an empty cell, which callers
    reject — the reference silently truncates the dataset there
    (arff_lexer.cpp:125-127), a defect replaced with a located error. A
    comma directly after its token is that token's terminator, so a single
    trailing comma is absorbed (``1,2,`` tokenizes like ``1,2``).

    Returns ``(token, lineno)`` pairs: ``line`` may be a quote-joined
    logical line whose '\\n's advance the physical line count, and each
    token cites the line it STARTED on — same attribution as the native
    scanner's per-token line."""
    out: list = []
    buf: list = []
    active = False            # a token is in progress
    token_since_comma = False  # a completed token awaits its comma
    quote = None
    cur_line = lineno
    tok_line = lineno

    def flush():
        nonlocal buf, active, token_since_comma
        out.append(("".join(buf), tok_line))
        buf = []
        active = False
        token_since_comma = True

    for ch in line:
        if quote is not None:
            if ch == quote:
                quote = None
            else:
                if ch == "\n":
                    cur_line += 1
                buf.append(ch)
            continue
        if ch == "\n":
            cur_line += 1
            # A newline outside quotes acts as inter-token whitespace
            # (only quote-joined logical lines contain one).
            if active:
                flush()
            continue
        if ch in ("'", '"'):
            quote = ch
            if not active:
                tok_line = cur_line
            active = True
            continue
        if ch in " \t":
            if active:
                flush()
            continue
        if ch == ",":
            if active:
                flush()
                token_since_comma = False  # comma terminated its own token
            elif token_since_comma:
                token_since_comma = False  # separator for the flushed token
            else:
                out.append(("", cur_line))  # ",," or leading comma: empty cell
            continue
        if not active:
            tok_line = cur_line
        active = True
        buf.append(ch)
    if quote is not None:
        raise ArffError(path, tok_line, "unterminated quoted value")
    if active:
        flush()
    return out


def _parse_attribute(rest: str, path: str, lineno: int) -> Attribute:
    rest = rest.strip(_WS)
    if not rest:
        raise ArffError(path, lineno, "@attribute needs a name and a type")
    # Name may be quoted.
    if rest[0] in ("'", '"'):
        q = rest[0]
        end = rest.find(q, 1)
        if end < 0:
            raise ArffError(path, lineno, "unterminated quoted attribute name")
        name, rest = rest[1:end], rest[end + 1 :].strip(_WS)
    else:
        parts = re.split(r"[ \t]+", rest, maxsplit=1)
        if len(parts) < 2:
            raise ArffError(path, lineno, f"@attribute '{parts[0]}' is missing a type")
        name, rest = parts[0], parts[1].strip(_WS)
    if not rest:
        raise ArffError(path, lineno, f"@attribute '{name}' is missing a type")
    if rest.startswith("{"):
        if not rest.endswith("}"):
            raise ArffError(path, lineno, "unterminated nominal value list")
        inner = rest[1:-1]
        # "{a,b,}" is reference-valid: the comma before "}" is consumed as
        # the previous token's terminator (arff_lexer.cpp:190, then
        # next_token's unconditional advance) and "}" lexes as BRKT_CLOSE.
        # Only a literal trailing comma is absorbed — a quoted-empty final
        # value ({a,''}) still hits the empty-value error below. "{}" is an
        # empty nominal set (reference: BRKT_CLOSE immediately ends the
        # value loop).
        values = (
            [] if inner.strip(_WS) == ""
            else [tok for tok, _ in _split_csv(inner, path, lineno)]
        )
        if any(v == "" for v in values):
            raise ArffError(path, lineno, "empty value in nominal list")
        return Attribute(name, "nominal", values)
    type_word = re.split(r"[ \t]+", rest, maxsplit=1)[0].lower()
    if type_word in _NUMERIC_TYPES:
        return Attribute(name, "numeric")
    if type_word == "string":
        return Attribute(name, "string")
    if type_word == "date":
        return Attribute(name, "date")
    raise ArffError(path, lineno, f"unsupported attribute type '{rest}'")


def _cell_to_float(
    tok: str, attr: Attribute, intern: dict, path: str, lineno: int
) -> float:
    if tok == "?":
        return math.nan
    if attr.type == "nominal":
        try:
            return float(attr.nominal_values.index(tok))
        except ValueError:
            raise ArffError(
                path, lineno, f"value '{tok}' not in nominal set for '{attr.name}'"
            ) from None
    if attr.type in ("string", "date"):
        # Intern in first-seen order (module docstring): the cell stores the
        # code; the table lands on attr.string_values after the parse.
        return float(intern.setdefault(tok, len(intern)))
    try:
        return _strtof(tok)
    except ValueError:
        raise ArffError(
            path, lineno, f"cannot parse '{tok}' as a number for '{attr.name}'"
        ) from None


def _scan_quote(s: str, quote: Optional[str] = None) -> Optional[str]:
    """Fold quote state over ``s``: returns the open quote char if the text
    ends inside a quoted value, else None. The carry for multi-line quoted
    values (arff_lexer.cpp:159-188 reads through newlines to the matching
    quote)."""
    for ch in s:
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
    return quote


def _fold_nominal(state: tuple, seg: str) -> tuple:
    """Fold nominal-list bracket/quote state over ``seg`` incrementally —
    ``state`` is ``(quote, opened, closed)``. The declaration continues on
    the next physical line while a ``{`` has opened (outside quotes) and no
    unquoted ``}`` has closed it, as in the reference's token-stream reader
    (newlines are ordinary whitespace between tokens, arff_lexer.cpp:93-97).
    Folding per appended segment keeps multi-line declarations linear in
    their total length (rescanning the accumulation is quadratic)."""
    quote, opened, closed = state
    if closed:
        return state
    for ch in seg:
        if quote is not None:
            if ch == quote:
                quote = None
        elif ch in ("'", '"'):
            quote = ch
        elif ch == "{":
            opened = True
        elif ch == "}" and opened:
            return (quote, opened, True)
    return (quote, opened, closed)


def parse_arff_lines(
    lines: Iterable[str], path: str = "<memory>"
) -> Dataset:
    relation = ""
    attributes: list = []
    interns: list = []  # per-attribute first-seen intern maps (string/date)
    rows: list = []
    in_data = False
    # (cell, lineno) pairs carried across physical lines (multi-line rows);
    # carrying the lineno keeps error locations on the token's own line.
    pending: list = []

    it = iter(lines)
    lineno = 0
    while True:
        raw = next(it, None)
        if raw is None:
            break
        lineno += 1
        # '%' starts a comment only at the true line start (the reference
        # lexer skips comments only when '%' is the first character after a
        # newline, arff_lexer.cpp:60-78); an indented or trailing '%' is
        # DATA and typically a located type error downstream.
        if raw.startswith("%"):
            continue
        # A quoted value may span physical lines (arff_lexer.cpp:159-188
        # reads to the matching quote through newlines): join lines into one
        # logical line while a quote is open, preserving the line break
        # inside the value VERBATIM — a '\r' before the newline stays, as in
        # the native parser's zero-copy slice and the reference's raw-byte
        # scanner (the file reader splits at '\n' only). Comment skipping
        # never applies inside a quote (the reference skips '%' lines only
        # BETWEEN tokens). The quote state folds incrementally over each
        # appended segment, so the join is linear in the value's length.
        logical = raw
        start_line = lineno
        open_q = _scan_quote(raw)
        while open_q is not None:
            nxt = next(it, None)
            if nxt is None:
                raise ArffError(path, start_line, "unterminated quoted value")
            lineno += 1
            logical += "\n" + nxt
            open_q = _scan_quote("\n" + nxt, open_q)
        line = logical.strip(_WS)
        if not line:
            continue
        if not in_data and line.startswith("@"):
            # ASCII space/tab separates the keyword — same set as the
            # native parser (arff_c.cc find_first_of(" \t")), NOT
            # Unicode whitespace.
            parts = re.split(r"[ \t]+", line, maxsplit=1)
            word = parts[0]
            rest = parts[1] if len(parts) > 1 else ""
            key = word.lower()
            if key == "@relation":
                # Strip exactly one matched outer quote pair (same rule as
                # the native parser) — not a greedy strip of quote chars.
                relation = rest.strip(_WS)
                if (
                    len(relation) >= 2
                    and relation[0] in ("'", '"')
                    and relation[-1] == relation[0]
                ):
                    relation = relation[1:-1]
            elif key == "@attribute":
                # An open nominal list continues on the next physical
                # line(s): the reference reads the {...} value tokens from
                # the lexer stream, where a newline is ordinary whitespace
                # (arff_parser.cpp:69-119). '%' comment lines between the
                # value tokens are skipped as usual; a quoted value inside
                # the continued list may itself span further lines.
                nom_state = _fold_nominal((None, False, False), rest)
                pieces = [rest]
                while nom_state[1] and not nom_state[2]:
                    nxt = next(it, None)
                    if nxt is None:
                        break  # _parse_attribute raises its located error
                    lineno += 1
                    if nxt.startswith("%"):
                        continue
                    seg = nxt
                    seg_q = _scan_quote(seg)
                    while seg_q is not None:
                        nx2 = next(it, None)
                        if nx2 is None:
                            raise ArffError(
                                path, lineno, "unterminated quoted value"
                            )
                        lineno += 1
                        seg += "\n" + nx2
                        seg_q = _scan_quote("\n" + nx2, seg_q)
                    piece = seg.strip(_WS)
                    pieces.append(piece)
                    # Quote state at each boundary is None (both rest and
                    # seg join to quote-balanced logical lines above), so
                    # folding just the appended piece matches a rescan; a
                    # single join below keeps the whole declaration linear
                    # (chained `rest += piece` recopies the accumulation).
                    nom_state = _fold_nominal(nom_state, " " + piece)
                rest = " ".join(pieces)
                attributes.append(_parse_attribute(rest, path, start_line))
                interns.append({})
            elif key == "@data":
                if not attributes:
                    raise ArffError(path, start_line, "@data before any @attribute")
                in_data = True
            else:
                raise ArffError(path, start_line, f"unknown keyword '{word}'")
            continue
        if not in_data:
            raise ArffError(
                path, start_line, f"unexpected content before @data: '{line}'"
            )
        if line.startswith("{"):
            raise ArffError(path, start_line, "sparse ARFF rows are not supported")
        cells = _split_csv(line, path, start_line)
        for tok, tok_line in cells:
            if tok == "":
                raise ArffError(path, tok_line, "empty value in data row")
        # The reference's reader consumes exactly num_attributes tokens per
        # instance from the @data token stream regardless of line breaks
        # (arff_parser.cpp:121-153): rows may span physical lines AND several
        # rows may share one line, so accumulate tokens and emit every full
        # group of num_attributes. Each token carries the physical line it
        # started on (quote-joined logical lines span several), matching the
        # native scanner's attribution.
        pending.extend(cells)
        d = len(attributes)
        off = 0
        while len(pending) - off >= d:
            rows.append(
                [_cell_to_float(tok, attr, intern, path, tok_line)
                 for (tok, tok_line), attr, intern in zip(
                     pending[off : off + d], attributes, interns)]
            )
            off += d
        if off:  # consume emitted rows once per line, like the C++ twin
            del pending[:off]
    # A partial row at EOF is discarded, matching arff_parser.cpp:130-133.

    if not attributes:
        raise ArffError(path, 0, "no @attribute declarations found")
    for attr, intern in zip(attributes, interns):
        if attr.type in ("string", "date"):
            attr.string_values = list(intern)  # insertion order = code order

    d = len(attributes)
    if rows:
        mat = np.asarray(rows, dtype=np.float32)
    else:
        mat = np.zeros((0, d), dtype=np.float32)
    features = mat[:, : d - 1]
    raw_labels = mat[:, d - 1]
    if np.isnan(raw_labels).any():
        bad = int(np.isnan(raw_labels).argmax())
        raise ArffError(path, 0, f"instance {bad} has a missing class label")
    labels = raw_labels.astype(np.int32)
    return Dataset(
        features=features, labels=labels, relation=relation,
        attributes=attributes, raw_targets=raw_labels.astype(np.float32),
    )


# First line whose stripped start is the @data keyword (word-bounded, so
# "@database" stays an unknown-keyword error for the full parser).
_DATA_RE = re.compile(r"(?mi)^[ \t\r]*@data(?=[ \t\r]|\r?$)")
# Empty-cell comma patterns the comma->space translation would silently
# swallow: ",,", a line-leading comma (",  ," covered by the first).
_BAD_COMMA_RE = re.compile(r",[ \t\r]*,|^[ \t\r]*,|\n[ \t\r]*,")


def _parse_numeric_fast(raw: str, path: str) -> "Dataset | None":
    """Vectorized parse for the common all-numeric case (~25x the
    token-by-token path): headers go through the full parser, then the @data
    section becomes one ``str.split`` + ``np.array(..., float32)`` — bitwise
    identical to the slow path (both convert decimal text at float64 and
    round once to float32). Returns None whenever ANY dialect subtlety might
    apply — quotes, comments, missing values, sparse braces, empty-cell
    comma patterns, non-numeric attributes, non-finite values, conversion
    failures — so every error case falls through to the full parser and its
    located messages."""
    m = _DATA_RE.search(raw)
    if m is None:
        return None
    data_end = raw.find("\n", m.end())
    if data_end < 0:
        return None
    # The match may lie INSIDE a multi-line header value — a quoted value
    # (quotes span physical lines, arff_lexer.cpp:159-188) or an open {...}
    # nominal list (newlines are ordinary whitespace between value tokens,
    # arff_parser.cpp:69-119) — and the @data line's own trailing content
    # can open a quote that joins the first data row into the header's
    # logical line. Fold quote AND brace state over everything up to and
    # including the @data physical line — skipping '%' comment lines only
    # while outside a quote, as parse_arff_lines does both at top level and
    # between continuation lines — and defer to the full parser when the
    # region ends inside either. Nominal lists don't nest, so one
    # open/close flag mirrors the per-declaration continuation state.
    head_lines = raw[: m.start()].split("\n")
    quote = None
    brace = False
    for ln in head_lines:
        if quote is None and ln.startswith("%"):
            continue
        for ch in ln:
            if quote is not None:
                if ch == quote:
                    quote = None
            elif ch in ("'", '"'):
                quote = ch
            elif ch == "{":
                brace = True
            elif ch == "}":
                brace = False
    if quote is not None or brace:
        return None  # the @data match itself lies inside a header value
    if _scan_quote(raw[m.end() : data_end]) is not None:
        return None  # the @data line's own tail opens a quote
    if head_lines and head_lines[-1] == "":
        # The slice ends at the newline BEFORE the @data line; drop the
        # phantom empty piece so the appended "@data" keeps its real line
        # number (errors like "@data before any @attribute" cite it).
        head_lines.pop()
    header = parse_arff_lines(head_lines + ["@data"], path)
    if not all(a.type == "numeric" for a in header.attributes):
        return None
    sec = raw[data_end + 1 :]
    # Eligible content is exactly the plain ASCII float charset plus the
    # separators the dialect shares with str.split(): anything else — quotes,
    # comments, '?', sparse braces, letters (inf/nan/unicode digits, which
    # numpy and _strtof accept differently), '_' (Python float accepts,
    # _strtof rejects), '\f'/'\v' (str.split() whitespace but dialect token
    # chars), or a '\r' outside a CRLF ending (token char, split() whitespace:
    # test_interior_cr_is_a_token_char) — defers to the full parser.
    if re.search(r"[^0-9eE+\-. \t\r\n,]|\r(?!\n)", sec) or _BAD_COMMA_RE.search(sec):
        return None
    toks = sec.replace(",", " ").split()
    try:
        arr64 = np.array(toks, dtype=np.float64)
    except (ValueError, OverflowError):
        return None  # a malformed token: the full parser owns the error
    with np.errstate(over="ignore"):
        # f32-range overflow (e.g. '1e40') clamps to inf like strtof; the
        # non-finite check below then defers to the full parser without the
        # cast warning escaping (it would crash under warnings-as-errors).
        arr = arr64.astype(np.float32)
    d = len(header.attributes)
    n = arr.size // d  # partial row at EOF discarded (arff_parser.cpp:130-133)
    if n == 0 or not np.isfinite(arr[: n * d]).all():
        return None  # inf/nan cells: defer to the full parser's handling
    # Double-rounding repair: the contract is C strtof's correctly-rounded
    # decimal->f32 (what the native twin and _strtof produce). Going through
    # f64 diverges ONLY when the f64 value lands exactly on an f32 midpoint
    # (any true value near a midpoint rounds TO that midpoint in f64, so a
    # non-midpoint f64 decides the f32 the same way the true value would).
    # Those rare tokens re-parse through _strtof.
    cast64 = arr.astype(np.float64)
    mid_hi = (cast64 + np.nextafter(arr, np.float32(np.inf)).astype(np.float64)) / 2
    mid_lo = (cast64 + np.nextafter(arr, np.float32(-np.inf)).astype(np.float64)) / 2
    amb = np.nonzero((arr64 == mid_hi) | (arr64 == mid_lo))[0]
    for i in amb:
        try:
            arr[i] = _strtof(toks[i])
        except ValueError:
            return None
    mat = arr[: n * d].reshape(n, d)
    raw_labels = mat[:, d - 1]
    return Dataset(
        features=mat[:, : d - 1],
        labels=raw_labels.astype(np.int32),
        relation=header.relation,
        attributes=header.attributes,
        raw_targets=raw_labels.astype(np.float32),
    )


def parse_arff_file(path: str) -> Dataset:
    # newline="" + manual split: physical lines end at '\n' ONLY, like the
    # reference scanner (NEWLINE = '\n', arff_scanner.cpp:4) and the native
    # twin. Universal-newline mode would turn a lone '\r' into a line break,
    # where the dialect treats interior '\r' as a token character ('\r\n'
    # endings still work — the trailing '\r' strips as whitespace).
    with open(path, "r", encoding="utf-8", errors="replace", newline="") as f:
        raw = f.read()
    fast = _parse_numeric_fast(raw, str(path))
    if fast is not None:
        return fast
    return parse_arff_lines(raw.split("\n"), path=str(path))
