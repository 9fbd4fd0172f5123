"""Go-template subset renderer for real Helm chart interop.

The reference consumes actual Helm charts — repo index search
(pkg/devspace/helm/search.go:1-151), ``requirements.yaml`` dependency
update + ``InstallChartByPath`` (pkg/devspace/helm/install.go:54).  Its
charts are Go ``text/template`` files with the sprig function library.
This module implements the pragmatic subset those charts actually use so
``add package`` can vendor an unmodified upstream-style chart and
``deploy`` can render it:

- actions ``{{ ... }}`` with ``{{-``/``-}}`` whitespace trimming
- ``.Values`` / ``.Release`` / ``.Chart`` / ``.Capabilities`` field paths
- ``if`` / ``else if`` / ``else`` / ``end``, ``range``, ``with``
- ``define`` + ``template`` / ``include`` (``_helpers.tpl``)
- variables (``$x := ...``, ``$x = ...``, ``$`` = root), pipelines
- the sprig/helm builtins common charts need (default, quote, toYaml,
  nindent, printf, eq/and/or/not, dict/list helpers, ...)

It is a renderer, not a Turing tarpit: unsupported constructs raise
``TemplateError`` with the template name and offset so chart authors get
a real diagnostic instead of mangled YAML.
"""

from __future__ import annotations

import base64
import hashlib
import json
import re
from typing import Any, Callable, Optional

import yaml


class TemplateError(Exception):
    pass


# ---------------------------------------------------------------------------
# Lexer: split source into literal text and {{ action }} tokens
# ---------------------------------------------------------------------------

def _scan_action(src: str, start: int) -> int:
    """Return the index just past the closing ``}}`` of the action opened
    at ``start`` (which points at ``{{``), skipping quoted strings.
    Comments scan to ``*/`` first (Go's lexer does the same), so a
    ``{{/* usage: {{ include "x" . }} */}}`` doc comment — ubiquitous in
    _helpers.tpl — doesn't terminate at the ``}}`` inside it."""
    i = start + 2
    n = len(src)
    j = i
    while j < n and src[j] in " \t\n-":
        j += 1
    if src.startswith("/*", j):
        close = src.find("*/", j + 2)
        if close < 0:
            raise TemplateError(f"unclosed comment at offset {start}")
        i = close + 2
    while i < n:
        c = src[i]
        if c == '"' or c == "`":
            quote = c
            i += 1
            while i < n:
                if src[i] == "\\" and quote == '"':
                    i += 2
                    continue
                if src[i] == quote:
                    break
                i += 1
            i += 1
            continue
        if c == "}" and i + 1 < n and src[i + 1] == "}":
            return i + 2
        i += 1
    raise TemplateError(f"unclosed action at offset {start}")


def _lex(src: str) -> list[tuple[str, str]]:
    """Yield ("text", s) / ("action", body) with trim markers applied."""
    out: list[tuple[str, str]] = []
    pos = 0
    while True:
        idx = src.find("{{", pos)
        if idx < 0:
            if pos < len(src):
                out.append(("text", src[pos:]))
            return out
        end = _scan_action(src, idx)
        body = src[idx + 2 : end - 2]
        trim_before = body.startswith("-") and (len(body) > 1 and body[1] in " \t\n")
        trim_after = body.endswith("-") and (len(body) > 1 and body[-2] in " \t\n")
        if trim_before:
            body = body[1:]
        if trim_after:
            body = body[:-1]
        text = src[pos:idx]
        if trim_before:
            text = text.rstrip(" \t\n\r")
        if text:
            out.append(("text", text))
        out.append(("action", body.strip()))
        pos = end
        if trim_after:
            while pos < len(src) and src[pos] in " \t\n\r":
                pos += 1
    return out


# ---------------------------------------------------------------------------
# Expression tokenizer (inside one action)
# ---------------------------------------------------------------------------

_TOKEN_RE = re.compile(
    r"""
      \s*(
        "(?:\\.|[^"\\])*"          # double-quoted string
      | `[^`]*`                    # raw string
      | -?\d+\.\d+                 # float
      | -?\d+                      # int
      | :=|=|\||\(|\)|,           # punctuation
      | \$[A-Za-z0-9_]*(?:\.[A-Za-z0-9_.]*)?   # variable (maybe with field path)
      | \.[A-Za-z0-9_.]*           # field path (or lone dot)
      | [A-Za-z_][A-Za-z0-9_.]*    # ident / function name
      )""",
    re.VERBOSE,
)


def _expr_tokens(s: str) -> list[str]:
    toks, pos = [], 0
    prev_end = -1
    while pos < len(s):
        m = _TOKEN_RE.match(s, pos)
        if not m:
            if s[pos:].strip() == "":
                break
            raise TemplateError(f"bad token in action: {s[pos:]!r}")
        tok = m.group(1)
        # Disambiguate `(expr).field` from `(expr) .field`: a field path
        # with NO whitespace after the closing paren is an access on the
        # paren result; with whitespace it is the next argument. Mark the
        # attached case (\x01 prefix) since whitespace is otherwise lost.
        if (
            tok.startswith(".")
            and toks
            and toks[-1] == ")"
            and m.start(1) == prev_end
        ):
            tok = "\x01" + tok
        toks.append(tok)
        prev_end = m.end()
        pos = m.end()
    return toks


# ---------------------------------------------------------------------------
# Parser: action stream -> node tree
# ---------------------------------------------------------------------------
# Nodes: ("text", s) | ("out", toks) | ("if", [(cond_toks, body)...], else_body)
#      | ("range", toks, body, else_body) | ("with", toks, body, else_body)
#      | ("define", name, body) handled at parse top-level into a dict


_KEYWORDS = ("if", "range", "with", "define", "block", "else", "end", "template")


def _parse(tokens: list[tuple[str, str]], defines: dict) -> list:
    pos = 0

    def parse_block(terminators: tuple[str, ...]):
        nonlocal pos
        nodes = []
        while pos < len(tokens):
            kind, body = tokens[pos]
            if kind == "text":
                nodes.append(("text", body))
                pos += 1
                continue
            word = body.split(None, 1)[0] if body else ""
            if word in terminators:
                return nodes, body
            pos += 1
            if word == "if":
                arms, else_body = parse_if(body[2:].strip())
                nodes.append(("if", arms, else_body))
            elif word == "range":
                inner, term = parse_block(("end", "else"))
                else_body = []
                if term.split(None, 1)[0] == "else":
                    pos += 1
                    else_body, _ = parse_block(("end",))
                pos += 1  # consume end
                nodes.append(("range", _expr_tokens(body[5:].strip()), inner, else_body))
            elif word == "with":
                inner, term = parse_block(("end", "else"))
                else_body = []
                if term.split(None, 1)[0] == "else":
                    pos += 1
                    else_body, _ = parse_block(("end",))
                pos += 1
                nodes.append(("with", _expr_tokens(body[4:].strip()), inner, else_body))
            elif word in ("define", "block"):
                name_toks = _expr_tokens(body.split(None, 1)[1])
                name = _unquote(name_toks[0])
                inner, _ = parse_block(("end",))
                pos += 1
                defines[name] = inner
                if word == "block":  # block = define + immediate template
                    nodes.append(("out", ["template", name_toks[0], "."]))
            elif word == "template":
                nodes.append(("out", _expr_tokens(body)))
            elif body.startswith("/*") or body == "":
                continue  # comment / empty action
            else:
                nodes.append(("out", _expr_tokens(body)))
        if terminators:
            raise TemplateError(
                f"unclosed block: expected {' or '.join(terminators)}"
            )
        return nodes, ""

    def parse_if(cond_src: str):
        nonlocal pos
        arms = []
        cond = _expr_tokens(cond_src)
        body, term = parse_block(("end", "else"))
        arms.append((cond, body))
        else_body = []
        while term.split(None, 1)[0] == "else":
            rest = term[4:].strip()
            pos += 1
            if rest.startswith("if"):
                cond2 = _expr_tokens(rest[2:].strip())
                body2, term = parse_block(("end", "else"))
                arms.append((cond2, body2))
            else:
                else_body, term = parse_block(("end",))
        pos += 1  # consume end
        return arms, else_body

    nodes, _ = parse_block(())
    return nodes


def _unquote(tok: str) -> str:
    if tok.startswith('"'):
        return json.loads(tok)
    if tok.startswith("`"):
        return tok[1:-1]
    return tok


# ---------------------------------------------------------------------------
# Function library (the sprig/helm subset charts actually use)
# ---------------------------------------------------------------------------

def _truthy(v: Any) -> bool:
    # Go template truth: false for false, 0, "", nil, empty map/slice
    if v is None or v is False:
        return False
    if isinstance(v, (int, float)) and v == 0:
        return False
    if isinstance(v, (str, list, dict, tuple)) and len(v) == 0:
        return False
    return True


def _to_yaml(v: Any) -> str:
    out = yaml.safe_dump(v, default_flow_style=False, sort_keys=False)
    # scalar documents get a `...` end marker — not wanted inline
    if out.endswith("...\n"):
        out = out[:-4]
    return out.rstrip("\n")


def _indent(n: int, s: Any) -> str:
    pad = " " * int(n)
    return "\n".join(pad + line for line in _stringify(s).splitlines())


def _num(v: Any):
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    try:
        f = float(v)
        return int(f) if f == int(f) else f
    except (TypeError, ValueError):
        return 0


def _num_strict(v: Any):
    """Arithmetic/comparison operand coercion that FAILS the render on
    garbage (real helm errors out with a diagnostic rather than silently
    comparing against 0; sprig's atoi-style `int`/`int64` casts keep the
    permissive _num above)."""
    if isinstance(v, bool):
        return int(v)
    if isinstance(v, (int, float)):
        return v
    try:
        f = float(v)
        return int(f) if f == int(f) else f
    except (TypeError, ValueError):
        raise TemplateError(
            f"non-numeric operand in arithmetic/comparison: {v!r}"
        ) from None


def _div_go(a, b):
    """Go's integer division truncates toward zero (Python's // floors:
    -7 // 2 == -4 but Go gives -3)."""
    na, nb = _num_strict(a), _num_strict(b)
    if nb == 0:
        raise TemplateError("division by zero in template")
    if isinstance(na, int) and isinstance(nb, int):
        q = abs(na) // abs(nb)
        return q if (na >= 0) == (nb >= 0) else -q
    return na / nb


def _mod_go(a, b):
    """Go's % truncates toward zero (result takes the dividend's sign)."""
    import math

    na, nb = _num_strict(a), _num_strict(b)
    if nb == 0:
        raise TemplateError("division by zero in template (mod)")
    if isinstance(na, int) and isinstance(nb, int):
        return int(math.fmod(na, nb))
    return math.fmod(na, nb)


def _semver_parse(v: Any) -> tuple[int, int, int]:
    """Lenient semver core parse: 'v1.27.3-gke.100' -> (1, 27, 3)."""
    s = str(v).strip().lstrip("vV")
    core = s.split("-", 1)[0].split("+", 1)[0]
    parts: list[int] = []
    for p in core.split("."):
        digits = re.match(r"\d+", p)
        parts.append(int(digits.group()) if digits else 0)
    while len(parts) < 3:
        parts.append(0)
    return parts[0], parts[1], parts[2]


def _semver_compare(constraint: Any, version: Any) -> bool:
    """Masterminds/semver-style constraint check (the sprig function
    charts use to pick manifests per Capabilities.KubeVersion): supports
    >=, >, <=, <, =, !=, ~, ^, wildcard/partial versions, comma/space
    AND lists, || OR groups and 'A - B' hyphen ranges."""
    ver = _semver_parse(version)
    text = str(constraint).strip()
    if not text:
        return True
    # hyphen range: "1.2 - 2.0" == ">=1.2 <=2.0"
    text = re.sub(
        r"(\S+)\s+-\s+(\S+)", lambda m: f">={m.group(1)} <={m.group(2)}", text
    )
    # ">= 1.25" (spaced operator) must not split into two terms
    text = re.sub(r"(>=|<=|==|!=|>|<|=|~|\^)\s+", r"\1", text)
    for group in text.split("||"):
        terms = [t for t in re.split(r"[,\s]+", group.strip()) if t]
        group_ok = True
        for term in terms:
            m = re.match(r"^(>=|<=|==|!=|>|<|=|~|\^)?\s*(.+)$", term)
            if not m:
                raise TemplateError(f"bad semver constraint: {term!r}")
            op = m.group(1) or "="
            target_s = m.group(2)
            tgt = _semver_parse(target_s)
            nfields = len(
                [
                    p
                    for p in target_s.lstrip("vV").split("-")[0].split(".")
                    if p not in ("", "*", "x", "X")
                ]
            )
            if op == ">=":
                ok = ver >= tgt
            elif op == ">":
                ok = ver > tgt
            elif op == "<=":
                ok = ver <= tgt
            elif op == "<":
                ok = ver < tgt
            elif op == "!=":
                ok = ver != tgt
            elif op == "~":
                upper = (
                    (tgt[0], tgt[1] + 1, 0) if nfields >= 2 else (tgt[0] + 1, 0, 0)
                )
                ok = tgt <= ver < upper
            elif op == "^":
                # Masterminds semantics: precision matters for 0.x —
                # ^0 == <1.0.0, ^0.0 == <0.1.0, ^0.0.3 == <0.0.4
                if tgt[0] > 0 or nfields <= 1:
                    upper = (tgt[0] + 1, 0, 0)
                elif tgt[1] > 0 or nfields == 2:
                    upper = (tgt[0], tgt[1] + 1, 0)
                else:
                    upper = (tgt[0], tgt[1], tgt[2] + 1)
                ok = tgt <= ver < upper
            else:  # exact / wildcard prefix ("1.2" matches any 1.2.x)
                ok = ver[:nfields] == tgt[:nfields] if nfields else True
            if not ok:
                group_ok = False
                break
        if group_ok:
            return True
    return False


def _cmp_ok(a, b) -> bool:
    try:
        return bool(a == b)
    except Exception:  # noqa: BLE001
        return False


def _build_functions(renderer: "Renderer") -> dict[str, Callable]:
    fns: dict[str, Callable] = {
        "default": lambda d, v=None: v if _truthy(v) else d,
        "coalesce": lambda *a: next((x for x in a if _truthy(x)), None),
        "ternary": lambda t, f, c: t if _truthy(c) else f,
        # helm's required fails on nil AND empty string
        "required": lambda msg, v: v if v is not None and v != "" else _fail(msg),
        "fail": lambda msg: _fail(msg),
        "empty": lambda v: not _truthy(v),
        "not": lambda v: not _truthy(v),
        "and": lambda *a: next((x for x in a if not _truthy(x)), a[-1]),
        "or": lambda *a: next((x for x in a if _truthy(x)), a[-1]),
        "eq": lambda a, *bs: any(_cmp_ok(a, b) for b in bs),
        "ne": lambda a, b: not _cmp_ok(a, b),
        "lt": lambda a, b: _num_strict(a) < _num_strict(b),
        "le": lambda a, b: _num_strict(a) <= _num_strict(b),
        "gt": lambda a, b: _num_strict(a) > _num_strict(b),
        "ge": lambda a, b: _num_strict(a) >= _num_strict(b),
        "add": lambda *a: sum(_num_strict(x) for x in a),
        "add1": lambda a: _num_strict(a) + 1,
        "sub": lambda a, b: _num_strict(a) - _num_strict(b),
        "mul": lambda *a: __import__("math").prod(_num_strict(x) for x in a),
        "div": _div_go,
        "mod": _mod_go,
        "min": lambda *a: min(_num_strict(x) for x in a),
        "max": lambda *a: max(_num_strict(x) for x in a),
        "int": lambda v: int(_num(v)),
        "int64": lambda v: int(_num(v)),
        "float64": lambda v: float(_num(v)),
        "toString": lambda v: _stringify(v),
        "quote": lambda *a: " ".join(json.dumps(_stringify(x)) for x in a),
        "squote": lambda *a: " ".join("'" + _stringify(x) + "'" for x in a),
        "upper": lambda s: str(s).upper(),
        "lower": lambda s: str(s).lower(),
        "title": lambda s: str(s).title(),
        "untitle": lambda s: str(s)[:1].lower() + str(s)[1:],
        "trim": lambda s: str(s).strip(),
        "trimSuffix": lambda suf, s: str(s)[: -len(suf)]
        if str(s).endswith(suf)
        else str(s),
        "trimPrefix": lambda pre, s: str(s)[len(pre) :]
        if str(s).startswith(pre)
        else str(s),
        "trimAll": lambda cut, s: str(s).strip(cut),
        "replace": lambda old, new, s: str(s).replace(old, new),
        "contains": lambda sub, s: sub in str(s),
        "hasPrefix": lambda pre, s: str(s).startswith(pre),
        "hasSuffix": lambda suf, s: str(s).endswith(suf),
        "trunc": lambda n, s: str(s)[: int(n)] if int(n) >= 0 else str(s)[int(n) :],
        "abbrev": lambda n, s: str(s)
        if len(str(s)) <= int(n)
        else str(s)[: int(n) - 3] + "...",
        "repeat": lambda n, s: str(s) * int(n),
        "nospace": lambda s: re.sub(r"\s", "", str(s)),
        "kebabcase": lambda s: re.sub(r"([a-z0-9])([A-Z])", r"\1-\2", str(s)).lower(),
        "snakecase": lambda s: re.sub(r"([a-z0-9])([A-Z])", r"\1_\2", str(s)).lower(),
        "camelcase": lambda s: "".join(
            w.title() for w in re.split(r"[_\-\s]+", str(s))
        ),
        "printf": lambda fmt, *a: _printf(fmt, *a),
        "print": lambda *a: "".join(_stringify(x) for x in a),
        "println": lambda *a: " ".join(_stringify(x) for x in a) + "\n",
        "indent": lambda n, s: _indent(n, s),
        "nindent": lambda n, s: "\n" + _indent(n, s),
        "toYaml": _to_yaml,
        "fromYaml": lambda s: yaml.safe_load(s) or {},
        "toJson": lambda v: json.dumps(v),
        "fromJson": lambda s: json.loads(s),
        "b64enc": lambda s: base64.b64encode(str(s).encode()).decode(),
        "b64dec": lambda s: base64.b64decode(str(s)).decode(),
        "sha256sum": lambda s: hashlib.sha256(str(s).encode()).hexdigest(),
        "adler32sum": lambda s: str(__import__("zlib").adler32(str(s).encode())),
        "len": lambda v: len(v) if v is not None else 0,
        "index": _index,
        "list": lambda *a: list(a),
        # sprig pads an odd trailing key with "" rather than dropping it
        "dict": lambda *a: {
            a[i]: (a[i + 1] if i + 1 < len(a) else "")
            for i in range(0, len(a), 2)
        },
        "get": lambda d, k: (d or {}).get(k, ""),
        "set": lambda d, k, v: (d.__setitem__(k, v), d)[1],
        "unset": lambda d, k: (d.pop(k, None), d)[1],
        "hasKey": lambda d, k: k in (d or {}),
        "omit": lambda d, *ks: {k: v for k, v in (d or {}).items() if k not in ks},
        "pick": lambda d, *ks: {k: v for k, v in (d or {}).items() if k in ks},
        "dig": _dig,
        # sprig type predicates (bitnami common.tplvalues.render et al.)
        "typeIs": lambda t, v: _type_matches(t, _go_type(v)),
        "typeIsLike": lambda t, v: _type_matches(t, _go_type(v)),
        "typeOf": _go_type,
        "kindIs": lambda t, v: _type_matches(t, _go_kind(v)),
        "kindOf": _go_kind,
        "keys": lambda *ds: [k for d in ds for k in (d or {})],
        "values": lambda d: list((d or {}).values()),
        "pluck": lambda k, *ds: [d[k] for d in ds if k in (d or {})],
        "merge": lambda dest, *srcs: _merge_dicts(dest, srcs, overwrite=False),
        "mergeOverwrite": lambda dest, *srcs: _merge_dicts(dest, srcs, overwrite=True),
        "deepCopy": lambda v: json.loads(json.dumps(v)),
        "first": lambda v: v[0] if v else None,
        "last": lambda v: v[-1] if v else None,
        "rest": lambda v: list(v[1:]),
        "initial": lambda v: list(v[:-1]),
        "append": lambda v, x: list(v or []) + [x],
        "prepend": lambda v, x: [x] + list(v or []),
        "concat": lambda *vs: [x for v in vs for x in (v or [])],
        "uniq": lambda v: list(dict.fromkeys(v)),
        "has": lambda x, v: x in (v or []),
        "without": lambda v, *xs: [x for x in v if x not in xs],
        "compact": lambda v: [x for x in v if _truthy(x)],
        "sortAlpha": lambda v: sorted(str(x) for x in v),
        "reverse": lambda v: list(reversed(v)),
        "join": lambda sep, v: str(sep).join(_stringify(x) for x in v),
        "split": lambda sep, s: dict(
            (f"_{i}", part) for i, part in enumerate(str(s).split(sep))
        ),
        "splitList": lambda sep, s: str(s).split(sep),
        "until": lambda n: list(range(int(n))),
        "untilStep": lambda a, b, s: list(range(int(a), int(b), int(s))),
        "seq": lambda *a: _seq(*a),
        "regexMatch": lambda pat, s: bool(re.search(pat, str(s))),
        "regexReplaceAll": lambda pat, s, repl: re.sub(
            pat, re.sub(r"\$\{(\w+)\}", r"\\g<\1>", repl), str(s)
        ),
        "semverCompare": _semver_compare,
        "semver": lambda v: dict(
            zip(("Major", "Minor", "Patch"), _semver_parse(v))
        ),
        "lookup": lambda *a: {},  # no live-cluster lookups at render time
        "tpl": lambda s, ctx: renderer._render_string(str(s), ctx),
        "include": lambda name, ctx: renderer._include(name, ctx),
        "randAlphaNum": lambda n: _det_rand(renderer, int(n)),
        "randAlpha": lambda n: _det_rand(renderer, int(n)),
        "uuidv4": lambda: _det_rand(renderer, 32),
        "now": lambda: "1970-01-01T00:00:00Z",
        "date": lambda fmt, t=None: "1970-01-01",
        "dateInZone": lambda fmt, t, z: "1970-01-01",
        "htpasswd": lambda u, p: f"{u}:{hashlib.sha256(str(p).encode()).hexdigest()}",
        "genCA": lambda *a: {"Cert": "", "Key": ""},
        "genSignedCert": lambda *a: {"Cert": "", "Key": ""},
        "genSelfSignedCert": lambda *a: {"Cert": "", "Key": ""},
    }
    return fns


def _fail(msg: Any):
    raise TemplateError(str(msg))


def _index(collection: Any, *keys):
    """Go's ``index`` builtin — the only way to reach map keys containing
    dashes/dots (``index .Values "app.kubernetes.io/name"``)."""
    cur = collection
    for k in keys:
        if cur is None:
            return None
        if isinstance(cur, dict):
            cur = cur.get(k)
        elif isinstance(cur, (list, tuple, str)):
            cur = cur[int(k)]
        else:
            raise TemplateError(f"index: cannot index {type(cur).__name__}")
    return cur


def _stringify(v: Any) -> str:
    if v is None:
        return ""
    if v is True:
        return "true"
    if v is False:
        return "false"
    if isinstance(v, float) and v == int(v):
        return str(int(v))
    return str(v)


def _printf(fmt: str, *args) -> str:
    # Go verbs -> Python: %v/%s -> %s; %d/%f/%q pass through sensibly
    out, ai = [], 0
    i = 0
    while i < len(fmt):
        c = fmt[i]
        if c == "%" and i + 1 < len(fmt):
            v = fmt[i + 1]
            if v == "%":
                out.append("%")
                i += 2
                continue
            arg = args[ai] if ai < len(args) else ""
            ai += 1
            if v in ("v", "s"):
                out.append(_stringify(arg))
            elif v == "d":
                out.append(str(int(_num(arg))))
            elif v == "f":
                out.append(str(float(_num(arg))))
            elif v == "q":
                out.append(json.dumps(_stringify(arg)))
            elif v == "t":
                out.append("true" if _truthy(arg) else "false")
            else:
                out.append("%" + v)
            i += 2
            continue
        out.append(c)
        i += 1
    return "".join(out)


def _merge_dicts(dest: dict, srcs, overwrite: bool) -> dict:
    for src in srcs:
        for k, v in (src or {}).items():
            if k in dest and isinstance(dest[k], dict) and isinstance(v, dict):
                _merge_dicts(dest[k], [v], overwrite)
            elif overwrite or k not in dest:
                dest[k] = v
    return dest


def _dig(*args):
    """sprig dig: path segments..., default, dict — nil-safe nested get."""
    if len(args) < 3:
        raise TemplateError("dig needs at least: key, default, dict")
    *path, default, d = args
    cur = d
    for part in path:
        if not isinstance(cur, dict) or part not in cur:
            return default
        cur = cur[part]
    return cur


def _go_kind(v: Any) -> str:
    if v is None:
        return "invalid"
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int64"
    if isinstance(v, float):
        return "float64"
    if isinstance(v, str):
        return "string"
    if isinstance(v, dict):
        return "map"
    if isinstance(v, (list, tuple)):
        return "slice"
    return type(v).__name__


_NUMERIC_TYPE_NAMES = {"int", "int64", "float64"}


def _type_matches(asked: str, actual: str) -> bool:
    """Helm's YAML->JSON pipeline turns every .Values number into
    float64, while numbers from template functions are int64 — charts
    guard against either. PyYAML preserves int/float, so treating the
    numeric type names as one family makes both guard styles behave as
    they do under real helm."""
    if asked in _NUMERIC_TYPE_NAMES and actual in _NUMERIC_TYPE_NAMES:
        return True
    return asked == actual


def _go_type(v: Any) -> str:
    kind = _go_kind(v)
    if kind == "map":
        return "map[string]interface {}"
    if kind == "slice":
        return "[]interface {}"
    return kind


def _seq(*a):
    a = [int(x) for x in a]
    if len(a) == 1:
        return list(range(1, a[0] + 1))
    if len(a) == 2:
        return list(range(a[0], a[1] + 1))
    return list(range(a[0], a[2] + 1, a[1]))


def _det_rand(renderer: "Renderer", n: int) -> str:
    """Deterministic stand-in for sprig's random strings: stable per
    (release, counter) so re-renders don't churn Secrets — upstream helm
    has the same churn problem and charts guard with ``lookup``."""
    renderer._rand_counter += 1
    seed = f"{renderer.seed}:{renderer._rand_counter}"
    digest = hashlib.sha256(seed.encode()).hexdigest()
    alnum = "".join(c for c in digest if c.isalnum())
    return (alnum * ((n // len(alnum)) + 1))[:n]


# ---------------------------------------------------------------------------
# Renderer
# ---------------------------------------------------------------------------

class Renderer:
    """Render a set of Go-template sources sharing one ``define`` space
    (a chart's ``templates/`` directory)."""

    def __init__(self, seed: str = "devspace"):
        self.defines: dict[str, list] = {}
        self.seed = seed
        self._rand_counter = 0
        self.functions = _build_functions(self)
        self._root_ctx: Any = None

    # -- public API ---------------------------------------------------------
    def load(self, name: str, source: str) -> None:
        """Parse ``source``, registering its defines. The parsed body is
        stored under ``name`` for later execute()."""
        try:
            tokens = _lex(source)
            self.defines[f"\x00file:{name}"] = _parse(tokens, self.defines)
        except TemplateError as e:
            raise TemplateError(f"{name}: {e}") from e

    def execute(self, name: str, context: Any) -> str:
        body = self.defines.get(f"\x00file:{name}")
        if body is None:
            raise TemplateError(f"no template loaded as {name!r}")
        self._root_ctx = context
        try:
            return self._exec(body, context, [{"$": context}])
        except TemplateError as e:
            raise TemplateError(f"{name}: {e}") from e

    # -- internals ----------------------------------------------------------
    def _render_string(self, source: str, context: Any) -> str:
        nodes = _parse(_lex(source), self.defines)
        return self._exec(nodes, context, [{"$": self._root_ctx or context}])

    def _include(self, name: str, ctx: Any) -> str:
        body = self.defines.get(name)
        if body is None:
            raise TemplateError(f"include: no template {name!r} defined")
        return self._exec(body, ctx, [{"$": self._root_ctx}])

    def _exec(self, nodes: list, dot: Any, scopes: list[dict]) -> str:
        out: list[str] = []
        for node in nodes:
            tag = node[0]
            if tag == "text":
                out.append(node[1])
            elif tag == "out":
                val = self._eval_action(node[1], dot, scopes)
                if val is not _NOTHING:
                    out.append(_stringify(val))
            elif tag == "if":
                done = False
                for cond, body in node[1]:
                    # {{ if $x := pipeline }} binds $x for the arm's body
                    val = self._eval_with_vars(cond, dot, scopes)
                    scope: dict = {}
                    if isinstance(val, tuple):
                        varname, val = val
                        scope[varname] = val
                    if _truthy(val):
                        out.append(self._exec(body, dot, scopes + [scope]))
                        done = True
                        break
                if not done and node[2]:
                    out.append(self._exec(node[2], dot, scopes + [{}]))
            elif tag == "range":
                out.append(self._exec_range(node, dot, scopes))
            elif tag == "with":
                val = self._eval_with_vars(node[1], dot, scopes)
                if isinstance(val, tuple):  # ($x := ...) style in with
                    varname, val = val
                else:
                    varname = None
                if _truthy(val):
                    scope: dict = {varname: val} if varname else {}
                    out.append(self._exec(node[2], val, scopes + [scope]))
                elif node[3]:
                    out.append(self._exec(node[3], dot, scopes + [{}]))
        return "".join(out)

    def _exec_range(self, node, dot, scopes) -> str:
        toks, body, else_body = node[1], node[2], node[3]
        # range $i, $v := pipeline  |  range $v := pipeline  |  range pipeline
        varnames: list[str] = []
        if ":=" in toks:
            idx = toks.index(":=")
            varnames = [t[1:] for t in toks[:idx] if t.startswith("$")]
            toks = toks[idx + 1 :]
        coll = self._eval_pipeline(toks, dot, scopes)
        items: list[tuple[Any, Any]]
        if isinstance(coll, dict):
            items = [(k, coll[k]) for k in sorted(coll, key=str)]
        elif isinstance(coll, (list, tuple)):
            items = list(enumerate(coll))
        elif coll is None:
            items = []
        elif isinstance(coll, int):
            items = list(enumerate(range(coll)))
        else:
            raise TemplateError(f"range over non-iterable {type(coll).__name__}")
        if not items:
            return self._exec(else_body, dot, scopes + [{}]) if else_body else ""
        out = []
        for key, val in items:
            scope: dict = {}
            if len(varnames) == 2:
                scope[varnames[0]], scope[varnames[1]] = key, val
            elif len(varnames) == 1:
                scope[varnames[0]] = val
            out.append(self._exec(body, val, scopes + [scope]))
        return "".join(out)

    def _eval_with_vars(self, toks, dot, scopes):
        if ":=" in toks:
            idx = toks.index(":=")
            name = toks[0][1:]
            return (name, self._eval_pipeline(toks[idx + 1 :], dot, scopes))
        return self._eval_pipeline(toks, dot, scopes)

    def _eval_action(self, toks: list[str], dot, scopes):
        # variable assignment produces no output
        if ":=" in toks or (len(toks) > 1 and toks[1] == "=" and toks[0].startswith("$")):
            if ":=" in toks:
                idx = toks.index(":=")
                val = self._eval_pipeline(toks[idx + 1 :], dot, scopes)
                scopes[-1][toks[0][1:]] = val
            else:
                val = self._eval_pipeline(toks[2:], dot, scopes)
                name = toks[0][1:]
                for scope in reversed(scopes):
                    if name in scope:
                        scope[name] = val
                        break
                else:
                    scopes[-1][name] = val
            return _NOTHING
        if toks and toks[0] == "template":
            name = _unquote(toks[1])
            ctx = self._eval_pipeline(toks[2:], dot, scopes) if len(toks) > 2 else None
            return self._include(name, ctx)
        return self._eval_pipeline(toks, dot, scopes)

    def _eval_pipeline(self, toks: list[str], dot, scopes):
        if not toks:
            raise TemplateError("empty pipeline")
        stages: list[list[str]] = [[]]
        depth = 0
        for t in toks:
            if t == "(":
                depth += 1
            elif t == ")":
                depth -= 1
            if t == "|" and depth == 0:
                stages.append([])
            else:
                stages[-1].append(t)
        value = _NOTHING
        for stage in stages:
            value = self._eval_command(stage, dot, scopes, piped=value)
        return value

    def _eval_command(self, toks: list[str], dot, scopes, piped):
        if not toks:
            raise TemplateError("empty command in pipeline")
        head = toks[0]
        # function call?
        if head in self.functions and not head.startswith((".", "$", '"', "`")):
            args, pos = [], 1
            while pos < len(toks):
                arg, pos = self._eval_operand(toks, pos, dot, scopes)
                args.append(arg)
            if piped is not _NOTHING:
                args.append(piped)
            try:
                return self.functions[head](*args)
            except TemplateError:
                raise
            except Exception as e:  # noqa: BLE001
                raise TemplateError(f"{head}: {e}") from e
        value, pos = self._eval_operand(toks, 0, dot, scopes)
        if pos != len(toks) or (callable(value) and piped is not _NOTHING):
            # a callable field with arguments: a template-exposed method,
            # e.g. {{ .Capabilities.APIVersions.Has "apps/v1" }}
            if callable(value):
                args = []
                while pos < len(toks):
                    arg, pos = self._eval_operand(toks, pos, dot, scopes)
                    args.append(arg)
                if piped is not _NOTHING:
                    args.append(piped)
                try:
                    return value(*args)
                except TemplateError:
                    raise
                except Exception as e:  # noqa: BLE001
                    raise TemplateError(f"calling {toks[0]}: {e}") from e
            raise TemplateError(f"unexpected args after operand: {toks}")
        return value

    def _eval_operand(self, toks: list[str], pos: int, dot, scopes):
        t = toks[pos]
        if t == "(":
            depth, j = 1, pos + 1
            while j < len(toks) and depth:
                if toks[j] == "(":
                    depth += 1
                elif toks[j] == ")":
                    depth -= 1
                j += 1
            inner = toks[pos + 1 : j - 1]
            val = self._eval_pipeline(inner, dot, scopes)
            # field access on a parenthesized expr: (dict "k" "v").k —
            # only when the field was ADJACENT to the paren (\x01 mark);
            # `tpl (...) .context` keeps .context as the next argument
            if j < len(toks) and toks[j].startswith("\x01"):
                val = _field(val, toks[j][2:])
                j += 1
            return val, j
        if t.startswith('"') or t.startswith("`"):
            return _unquote(t), pos + 1
        if re.fullmatch(r"-?\d+", t):
            return int(t), pos + 1
        if re.fullmatch(r"-?\d+\.\d+", t):
            return float(t), pos + 1
        if t in ("true", "false"):
            return t == "true", pos + 1
        if t in ("nil", "null"):
            return None, pos + 1
        if t.startswith("$"):
            name = t[1:]
            field = ""
            if "." in name:
                name, _, field = name.partition(".")
            val = _NOTHING
            for scope in reversed(scopes):
                if name in scope:
                    val = scope[name]
                    break
            if val is _NOTHING:
                if name == "":
                    val = scopes[0].get("$")
                else:
                    raise TemplateError(f"undefined variable ${name}")
            if field:
                val = _field(val, field)
            return val, pos + 1
        if t.startswith("."):
            return _field(dot, t[1:]), pos + 1
        if t in self.functions:
            # zero-arg function used as an operand (e.g. nested in parens)
            return self.functions[t](), pos + 1
        raise TemplateError(f"unknown operand {t!r}")


class _Nothing:
    def __repr__(self):
        return "<nothing>"


_NOTHING = _Nothing()


def _field(obj: Any, path: str) -> Any:
    """Nil-safe field traversal: missing keys yield None (Go maps yield the
    zero value; we extend the same forgiveness to nested access so charts
    can guard with ``default``/``if`` instead of crashing).

    Underscore-prefixed parts are rejected: charts come from untrusted
    repos, and ``getattr`` traversal into dunders would otherwise reach
    ``__globals__``/``__builtins__`` — template-to-Python code execution.
    Go templates only expose exported (capitalized) fields; same idea."""
    if not path:
        return obj
    cur = obj
    for part in path.split("."):
        if not part:
            continue
        if isinstance(cur, dict):
            # dict keys are data, not attributes — underscore keys are fine
            # (sprig's `split` yields _0/_1/... keys)
            cur = cur.get(part)
        elif cur is None:
            return None
        else:
            # attribute traversal can reach Python internals — block
            # underscore names here (``__globals__`` -> builtins -> eval)
            if part.startswith("_"):
                raise TemplateError(f"illegal field name {part!r}")
            cur = getattr(cur, part, None)
    return cur
