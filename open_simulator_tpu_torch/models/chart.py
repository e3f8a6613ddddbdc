"""Offline Helm-chart rendering.

Mirrors pkg/chart/chart.go:18-118 (ProcessChart): load Chart.yaml +
values.yaml, process chart dependencies (subcharts under charts/ with
condition gating and value scoping), render templates with fabricated
release values (Release.Name = app name, Namespace default, Revision 1,
Service Helm), skip NOTES.txt, and emit manifests in Helm's
InstallOrder (chart.go:54-118).

The helm Go engine is not available here, so this module implements a
real subset of Go text/template + sprig as an AST interpreter:

  actions     {{ expr }} with {{- ... -}} whitespace trim, {{/* */}}
  data        .path lookups, $ (root dot), $var, literals, (pipelines)
  blocks      if / else if / else, range (lists + sorted maps, with
              $i, $v := decls), with, define
  variables   {{ $x := expr }} and {{ $x = expr }}, block-scoped
  templates   define/include/template across all chart files (incl.
              _helpers.tpl and subcharts — one shared namespace, as in
              helm), tpl for string re-rendering
  functions   the sprig/builtin subset real charts use (quote, default,
              toYaml, nindent, printf, eq/and/or, dict/list, trunc,
              b64enc, required, ...)

Unknown/missing paths render empty (non-strict mode, matching the
engine's default used by the reference).
"""

from __future__ import annotations

import atexit
import base64
import hashlib
import json
import os
import re
from collections import OrderedDict
from typing import Dict, List, Optional, Tuple

from .validation import InputError


class _LazyYaml:
    """PyYAML, imported at first use: the port loads no YAML parser at
    module import."""

    def __getattr__(self, name):
        import yaml as _yaml

        return getattr(_yaml, name)


yaml = _LazyYaml()

# helm releaseutil.InstallOrder (chart.go:84-118 sorts with this)
INSTALL_ORDER = [
    "Namespace",
    "NetworkPolicy",
    "ResourceQuota",
    "LimitRange",
    "PodSecurityPolicy",
    "PodDisruptionBudget",
    "ServiceAccount",
    "Secret",
    "SecretList",
    "ConfigMap",
    "StorageClass",
    "PersistentVolume",
    "PersistentVolumeClaim",
    "CustomResourceDefinition",
    "ClusterRole",
    "ClusterRoleList",
    "ClusterRoleBinding",
    "ClusterRoleBindingList",
    "Role",
    "RoleList",
    "RoleBinding",
    "RoleBindingList",
    "Service",
    "DaemonSet",
    "Pod",
    "ReplicationController",
    "ReplicaSet",
    "Deployment",
    "HorizontalPodAutoscaler",
    "StatefulSet",
    "Job",
    "CronJob",
    "Ingress",
    "APIService",
]
_ORDER_INDEX = {k: i for i, k in enumerate(INSTALL_ORDER)}

_TOKEN = re.compile(r"\{\{(-?)\s*(.*?)\s*(-?)\}\}", re.S)


class ChartError(InputError):
    """A template/chart evaluation error is an input error: the chart
    the user pointed simon at does not render. Rooting it in
    InputError (a ValueError) routes it to exit code 2 with a clean
    `error:` line instead of a traceback."""


class _Missing:
    """Sentinel for unresolved paths (renders empty, falsy)."""

    def __str__(self):
        return ""

    def __bool__(self):
        return False

    def __eq__(self, other):
        return isinstance(other, _Missing)

    def __hash__(self):
        return 0


MISSING = _Missing()


def _truthy(v) -> bool:
    if v is MISSING or v is None:
        return False
    if isinstance(v, bool):
        return v
    if isinstance(v, (int, float)):
        return v != 0
    if isinstance(v, (str, list, dict, tuple)):
        return len(v) > 0
    return True


def _gostr(v) -> str:
    """Render a value the way Go's %v does for the cases charts hit."""
    if v is MISSING or v is None:
        return ""
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, float) and v == int(v):
        # Go prints 2.0 as 2 for untyped constants in practice charts use
        return str(int(v))
    if isinstance(v, (dict, list)):
        return yaml.safe_dump(v, default_flow_style=True).strip()
    return str(v)


# ---------------------------------------------------------------------------
# Lexing: template text -> [("text", s) | ("act", s)] with trims applied
# ---------------------------------------------------------------------------


def _lex(text: str) -> List[Tuple[str, str]]:
    parts: List[Tuple[str, str]] = []
    pos = 0
    trim_next = False
    for m in _TOKEN.finditer(text):
        lit = text[pos : m.start()]
        if trim_next:
            lit = lit.lstrip()
        if m.group(1) == "-":
            lit = lit.rstrip()
        if lit:
            parts.append(("text", lit))
        action = m.group(2).strip()
        trim_next = m.group(3) == "-"
        if action.startswith("/*"):
            pos = m.end()
            continue  # comment
        parts.append(("act", action))
        pos = m.end()
    lit = text[pos:]
    if trim_next:
        lit = lit.lstrip()
    if lit:
        parts.append(("text", lit))
    return parts


# ---------------------------------------------------------------------------
# Expression tokenizer: string -> atom list; parens become sublists
# ---------------------------------------------------------------------------


def _tokenize_expr(s: str):
    atoms: List = []
    stack: List[List] = [atoms]
    i, n = 0, len(s)
    while i < n:
        ch = s[i]
        if ch.isspace():
            i += 1
        elif ch == "(":
            sub: List = []
            stack[-1].append(sub)
            stack.append(sub)
            i += 1
        elif ch == ")":
            if len(stack) > 1:
                stack.pop()
            i += 1
        elif ch == "|":
            stack[-1].append("|")
            i += 1
        elif ch in "\"'`":
            j = i + 1
            buf = []
            while j < n and s[j] != ch:
                if ch == '"' and s[j] == "\\" and j + 1 < n:
                    esc = s[j + 1]
                    buf.append({"n": "\n", "t": "\t", '"': '"', "\\": "\\"}.get(esc, esc))
                    j += 2
                else:
                    buf.append(s[j])
                    j += 1
            stack[-1].append(("str", "".join(buf)))
            i = j + 1
        else:
            j = i
            while j < n and not s[j].isspace() and s[j] not in "()|\"'`":
                j += 1
            stack[-1].append(s[i:j])
            i = j
    return atoms


def _split_pipeline(atoms: List) -> List[List]:
    cmds: List[List] = [[]]
    for a in atoms:
        if a == "|":
            cmds.append([])
        else:
            cmds[-1].append(a)
    return [c for c in cmds if c]


# ---------------------------------------------------------------------------
# Parsing: lexed parts -> AST
# Nodes: ("text", s) ("out", expr) ("var", name, expr, decl)
#        ("if", [(expr, body), ...], else_body)
#        ("range", [varnames], expr, body, else_body)
#        ("with", varname|None, expr, body, else_body)
#        ("define", name, body) ("template", name_expr, ctx_expr)
# ---------------------------------------------------------------------------

_VAR_ACT = re.compile(r"^(\$[A-Za-z_][\w]*)\s*(:?=)\s*(.*)$", re.S)
_RANGE_DECL = re.compile(r"^((?:\$[\w]+\s*,\s*)?\$[\w]+)\s*:=\s*(.*)$", re.S)


def _parse(parts: List[Tuple[str, str]], i: int, in_block: bool):
    """Returns (nodes, next_i, terminator_action_or_None)."""
    nodes: List = []
    while i < len(parts):
        kind, payload = parts[i]
        if kind == "text":
            nodes.append(("text", payload))
            i += 1
            continue
        act = payload
        if act == "end" or act == "else" or act.startswith("else if ") or act.startswith("else if\t"):
            if in_block:
                return nodes, i, act
            i += 1  # stray terminator outside a block: ignore
            continue
        if act.startswith("if ") or act.startswith("if\t"):
            branches = []
            cond = act[3:].strip()
            body, i, term = _parse(parts, i + 1, True)
            branches.append((cond, body))
            else_body: List = []
            while term is not None and term.startswith("else if"):
                cond = term[len("else if") :].strip()
                body, i, term = _parse(parts, i + 1, True)
                branches.append((cond, body))
            if term == "else":
                else_body, i, term = _parse(parts, i + 1, True)
            nodes.append(("if", branches, else_body))
            i += 1
            continue
        if act.startswith("range ") or act == "range":
            rest = act[5:].strip()
            m = _RANGE_DECL.match(rest)
            if m:
                varnames = [v.strip() for v in m.group(1).split(",")]
                expr = m.group(2)
            else:
                varnames, expr = [], rest
            body, i, term = _parse(parts, i + 1, True)
            else_body = []
            if term == "else":
                else_body, i, term = _parse(parts, i + 1, True)
            nodes.append(("range", varnames, expr, body, else_body))
            i += 1
            continue
        if act.startswith("with ") or act.startswith("with\t"):
            rest = act[5:].strip()
            varname = None
            m = _VAR_ACT.match(rest)
            if m and m.group(2) == ":=":
                varname, rest = m.group(1), m.group(3)
            body, i, term = _parse(parts, i + 1, True)
            else_body = []
            if term == "else":
                else_body, i, term = _parse(parts, i + 1, True)
            nodes.append(("with", varname, rest, body, else_body))
            i += 1
            continue
        if act.startswith("define ") or act.startswith("block "):
            is_block = act.startswith("block ")
            rest = act.split(None, 1)[1].strip()
            atoms = _tokenize_expr(rest)
            name = atoms[0][1] if atoms and isinstance(atoms[0], tuple) else str(atoms[0])
            body, i, _term = _parse(parts, i + 1, True)
            nodes.append(("define", name, body))
            if is_block:
                # block = define + template in place
                ctx = rest[len(name) + 2 :].strip() or "."
                nodes.append(("template", ('"%s"' % name), ctx))
            i += 1
            continue
        if act.startswith("template "):
            atoms = _tokenize_expr(act[9:].strip())
            name_atom = atoms[0] if atoms else ("str", "")
            ctx = atoms[1:] or ["."]
            nodes.append(("template", name_atom, ctx))
            i += 1
            continue
        m = _VAR_ACT.match(act)
        if m:
            nodes.append(("var", m.group(1), m.group(3), m.group(2) == ":="))
            i += 1
            continue
        nodes.append(("out", act))
        i += 1
    return nodes, i, None


def _parse_template(text: str) -> List:
    nodes, _, _ = _parse(_lex(text), 0, False)
    return nodes


# ---------------------------------------------------------------------------
# Evaluation
# ---------------------------------------------------------------------------


class _Env:
    __slots__ = ("root", "dot", "scopes", "templates", "depth")

    def __init__(self, root, dot, templates, scopes=None, depth=0):
        self.root = root
        self.dot = dot
        self.templates = templates
        self.scopes = scopes if scopes is not None else [{"$": dot}]
        self.depth = depth

    def child(self, dot=None):
        e = _Env(self.root, self.dot if dot is None else dot, self.templates,
                 self.scopes + [{}], self.depth)
        return e

    def get_var(self, name):
        for scope in reversed(self.scopes):
            if name in scope:
                return scope[name]
        return MISSING

    def set_var(self, name, value, decl):
        if decl:
            self.scopes[-1][name] = value
            return
        for scope in reversed(self.scopes):
            if name in scope:
                scope[name] = value
                return
        self.scopes[-1][name] = value


def _field(value, part: str):
    if value is MISSING or value is None:
        return MISSING
    if isinstance(value, dict):
        return value[part] if part in value else MISSING
    att = getattr(value, part, MISSING)
    return att


def _walk(value, path: str):
    for part in path.split("."):
        if part:
            value = _field(value, part)
    return value


def _eval_atom(atom, env: _Env):
    if isinstance(atom, list):
        return _eval_pipeline(atom, env)
    if isinstance(atom, tuple):  # ("str", s)
        return atom[1]
    s = atom
    if s == ".":
        return env.dot
    if s.startswith("."):
        return _walk(env.dot, s[1:])
    if s == "$":
        return env.get_var("$")
    if s.startswith("$"):
        head, dot, rest = s.partition(".")
        v = env.get_var(head)
        return _walk(v, rest) if dot else v
    if s == "true":
        return True
    if s == "false":
        return False
    if s in ("nil", "null"):
        return None
    try:
        return int(s)
    except ValueError:
        pass
    try:
        return float(s)
    except ValueError:
        pass
    return MISSING  # bare ident with no args and not a function


def _eval_command(atoms: List, env: _Env, piped=None):
    if not atoms:
        return MISSING
    head = atoms[0]
    extra = [] if piped is None else [piped]
    if isinstance(head, str) and not head.startswith((".", "$")) and (
        head in FUNCS or len(atoms) > 1 or piped is not None
    ):
        if head in FUNCS:
            args = [_eval_atom(a, env) for a in atoms[1:]] + extra
            return FUNCS[head](args, env)
        # not a known function: fall through to value semantics
    value = _eval_atom(head, env)
    if callable(value):
        args = [_eval_atom(a, env) for a in atoms[1:]] + extra
        try:
            return value(*args)
        except (TypeError, ValueError, KeyError, IndexError, AttributeError) as e:
            # a failed method/value call renders as "<no value>" like a
            # Go template error-less miss, but the swallowed reason is
            # kept for `--trace` output — a chart that silently renders
            # wrong must be diagnosable without a debugger
            from ..utils.trace import GLOBAL

            GLOBAL.append_note(
                "chart-template-call",
                f"{head!r}: {type(e).__name__}: {e}",
            )
            return MISSING
    return value


def _eval_pipeline(atoms: List, env: _Env):
    cmds = _split_pipeline(atoms)
    if not cmds:
        return MISSING
    val = _eval_command(cmds[0], env)
    for cmd in cmds[1:]:
        val = _eval_command(cmd, env, piped=val)
    return val


def _eval_expr(expr: str, env: _Env):
    return _eval_pipeline(_tokenize_expr(expr), env)


def _exec(nodes: List, env: _Env, out: List[str]):
    for node in nodes:
        tag = node[0]
        if tag == "text":
            out.append(node[1])
        elif tag == "out":
            out.append(_gostr(_eval_expr(node[1], env)))
        elif tag == "var":
            env.set_var(node[1], _eval_expr(node[2], env), node[3])
        elif tag == "if":
            done = False
            for cond, body in node[1]:
                if _truthy(_eval_expr(cond, env)):
                    _exec(body, env.child(), out)
                    done = True
                    break
            if not done and node[2]:
                _exec(node[2], env.child(), out)
        elif tag == "with":
            _varname, expr, body, else_body = node[1], node[2], node[3], node[4]
            v = _eval_expr(expr, env)
            if _truthy(v):
                child = env.child(dot=v)
                if _varname:
                    child.set_var(_varname, v, True)
                _exec(body, child, out)
            elif else_body:
                _exec(else_body, env.child(), out)
        elif tag == "range":
            varnames, expr, body, else_body = node[1], node[2], node[3], node[4]
            v = _eval_expr(expr, env)
            items: List[Tuple] = []
            if isinstance(v, dict):
                items = [(k, v[k]) for k in sorted(v, key=str)]
            elif isinstance(v, (list, tuple)):
                items = list(enumerate(v))
            elif isinstance(v, int) and not isinstance(v, bool):
                items = [(i, i) for i in range(v)]
            if items:
                for key, elem in items:
                    child = env.child(dot=elem)
                    if len(varnames) == 1:
                        child.set_var(varnames[0], elem, True)
                    elif len(varnames) == 2:
                        child.set_var(varnames[0], key, True)
                        child.set_var(varnames[1], elem, True)
                    _exec(body, child, out)
            elif else_body:
                _exec(else_body, env.child(), out)
        elif tag == "define":
            env.templates[node[1]] = node[2]
        elif tag == "template":
            name_atom, ctx_atoms = node[1], node[2]
            name = (
                name_atom[1]
                if isinstance(name_atom, tuple)
                else _gostr(_eval_atom(name_atom, env))
            )
            dot = _eval_pipeline(list(ctx_atoms), env) if isinstance(ctx_atoms, list) else _eval_expr(ctx_atoms, env)
            out.append(_include(name, dot, env))
    return out


def _include(name: str, dot, env: _Env) -> str:
    body = env.templates.get(name)
    if body is None:
        return ""
    if env.depth > 250:
        raise ChartError(f"template recursion too deep rendering {name!r}")
    child = _Env(env.root, dot, env.templates, [{"$": dot}], env.depth + 1)
    return "".join(_exec(body, child, []))


# ---------------------------------------------------------------------------
# Function library (text/template builtins + the sprig subset charts use)
# ---------------------------------------------------------------------------


def _arg(args, i, default=MISSING):
    return args[i] if len(args) > i else default


def _to_int(v):
    if isinstance(v, bool):
        return int(v)
    try:
        return int(float(str(v)))
    except (TypeError, ValueError):
        return 0


def _go_printf(fmt, args):
    out = []
    ai = 0
    i = 0
    while i < len(fmt):
        ch = fmt[i]
        if ch != "%":
            out.append(ch)
            i += 1
            continue
        j = i + 1
        while j < len(fmt) and fmt[j] in "-+ #0123456789.":
            j += 1
        if j >= len(fmt):
            out.append(ch)
            break
        verb = fmt[j]
        spec = fmt[i:j]
        a = args[ai] if ai < len(args) else MISSING
        if verb == "%":
            out.append("%")
            i = j + 1
            continue
        ai += 1
        if verb in "dxXob":
            out.append((spec + verb) % _to_int(a))
        elif verb in "feEgG":
            try:
                out.append((spec + verb) % float(a))
            except (TypeError, ValueError):
                out.append(_gostr(a))
        elif verb == "q":
            out.append('"%s"' % _gostr(a))
        elif verb == "t":
            out.append("true" if _truthy(a) else "false")
        else:  # s, v
            out.append((spec + "s") % _gostr(a))
        i = j + 1
    return "".join(out)


def _indent(n, s):
    pad = " " * _to_int(n)
    return "\n".join(pad + line if line else line for line in _gostr(s).split("\n"))


def _fn_dict(args, env):
    d = {}
    for k, v in zip(args[::2], args[1::2]):
        d[_gostr(k)] = v
    return d


def _fn_merge(args, env):
    # merge dst src...: dst wins (sprig merge semantics)
    out: dict = {}
    for src in reversed([a for a in args if isinstance(a, dict)]):
        _deep_merge_into(out, src)
    return out


def _deep_merge_into(dst: dict, src: dict):
    for k, v in src.items():
        if isinstance(v, dict) and isinstance(dst.get(k), dict):
            _deep_merge_into(dst[k], v)
        else:
            dst[k] = v


def _fn_required(args, env):
    msg, v = _arg(args, 0, ""), _arg(args, 1)
    if v is MISSING or v is None:
        raise ChartError(_gostr(msg) or "required value missing")
    return v


def _fn_tpl(args, env):
    text, dot = _gostr(_arg(args, 0, "")), _arg(args, 1, env.dot)
    nodes = _parse_template(text)
    child = _Env(env.root, dot, env.templates, [{"$": dot}], env.depth + 1)
    return "".join(_exec(nodes, child, []))


def _cmp(args, op):
    if len(args) < 2:
        return False
    a, b = args[0], args[1]
    try:
        return op(a, b)
    except TypeError:
        return op(_gostr(a), _gostr(b))


def _eq(args, env):
    if len(args) < 2:
        return False
    first = args[0]
    return any(_loose_eq(first, other) for other in args[1:])


def _loose_eq(a, b):
    if type(a) is type(b):
        return a == b
    if isinstance(a, bool) or isinstance(b, bool):
        return a is b
    if isinstance(a, (int, float)) and isinstance(b, (int, float)):
        return a == b
    return _gostr(a) == _gostr(b)


FUNCS = {
    "quote": lambda a, e: " ".join('"%s"' % _gostr(x) for x in a),
    "squote": lambda a, e: " ".join("'%s'" % _gostr(x) for x in a),
    "default": lambda a, e: (a[1] if len(a) > 1 and _truthy(a[1]) else _arg(a, 0)),
    "coalesce": lambda a, e: next((x for x in a if _truthy(x)), MISSING),
    "ternary": lambda a, e: (_arg(a, 0) if _truthy(_arg(a, 2)) else _arg(a, 1)),
    "empty": lambda a, e: not _truthy(_arg(a, 0)),
    "int": lambda a, e: _to_int(_arg(a, 0)),
    "int64": lambda a, e: _to_int(_arg(a, 0)),
    "float64": lambda a, e: float(_gostr(_arg(a, 0)) or 0),
    "toString": lambda a, e: _gostr(_arg(a, 0)),
    "toYaml": lambda a, e: (
        ""
        if _arg(a, 0) in (MISSING, None)
        else yaml.safe_dump(_arg(a, 0), default_flow_style=False).rstrip()
    ),
    "fromYaml": lambda a, e: yaml.safe_load(_gostr(_arg(a, 0, ""))) or {},
    "toJson": lambda a, e: json.dumps(
        None if _arg(a, 0) is MISSING else _arg(a, 0), separators=(",", ":")
    ),
    "fromJson": lambda a, e: json.loads(_gostr(_arg(a, 0, "null")) or "null") or {},
    "indent": lambda a, e: _indent(_arg(a, 0, 0), _arg(a, 1, "")),
    "nindent": lambda a, e: "\n" + _indent(_arg(a, 0, 0), _arg(a, 1, "")),
    "trim": lambda a, e: _gostr(_arg(a, 0, "")).strip(),
    "trimSuffix": lambda a, e: (
        _gostr(_arg(a, 1, ""))[: -len(_gostr(_arg(a, 0)))]
        if _gostr(_arg(a, 1, "")).endswith(_gostr(_arg(a, 0, "")))
        and _gostr(_arg(a, 0))
        else _gostr(_arg(a, 1, ""))
    ),
    "trimPrefix": lambda a, e: (
        _gostr(_arg(a, 1, ""))[len(_gostr(_arg(a, 0))) :]
        if _gostr(_arg(a, 1, "")).startswith(_gostr(_arg(a, 0, "")))
        else _gostr(_arg(a, 1, ""))
    ),
    "trunc": lambda a, e: (
        _gostr(_arg(a, 1, ""))[: _to_int(_arg(a, 0, 0))]
        if _to_int(_arg(a, 0, 0)) >= 0
        else _gostr(_arg(a, 1, ""))[_to_int(_arg(a, 0, 0)) :]
    ),
    "replace": lambda a, e: _gostr(_arg(a, 2, "")).replace(
        _gostr(_arg(a, 0, "")), _gostr(_arg(a, 1, ""))
    ),
    "lower": lambda a, e: _gostr(_arg(a, 0, "")).lower(),
    "upper": lambda a, e: _gostr(_arg(a, 0, "")).upper(),
    "title": lambda a, e: _gostr(_arg(a, 0, "")).title(),
    "abbrev": lambda a, e: _gostr(_arg(a, 1, ""))[: _to_int(_arg(a, 0, 0))],
    "contains": lambda a, e: _gostr(_arg(a, 0, "")) in _gostr(_arg(a, 1, "")),
    "hasPrefix": lambda a, e: _gostr(_arg(a, 1, "")).startswith(_gostr(_arg(a, 0, ""))),
    "hasSuffix": lambda a, e: _gostr(_arg(a, 1, "")).endswith(_gostr(_arg(a, 0, ""))),
    "repeat": lambda a, e: _gostr(_arg(a, 1, "")) * _to_int(_arg(a, 0, 0)),
    "join": lambda a, e: _gostr(_arg(a, 0, "")).join(
        _gostr(x) for x in (_arg(a, 1) if isinstance(_arg(a, 1), (list, tuple)) else [])
    ),
    "split": lambda a, e: {
        f"_{i}": part
        for i, part in enumerate(_gostr(_arg(a, 1, "")).split(_gostr(_arg(a, 0, " "))))
    },
    "splitList": lambda a, e: _gostr(_arg(a, 1, "")).split(_gostr(_arg(a, 0, " "))),
    "printf": lambda a, e: _go_printf(_gostr(_arg(a, 0, "")), a[1:]),
    "print": lambda a, e: " ".join(_gostr(x) for x in a),
    "println": lambda a, e: " ".join(_gostr(x) for x in a) + "\n",
    "eq": _eq,
    "ne": lambda a, e: not _eq(a, e),
    "lt": lambda a, e: _cmp(a, lambda x, y: x < y),
    "le": lambda a, e: _cmp(a, lambda x, y: x <= y),
    "gt": lambda a, e: _cmp(a, lambda x, y: x > y),
    "ge": lambda a, e: _cmp(a, lambda x, y: x >= y),
    "and": lambda a, e: next((x for x in a if not _truthy(x)), a[-1] if a else MISSING),
    "or": lambda a, e: next((x for x in a if _truthy(x)), a[-1] if a else MISSING),
    "not": lambda a, e: not _truthy(_arg(a, 0)),
    "add": lambda a, e: sum(_to_int(x) for x in a),
    "add1": lambda a, e: _to_int(_arg(a, 0)) + 1,
    "sub": lambda a, e: _to_int(_arg(a, 0)) - sum(_to_int(x) for x in a[1:]),
    "mul": lambda a, e: _prod(a),
    "div": lambda a, e: (
        _to_int(_arg(a, 0)) // _to_int(_arg(a, 1)) if _to_int(_arg(a, 1)) else 0
    ),
    "mod": lambda a, e: (
        _to_int(_arg(a, 0)) % _to_int(_arg(a, 1)) if _to_int(_arg(a, 1)) else 0
    ),
    "max": lambda a, e: max((_to_int(x) for x in a), default=0),
    "min": lambda a, e: min((_to_int(x) for x in a), default=0),
    "len": lambda a, e: len(_arg(a, 0, "")) if _arg(a, 0) is not MISSING else 0,
    "first": lambda a, e: (_arg(a, 0)[0] if _truthy(_arg(a, 0)) else MISSING),
    "last": lambda a, e: (_arg(a, 0)[-1] if _truthy(_arg(a, 0)) else MISSING),
    "rest": lambda a, e: list(_arg(a, 0, []))[1:],
    "initial": lambda a, e: list(_arg(a, 0, []))[:-1],
    "uniq": lambda a, e: list(dict.fromkeys(_arg(a, 0, []))),
    "sortAlpha": lambda a, e: sorted(_gostr(x) for x in _arg(a, 0, [])),
    "reverse": lambda a, e: list(reversed(_arg(a, 0, []))),
    "has": lambda a, e: _arg(a, 0) in (_arg(a, 1) or []),
    "until": lambda a, e: list(range(_to_int(_arg(a, 0, 0)))),
    "untilStep": lambda a, e: list(
        range(_to_int(_arg(a, 0, 0)), _to_int(_arg(a, 1, 0)), _to_int(_arg(a, 2, 1)) or 1)
    ),
    "seq": lambda a, e: " ".join(
        str(i) for i in range(_to_int(_arg(a, 0, 1)), _to_int(_arg(a, -1, 0)) + 1)
    ),
    "list": lambda a, e: list(a),
    "tuple": lambda a, e: list(a),
    "dict": _fn_dict,
    "get": lambda a, e: (
        _arg(a, 0).get(_gostr(_arg(a, 1)), "") if isinstance(_arg(a, 0), dict) else ""
    ),
    "set": lambda a, e: _dict_set(a),
    "unset": lambda a, e: _dict_unset(a),
    "hasKey": lambda a, e: isinstance(_arg(a, 0), dict) and _gostr(_arg(a, 1)) in a[0],
    "keys": lambda a, e: [k for d in a if isinstance(d, dict) for k in d],
    "values": lambda a, e: [v for d in a if isinstance(d, dict) for v in d.values()],
    "pick": lambda a, e: {
        k: v
        for k, v in (_arg(a, 0) or {}).items()
        if k in {_gostr(x) for x in a[1:]}
    },
    "omit": lambda a, e: {
        k: v
        for k, v in (_arg(a, 0) or {}).items()
        if k not in {_gostr(x) for x in a[1:]}
    },
    "merge": _fn_merge,
    "mergeOverwrite": lambda a, e: _fn_merge(list(reversed(a)), e),
    "deepCopy": lambda a, e: json.loads(json.dumps(_arg(a, 0))),
    "kindIs": lambda a, e: _kind_of(_arg(a, 1)) == _gostr(_arg(a, 0)),
    "kindOf": lambda a, e: _kind_of(_arg(a, 0)),
    "typeOf": lambda a, e: _kind_of(_arg(a, 0)),
    "b64enc": lambda a, e: base64.b64encode(_gostr(_arg(a, 0, "")).encode()).decode(),
    "b64dec": lambda a, e: base64.b64decode(_gostr(_arg(a, 0, "")).encode()).decode(
        errors="replace"
    ),
    "sha256sum": lambda a, e: hashlib.sha256(_gostr(_arg(a, 0, "")).encode()).hexdigest(),
    "adler32sum": lambda a, e: str(_adler32(_gostr(_arg(a, 0, "")))),
    "regexMatch": lambda a, e: bool(re.search(_gostr(_arg(a, 0, "")), _gostr(_arg(a, 1, "")))),
    # Go replacement syntax ${1} -> Python \1
    "regexReplaceAll": lambda a, e: re.sub(
        _gostr(_arg(a, 0, "")),
        re.sub(r"\$\{?(\d+)\}?", r"\\\1", _gostr(_arg(a, 2, ""))),
        _gostr(_arg(a, 1, "")),
    ),
    "index": lambda a, e: _fn_index(a),
    "required": _fn_required,
    "fail": lambda a, e: (_ for _ in ()).throw(ChartError(_gostr(_arg(a, 0, "fail")))),
    "include": lambda a, e: _include(_gostr(_arg(a, 0, "")), _arg(a, 1), e),
    "tpl": _fn_tpl,
    "lookup": lambda a, e: {},  # no live cluster in the simulator
    "semverCompare": lambda a, e: True,  # offline render: accept all
    "randAlphaNum": lambda a, e: "x" * _to_int(_arg(a, 0, 8)),  # deterministic
    "uuidv4": lambda a, e: "00000000-0000-4000-8000-000000000000",
    "now": lambda a, e: "2020-01-01T00:00:00Z",
    "date": lambda a, e: "2020-01-01",
    "dateInZone": lambda a, e: "2020-01-01",
    "htpasswd": lambda a, e: "",
    "genCA": lambda a, e: {"Cert": "", "Key": ""},
    "genSignedCert": lambda a, e: {"Cert": "", "Key": ""},
    "genSelfSignedCert": lambda a, e: {"Cert": "", "Key": ""},
}

def _fn_index(args):
    """text/template `index`: walk maps by key and slices by position."""
    cur = _arg(args, 0)
    for key in args[1:]:
        if isinstance(cur, dict):
            cur = cur.get(_gostr(key), MISSING) if _gostr(key) in cur else cur.get(key, MISSING)
        elif isinstance(cur, (list, tuple)):
            i = _to_int(key)
            cur = cur[i] if 0 <= i < len(cur) else MISSING
        else:
            return MISSING
        if cur is MISSING:
            return MISSING
    return cur


def _prod(args):
    out = 1
    for x in args:
        out *= _to_int(x)
    return out


def _dict_set(args):
    d = _arg(args, 0)
    if isinstance(d, dict):
        d[_gostr(_arg(args, 1))] = _arg(args, 2)
    return d


def _dict_unset(args):
    d = _arg(args, 0)
    if isinstance(d, dict):
        d.pop(_gostr(_arg(args, 1)), None)
    return d


def _kind_of(v) -> str:
    if isinstance(v, bool):
        return "bool"
    if isinstance(v, int):
        return "int"
    if isinstance(v, float):
        return "float64"
    if isinstance(v, str):
        return "string"
    if isinstance(v, (list, tuple)):
        return "slice"
    if isinstance(v, dict):
        return "map"
    if v is None or v is MISSING:
        return "invalid"
    return type(v).__name__


def _adler32(s: str) -> int:
    import zlib

    return zlib.adler32(s.encode())


class _APIVersions:
    """Minimal .Capabilities.APIVersions with a Has method."""

    _KNOWN = {"v1", "apps/v1", "batch/v1", "batch/v1beta1", "networking.k8s.io/v1",
              "rbac.authorization.k8s.io/v1", "storage.k8s.io/v1",
              "policy/v1beta1", "apiextensions.k8s.io/v1"}

    def Has(self, version):
        return _gostr(version) in self._KNOWN


def default_capabilities() -> dict:
    # the vendored scheduler engine is k8s v1.20.5 (SURVEY.md §0)
    return {
        "KubeVersion": {
            "Major": "1",
            "Minor": "20",
            "Version": "v1.20.5",
            "GitVersion": "v1.20.5",
        },
        "APIVersions": _APIVersions(),
    }


# ---------------------------------------------------------------------------
# Public rendering API
# ---------------------------------------------------------------------------


def render_template(text: str, context: dict, templates: Optional[dict] = None) -> str:
    """Render the supported Go-template subset with `context` as both the
    root and the initial dot (the helm convention)."""
    nodes = _parse_template(text)
    env = _Env(context, context, templates if templates is not None else {})
    return "".join(_exec(nodes, env, []))


def _deep_merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in (override or {}).items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _deep_merge(out[k], v)
        else:
            out[k] = v
    return out


class _Subchart:
    __slots__ = ("name", "path", "meta", "values")

    def __init__(self, name, path, meta, values):
        self.name = name
        self.path = path
        self.meta = meta
        self.values = values


def _load_chart_meta(path: str) -> Tuple[dict, dict]:
    chart_file = os.path.join(path, "Chart.yaml")
    if not os.path.isfile(chart_file):
        raise ChartError(f"{path}: not a helm chart (no Chart.yaml)")
    with open(chart_file) as f:
        meta = yaml.safe_load(f) or {}
    values = {}
    values_file = os.path.join(path, "values.yaml")
    if os.path.isfile(values_file):
        with open(values_file) as f:
            values = yaml.safe_load(f) or {}
    return meta, values


def _dependencies(path: str, meta: dict) -> List[dict]:
    deps = list(meta.get("dependencies") or [])
    req_file = os.path.join(path, "requirements.yaml")
    if os.path.isfile(req_file):
        with open(req_file) as f:
            req = yaml.safe_load(f) or {}
        deps.extend(req.get("dependencies") or [])
    return deps


def _dependency_enabled(dep: dict, parent_values: dict) -> bool:
    """Helm condition gating (ProcessDependencyConditions): the first
    resolvable condition path decides; absent conditions mean enabled."""
    cond = dep.get("condition")
    if not cond:
        return True
    for path in str(cond).split(","):
        cur = parent_values
        found = True
        for part in path.strip().split("."):
            if isinstance(cur, dict) and part in cur:
                cur = cur[part]
            else:
                found = False
                break
        if found:
            return bool(cur)
    return True


# unpacked .tgz dependencies, keyed by (path, mtime) so repeated
# renders of the same chart reuse one scratch extraction; LRU-bounded,
# evicted/exit-time scratch dirs removed (value = (chart_root, tmpdir))
_ARCHIVE_CACHE: "OrderedDict[tuple, tuple]" = OrderedDict()  # key -> (root, tmp)
_ARCHIVE_CACHE_CAP = 32
# LRU eviction must NOT rmtree immediately — an in-flight render may
# still hold _Subchart.path pointers into the evicted extraction.
# Evicted dirs park here and are reclaimed at the next process_chart
# entry (no render in flight then) or at process exit.
_ARCHIVE_EVICTED: List[str] = []
_ARCHIVE_LIVE: List[str] = []  # dirs still referenced by the cache


def _purge_evicted_archives() -> None:
    import shutil

    while _ARCHIVE_EVICTED:
        shutil.rmtree(_ARCHIVE_EVICTED.pop(), ignore_errors=True)


def _cleanup_archive_scratch() -> None:
    import shutil

    _purge_evicted_archives()
    while _ARCHIVE_LIVE:
        shutil.rmtree(_ARCHIVE_LIVE.pop(), ignore_errors=True)
    _ARCHIVE_CACHE.clear()


atexit.register(_cleanup_archive_scratch)


def _unpack_chart_archive(archive_path: str) -> Optional[str]:
    """Helm packaged dependency (helm loader.Load accepts both a chart
    directory and a .tgz archive): extract to a scratch dir and return
    the chart root — the top-level directory holding Chart.yaml, which
    `helm package` names after the chart. Archive members with unsafe
    paths are refused by tarfile's data filter (manual member screening
    on Pythons predating the `filter` kwarg)."""
    key = (archive_path, os.path.getmtime(archive_path))
    if key in _ARCHIVE_CACHE:
        _ARCHIVE_CACHE.move_to_end(key)
        return _ARCHIVE_CACHE[key][0]
    import tarfile
    import tempfile

    root = None
    tmp = None
    try:
        tmp = tempfile.mkdtemp(prefix="simon-torch-chart-")
        _ARCHIVE_LIVE.append(tmp)
        with tarfile.open(archive_path, "r:gz") as tf:
            try:
                tf.extractall(tmp, filter="data")
            except TypeError:  # Python < 3.10.12/3.11.4: no filter kwarg
                safe = [
                    m
                    for m in tf.getmembers()
                    if (m.isreg() or m.isdir())
                    and not m.name.startswith("/")
                    and ".." not in m.name.split("/")
                ]
                tf.extractall(tmp, members=safe)
        for entry in sorted(os.listdir(tmp)):
            cand = os.path.join(tmp, entry)
            if os.path.isdir(cand) and os.path.isfile(
                os.path.join(cand, "Chart.yaml")
            ):
                root = cand
                break
    except (tarfile.TarError, OSError):
        root = None
    _ARCHIVE_CACHE[key] = (root, tmp)
    if len(_ARCHIVE_CACHE) > _ARCHIVE_CACHE_CAP:
        _evicted_root, evicted_tmp = _ARCHIVE_CACHE.popitem(last=False)[1]
        if evicted_tmp:
            _ARCHIVE_LIVE.remove(evicted_tmp)
            _ARCHIVE_EVICTED.append(evicted_tmp)
    return root


def _collect_charts(
    name: str, path: str, values: dict, globals_: dict, _loaded=None
) -> List[_Subchart]:
    """Flatten parent + enabled subcharts with helm value scoping:
    subchart values = deep_merge(subchart defaults, parent.values[name]),
    with `global` propagated down. charts/ entries may be unpacked
    directories or `helm package` .tgz archives. `_loaded` carries an
    already-parsed (meta, values) pair so callers that peeked at
    Chart.yaml for the dedup key don't parse it twice."""
    meta, own_values = _loaded if _loaded is not None else _load_chart_meta(path)
    merged = _deep_merge(own_values, values)
    g = _deep_merge(globals_, merged.get("global") or {})
    if g:
        merged["global"] = g
    charts = [_Subchart(name, path, meta, merged)]
    # charts/ entries are unpacked under the dependency's chart *name*;
    # an alias renames the subchart at load time (helm chartutil), so
    # condition gating and value scoping key on the alias when present
    deps_by_name = {d.get("name"): d for d in _dependencies(path, meta)}
    charts_dir = os.path.join(path, "charts")
    if os.path.isdir(charts_dir):
        seen_entries = set()
        for entry in sorted(os.listdir(charts_dir)):
            sub_path = os.path.join(charts_dir, entry)
            if os.path.isfile(sub_path) and entry.endswith((".tgz", ".tar.gz")):
                # packaged dependency: the dependency key is the chart's
                # metadata name (helm matches deps by name; the archive
                # filename only carries name-version by convention, so
                # dedup must come from the extracted Chart.yaml below,
                # never from the filename — an archive hand-renamed to
                # '<seen-chart>-X.Y.Z.tgz' may contain a different
                # chart). Extraction of a duplicate is cheap: the
                # archive cache keys on (path, mtime).
                sub_path = _unpack_chart_archive(sub_path)
                if sub_path is None:
                    continue
                sub_loaded = _load_chart_meta(sub_path)
                entry = sub_loaded[0].get("name") or entry
            elif not os.path.isdir(sub_path) or not os.path.isfile(
                os.path.join(sub_path, "Chart.yaml")
            ):
                continue
            else:
                # dedup + dependency lookup key on the chart's metadata
                # name for directories too — a vendored dir may carry a
                # versioned name that differs from the chart name
                sub_loaded = _load_chart_meta(sub_path)
                entry = sub_loaded[0].get("name") or entry
            # a dependency vendored both unpacked and as a .tgz (helm
            # pull --untar next to helm dependency update leftovers)
            # loads once — the sorted walk puts the directory first
            if entry in seen_entries:
                continue
            seen_entries.add(entry)
            dep = deps_by_name.get(entry, {})
            if dep and not _dependency_enabled(dep, merged):
                continue
            sub_name = dep.get("alias") or entry
            sub_values = merged.get(sub_name) or {}
            charts.extend(
                _collect_charts(sub_name, sub_path, sub_values, g, _loaded=sub_loaded)
            )
    return charts


def process_chart(name: str, path: str, extra_values: Optional[dict] = None) -> List[str]:
    """ProcessChart (pkg/chart/chart.go:18-41): render a chart directory
    (with its subcharts) into YAML manifest strings in install order."""
    # no render in flight here: safe to reclaim LRU-evicted extractions
    _purge_evicted_archives()
    charts = _collect_charts(name, path, extra_values or {}, {})

    release = {
        "Name": name,
        "Namespace": "default",
        "IsUpgrade": False,
        "IsInstall": True,
        "Revision": 1,
        "Service": "Helm",
    }
    capabilities = default_capabilities()

    # Pass 1: one shared named-template namespace across parent+subcharts
    # (helm semantics: all defines are global). Defines are registered
    # under each chart's own context so closures over .Chart resolve at
    # include time via the caller's env — matching helm, where defines
    # capture nothing.
    templates: Dict[str, List] = {}
    chart_files: List[Tuple[_Subchart, str, str, List]] = []
    for chart in charts:
        tdir = os.path.join(chart.path, "templates")
        if not os.path.isdir(tdir):
            continue
        for root, _, files in os.walk(tdir):
            if os.path.basename(root) == "tests":
                continue  # helm test hooks are not installed
            for fname in sorted(files):
                if fname.endswith("NOTES.txt"):
                    continue
                if not fname.endswith((".yaml", ".yml", ".tpl")):
                    continue
                fpath = os.path.join(root, fname)
                with open(fpath) as f:
                    text = f.read()
                nodes = _parse_template(text)
                _register_defines(nodes, templates)
                rel = os.path.relpath(fpath, chart.path)
                chart_files.append((chart, fname, rel, nodes))

    manifests: List[Tuple[str, str]] = []
    for chart, fname, rel, nodes in chart_files:
        if fname.startswith("_"):
            continue  # partials only contribute defines
        chart_meta = dict(chart.meta)
        chart_meta.setdefault("Name", chart_meta.get("name", chart.name))
        context = {
            "Values": chart.values,
            "Release": release,
            "Chart": chart_meta,
            "Capabilities": capabilities,
            "Template": {
                "Name": f"{chart.name}/{rel}",
                "BasePath": f"{chart.name}/templates",
            },
        }
        env = _Env(context, context, templates)
        rendered = "".join(_exec(nodes, env, []))
        if not rendered.strip():
            continue
        for doc_text in re.split(r"^---\s*$", rendered, flags=re.M):
            if not doc_text.strip():
                continue
            try:
                doc = yaml.safe_load(doc_text)
            except yaml.YAMLError:
                continue
            if not isinstance(doc, dict) or "kind" not in doc:
                continue
            manifests.append((doc.get("kind", ""), doc_text))
    manifests.sort(key=lambda kv: _ORDER_INDEX.get(kv[0], len(INSTALL_ORDER)))
    return [m for _, m in manifests]


def _register_defines(nodes: List, templates: Dict[str, List]):
    for node in nodes:
        tag = node[0]
        if tag == "define":
            templates[node[1]] = node[2]
            _register_defines(node[2], templates)
        elif tag == "if":
            for _, body in node[1]:
                _register_defines(body, templates)
            _register_defines(node[2], templates)
        elif tag in ("range", "with"):
            _register_defines(node[3], templates)
            _register_defines(node[4], templates)
