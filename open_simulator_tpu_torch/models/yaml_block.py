"""A loader for the block YAML that Kubernetes manifests are written in.

`load_all(text)` returns the documents `yaml.safe_load_all(text)` would
return, for every text inside the subset below, and raises `Refused` at
the first construct outside it; models/decode.py `safe_load_all` then
parses the text with libyaml, or the pure loader, as before, so every
error stays PyYAML's own.

PyYAML spends its time on one Python object a parser event, not in the
C scanner, so this loader reads the text a line at a time instead: each
distinct line is taken apart once a call, and each distinct plain
scalar is typed once a call by PyYAML's own resolver and SafeConstructor
(`yes`, `012`, `1_000`, `1:30`, `.inf`, `~` and `2001-12-14` come out as
PyYAML makes them). Only those immutable scalars are shared: every
mapping and list is a new object, since later phases mutate documents.

The subset:

- `---` alone on a line (a comment may follow) starts a document; a
  first document needs no marker. An empty document is None.
- block mappings nested by indentation; block sequences (`- `), both
  indented under their key and at the key's own column, with
  `- key: value` compact mappings;
- plain scalars on one line, `' #'` comments after them and whole-line
  comments; single-quoted scalars on one line (`''` for a quote);
  double-quoted ones on one line with no `\\`; the empty `{}` and `[]`;
  an empty value is None. A repeated key keeps its first position and
  its last value, as PyYAML's dict does.

Refused: any character PyYAML's reader rejects, a tab, `\\r` or another
line break than `\\n`, a byte order mark; `...`, directives, anchors,
aliases, tags, merge keys (`<<`), `?` keys, block scalars (`|`, `>`),
non-empty flow collections, any scalar spread over lines, a plain value
that holds `': '` or ends in `:`, a scalar alone on a line, and any
indentation that does not continue an open block or open a new one
under an empty value.
"""

from __future__ import annotations

import re
from typing import List


class Refused(Exception):
    """The text holds a construct outside the loader's subset."""


# what PyYAML's reader accepts, less the tab, "\r", NEL, the line and
# paragraph separators and the byte order mark
_OUTSIDE = re.compile(
    "[^\n\x20-\x7e\xa0-\u2027\u202a-\ud7ff\ue000-\ufefe\uff00-\ufffd\U00010000-\U0010ffff]")
# characters that cannot start a plain scalar (PyYAML's check_plain)
_INDICATORS = frozenset("-?:,[]{}#&*!|>'\"%@`")
# PyYAML takes a simple key only while its `:` lies at most 1024
# characters past the key's start; keys near that are left to it
_KEY_LIMIT = 1000
_STR = "tag:yaml.org,2002:str"
_CONSTRUCTED = frozenset("tag:yaml.org,2002:" + t
                         for t in ("null", "bool", "int", "float", "timestamp"))

# line kinds: `key: value`, `- value`, `- key: value`, then the two a
# load passes over: `---`, and a blank or comment line
_ENTRY, _ITEM, _ITEM_ENTRY, _DOC, _BLANK = range(5)
# what a line's value is: a finished scalar, empty (None, or the block
# that the next lines open), a new `{}`, a new `[]`
_SCALAR, _EMPTY, _NEW_DICT, _NEW_LIST = range(4)
_DOC_LINE = (_DOC, 0, None, None, _SCALAR, 0)
_BLANK_LINE = (_BLANK, 0, None, None, _SCALAR, 0)
_MISSING = object()


def load_all(text: str) -> List:
    """The documents of `text`, as `list(yaml.safe_load_all(text))`
    gives them; raises Refused for a text outside the subset."""
    if not isinstance(text, str) or _OUTSIDE.search(text):
        raise Refused("a character outside the subset")
    parse = _Lines().parse
    lines = {}
    seen = lines.get
    docs = []
    doc_open = False
    root = None
    stack = []  # open blocks, innermost last: (column, container, is_list, indentless)
    pending = None  # the slot of an empty value: (container, key or index, column, of_key)
    for line in text.split("\n"):
        p = seen(line)
        if p is None:
            p = lines[line] = parse(line)
        # a line's tuple: its kind, column, key, value, the value's mode,
        # and the key's column after a `- `
        kind, col, key, value, mode, key_col = p
        if kind >= _DOC:
            if kind == _DOC:
                if doc_open:
                    docs.append(root)
                doc_open, root, stack, pending = True, None, [], None
            continue
        doc_open = True
        if pending is not None:
            # the line either opens the empty value's block or leaves it None
            owner, slot, at, of_key = pending
            pending = None
            if col > at:
                child = {} if kind == _ENTRY else []
                stack.append((col, child, kind != _ENTRY, False))
                owner[slot] = child
            elif col == at and of_key and kind != _ENTRY:
                child = []
                stack.append((col, child, True, True))
                owner[slot] = child
        while stack and stack[-1][0] > col:
            stack.pop()
        if not stack:
            if root is not None:
                raise Refused(f"indentation that closes the document: {line!r}")
            root = {} if kind == _ENTRY else []
            stack.append((col, root, kind != _ENTRY, False))
        at, block, is_list, indentless = stack[-1]
        if at != col:
            raise Refused(f"indentation that continues no block: {line!r}")
        if kind == _ENTRY:
            if is_list:
                if not indentless:
                    raise Refused(f"a key inside a sequence: {line!r}")
                stack.pop()
                block = stack[-1][1]
        elif not is_list:
            raise Refused(f"a sequence entry inside a mapping: {line!r}")
        elif kind == _ITEM:
            if mode == _SCALAR:
                block.append(value)
            else:
                block.append(_fresh(mode))
                if mode == _EMPTY:
                    pending = (block, len(block) - 1, col, False)
            continue
        else:
            child = {}
            block.append(child)
            col = key_col
            stack.append((col, child, False, False))
            block = child
        if mode == _SCALAR:
            block[key] = value
        else:
            block[key] = _fresh(mode)
            if mode == _EMPTY:
                pending = (block, key, col, True)
    if doc_open:
        docs.append(root)
    return docs


def _fresh(mode: int):
    """A value that is not a finished scalar, as a document holds it:
    None for an empty one, a new object for `{}` and `[]`."""
    if mode == _NEW_DICT:
        return {}
    if mode == _NEW_LIST:
        return []
    return None


class _Lines:
    """One call's line parser: each line to a tuple of its kind, column,
    key and value, with plain scalars typed once a distinct text."""

    def __init__(self):
        import yaml  # only YAML ingestion needs PyYAML
        from yaml.nodes import ScalarNode

        self._loader = yaml.SafeLoader("")
        self._node = ScalarNode
        self._scalars = {}

    def parse(self, line: str) -> tuple:
        """The line's tuple: (kind, column, key, value, the value's mode,
        the key's column after a `- `)."""
        s = line.lstrip(" ")
        if not s or s[0] == "#":
            return _BLANK_LINE
        col = len(line) - len(s)
        head = s[0]
        if col == 0 and head in "-.%":
            if s.startswith("---") and _blank_after(s, 3):
                return _DOC_LINE
            if s.startswith(("---", "...")) or head == "%":
                raise Refused(f"a marker or directive: {line!r}")
        if head == "-" and (len(s) == 1 or s[1] == " "):
            rest = s[1:].lstrip(" ")
            if not rest or rest[0] == "#":
                return (_ITEM, col, None, None, _EMPTY, 0)
            if rest[0] == "-" and (len(rest) == 1 or rest[1] == " "):
                raise Refused(f"a sequence inside a sequence entry: {line!r}")
            entry = self._entry(rest)
            if entry is None:
                return (_ITEM, col, None, *self._value(rest), 0)
            return (_ITEM_ENTRY, col, *entry, col + len(s) - len(rest))
        entry = self._entry(s)
        if entry is None:
            raise Refused(f"a scalar alone on a line: {line!r}")
        return (_ENTRY, col, *entry, 0)

    def _entry(self, s: str):
        """(key, value, mode) of a `key: value` text, or None for a
        scalar."""
        if s[0] in "'\"":
            key, end = _quoted(s)
            rest = s[end:].lstrip(" ")
            if not rest.startswith(":") or rest[1:2] not in ("", " "):
                return None
            if len(s) - len(rest) > _KEY_LIMIT:
                raise Refused("a key past PyYAML's simple-key limit")
            return (key, *self._value(rest[1:]))
        i = s.find(": ")
        if i == -1:
            t = s.rstrip(" ")
            if not t.endswith(":"):
                return None
            i, after = len(t) - 1, ""
        else:
            after = s[i + 2:]
        j = s.find(" #")
        if j != -1 and j < i:
            return None
        key = s[:i].rstrip(" ")
        if not key or i > _KEY_LIMIT or not _plain_start(key):
            raise Refused(f"a key outside the subset: {s!r}")
        return (self._resolve(key), *self._value(after))

    def _value(self, v: str):
        """(value, mode) of the text after `key: ` or `- `."""
        v = v.lstrip(" ")
        if not v or v[0] == "#":
            return None, _EMPTY
        if v[0] in "'\"":
            text, end = _quoted(v)
            if not _blank_after(v, end):
                raise Refused(f"text after a quoted scalar: {v!r}")
            return text, _SCALAR
        if not _plain_start(v):
            if v.startswith("{}") and _blank_after(v, 2):
                return None, _NEW_DICT
            if v.startswith("[]") and _blank_after(v, 2):
                return None, _NEW_LIST
            raise Refused(f"a value outside the subset: {v!r}")
        j = v.find(" #")
        if j != -1:
            v = v[:j]
        v = v.rstrip(" ")
        if ": " in v or v.endswith(":"):
            raise Refused(f"a mapping value inside a plain scalar: {v!r}")
        return self._resolve(v), _SCALAR

    def _resolve(self, text: str):
        """A plain scalar as PyYAML's SafeLoader types it."""
        value = self._scalars.get(text, _MISSING)
        if value is _MISSING:
            loader = self._loader
            tag = loader.resolve(self._node, text, (True, False))
            if tag == _STR:
                value = text
            elif tag in _CONSTRUCTED:
                try:
                    value = loader.construct_object(self._node(tag, text))
                except Exception as e:  # noqa: BLE001 - PyYAML's own load raises it
                    raise Refused(f"a scalar PyYAML cannot construct: {text!r}") from e
            else:
                raise Refused(f"a scalar of tag {tag}: {text!r}")
            self._scalars[text] = value
        return value


def _plain_start(s: str) -> bool:
    """Whether `s` may start a plain scalar: no indicator first, except a
    `-` that a non-space follows."""
    head = s[0]
    return head not in _INDICATORS or (head == "-" and len(s) > 1 and s[1] != " ")


def _blank_after(s: str, end: int) -> bool:
    """Whether `s[end:]` is empty, or a space and then only spaces or a
    comment."""
    if end == len(s):
        return True
    if s[end] != " ":
        return False
    rest = s[end:].lstrip(" ")
    return not rest or rest[0] == "#"


def _quoted(s: str):
    """(text, end) of the quoted scalar that opens `s`; refuses one that
    does not close on its line or holds an escape."""
    if s[0] == '"':
        end = s.find('"', 1)
        if end == -1 or "\\" in s[1:end]:
            raise Refused(f"a double-quoted scalar outside the subset: {s!r}")
        return s[1:end], end + 1
    parts, i = [], 1
    while True:
        end = s.find("'", i)
        if end == -1:
            raise Refused(f"a single-quoted scalar that does not close: {s!r}")
        if s.startswith("''", end):
            parts.append(s[i:end + 1])
            i = end + 2
            continue
        parts.append(s[i:end])
        return "".join(parts), end + 1
