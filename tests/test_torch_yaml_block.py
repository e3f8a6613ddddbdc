"""The port's block-YAML loader (models/yaml_block.py) against PyYAML.

Every text the loader accepts must give `list(yaml.safe_load_all(text))`
in value and in type at every level (`True == 1` in Python, so values
alone prove nothing); every text it refuses must reach PyYAML through
models/decode.py `safe_load_all` and give PyYAML's documents or error.
The benchmark's inputs and the example directories of plain block YAML
must not be refused: the counters in utils/trace.py `COUNTERS` say so.
"""

import contextlib
import datetime
import io
import math
import os
import random

import pytest
import yaml

from benchmark.tests import tiny
from open_simulator_tpu_torch import cli
from open_simulator_tpu_torch.models import decode
from open_simulator_tpu_torch.models.yaml_block import Refused, load_all
from open_simulator_tpu_torch.utils.trace import COUNTERS

_EXAMPLE = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "example")
EXAMPLE_FILES = sorted(
    os.path.relpath(os.path.join(root, f), _EXAMPLE)
    for root, _, files in os.walk(_EXAMPLE) for f in files if f.endswith((".yaml", ".yml")))
# the chart's templates are Go templates, not YAML, until rendered
TEMPLATES = os.path.join("application", "charts", "hello", "templates")
# directories whose files, read recursively, are all plain block YAML
BLOCK_DIRS = sorted(d for d in {os.path.dirname(f) for f in EXAMPLE_FILES}
                    if d and not os.path.join(TEMPLATES, "").startswith(os.path.join(d, "")))


def same(got, want) -> bool:
    """Equal in value and in type at every level, keys in order."""
    if type(got) is not type(want):
        return False
    if isinstance(got, dict):
        return (len(got) == len(want)
                and all(same(a, b) for a, b in zip(got, want))
                and all(same(got[k], want[k]) for k in got))
    if isinstance(got, list):
        return len(got) == len(want) and all(same(a, b) for a, b in zip(got, want))
    if isinstance(got, float) and math.isnan(got):
        return math.isnan(want)
    if isinstance(got, datetime.datetime):
        return got == want and got.tzinfo == want.tzinfo
    return got == want


def pyyaml(text):
    """PyYAML's documents, or its error."""
    try:
        return list(yaml.safe_load_all(text)), None
    except Exception as e:  # noqa: BLE001 - the error is what is compared
        return None, e


def assert_accepted(text):
    want, err = pyyaml(text)
    assert err is None, err
    got = load_all(text)
    assert same(got, want), (got, want)


def assert_refused_and_pyyaml(text):
    with pytest.raises(Refused):
        load_all(text)
    before = COUNTERS.get("yaml_block_refused_total")
    want, err = pyyaml(text)
    if err is None:
        assert same(decode.safe_load_all(text), want)
    else:
        with pytest.raises(type(err)) as got:
            decode.safe_load_all(text)
        assert str(got.value) == str(err)
    assert COUNTERS.get("yaml_block_refused_total") == before + 1


def assert_equal_or_refused(text):
    """The loader's documents equal PyYAML's, or the text is refused and
    safe_load_all gives PyYAML's documents or error."""
    try:
        got = load_all(text)
    except Refused:
        assert_refused_and_pyyaml(text)
        return
    want, err = pyyaml(text)
    assert err is None, f"accepted what PyYAML rejects: {err!r}"
    assert same(got, want), (got, want)


# -- the corpus ---------------------------------------------------------

@pytest.mark.parametrize("path", EXAMPLE_FILES)
def test_example_files(path):
    with open(os.path.join(_EXAMPLE, path)) as f:
        text = f.read()
    if path.startswith(TEMPLATES):
        assert_equal_or_refused(text)
    else:
        assert_accepted(text)


CELLS = [("k8s-5k-basic", "capacity-plan", 5, [40]),
         ("k8s-5k-spread", "spread-rollout", 6, [5, 7])]


def _cell_files(tmp_path, cell):
    config, traffic, nodes, replicas = cell
    inst = tiny.instance(config, traffic, nodes, replicas, seed=2**31 + 17)
    root = tmp_path / config
    inst.write(str(root))
    return {p.relative_to(root).as_posix(): p.read_text() for p in sorted(root.rglob("*.yaml"))}


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_benchmark_generator_files(tmp_path, cell):
    files = _cell_files(tmp_path, cell)
    assert set(files) == {"simon-config.yaml", "cluster/nodes.yaml", "app/workloads.yaml",
                          "newnode/node.yaml"}
    for text in files.values():
        assert_accepted(text)
    assert len(load_all(files["cluster/nodes.yaml"])) == cell[2]


# plain scalars whose type PyYAML's YAML 1.1 resolver decides
SCALARS = [
    "yes", "Yes", "YES", "no", "No", "NO", "true", "True", "TRUE", "false", "False", "FALSE",
    "on", "On", "ON", "off", "Off", "OFF", "y", "Y", "n", "N",
    "~", "null", "Null", "NULL", "nil", "None",
    "0", "-0", "+12", "012", "0777", "08", "0o17", "0x1F", "0xff_ff", "0b1010", "0b1_0",
    "1_000", "1__0", "-1_000", "1:30", "-1:30", "190:20:30", "1:60", "12:12:12.5",
    "1.5", "1.", ".5", "+.5", "-1.5e+3", "1.0e+3", "1e3", "1E3", "0.1_0", "6.8523015e+5",
    ".inf", ".Inf", "-.INF", "+.inf", ".nan", ".NaN", ".NAN",
    "2001-12-14", "2002-12-14", "2001-12-14t21:59:43.10-05:00", "2001-12-14 21:59:43.10",
    "2001-12-14T21:59:43Z", "2001-12-14 21:59:43.10 -5",
    "500m", "32Gi", "1.5Gi", "node-00001", "kubernetes.io/hostname", "a b", "a  b", "a:b",
    "http://x:80/y", "a,b", "x[0]", "x{y}", "-x", "--", "-.", ".", "é", "日本",
    "a#b", "a'b", 'a"b', "a\\b", "~x", "<x",
]
# scalars that some positions leave outside the subset, or PyYAML rejects
EDGE_SCALARS = ["---", "...", "%", "?x", ":x", "@x", "`x", "&a x", "*a", "!t x", "|", ">",
                "-", "- x", "<<", "=", "a: b", "a:", "{ }", "[a]", "{a: 1}", "'a", '"a', "#"]


@pytest.mark.parametrize("scalar", SCALARS, ids=repr)
def test_plain_scalars_as_values_keys_and_items(scalar):
    assert_accepted(f"key: {scalar}\n")
    assert_accepted(f"{scalar}: value\n")
    assert_accepted(f"- {scalar}\n- {scalar}\n")
    assert_accepted(f"key: {scalar} # a comment\n")


@pytest.mark.parametrize("scalar", EDGE_SCALARS, ids=repr)
def test_edge_scalars_equal_pyyaml_or_are_refused(scalar):
    for text in (f"key: {scalar}\n", f"{scalar}: value\n", f"- {scalar}\n",
                 f"a:\n  {scalar}: 1\n", f"- {scalar} # c\n"):
        assert_equal_or_refused(text)


QUOTED = ["'yes'", "'012'", "'1:30'", "'~'", "''", '""', "'it''s'", "''''", "'a: b'",
          "'a #b'", '"a: b"', '"yes"', '" spaced "', "' spaced '", "'{}'", '"[]"', "'-'"]


@pytest.mark.parametrize("quoted", QUOTED, ids=repr)
def test_quoted_look_alikes_stay_strings(quoted):
    assert_accepted(f"key: {quoted}\n{quoted}: v\n")
    assert_accepted(f"- {quoted}\n- {quoted}   # c\n")
    assert_accepted(f"{quoted} : v\n")


LAYOUTS = {
    "indented_sequence": "a:\n  - x\n  - y\nb: 1\n",
    "indentless_sequence": "a:\n- x\n- y\nb: 1\n",
    "compact_mappings": "containers:\n- name: c\n  image: i\n- name: d\n  ports:\n  - 80\n  - 443\n",
    "compact_mapping_wide_dash": "-   a: 1\n    b:\n      c: 2\n-   d\n",
    "item_then_block": "-\n  a: 1\n  b: 2\n-\n- x\n-   # c\n  - y\n",
    "nested": "a:\n  b:\n    c:\n      d: 1\n  e: 2\nf: 3\n",
    "root_indented": "  a: 1\n  b:\n    c: 2\n",
    "root_sequence": "- a\n- b: 1\n  c: 2\n-\n",
    "empty_values": "a:\nb:   \nc: # c\nd:\n  e:\nf:\n",
    "empty_flow": "a: {}\nb: []\nc: {}  # c\nd:\n- {}\n- []\n",
    "comments": "# head\na: 1 # c\n  # indented comment\nb: x y  #  c\n# tail\n",
    "blank_lines": "\n\na: 1\n\n   \nb:\n\n  c: 2\n\n",
    "duplicate_keys": "a: 1\nb: 2\na: 3\nc:\n  x: 1\nc: 4\n",
    "duplicate_key_block": "a: 1\na:\n  b: 2\n",
    "int_and_bool_keys": "1: a\ntrue: b\nno: c\n~: d\n2001-12-14: e\n0x10: f\n1.5: g\n.nan: h\n",
    "trailing_spaces": "a: 1   \nb:    x   \nc:   \n",
    "no_final_newline": "a: 1\nb: 2",
    "empty_text": "",
    "only_comments": "# a\n\n# b\n",
    "marker_alone": "---\n",
    "marker_no_newline": "---",
    "marker_comment": "--- # c\na: 1\n",
    "two_markers": "---\n---\n",
    "first_marker": "---\na: 1\n---\nb: 2\n",
    "comment_then_marker": "# c\n---\na: 1\n",
    "implicit_then_marker": "a: 1\n---\nb: 2\n",
    "trailing_marker": "a: 1\n---\n",
    "empty_middle_document": "a: 1\n---\n# nothing\n---\nb: 2\n",
    "open_value_then_marker": "a:\n---\nb:\n",
    "keys_with_spaces": "a b: 1\n'c d': 2\n\"e\": 3\nf:g: 4\n",
    "k8s_pod": ("apiVersion: v1\nkind: Pod\nmetadata:\n  name: p\n  labels:\n    app: web\n"
                "  annotations:\n    note: \"x y\"\nspec:\n  nodeSelector:\n    disk: ssd\n"
                "  tolerations:\n  - key: k\n    operator: Exists\n    effect: NoSchedule\n"
                "  containers:\n    - name: c\n      image: 'nginx:1.21'\n      resources:\n"
                "        requests:\n          cpu: 500m\n          memory: 1Gi\n"
                "        limits: {}\n      args: []\n"),
}


@pytest.mark.parametrize("name", sorted(LAYOUTS))
def test_layouts(name):
    assert_accepted(LAYOUTS[name])


REFUSED = {
    "tab_in_quotes": "a: 'x\ty'\n",
    "tab_indent": "a:\n\tb: 1\n",
    "carriage_return": "a: 1\r\nb: 2\r\n",
    "byte_order_mark": "\ufeffa: 1\n",
    "line_separator": "a: x\u2028y\n",
    "next_line": "a: x\x85y\n",
    "control_character": "a: x\x07y\n",
    "document_end": "a: 1\n...\n",
    "directive": "%YAML 1.1\n---\na: 1\n",
    "content_after_marker": "--- a: 1\n",
    "scalar_after_marker": "--- text\n",
    "anchor_alias": "a: &x 1\nb: *x\n",
    "tag": "a: !!str 1\n",
    "local_tag": "a: !thing x\n",
    "merge_key": "base:\n  a: 1\nderived:\n  <<: {a: 2}\n",
    "merge_key_block": "a:\n  <<:\n    b: 1\n",
    "value_key": "=: 1\n",
    "value_scalar": "a: =\n",
    "complex_key": "? a\n: b\n",
    "literal_block": "a: |\n  x\n  y\n",
    "folded_block": "a: >-\n  x\n  y\n",
    "plain_continuation": "a: b\n  c\n",
    "plain_continuation_after_blank": "a: b\n\n  c\n",
    "quoted_continuation": "a: 'b\n  c'\n",
    "double_quoted_escape": 'a: "x\\ty"\n',
    "flow_mapping": "a: {b: 1}\n",
    "flow_sequence": "a: [1, 2]\n",
    "flow_spaced_empty": "a: { }\n",
    "json": '{"apps": [{"name": "x", "yaml": "kind: Pod"}]}\n',
    "mapping_in_value": "a: b: c\n",
    "colon_ended_value": "a: b:\n",
    "scalar_line": "a\n",
    "scalar_document": "--- \nplain\n",
    "quoted_document": "'x'\n",
    "sequence_in_item": "- - a\n",
    "dash_value": "a: -\n",
    "dash_space_value": "a: - b\n",
    "key_inside_sequence": "a:\n  - x\n  b: 1\n",
    "item_inside_mapping": "a: 1\n- b\n",
    "misplaced_indent": "a:\n  b: 1\n c: 2\n",
    "dedent_below_root": "  a: 1\nb: 2\n",
    "deeper_after_value": "a: 1\n  b: 2\n",
    "text_after_quote": "a: 'b' c\n",
    "comment_touching_quote": "a: 'b'#c\n",
    "unclosed_quote": "a: 'b\n",
    "reserved_start": "a: @x\n",
    "backquote_start": "a: `x\n",
    "question_start": "a: ?x\n",
    "unconstructable_int": "a: 0b_\n",
    "unconstructable_date": "a: 2001-13-45\n",
    "long_key": "k" * 1100 + ": v\n",
    "long_key_padded": "k" * 1010 + " " * 20 + ": v\n",
    "long_quoted_key_padded": "'" + "k" * 1010 + "'" + " " * 20 + ": v\n",
    "comment_in_key": "a #b: c\n",
    "no_space_after_colon": "a:b\n",
}


@pytest.mark.parametrize("name", sorted(REFUSED))
def test_refused_texts_reach_pyyaml(name):
    assert_refused_and_pyyaml(REFUSED[name])


def test_every_mapping_and_list_is_a_fresh_object():
    text = "a: {}\nb: {}\nc: []\nd: []\ne:\n  x: 1\n---\ne:\n  x: 1\n"
    first, second = load_all(text)
    assert first["a"] is not first["b"] and first["c"] is not first["d"]
    assert first["e"] == second["e"] and first["e"] is not second["e"]
    first["e"]["x"] = 2
    assert second["e"] == {"x": 1}


def _random_block_yaml(rng: random.Random) -> str:
    """A block-YAML text of random structure, indentation, sequence style,
    spacing and comments, with scalars from SCALARS and QUOTED and, now
    and then, one from EDGE_SCALARS."""
    scalars = SCALARS + QUOTED + ["{}", "[]", ""]

    def scalar(pool):
        return rng.choice(EDGE_SCALARS if rng.random() < 0.01 else pool)

    def tree(depth):
        x = rng.random()
        if depth > 3 or x < 0.35:
            return ("scalar", scalar(scalars))
        if x < 0.7:
            return ("map", [(scalar(SCALARS + QUOTED), tree(depth + 1))
                            for _ in range(rng.randint(1, 4))])
        return ("seq", [tree(depth + 1) for _ in range(rng.randint(1, 3))])

    def emit(node, indent, out, step, indentless):
        kind, body = node
        if kind == "map":
            for key, child in body:
                if child[0] == "scalar":
                    out.append(" " * indent + f"{key}:{rng.choice([' ', '  '])}{child[1]}"
                               + rng.choice(["", "", " # c"]))
                    continue
                out.append(" " * indent + f"{key}:" + rng.choice(["", "", " # c"]))
                if rng.random() < 0.1:
                    out.append(rng.choice(["", "# c", "   # c"]))
                inner = indent if child[0] == "seq" and indentless else indent + step
                emit(child, inner, out, step, indentless)
        else:
            for child in body:
                gap = rng.choice([" ", " ", "   "])
                if child[0] == "scalar":
                    out.append(" " * indent + "-" + gap + child[1] + rng.choice(["", " # c"]))
                elif child[0] == "map" and rng.random() < 0.7:
                    sub = []
                    emit(child, indent + 1 + len(gap), sub, step, indentless)
                    sub[0] = " " * indent + "-" + gap + sub[0].lstrip(" ")
                    out.extend(sub)
                else:
                    out.append(" " * indent + "-")
                    emit(child, indent + step, out, step, indentless)

    docs = []
    for _ in range(rng.randint(1, 3)):
        root = tree(0)
        if root[0] == "scalar":
            root = ("map", [("k", root)])
        out = []
        emit(root, rng.choice([0, 0, 2]), out, rng.choice([1, 2, 2, 4]), rng.random() < 0.5)
        docs.append("\n".join(out))
    return (rng.choice(["", "---\n", "# c\n"]) + "\n---\n".join(docs)
            + rng.choice(["", "\n", "\n---\n"]))


@pytest.mark.parametrize("seed", range(8))
def test_random_block_yaml_equals_pyyaml_or_is_refused(seed):
    rng = random.Random(seed)
    accepted = 0
    for _ in range(150):
        text = _random_block_yaml(rng)
        assert_equal_or_refused(text)
        try:
            load_all(text)
            accepted += 1
        except Refused:
            pass
    # most texts stay inside the subset, so the comparison is not vacuous
    assert accepted > 75


# -- engagement: the benchmark's inputs and plain block YAML take the loader

@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_benchmark_inputs_are_never_refused(tmp_path, cell):
    files = _cell_files(tmp_path, cell)
    refused = COUNTERS.get("yaml_block_refused_total")
    docs = COUNTERS.get("yaml_block_docs_total")
    loaded = decode.decode_yaml_content(list(files.values()))
    assert COUNTERS.get("yaml_block_refused_total") == refused
    n = sum(len(list(yaml.safe_load_all(t))) for t in files.values())
    assert COUNTERS.get("yaml_block_docs_total") == docs + n
    assert len(loaded.nodes) == cell[2] + 1


@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_simon_apply_loads_the_benchmark_request_with_the_loader(tmp_path, cell):
    """The cluster directory, the app directory and the new node of one
    `simon apply` all take the loader: every document it loads is
    counted, and nothing is refused."""
    config, traffic, nodes, replicas = cell
    path = tiny.instance(config, traffic, nodes, replicas).write(str(tmp_path / "req"))
    refused = COUNTERS.get("yaml_block_refused_total")
    docs = COUNTERS.get("yaml_block_docs_total")
    with contextlib.redirect_stdout(io.StringIO()):
        assert cli.main(["apply", "-f", path, "--device", "cpu"]) == 0
    assert COUNTERS.get("yaml_block_refused_total") == refused
    assert COUNTERS.get("yaml_block_docs_total") == docs + nodes + len(replicas) + 1


@pytest.mark.parametrize("path", BLOCK_DIRS)
def test_plain_example_directories_are_never_refused(path):
    refused = COUNTERS.get("yaml_block_refused_total")
    docs = COUNTERS.get("yaml_block_docs_total")
    decode.load_directory(os.path.join(_EXAMPLE, path))
    assert COUNTERS.get("yaml_block_refused_total") == refused
    assert COUNTERS.get("yaml_block_docs_total") > docs


def test_a_chart_template_is_refused_and_counted():
    refused = COUNTERS.get("yaml_block_refused_total")
    with pytest.raises(yaml.YAMLError):
        decode.load_directory(os.path.join(_EXAMPLE, TEMPLATES))
    assert COUNTERS.get("yaml_block_refused_total") > refused
