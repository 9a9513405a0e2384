"""Protobuf text-format ("prototxt") reader.

The reference's entire model zoo and solver configuration is protobuf text
(the reference's src/caffe/proto/caffe.proto; e.g. examples/kitti_car/
mscnn-7s-576-2x/{solver_2nd,trainval_2nd}.prototxt). To keep that surface,
this module parses the text format schema-lessly into nested dicts:

  * `key: value`   -> scalar (int / float / bool / enum-string / "string")
  * `key { ... }`  -> message dict
  * repeated keys  -> list (in file order)

No generated protobuf code is involved — field semantics are applied by the
consumers (mscnn_torch.config.zoo_import, mscnn_torch.train.solver).

A copy of `mscnn_tpu/config/prototxt.py`, which needs no jax: the
port imports nothing of the JAX package, so it keeps its own.
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Tuple, Union

Value = Union[str, int, float, bool, "Message"]
Message = Dict[str, Union[Value, List[Value]]]

_TOKEN = re.compile(r"""
    \s*(?:
        (?P<comment>\#[^\n]*)
      | (?P<brace>[{}])
      | (?P<colon>:)
      | (?P<string>"(?:[^"\\]|\\.)*"|'(?:[^'\\]|\\.)*')
      | (?P<atom>[^\s{}:"']+)
    )""", re.VERBOSE)


def _tokenize(text: str):
    pos = 0
    while pos < len(text):
        if text[pos:].strip() == "":
            return
        m = _TOKEN.match(text, pos)
        if m is None:
            raise ValueError(f"prototxt tokenize error at char {pos}: "
                             f"{text[pos:pos+40]!r}")
        pos = m.end()
        if m.lastgroup == "comment" or m.group().strip() == "":
            continue
        yield m.lastgroup, m.group().strip()
        if pos >= len(text):
            return


def _coerce(atom: str):
    low = atom.lower()
    if low == "true":
        return True
    if low == "false":
        return False
    try:
        return int(atom)
    except ValueError:
        pass
    try:
        return float(atom)
    except ValueError:
        pass
    return atom  # enum value like TRAIN / GPU / MAX


def _insert(msg: Message, key: str, value):
    if key in msg:
        cur = msg[key]
        if isinstance(cur, list):
            cur.append(value)
        else:
            msg[key] = [cur, value]
    else:
        msg[key] = value


def parse_prototxt(text: str) -> Message:
    tokens = list(_tokenize(text))

    def parse_msg(i: int, nested: bool = False) -> Tuple[Message, int]:
        msg: Message = {}
        while i < len(tokens):
            kind, tok = tokens[i]
            if kind == "brace" and tok == "}":
                if not nested:
                    raise ValueError("unbalanced '}' in prototxt")
                return msg, i + 1
            if kind != "atom":
                raise ValueError(f"expected field name, got {tok!r}")
            key = tok
            kind2, tok2 = tokens[i + 1]
            if kind2 == "colon":
                kind3, tok3 = tokens[i + 2]
                if kind3 == "string":
                    _insert(msg, key, tok3[1:-1])
                elif kind3 == "brace" and tok3 == "{":
                    sub, i2 = parse_msg(i + 3, nested=True)
                    _insert(msg, key, sub)
                    i = i2
                    continue
                else:
                    _insert(msg, key, _coerce(tok3))
                i += 3
            elif kind2 == "brace" and tok2 == "{":
                sub, i2 = parse_msg(i + 2, nested=True)
                _insert(msg, key, sub)
                i = i2
            else:
                raise ValueError(f"expected ':' or '{{' after {key!r}")
        if nested:
            raise ValueError("unbalanced '{' in prototxt")
        return msg, i

    msg, i = parse_msg(0)
    if i != len(tokens):
        raise ValueError("unbalanced braces in prototxt")
    return msg


def parse_prototxt_file(path: str) -> Message:
    with open(path) as f:
        return parse_prototxt(f.read())


def as_list(v) -> list:
    """Normalize a maybe-repeated field to a list."""
    if v is None:
        return []
    return v if isinstance(v, list) else [v]


def layers(net: Message) -> List[Message]:
    """All layer messages of a parsed NetParameter."""
    return as_list(net.get("layer"))


def layers_by_type(net: Message, type_name: str) -> List[Message]:
    return [l for l in layers(net) if l.get("type") == type_name]


def layer_phase(layer: Message) -> str:
    """TRAIN / TEST / BOTH from include/exclude NetStateRules."""
    for inc in as_list(layer.get("include")):
        if "phase" in inc:
            return str(inc["phase"])
    return "BOTH"


# -- emission (inverse of parse) ---------------------------------------------

# Parsing collapses the quoted-string / bare-enum distinction to plain str;
# on the way out, protobuf text format requires enums bare and strings
# quoted. Enum values in caffe.proto are ALL_CAPS identifiers (TRAIN, MAX,
# LMDB, ...), so the shape of the atom decides — EXCEPT for fields that
# caffe.proto types as string (a net named "MSCNN" must stay quoted or the
# reference's TextFormat parser rejects the file).
_ENUM_ATOM = re.compile(r"^[A-Z][A-Z0-9_]*$")

# string-typed fields of caffe.proto that could plausibly hold an
# ALL_CAPS value (names, paths, type strings, lr_policy etc.)
_STRING_FIELDS = frozenset({
    "name", "type", "top", "bottom", "source", "mean_file", "root_folder",
    "snapshot_prefix", "net", "train_net", "test_net", "lr_policy",
    "regularization_type", "module", "layer", "crop_mode", "learned_net",
    "window_file", "label_file", "sample_mode",
})


def _emit_value(v, field: str = "") -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return repr(v)
    s = str(v)
    if _ENUM_ATOM.match(s) and field not in _STRING_FIELDS:
        return s
    return '"' + s.replace("\\", "\\\\").replace('"', '\\"') + '"'


def emit_prototxt(msg: Message, indent: int = 0) -> str:
    """Serialize a nested-dict message back to protobuf text format.

    Inverse of parse_prototxt up to the parser's value coercion:
    `parse(emit(parse(text))) == parse(text)` for every reference zoo
    prototxt (tested in tests/test_netspec.py)."""
    pad = "  " * indent
    lines: List[str] = []
    for key, val in msg.items():
        for v in as_list(val):
            if isinstance(v, dict):
                lines.append(f"{pad}{key} {{")
                body = emit_prototxt(v, indent + 1)
                if body:
                    lines.append(body)
                lines.append(f"{pad}}}")
            else:
                lines.append(f"{pad}{key}: {_emit_value(v, key)}")
    return "\n".join(lines)
