"""The YAML-subset reader behind ``define_configuration``: every shipped
config reads as PyYAML reads it, and syntax outside the subset raises
instead of being misread."""
import glob
import os

import pytest

from localregneuralde_tpu.harness.config import (
    define_configuration,
    parse_yaml_subset,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SHIPPED = sorted(
    os.path.relpath(p, REPO)
    for p in glob.glob(os.path.join(REPO, "experiments", "*", "*.yaml"))
)


@pytest.mark.parametrize("path", SHIPPED)
def test_shipped_config_reads_like_pyyaml(path):
    with open(os.path.join(REPO, path)) as f:
        text = f.read()
    ours = parse_yaml_subset(text)
    yaml = pytest.importorskip("yaml")
    assert ours == yaml.safe_load(text)
    define_configuration([], os.path.join(REPO, path))


def test_scalars_lists_comments_and_nulls():
    text = (
        "# header\n"
        "a:\n"
        "  s: 'x # not a comment'  # a comment\n"
        "  d: \"tab\\tsep\"\n"
        "  l: [1, 2.5, -3e-2, \"q\"]\n"
        "  e: []\n"
        "  b: true\n"
        "  n: ~\n"
        "  word: tsit5\n"
        "c:\n"
        "z: 7\n"
    )
    assert parse_yaml_subset(text) == {
        "a": {"s": "x # not a comment", "d": "tab\tsep",
              "l": [1, 2.5, -0.03, "q"], "e": [], "b": True, "n": None,
              "word": "tsit5"},
        "c": None,
        "z": 7,
    }


@pytest.mark.parametrize("text", [
    "a:\n  - 1\n  - 2\n",             # block list
    "a:\n\tb: 1\n",                   # tab indentation
    "a:\n    b: 1\n  c: 2\n",         # dedent to no open level
    "a: 1\na: 2\n",                   # duplicate key
    "a: &anchor 1\n",                 # anchor
    "a: [1, [2, 3]]\n",               # nested flow list
    "just text\n",                    # not a mapping
    "a: 1\n  b: 2\n",                 # child under a scalar
])
def test_unsupported_yaml_raises(text):
    with pytest.raises(ValueError):
        parse_yaml_subset(text)
