"""The port's ``core`` (the lake) is a copy of the JAX package's, and stays one.

Every file of ``src/repro_torch/core/`` equals its counterpart in
``src/repro/core/`` line for line, once import lines naming ``repro`` are
read as naming ``repro_torch`` and with change tags in the JAX package's
docstrings (an upper-case word, a dash and a number, in parentheses) left out
as the copy leaves them out, except for the hunks listed here: the TQL engine
that jits through jax, which the port leaves out (ROADMAP Queue 1 item 15).
A change to either copy that is not made to the other fails here.
"""

import difflib
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
JAX_CORE = ROOT / "src" / "repro" / "core"
PORT_CORE = ROOT / "src" / "repro_torch" / "core"

# file -> (lines only the JAX package has, lines only the port has)
EXPECTED = {
    "tql/executor.py": (
        ["            import jax.numpy as jnp  # deferred; numpy engine has no jax dep",
         "            self.xp = jnp",
         "        else:",
         "            self.xp = np",
         "        if self.engine == \"jax\":",
         "            import jax",
         "",
         "            @jax.jit",
         "            def run(cs):",
         "                return self._eval(node, cs, self.xp)",
         "",
         "            return np.asarray(run({k: self.xp.asarray(v) for k, v in cols.items()}))"],
        ["            raise NotImplementedError(",
         "                \"the jax TQL engine is not ported; see ROADMAP Queue 1 item \"",
         "                \"15 (TQL tensor engine)\")",
         "        self.xp = np"]),
}

_IMPORT = re.compile(r"^(\s*)(from|import)\s+repro(\.|\s)")
_CHANGE_TAG = re.compile(r" \([A-Z]+-\d+\)|, [A-Z]+-\d+(?=\))")


def _normalised(path: Path):
    return [_CHANGE_TAG.sub("", _IMPORT.sub(r"\1\2 repro_torch\3", line))
            for line in path.read_text().splitlines()]


def _files(root: Path):
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


def test_the_copy_has_every_file_and_no_other():
    assert _files(PORT_CORE) == _files(JAX_CORE)


@pytest.mark.parametrize("name", _files(JAX_CORE))
def test_each_file_is_a_copy(name):
    want = _normalised(JAX_CORE / name)
    got = _normalised(PORT_CORE / name)
    only_jax, only_port = [], []
    for tag, i1, i2, j1, j2 in difflib.SequenceMatcher(
            None, want, got, autojunk=False).get_opcodes():
        if tag != "equal":
            only_jax += want[i1:i2]
            only_port += got[j1:j2]
    assert (only_jax, only_port) == EXPECTED.get(name, ([], []))
