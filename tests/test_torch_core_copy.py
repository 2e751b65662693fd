"""The port's ``core`` (the lake) is a copy of the JAX package's, and stays one.

Every file of ``src/repro_torch/core/`` equals its counterpart in
``src/repro/core/`` line for line, once import lines naming ``repro`` are
read as naming ``repro_torch`` and with change tags in the JAX package's
docstrings (an upper-case word, a dash and a number, in parentheses) left out
as the copy leaves them out, except for the hunks listed here: the TQL tensor
engine, which jits through jax in the JAX package and runs as torch operations
on a device in the port (``engine="torch"``, ``repro_torch/tql_engine.py``),
and the batched TQL functions, which reduce and cast through the engine's
array namespace so that they take torch tensors as well as numpy arrays.
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
        ['  math.  With ``engine="jax"`` the expression graph is jitted through XLA —',
         '  the paper\'s "execution of the query can be delegated to external tensor',
         '    signal fallback.  ``xp`` is numpy or jax.numpy."""',
         '    def __init__(self, view: DatasetView, seed: int, engine: str = "numpy") -> None:',
         '        if engine == "jax":',
         '            import jax.numpy as jnp  # deferred; numpy engine has no jax dep',
         '            self.xp = jnp',
         '        if self.engine == "jax":',
         '            import jax',
         '',
         '            @jax.jit',
         '            def run(cs):',
         '                return self._eval(node, cs, self.xp)',
         '',
         '            return np.asarray(run({k: self.xp.asarray(v) for k, v in cols.items()}))',
         '                 scan_plan_hint: Optional[ScanPlan] = None) -> None:',
         '        if self.engine in ("auto", "numpy", "jax"):',
         '                                "jax" if self.engine == "jax" else "numpy")',
         '                if self.engine == "jax":',
         '                  tenant: Optional[str] = None) -> DatasetView:',
         '                    shards=shards, tenant=tenant).run(base)'],
        ['  math.  With ``engine="torch"`` the expression graph runs as torch',
         '  operations on a device, the card by default (:mod:`repro_torch.tql_engine`)',
         '  — the paper\'s "execution of the query can be delegated to external tensor',
         '    signal fallback.  ``xp`` is numpy or a torch namespace on ``device``."""',
         '    def __init__(self, view: DatasetView, seed: int, engine: str = "numpy",',
         '                 device: Any = None) -> None:',
         '        if engine == "torch":',
         '            from repro_torch.tql_engine import TorchNamespace  # deferred',
         '            self.xp = TorchNamespace(device)',
         '        if self.engine == "torch":',
         '            xp = self.xp',
         '            return xp.to_numpy(self._eval(',
         '                node, {k: xp.asarray(v) for k, v in cols.items()}, xp))',
         '                 scan_plan_hint: Optional[ScanPlan] = None,',
         '                 device: Any = None) -> None:',
         '        if engine == "jax":',
         '            raise ValueError("engine=\'jax\' is the JAX package\'s; the port\'s "',
         '                             "tensor engine is engine=\'torch\'")',
         '        #: where engine="torch" evaluates: ``device``, else the CUDA device',
         '        self.device = None',
         '        if engine == "torch":',
         '            from repro_torch.tql_engine import engine_device  # deferred',
         '            self.device = engine_device(device)',
         '        if self.engine in ("auto", "numpy", "torch"):',
         '                                "torch" if self.engine == "torch" else "numpy",',
         '                                self.device)',
         '                if self.engine == "torch":',
         '                  tenant: Optional[str] = None,',
         '                  device: Any = None) -> DatasetView:',
         '                    shards=shards, tenant=tenant, device=device).run(base)']),
    "tql/functions.py": (
        ['def _reduce_all(np_reduce, empty):',
         '    same identity per empty row so both execution paths agree.',
         '        return np_reduce(a, axis=tuple(range(1, a.ndim)))',
         '        row, batched = _reduce_all(red, empty)',
         '            (x.astype("float32") if hasattr(x, "astype") else x) ** 2,',
         '                      lambda x, xp=np: x.astype("float32"))'],
        ['def _reduce_all(np_reduce, empty, method):',
         '    same identity per empty row so both execution paths agree.  The',
         "    batched form reduces with ``xp``'s function of the name ``method``.",
         '        return getattr(xp, method)(a, axis=tuple(range(1, a.ndim)))',
         '        row, batched = _reduce_all(red, empty, name.lower())',
         '            xp.asarray(x, dtype="float32") ** 2,',
         '                      lambda x, xp=np: xp.asarray(x, dtype="float32"))']),
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
