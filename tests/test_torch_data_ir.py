"""The PyTorch port's data and IR layers against the JAX package.

* ``repro_torch.relational.tpch.generate`` reproduces the reference
  tables column by column (codes, dictionaries, domains, uniqueness);
* ``tables_from_numpy`` carries the reference tables across unchanged;
* every TPC-H query and template optimizes to the same plan text;
* nothing in ``src/repro_torch`` or ``chip_smoke.py`` imports JAX or the
  JAX package.
"""
import ast
import os

import numpy as np
import pytest

from repro.core import FlareContext as JaxContext
from repro.relational import queries as JQ
from repro.relational import tpch as JT
from repro_torch.core import FlareContext
from repro_torch.relational import queries as Q
from repro_torch.relational import table as PT
from repro_torch.relational import tpch as PTPCH

SF = 0.005
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_tables_equal(ref, port):
    assert sorted(ref) == sorted(port)
    for name in ref:
        a, b = ref[name], port[name]
        assert a.num_rows == b.num_rows, name
        assert [(f.name, f.dtype, f.domain, f.unique) for f in a.schema] == \
            [(f.name, f.dtype, f.domain, f.unique) for f in b.schema], name
        for f in a.schema:
            ca, cb = a.column(f.name), b.column(f.name)
            assert ca.dictionary == cb.dictionary, (name, f.name)
            assert ca.data.dtype == cb.data.dtype, (name, f.name)
            np.testing.assert_array_equal(ca.data, cb.data,
                                          err_msg=f"{name}.{f.name}")


@pytest.mark.parametrize("seed", [0, 7])
def test_generate_matches_reference(seed):
    assert_tables_equal(JT.generate(SF, seed), PTPCH.generate(SF, seed))


def as_spec(tables):
    """Plain numpy dictionaries of (reference) tables, the input of
    ``tables_from_numpy``."""
    spec = {}
    for name, tbl in tables.items():
        spec[name] = {
            "columns": {f.name: tbl[f.name] for f in tbl.schema},
            "dtypes": {f.name: f.dtype for f in tbl.schema},
            "dictionaries": {f.name: tbl.dictionary(f.name)
                             for f in tbl.schema
                             if tbl.dictionary(f.name) is not None},
            "domains": {f.name: f.domain for f in tbl.schema
                        if f.domain is not None},
            "uniques": [f.name for f in tbl.schema if f.unique],
        }
    return spec


def test_tables_from_numpy_carries_reference_tables():
    ref = JT.generate(SF, 3)
    assert_tables_equal(ref, PT.tables_from_numpy(as_spec(ref)))


@pytest.fixture(scope="module")
def ctxs():
    jc = JaxContext()
    JQ.register_tpch(jc, sf=SF)
    pc = FlareContext(device="cpu")
    Q.register_tpch(pc, sf=SF)
    return jc, pc


@pytest.mark.parametrize(
    "kind,name",
    [("query", n) for n in Q.QUERIES] + [("template", n) for n in Q.TEMPLATES])
def test_optimized_plan_text_matches_reference(ctxs, kind, name):
    jc, pc = ctxs
    jreg = JQ.QUERIES if kind == "query" else JQ.TEMPLATES
    preg = Q.QUERIES if kind == "query" else Q.TEMPLATES
    want = jreg[name](jc).explain()
    got = preg[name](pc).explain()
    assert got == want
    assert preg[name](pc).lower().plan().fingerprint() == \
        jreg[name](jc).lower(engine="compiled").plan().fingerprint()


def _imports(path):
    tree = ast.parse(open(path).read(), filename=path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_port_imports_neither_jax_nor_reference():
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(os.path.join(REPO, "src", "repro_torch")):
        files += [os.path.join(root, n) for n in names if n.endswith(".py")]
    assert len(files) > 10
    bad = []
    for path in files:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append((os.path.relpath(path, REPO), mod))
    assert not bad, bad
