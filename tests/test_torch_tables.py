"""The torch port's device tables against the JAX package's, on the golden
index: built by the port itself from its own index loader, and carried
across from the JAX tables by convert.tables_from_jax. Also: the port and
chip_smoke.py import no jax, nothing of the JAX package and not bench.

The golden index comes from tests/torch_golden.py (built once, under a
lock, keyed by ref.fa's content), not from conftest's shared cache.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from torch_golden import golden_index_dir, golden_oracle_index  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module")
def ti(golden_oracle_index):
    from desamba_tpu.index.tensor_index import from_oracle_index

    return from_oracle_index(golden_oracle_index)


@pytest.fixture(scope="module")
def jtab(ti):
    from desamba_tpu.ops.ekmer import EkArrays
    from desamba_tpu.ops.fm import FmArrays
    from desamba_tpu.ops.locate import LocArrays
    from desamba_tpu.ops.refwin import RefArrays

    return dict(fm=FmArrays(ti), ek=EkArrays(ti, fold_bits="auto"),
                loc=LocArrays(ti), ra=RefArrays(ti))


@pytest.fixture(scope="module")
def host_index(golden_index_dir):
    from desamba_tpu_torch.index.loader import load_index

    return load_index(golden_index_dir)


@pytest.fixture(scope="module")
def ttab(host_index):
    from desamba_tpu_torch.convert import build_tables

    return dict(zip(("fm", "ek", "loc", "ra"),
                    build_tables(host_index, "cpu")))


def _bits(x):
    """Array as raw 32-bit (or narrower) words, for bit-exact compares."""
    a = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return a.view(np.uint32) if a.dtype in (np.int32, np.uint32) else a


LEAVES = [("fm", k) for k in ("occ32", "pad", "rank", "hash13", "sa_uni",
                               "sa_off", "lfc")] + \
         [("ek", "w01")] + \
         [("loc", k) for k in ("uni_start", "uni_len", "reflist",
                               "refpos_global", "refpos_refid",
                               "ref_offset")] + \
         [("ra", k) for k in ("ref_words_lsb", "ref_offset", "ref_len")]


@pytest.mark.parametrize("table,leaf", LEAVES)
def test_table_equals_jax(jtab, ttab, table, leaf):
    a = _bits(getattr(jtab[table], leaf))
    b = _bits(getattr(ttab[table], leaf))
    assert a.shape == b.shape and a.dtype == b.dtype, (a.dtype, b.dtype)
    assert (a == b).all()


def test_scalars_equal_jax(jtab, ttab):
    jfm, tfm = jtab["fm"], ttab["fm"]
    assert (int(jfm.L), int(jfm.dollar_pos)) == (tfm.L, tfm.dollar_pos)
    jek, tek = jtab["ek"], ttab["ek"]
    for k in ("n_words0", "mask_bits", "lek", "single_base_max",
              "fold_bits"):
        assert getattr(jek, k) == getattr(tek, k), k


@pytest.mark.parametrize("fold_bits", [1, 2])
def test_exist_filter_fold_equals_jax(ti, host_index, fold_bits):
    from desamba_tpu.ops.ekmer import EkArrays as JEk
    from desamba_tpu_torch.ops.ekmer import EkArrays

    j = JEk(ti, fold_bits=fold_bits)
    t = EkArrays.from_tensor_index(host_index, "cpu", fold_bits=fold_bits)
    assert (j.mask_bits, j.n_words0) == (t.mask_bits, t.n_words0)
    assert (_bits(j.w01) == _bits(t.w01)).all()


@pytest.mark.parametrize("table", ["fm", "ek", "loc", "ra"])
def test_tables_from_jax_equal_own_build(jtab, ttab, table):
    from desamba_tpu_torch.convert import tables_from_jax

    conv = dict(zip(("fm", "ek", "loc", "ra"), tables_from_jax(
        jtab["fm"], jtab["ek"], jtab["loc"], jtab["ra"], "cpu")))
    leaves = [k for t, k in LEAVES if t == table]
    for k in leaves:
        a, b = getattr(conv[table], k), getattr(ttab[table], k)
        assert a.dtype == b.dtype and torch.equal(a, b), k
    if table == "fm":
        assert (conv["fm"].L, conv["fm"].dollar_pos) == (
            ttab["fm"].L, ttab["fm"].dollar_pos)
    if table == "ek":
        assert conv["ek"].n_words0 == ttab["ek"].n_words0


FORBIDDEN = ("jax", "jaxlib", "desamba_tpu", "bench")


def _forbidden(mod: str) -> bool:
    return mod.split(".")[0] in FORBIDDEN


def test_port_imports_no_jax():
    """Importing every module of the port, and chip_smoke.py as a module,
    in a fresh interpreter leaves jax, the JAX package (desamba_tpu and
    all under it) and bench out of sys.modules."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import desamba_tpu_torch as p\n"
        "mods = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "'desamba_tpu_torch.')]\n"
        "for m in mods: importlib.import_module(m)\n"
        "import chip_smoke\n"
        "assert len(mods) >= 41, mods\n"
        f"bad = [m for m in sys.modules if m.split('.')[0] in {FORBIDDEN}]\n"
        "assert not bad, bad\n"
        "print('ok', len(mods))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr
    assert p.stdout.startswith("ok")


def _sources():
    pkg = os.path.join(ROOT, "desamba_tpu_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


@pytest.mark.parametrize("path", _sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_no_source_names_jax_or_the_jax_package(path):
    """No import or from-import in the port or chip_smoke.py names jax,
    desamba_tpu (or anything under it) or bench, at any depth."""
    tree = ast.parse(open(path).read(), path)
    named = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            named += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            named.append(node.module or "")
    assert not [m for m in named if _forbidden(m)], named
