"""The port's static-analysis engine (`multihop_offload_tpu_torch/analysis/`)
against JAX's `mho-lint` engine, on the CPU.

* The rules carried as they are (E999, F401, F811, JX005, JX006, JX008,
  JX011, OB001): the same fixture sources (JAX's seeded tree and the
  inline cases here) through both engines give the same (rule, file,
  line) findings and waived sites.
* The rules carried with the array namespace mapped (JX003, MP001,
  SL001): a JAX fixture and its torch counterpart, written line for line,
  give the same (rule, line) findings; torch's own spellings (sizes as
  arguments, `dtype=` only, `torch.float`) are held separately.
* The registry: `--list-rules` has JAX's id, scope and waiver token for
  every carried rule; the JSON report has JAX's keys; the baseline
  workflow behaves as JAX's.
* The port's package scans clean.

Stdlib only under test: the port's engine imports no jax.
"""

from __future__ import annotations

import json
import os
import textwrap

import pytest

from multihop_offload_tpu.analysis import get_rule as j_get_rule
from multihop_offload_tpu.analysis import run_analysis as j_run
from multihop_offload_tpu.analysis.cli import main as j_main
from multihop_offload_tpu_torch.analysis import all_rules, get_rule, run_analysis, write_baseline
from multihop_offload_tpu_torch.analysis.cli import main as t_main
from multihop_offload_tpu_torch.analysis.engine import PACKAGE_DIR
from multihop_offload_tpu_torch.analysis.rules import GROUPS

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SEEDED = os.path.join(REPO, "tests", "fixtures", "analysis_seeded")
AS_IS = ("E999", "F401", "F811", "JX005", "JX006", "JX008", "JX011", "OB001")
MAPPED = ("JX003", "MP001", "SL001")

# one source through both engines: each carried rule's hits, waivers and
# false-positive guards
SAME_SOURCE = {
    "imports.py": """\
        import os
        import sys
        import json  # noqa: F401
        from typing import List
        import os
        import _private

        __all__ = ["exported"]
        from collections import OrderedDict as exported


        def f(x: List):
            return sys.argv
    """,
    "broken.py": """\
        def f(:
            pass
    """,
    "obs/clocks.py": """\
        import random
        import time

        import numpy as np


        def now():
            return time.time()


        def measured():
            return time.perf_counter()  # nondet-ok(test)


        def draws():
            a = random.random()
            b = np.random.rand(3)
            c = np.random.default_rng()
            d = np.random.default_rng(0)
            return a, b, c, d, np.random.Generator
    """,
    "cli/console.py": """\
        import time


        def main():
            print(time.time())
    """,
    "serve/errors.py": """\
        def a(f):
            try:
                f()
            except:
                raise


        def b(f):
            try:
                f()
            except Exception:
                pass


        def c(f):
            try:
                f()
            except (ValueError, BaseException):
                pass


        def d(f):
            try:
                f()
            except Exception:  # swallow-ok(test)
                pass


        def e(f):
            try:
                f()
            except ValueError:
                pass
    """,
    "env/queue.py": """\
        def delay(lam, mu, rho, eps):
            a = lam / (1 - rho)
            b = lam / (1.0 - lam / mu)
            c = lam / max(1 - rho, eps)
            d = lam / (2 - rho)
            e = lam / (1 - rho)  # div-ok(test)
            return a, b, c, d, e
    """,
    "loop/topo.py": """\
        import networkx as nx
        from networkx import barabasi_albert_graph


        def draws(n):
            g = nx.Graph()
            h = barabasi_albert_graph(n, 2, seed=0)
            p = nx.path_graph(n)  # topo-ok(test)
            return g, h, p, nx.shortest_path(g, 0, 1)
    """,
    "graphs/allowed.py": """\
        import networkx as nx


        def draw(n):
            return nx.path_graph(n)
    """,
    "train/prints.py": """\
        from pprint import pprint


        def log(x):
            print(x)
            print(x)  # print-ok(test)
            pprint(x)
    """,
}

# the mapped rules: JAX's spelling and the port's, line for line
MAPPED_SOURCES = {
    "env/mapped.py": ("""\
        import jax.numpy as weird_alias
        import jax.numpy as jnp
        import numpy as np


        def mp(x):
            a = x.astype(weird_alias.float32)
            b = x.astype(np.float32)
            c = x.astype(weird_alias.float32)  # fp32-island(test)
            return a, b, c, x.astype(weird_alias.float64)


        def sl(n, m):
            a = jnp.zeros(
                (n, n)
            )
            z = jnp.zeros
            b = z((n, n), jnp.int32)
            c = jnp.zeros((n, m), jnp.int32)
            d = jnp.full((n, n), 0.0)  # dense-ok(test)
            e = jnp.ones([m, m], dtype=jnp.int32)
            return a, b, c, d, e


        def jx(n):
            a = jnp.arange(n)
            b = jnp.ones((n,))
            c = jnp.zeros((n,), dtype=jnp.int32)
            d = np.arange(n)
            e = np.zeros((n,), np.int32)
            f = jnp.arange(n)  # dtype-ok(test)
            return a, b, c, d, e, f
    """, """\
        import torch as weird_alias
        import torch
        import numpy as np


        def mp(x):
            a = x.to(weird_alias.float32)
            b = x.astype(np.float32)
            c = x.to(weird_alias.float32)  # fp32-island(test)
            return a, b, c, x.to(weird_alias.float64)


        def sl(n, m):
            a = torch.zeros(
                (n, n)
            )
            z = torch.zeros
            b = z((n, n), dtype=torch.int32)
            c = torch.zeros((n, m), dtype=torch.int32)
            d = torch.full((n, n), 0.0)  # dense-ok(test)
            e = torch.ones([m, m], dtype=torch.int32)
            return a, b, c, d, e


        def jx(n):
            a = torch.arange(n)
            b = torch.ones((n,))
            c = torch.zeros((n,), dtype=torch.int32)
            d = np.arange(n)
            e = np.zeros((n,), np.int32)
            f = torch.arange(n)  # dtype-ok(test)
            return a, b, c, d, e, f
    """),
    # out of the rules' dirs, and `precision.py`, exempt in both
    "cli/mapped.py": ("""\
        import jax.numpy as jnp


        def f(n):
            return jnp.zeros((n, n)).astype(jnp.float32), jnp.arange(n)
    """, """\
        import torch


        def f(n):
            return torch.zeros((n, n)).to(torch.float32), torch.arange(n)
    """),
    "models/precision.py": ("""\
        import jax.numpy as jnp

        DEFAULT = jnp.float32
    """, """\
        import torch

        DEFAULT = torch.float32
    """),
}


def write_tree(root, files: dict) -> str:
    for rel, src in files.items():
        p = root / rel
        p.parent.mkdir(parents=True, exist_ok=True)
        p.write_text(textwrap.dedent(src))
    return str(root)


def sites(report, root) -> dict:
    """(rule, file, line) of the live findings and of the waived sites."""
    def key(f):
        return f.rule, os.path.relpath(f.path, root), f.line

    return {"findings": sorted(map(key, report.findings)),
            "waived": sorted(map(key, report.waived))}


@pytest.fixture(scope="module")
def same_tree(tmp_path_factory):
    return write_tree(tmp_path_factory.mktemp("same"), SAME_SOURCE)


@pytest.mark.parametrize("rule_id", AS_IS)
def test_carried_rule_matches_jax_on_the_same_sources(rule_id, same_tree):
    """Both engines on the inline sources and on JAX's seeded tree: the
    same findings and waived sites, and the inline cases hit the rule."""
    got = sites(run_analysis([same_tree], select=rule_id), same_tree)
    assert got == sites(j_run([same_tree], select=rule_id), same_tree)
    assert got["findings"]
    seeded_got = sites(run_analysis([SEEDED], select=rule_id), SEEDED)
    assert seeded_got == sites(j_run([SEEDED], select=rule_id), SEEDED)


@pytest.mark.parametrize("rule_id", MAPPED)
def test_mapped_rule_reads_torch_as_jax_reads_jax_numpy(rule_id, tmp_path):
    """JAX's fixture through JAX's engine, its torch counterpart through the
    port's: the same (rule, file, line) findings and waived sites."""
    jroot = write_tree(tmp_path / "jax", {k: v[0] for k, v in MAPPED_SOURCES.items()})
    troot = write_tree(tmp_path / "torch", {k: v[1] for k, v in MAPPED_SOURCES.items()})
    got = sites(run_analysis([troot], select=rule_id), troot)
    assert got == sites(j_run([jroot], select=rule_id), jroot)
    assert got["findings"] and got["waived"]


def test_torch_spellings_of_the_mapped_rules(tmp_path):
    """What torch spells its own way: sizes as arguments (SL001 reads
    `torch.zeros(n, n)`, JX003 takes no positional dtype) and the
    `torch.float` alias of float32 (MP001)."""
    root = write_tree(tmp_path, {"sim/t.py": """\
        import torch


        def f(n, m):
            a = torch.zeros(n, n, dtype=torch.int32)
            b = torch.empty(n, m, dtype=torch.int32)
            c = torch.ones(n, m)
            return a, b, c, torch.arange(0, n, 1), torch.ones(n).to(torch.float)
    """})
    got = sites(run_analysis([root], select="SL001,JX003,MP001"), root)
    assert got["findings"] == [("JX003", "sim/t.py", 7), ("JX003", "sim/t.py", 8),
                               ("JX003", "sim/t.py", 8), ("MP001", "sim/t.py", 8),
                               ("SL001", "sim/t.py", 5)]


def test_rules_keep_jax_ids_scopes_and_waivers(capsys):
    """Every carried rule has JAX's id, severity, scope, waiver token and
    directories; `--list-rules` lists exactly them; the `repo` group is
    JAX's carried part."""
    ids = [r.id for r in all_rules()]
    assert sorted(ids) == sorted(AS_IS + MAPPED)
    for rid in ids:
        ours, jax_rule = get_rule(rid), j_get_rule(rid)
        for field in ("severity", "scope", "waiver", "dirs", "exempt_dirs", "exempt_files"):
            assert getattr(ours, field) == getattr(jax_rule, field), (rid, field)
    assert t_main(["--list-rules"]) == 0
    rows = capsys.readouterr().out.splitlines()[2:]
    assert [r.split()[0] for r in rows] == sorted(ids)
    for row, r in zip(rows, all_rules()):
        assert (r.waiver + "<why>)" if r.waiver else "-") in row and r.scope in row
    assert set(GROUPS["repo"]) == set(ids) - set(GROUPS["pyflakes"])


def test_cli_json_keys_report_and_exit_codes(tmp_path, capsys):
    """The CLI's JSON and `--report` carry JAX's keys; exit 0 clean, 1 on a
    finding, 2 on an unknown rule id."""
    root = write_tree(tmp_path / "tree", {"train/p.py": "print(1)\nprint(2)  # print-ok(t)\n"})
    outs = []
    for main in (t_main, j_main):
        rep = tmp_path / f"{main.__module__}.json"
        assert main(["--json", "--select", "OB001", "--report", str(rep), root]) == 1
        outs.append((json.loads(capsys.readouterr().out), json.loads(rep.read_text())))
    (ours, our_rep), (theirs, their_rep) = outs
    assert set(ours) == set(theirs)
    assert set(ours["findings"][0]) == set(theirs["findings"][0])
    assert set(ours["waived"][0]) == set(theirs["waived"][0])
    assert ours["rules"] == theirs["rules"] == {"OB001": {"findings": 1, "waived": 1,
                                                         "suppressed": 0}}
    assert set(our_rep) == set(their_rep) and our_rep["tool"] == "mho-lint"
    (tmp_path / "clean").mkdir()
    (tmp_path / "clean" / "c.py").write_text("X = 1\n")
    assert t_main([str(tmp_path / "clean")]) == 0
    assert t_main(["--select", "JX001", str(tmp_path / "clean")]) == 2


def test_baseline_suppresses_then_resurfaces_on_change(tmp_path):
    """JAX's baseline workflow: a recorded finding is suppressed until its
    line changes."""
    root = write_tree(tmp_path / "t", {"env/m.py": """\
        import torch


        def tp(n):
            return torch.arange(n)
    """})
    rep = run_analysis([root])
    assert [f.rule for f in rep.findings] == ["JX003"]
    bl = tmp_path / "baseline.json"
    write_baseline(str(bl), rep.findings)
    assert t_main(["--baseline", str(bl), root]) == 0
    rep2 = run_analysis([root], baseline=str(bl))
    assert not rep2.findings and len(rep2.suppressed) == 1
    p = tmp_path / "t" / "env" / "m.py"
    p.write_text(p.read_text().replace("torch.arange(n)", "torch.arange(2 * n)"))
    rep3 = run_analysis([root], baseline=str(bl))
    assert [f.rule for f in rep3.findings] == ["JX003"] and not rep3.suppressed


@pytest.mark.parametrize("select", ["repo", "pyflakes"])
def test_port_package_scans_clean(select):
    """The port's package: no live finding under either group (each
    deliberate site carries its rule's waiver with a reason)."""
    rep = run_analysis([os.path.join(REPO, PACKAGE_DIR)], select=select)
    assert not rep.findings, [f.render() for f in rep.findings]
    assert rep.files_scanned > 100
    assert all(f.waiver_reason.strip() for f in rep.waived)
