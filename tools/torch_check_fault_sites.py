#!/usr/bin/env python3
"""Gate: every fault-injection site of the port is exercised by a test.

    python3 tools/torch_check_fault_sites.py [--device cuda|cpu] [root]

The port of ``tools/check_fault_sites.py``. A site is any string literal
given as ``faults.inject("<site>")`` or as a ``site="<site>"`` keyword (the
``retry_call`` form) in ``mxnet_tpu_torch/``, found by an AST walk of its
own (the reference's walk, ``tools.lint``, reads ``mxnet_tpu/``). A site
counts as tested when its quoted string appears in a
``tests/test_torch_*.py`` file: a test that installs a ``FaultPlan``
against it and holds the recovery. The walk reads source only, so
``--device`` (default ``cuda``, as every gate of the port) changes nothing
here; it is taken so that the gates share one command line.

Exits 1 and lists every untested site with the files that declare it.
"""
import argparse
import ast
import os
import re
import sys
from typing import Dict, Iterator, Set

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PACKAGE = "mxnet_tpu_torch"
TEST_GLOB = re.compile(r"^test_torch_.*\.py$")
_SITE_NAME = re.compile(r"^[a-z0-9_.]+$")


def py_files(root: str) -> Iterator[str]:
    for dirpath, dirs, files in os.walk(root):
        dirs[:] = sorted(d for d in dirs if d != "__pycache__")
        for f in sorted(files):
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def _str_const(node) -> str:
    if isinstance(node, ast.Constant) and isinstance(node.value, str) \
            and _SITE_NAME.match(node.value):
        return node.value
    return ""


def _call_name(func) -> str:
    while isinstance(func, ast.Attribute):
        return func.attr
    return func.id if isinstance(func, ast.Name) else ""


def collect_sites(pkg_dir: str) -> Dict[str, Set[str]]:
    """Site -> the files (relative to the package's parent) declaring it."""
    pkg_dir = os.path.abspath(pkg_dir)
    base = os.path.dirname(pkg_dir)
    sites: Dict[str, Set[str]] = {}
    for path in py_files(pkg_dir):
        with open(path, encoding="utf-8") as f:
            tree = ast.parse(f.read(), filename=path)
        rel = os.path.relpath(path, base)
        for node in ast.walk(tree):
            if not isinstance(node, ast.Call):
                continue
            found = []
            if _call_name(node.func) == "inject" and node.args:
                found.append(_str_const(node.args[0]))
            found += [_str_const(kw.value) for kw in node.keywords
                      if kw.arg == "site"]
            for s in filter(None, found):
                sites.setdefault(s, set()).add(rel)
    return sites


def tests_text(tests_dir: str) -> str:
    """The text of every ``tests/test_torch_*.py`` file."""
    parts = []
    for name in sorted(os.listdir(tests_dir)):
        if TEST_GLOB.match(name):
            with open(os.path.join(tests_dir, name), encoding="utf-8") as f:
                parts.append(f.read())
    return "\n".join(parts)


def tested_sites(tests_dir: str, sites) -> Set[str]:
    text = tests_text(tests_dir)
    return {s for s in sites
            if re.search(r"""["']""" + re.escape(s) + r"""["']""", text)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("root", nargs="?", default=ROOT)
    a = ap.parse_args(argv)
    pkg = os.path.join(a.root, PACKAGE)
    sites = collect_sites(pkg)
    if not sites:
        print(f"torch_check_fault_sites: no injection sites under {pkg}",
              file=sys.stderr)
        return 1
    missing = sorted(set(sites) - tested_sites(os.path.join(a.root,
                                                            "tests"), sites))
    if missing:
        print("torch_check_fault_sites: FAIL, injection sites that no "
              "tests/test_torch_*.py file names:", file=sys.stderr)
        for s in missing:
            print(f"  {s!r}  (declared in {', '.join(sorted(sites[s]))})",
                  file=sys.stderr)
        return 1
    print(f"torch_check_fault_sites: {len(sites)} sites, every one named "
          f"in a test: {sorted(sites)}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
