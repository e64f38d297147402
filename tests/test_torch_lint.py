"""The port under the project's invariant linter (`tools/gskylint`).

The port and its soak tool are linted together with the JAX package, so
that the metrics check (GSKY-METRICS) reads the families registered in
`gsky_tpu/obs/metrics.py` as `tests/test_gskylint.py`'s
`test_repo_tree_is_clean` does; with the checked-in (empty) baseline
there is no finding, and no inline ``# gskylint: disable=`` in the port
or the tool."""

import os

from tools.gskylint.engine import lint_paths

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PORT = ("gsky_tpu_torch", os.path.join("tools", "soak_torch.py"))


def test_port_lints_clean():
    live, _ = lint_paths(
        [os.path.join(ROOT, p) for p in ("gsky_tpu",) + PORT], root=ROOT,
        baseline_path=os.path.join(ROOT, "tools", "gskylint",
                                   "baseline.json"))
    assert live == [], "\n".join(f.render() for f in live)


def test_port_has_no_inline_suppressions():
    found = []
    for p in PORT:
        path = os.path.join(ROOT, p)
        files = [path] if path.endswith(".py") else [
            os.path.join(d, f) for d, _, fs in os.walk(path)
            for f in fs if f.endswith(".py")]
        for f in files:
            with open(f, encoding="utf-8") as fp:
                found += [f"{os.path.relpath(f, ROOT)}:{i}"
                          for i, line in enumerate(fp, 1)
                          if "gskylint: disable" in line]
    assert found == []
