"""The port's policy linter (``repro_torch.analysis``): the reference's
rules that are not tied to JAX (REP002, REP005, REP007, REP008), scoped to
``repro_torch/`` paths.

Every ported rule gets the reference's fires and clean fixture cases
(``tests/test_analysis.py``) on ``src/repro_torch/`` paths; the fixtures
are written into a tmp tree with repo-like relative paths and linted with
``root=tmp``, so the same scoping runs as on the real tree. Then the
mechanics (suppression, baseline, REP000), and the CLI: it exits 0 on the
port's own tree with the checked-in (empty) baseline and nonzero on a
violation of each rule injected into a temporary tree.
"""

import json
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

from repro_torch.analysis import lint
from repro_torch.analysis.rules import RULES, RULES_BY_CODE

REPO = pathlib.Path(__file__).resolve().parents[1]
BASELINE = REPO / "src" / "repro_torch" / "analysis" / "baseline.json"


def _lint_tree(tmp_path, files, rules=None):
    """Write ``{relpath: source}`` into tmp and lint with root=tmp."""
    for rel, src in files.items():
        f = tmp_path / rel
        f.parent.mkdir(parents=True, exist_ok=True)
        f.write_text(textwrap.dedent(src))
    return lint.lint_paths([tmp_path], root=tmp_path, rules=rules)


def _codes(violations):
    return [v.code for v in violations]


def test_rule_registry_is_the_ported_rules():
    codes = [r.code for r in RULES]
    assert codes == ["REP002", "REP005", "REP007", "REP008"]
    for r in RULES:
        assert r.title and r.origin and r.fix_hint
        assert RULES_BY_CODE[r.code] is r


# --------------------------------------------- REP002: kernel dispatch

def test_rep002_fires_on_direct_kernel_imports(tmp_path):
    vs = _lint_tree(tmp_path, {"src/repro_torch/models/bad.py": """\
        from repro_torch.kernels.flash_attention import flash_attention_fwd
        from repro_torch.kernels import ref
        import repro_torch.kernels.ssd

        def f(q, k, v):
            return repro_torch.kernels.cluster_attention.cluster_attention_fwd(
                q, k, v)
        """})
    hits = [v for v in vs if v.code == "REP002"]
    assert len(hits) == 4, [v.format() for v in vs]
    assert all("ops" in v.fix_hint for v in hits)


def test_rep002_clean_via_ops_inside_kernels_and_out_of_scope(tmp_path):
    vs = _lint_tree(tmp_path, {
        "src/repro_torch/models/good.py": """\
            from repro_torch.kernels import ops

            def f(q, k, v):
                return ops.flash_attention(q, k, v)
            """,
        # the kernels package may import its own modules
        "src/repro_torch/kernels/ops.py": """\
            from repro_torch.kernels import cluster_attention as _ca
            from repro_torch.kernels import ref
            """,
        # the JAX package's kernels are the reference linter's business
        "src/repro_torch/core/other.py": """\
            from repro.kernels import ref
            """,
    })
    assert "REP002" not in _codes(vs), [v.format() for v in vs]


# --------------------------------------------- REP005: task-layer policy

def test_rep005_fires_on_family_branches_and_loss_dense(tmp_path):
    vs = _lint_tree(tmp_path, {"src/repro_torch/runtime/trainer.py": """\
        def step(self, task, model):
            if isinstance(task, NodeTask):
                return model.loss_dense
            return model.family
        """})
    hits = [v for v in vs if v.code == "REP005"]
    msgs = " | ".join(v.message for v in hits)
    assert len(hits) == 3, [v.format() for v in vs]
    assert "loss_dense" in msgs and "NodeTask" in msgs and ".family" in msgs


def test_rep005_clean_trainer_and_registry_dispatch(tmp_path):
    vs = _lint_tree(tmp_path, {
        "src/repro_torch/runtime/trainer.py": """\
            def step(self, task, model, variant):
                return model.loss_variants[variant]
            """,
        # a config registry may dispatch on the family
        "src/repro_torch/configs/registry.py": """\
            def build(cfg):
                return REGISTRY[cfg.family](cfg)
            """,
    })
    assert "REP005" not in _codes(vs), [v.format() for v in vs]


# ------------------------------- REP007: schedule literals stay tuned

def test_rep007_fires_on_block_size_literals_in_kernels(tmp_path):
    vs = _lint_tree(tmp_path, {"src/repro_torch/kernels/bad.py": """\
        def flash(q, *, block_q=128, block_k=128):
            return q

        def launch(q):
            return flash(q, block_q=64, block_k=64)

        def ssd(x, chunk=256):
            return x
        """})
    hits = [v for v in vs if v.code == "REP007"]
    assert len(hits) == 5, [v.format() for v in vs]
    assert all("schedule" in v.fix_hint.lower() or
               "winner" in v.fix_hint.lower() for v in hits)


def test_rep007_clean_required_args_and_out_of_scope(tmp_path):
    vs = _lint_tree(tmp_path, {
        # required args + threading a resolved variable is the idiom;
        # None defaults (dispatch resolves) and bools are fine
        "src/repro_torch/kernels/good.py": """\
            def flash(q, *, block_q, block_k, causal=True):
                return q

            def dispatch(q, block_q=None, block_k=None):
                bq, bk = block_q or 1, block_k or 1
                return flash(q, block_q=bq, block_k=bk)
            """,
        # non-kernel code is out of scope (tune cases pin shapes freely)
        "src/repro_torch/tune/cases.py": """\
            def case(chunk=256, bq=32):
                return chunk + bq
            """,
    })
    assert "REP007" not in _codes(vs), [v.format() for v in vs]


# ------------------------------- REP008: swallowed broad excepts

def test_rep008_fires_on_swallowing_broad_handlers(tmp_path):
    vs = _lint_tree(tmp_path, {"src/repro_torch/runtime/bad.py": """\
        import logging

        def f(x):
            try:
                return x()
            except:
                pass

        def g(x):
            try:
                return x()
            except Exception:
                pass

        def h(x):
            try:
                return x()
            except BaseException as e:
                logging.error(e)
        """})
    hits = [v for v in vs if v.code == "REP008"]
    assert len(hits) == 3, [v.format() for v in vs]
    assert all("swallows" in v.message for v in hits)


def test_rep008_clean_on_raise_warn_narrow_and_suppressed(tmp_path):
    vs = _lint_tree(tmp_path, {"src/repro_torch/runtime/good.py": """\
        import warnings

        def reraises(x):
            try:
                return x()
            except Exception as e:
                raise RuntimeError("wrapped") from e

        def warns(x):
            try:
                return x()
            except Exception as e:
                warnings.warn(f"recovered: {e}", RuntimeWarning)
                return None

        def narrow(x):
            try:
                return x()
            except ValueError:
                return None

        def justified(x):
            try:
                return x()
            # crash path: state may be half-dead, any error here would
            # mask the original exception.  # repro-lint: disable=REP008
            except Exception:
                return None
        """})
    assert "REP008" not in _codes(vs), [v.format() for v in vs]


# ------------------------------------- suppression / baseline / REP000

_BAD_EXCEPT = """\
    def f(x):
        try:
            return x()
        except Exception:{}
            return None
    """


def test_suppression_inline_and_other_codes(tmp_path):
    vs = _lint_tree(tmp_path, {"src/repro_torch/runtime/a.py":
                               _BAD_EXCEPT.format(
                                   "  # repro-lint: disable=REP008")})
    assert not vs, [v.format() for v in vs]
    # suppressing a different code does NOT silence the hit
    vs = _lint_tree(tmp_path, {"src/repro_torch/runtime/a.py":
                               _BAD_EXCEPT.format(
                                   "  # repro-lint: disable=REP002")})
    assert _codes(vs) == ["REP008"], [v.format() for v in vs]


def test_baseline_ratchets_on_counts(tmp_path):
    files = {"src/repro_torch/runtime/bad.py":
             textwrap.dedent(_BAD_EXCEPT.format(""))}
    vs = _lint_tree(tmp_path, files)
    assert len(vs) == 1
    base_path = tmp_path / "baseline.json"
    lint.write_baseline(base_path, vs)
    baseline = lint.load_baseline(base_path)
    assert baseline == {"src/repro_torch/runtime/bad.py::REP008": 1}
    assert not lint.new_violations(vs, baseline)
    files["src/repro_torch/runtime/bad.py"] += textwrap.dedent("""\

        def g(x):
            try:
                return x()
            except BaseException:
                return None
        """)
    vs = _lint_tree(tmp_path, files)
    assert len(lint.new_violations(vs, baseline)) == 2


def test_syntax_error_reports_rep000(tmp_path):
    vs = _lint_tree(tmp_path, {"src/repro_torch/models/broken.py":
                               "def f(:\n"})
    assert _codes(vs) == ["REP000"]


def test_checked_in_baseline_is_empty():
    assert lint.load_baseline(BASELINE) == {}


# ------------------------------------------------------------------ CLI

def _run_cli(*argv, cwd=REPO):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO / "src") + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", *argv],
        cwd=cwd, env=env, capture_output=True, text=True)


def test_cli_exits_zero_on_the_ports_tree():
    """The default path (``src/repro_torch``) against the checked-in,
    empty baseline."""
    r = _run_cli()
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new violation(s), 0 baselined, 4 rules" in r.stdout


_INJECTED = {
    "REP002": ("src/repro_torch/models/bad.py",
               "from repro_torch.kernels import ref\n"),
    "REP005": ("src/repro_torch/runtime/trainer.py",
               "def step(model):\n    return model.family\n"),
    "REP007": ("src/repro_torch/kernels/bad.py",
               "def ssd(x, chunk=256):\n    return x\n"),
    "REP008": ("src/repro_torch/runtime/bad.py",
               textwrap.dedent(_BAD_EXCEPT.format(""))),
}


@pytest.mark.parametrize("code", sorted(_INJECTED))
def test_cli_exits_nonzero_on_an_injected_violation(tmp_path, code):
    (tmp_path / "ROADMAP.md").write_text("fixture root marker\n")
    rel, src = _INJECTED[code]
    bad = tmp_path / rel
    bad.parent.mkdir(parents=True)
    bad.write_text(src)
    report = tmp_path / "report.json"
    r = _run_cli(str(tmp_path), "--report", str(report))
    assert r.returncode == 1, r.stdout + r.stderr
    assert code in r.stdout and "hint:" in r.stdout
    doc = json.loads(report.read_text())
    assert doc["tool"] == "repro_torch.analysis" and doc["ok"] is False
    assert {r_["code"] for r_ in doc["rules"]} == set(RULES_BY_CODE)
    assert [v["code"] for v in doc["new_violations"]] == [code]
    assert doc["counts"] == {f"{rel}::{code}": 1}


def test_cli_list_rules_prints_the_registry():
    r = _run_cli("--list-rules")
    assert r.returncode == 0, r.stdout + r.stderr
    for rule in RULES:
        assert rule.code in r.stdout and rule.origin in r.stdout
        assert rule.fix_hint in r.stdout
    assert [ln.split()[0] for ln in r.stdout.splitlines()
            if ln.startswith("REP")] == ["REP002", "REP005", "REP007",
                                          "REP008"]


def _bad_tree(tmp_path):
    (tmp_path / "ROADMAP.md").write_text("fixture root marker\n")
    rel, src = _INJECTED["REP008"]
    bad = tmp_path / rel
    bad.parent.mkdir(parents=True)
    bad.write_text(src)
    return str(tmp_path)


def test_cli_update_baseline_then_the_violation_is_baselined(tmp_path):
    tree = _bad_tree(tmp_path)
    base = tmp_path / "base.json"
    r = _run_cli(tree, "--update-baseline", "--baseline", str(base))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "1 violation(s) accepted" in r.stdout
    assert lint.load_baseline(base) == {
        "src/repro_torch/runtime/bad.py::REP008": 1}
    r = _run_cli(tree, "--baseline", str(base))
    assert r.returncode == 0, r.stdout + r.stderr
    assert "0 new violation(s), 1 baselined" in r.stdout
    # the checked-in baseline was not touched
    assert lint.load_baseline(BASELINE) == {}


def test_cli_update_baseline_without_a_path_returns_2(tmp_path):
    r = _run_cli(_bad_tree(tmp_path), "--update-baseline",
                 "--baseline", "none")
    assert r.returncode == 2, r.stdout + r.stderr
    assert "needs a baseline path" in r.stderr


def test_cli_baseline_none_fails_on_a_violation(tmp_path):
    r = _run_cli(_bad_tree(tmp_path), "--baseline", "none")
    assert r.returncode == 1, r.stdout + r.stderr
    assert "REP008" in r.stdout and "1 new violation(s), 0 baselined" \
        in r.stdout
