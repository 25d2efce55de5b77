"""The port's lint (``analysis/lint.py``): each rule fires on a minimal
snippet, a ``# lint-ok: <rule>`` waiver silences it, each keeps its scope,
a syntax error is a finding, and ``src/repro_torch`` is clean."""
import textwrap

import pytest

from repro_torch.analysis.lint import lint_paths, lint_source


def _lint(src, path="src/repro_torch/core/router.py"):
    return lint_source(path, textwrap.dedent(src))


def _rules(findings):
    return [f.rule for f in findings]


# ---------------------------------------------------------------------------
# nondet-in-det-path
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["torch.topk(logits, 2)", "logits.topk(2)",
                                  "torch.argmax(logits, -1)", "logits.argmin(-1)",
                                  "torch.sort(logits, dim=-1)", "torch.argsort(logits)",
                                  "logits.argsort(dim=-1)"])
def test_nondet_fires_in_router_module(call):
    f = _lint(f"def route(logits):\n    return {call}\n")
    assert _rules(f) == ["nondet-in-det-path"]
    assert "deterministic_top_k" in f[0].message


def test_nondet_exempt_in_guard_helper_stable_sort_and_waiver():
    f = _lint("""
        def deterministic_top_k(logits, k):
            return torch.topk(logits, k)

        def route(cfg, logits):
            if cfg.deterministic_router:
                idx = deterministic_top_k(logits, 2)
            else:
                idx = torch.topk(logits, 2)
            order = torch.argsort(logits, stable=True)
            vals = torch.sort(logits, stable=True, descending=True)
            best = logits.argmax(-1)  # lint-ok: nondet-in-det-path
            return idx, order, vals, best, sorted([3, 1])
    """)
    assert f == []


def test_nondet_not_flagged_outside_det_modules():
    f = _lint("def pick(x):\n    return torch.argmax(x)\n",
              path="src/repro_torch/models/attn_core.py")
    assert f == []


# ---------------------------------------------------------------------------
# implicit-dtype
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["torch.zeros(n)", "torch.ones((n, n), device=d)",
                                  "torch.empty(n)", "torch.full((n,), 2.0)",
                                  "torch.arange(n)", "torch.linspace(0, 1, n)",
                                  "torch.eye(n)", "torch.tensor([1, 2])"])
def test_implicit_dtype_fires_in_hot_path(call):
    f = _lint(f"def f(n, d):\n    return {call}\n", path="src/repro_torch/models/ffn.py")
    assert _rules(f) == ["implicit-dtype"]


def test_explicit_dtype_and_like_ok():
    f = _lint("""
        def f(n, x):
            a = torch.arange(n, dtype=torch.long)
            b = torch.zeros((n, n), dtype=x.dtype, device=x.device)
            c = torch.zeros_like(x)
            d = x.new_zeros((n,))
            e = torch.tensor([1.0])  # lint-ok: implicit-dtype
            return a, b, c, d, e
    """, path="src/repro_torch/kernels/gmm/ops.py")
    assert f == []


def test_implicit_dtype_scoped_to_hot_paths():
    f = _lint("def f(n):\n    return torch.arange(n)\n",
              path="src/repro_torch/launch/dryrun.py")
    assert f == []


# ---------------------------------------------------------------------------
# global-rng
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("call", ["torch.randn((4, 4))", "torch.rand(4, device=d)",
                                  "torch.randint(0, 9, (4,))", "torch.randperm(4)",
                                  "torch.multinomial(p, 1)", "w.normal_(0, 0.02)",
                                  "w.uniform_()", "torch.randn_like(w)",
                                  "torch.nn.init.normal_(w)"])
def test_global_rng_fires_anywhere(call):
    f = _lint(f"def init(w, p, d):\n    return {call}\n",
              path="src/repro_torch/launch/bench_gmm.py")
    assert _rules(f) == ["global-rng"]
    assert "torch.Generator" in f[0].message


def test_seeded_generator_and_waiver_ok():
    f = _lint("""
        def init(w, p, seed):
            g = torch.Generator().manual_seed(seed)
            a = torch.randn((4, 4), generator=g)
            b = w.normal_(0, 0.02, generator=g)
            c = torch.multinomial(p, 1, generator=g)
            d = torch.rand(4)  # lint-ok: global-rng
            return a, b, c, d
    """)
    assert f == []


# ---------------------------------------------------------------------------
# host-sync-branch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("test", ["x.item() > 0", "bool(flag)", "torch.any(x > 0)",
                                  "not torch.all(x)", "torch.equal(x, y)",
                                  "x.sum().item()", "len(x.tolist()) > 2"])
@pytest.mark.parametrize("stmt", ["if {}:\n        pass", "while {}:\n        break",
                                  "assert {}"])
def test_host_sync_branch_fires_on_the_step_path(test, stmt):
    f = _lint(f"def step(x, y, flag):\n    {stmt.format(test)}\n",
              path="src/repro_torch/serve/engine.py")
    assert _rules(f) == ["host-sync-branch"]
    assert "sync" in f[0].message


def test_host_sync_branch_ignores_shapes_waivers_and_other_paths():
    src = """
        def step(x, cfg, groups):
            if x.shape[0] > 1 and x.dtype == torch.float32 and groups is not None:
                pass
            while isinstance(x, tuple):
                x = x[0]
            assert x.dim() == 2
            if x.any().item():  # lint-ok: host-sync-branch
                pass
    """
    assert _lint(src, path="src/repro_torch/train/loop.py") == []
    assert _lint("def f(x):\n    if x.item():\n        pass\n",
                 path="src/repro_torch/launch/serve.py") == []


# ---------------------------------------------------------------------------
# unregistered-axis-name
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("expr", ['groups.attn["expert"]', 'groups.moe["tp"]',
                                  'fg.axis("attn", "ep")', 'fg.atoms("moe", "dp_cp")',
                                  'fg.size("attn", "etp")', 'fg.axis("mlp", "tp")',
                                  'fg.atom_size(("f0", "pods"))', 'fg.atom_index(("x1",))'])
def test_unregistered_axis_literal_fires(expr):
    f = _lint(f"def g(groups, fg):\n    return {expr}\n")
    assert _rules(f) == ["unregistered-axis-name"]


def test_registered_and_resolved_axis_names_ok():
    f = _lint("""
        def g(groups, fg, name, x):
            a = groups.attn["cp_tp"], groups.moe["tokens"], groups.attn[name]
            b = fg.axis("moe", "ep"), fg.atoms("attn", "stage"), fg.size("moe", "seq")
            c = fg.atom_size(("pod", "pp", "f12")), fg.atom_index(fg.atoms("attn", "tp"))
            d = x.size(0), groups.moe["bogus"]  # lint-ok: unregistered-axis-name
            return a, b, c, d
    """)
    assert f == []


# ---------------------------------------------------------------------------
# Syntax errors and the whole package
# ---------------------------------------------------------------------------

def test_syntax_error_is_finding():
    assert _rules(lint_source("x.py", "def broken(:\n")) == ["syntax-error"]


def test_port_tree_is_clean():
    assert lint_paths(["src/repro_torch"]) == []
