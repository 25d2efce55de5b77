"""The port's init-purity checks (``analysis/purity.py``).

* ``tree_bitwise_diffs`` against the reference's ``pytree_bitwise_diffs``
  on the same arrays: the same leaves, mismatch counts and ``max |Δ|``.
* ``check_purity`` names an impure run's variant and leaf.
* The built-in suite (reduced Mixtral-8x22B at 4 layers: the reference's
  three folds against the one-rank init, pp = 1 against pp = 2) has no
  findings, and catches two seeded faults: an init that folds the fold
  into its seed (``mapping-dependent-init``), and a pipeline stage that
  draws only its own leaves (``pp-stack-init-impurity``).
"""
import numpy as np
import torch

from repro_torch.analysis.purity import builtin_purity_suite, check_purity, tree_bitwise_diffs


def _cases():
    rng = np.random.default_rng(0)
    a = {"w": rng.standard_normal((3, 4, 5)).astype(np.float32),
         "b": np.arange(6, dtype=np.float32), "i": np.arange(12, dtype=np.int32).reshape(3, 4)}
    same = {k: v.copy() for k, v in a.items()}
    ulp = {k: v.copy() for k, v in a.items()}
    ulp["w"][0, 1, 2] = np.nextafter(ulp["w"][0, 1, 2], np.float32(9))  # close is still a diff
    ulp["w"][2, 3] += 1e-3
    ulp["b"][4] = -1.0
    ulp["i"][1, 1] += 7
    shape = dict(a, b=np.zeros(7, np.float32))
    dtype = dict(a, i=a["i"].astype(np.int64))
    return a, [same, ulp, shape, dtype]


def test_bitwise_diffs_match_reference():
    from repro.analysis.purity import pytree_bitwise_diffs
    a, others = _cases()
    for other in others:
        got = {name: (n, d) for name, n, d in tree_bitwise_diffs(a, other)}
        want = {path.strip("[]'"): (n, d) for path, n, d in pytree_bitwise_diffs(a, other)}
        assert got.keys() == want.keys()
        for name, (n, d) in got.items():
            assert n == want[name][0], name
            assert d == want[name][1] or (np.isinf(d) and np.isinf(want[name][1])), name
    assert tree_bitwise_diffs({"a": np.zeros(2)}, {"b": np.zeros(2)}) == \
        pytree_bitwise_diffs({"a": np.zeros(2)}, {"b": np.zeros(2)}) == \
        [("<structure>", 1, float("inf"))]
    m = torch.nn.Linear(3, 2)
    assert tree_bitwise_diffs(m, {k: v.numpy() for k, v in m.state_dict().items()}) == []


def test_check_purity_flags_impure_run():
    calls = []

    def run(ctx):
        calls.append(ctx)
        return {"w": torch.full((4,), float(len(calls)))}

    found = check_purity(run, [("a", 1), ("b", 2)], rule="test-impure", where="here")
    assert [f.rule for f in found] == ["test-impure"]
    assert "'b'" in found[0].message and "w" in found[0].message


def test_builtin_suite_is_clean():
    assert builtin_purity_suite() == []


def _fold_seeded(cfg, *, seed, device, groups):
    """A seeded fault: the fold's DP degree folded into the seed."""
    from repro_torch.models.transformer import init_lm
    dp = 0 if groups is None else groups.pcfg.attn.dp
    return init_lm(cfg, seed=seed + dp, device=device, groups=groups)


def _own_leaves_only(cfg, *, seed, device, groups):
    """A seeded fault: a later pipeline stage draws its own matrices from a
    fresh generator, not at their place in the whole model's stream."""
    from repro_torch.models.transformer import init_lm
    p = init_lm(cfg, seed=seed, device=device, groups=groups)
    if groups is not None and groups.pp_stage > 0:
        g = torch.Generator().manual_seed(seed)
        with torch.no_grad():
            for _, t in p.named_parameters():
                if t.dim() >= 2:
                    t.copy_(torch.randn(t.shape, generator=g) * 0.02)
    return p


def test_seeded_faults_are_caught():
    found = builtin_purity_suite(init=_fold_seeded)
    rules = [f.rule for f in found]
    assert "mapping-dependent-init" in rules
    first = found[rules.index("mapping-dependent-init")]
    assert "max |Δ|" in first.message and "'dp2cp1tp2" in first.message
    found = builtin_purity_suite(init=_own_leaves_only)
    assert [f.rule for f in found] == ["pp-stack-init-impurity"]
    assert "'dp1cp1tp2/edp1ep1etp2/pp2'" in found[0].message
