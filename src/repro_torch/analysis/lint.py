"""The port's lint: AST rules for hazards a generic linter cannot see.

Port of ``repro.analysis.lint``: the same machinery (a waiver is a trailing
``# lint-ok: <rule>`` comment on the line), with the torch forms of the
reference's five rules:

* ``nondet-in-det-path`` — a value-ordered op (``torch.topk``, ``argmax``,
  ``argmin``, or ``sort`` / ``argsort`` without ``stable=``) in the routing
  and dispatch modules outside the ``deterministic_top_k`` helper or a
  branch guarded by ``deterministic_router``: float ties flip across
  mappings.
* ``implicit-dtype`` — ``torch.zeros``, ``ones``, ``empty``, ``full``,
  ``arange``, ``linspace``, ``eye`` or ``tensor`` without ``dtype=`` in the
  hot paths (``core``, ``models``, ``kernels``, ``train``): the default
  dtype silently sets what downstream arithmetic runs in.
* ``global-rng`` (the reference's ``key-reuse``) — a sampling call or an
  in-place sampler with no ``generator=``, or a ``*_like`` sampler (which
  takes none): it draws from the process-global RNG, whose state depends
  on whatever ran before, so the draw is not a function of a seed.
* ``host-sync-branch`` (the reference's ``traced-branch``) — a Python
  ``if``, ``while`` or ``assert`` whose test reads a tensor's value
  (``.item()``, ``.tolist()``, ``bool(t)``, ``torch.any`` / ``all`` /
  ``equal`` / …) in
  ``core``, ``models``, ``kernels``, ``train`` or ``serve``: each such read
  synchronises the device with the host on the step's path, and raises on
  the dry run's fake tensors; it also keeps the step out of a CUDA graph.
* ``unregistered-axis-name`` — a string literal naming a logical axis
  (``groups.attn["…"]``, ``groups.moe["…"]``, ``.axis(side, "…")``,
  ``.atoms(side, "…")``, ``.size(side, "…")``) that
  ``core.folding.is_logical_axis_name`` rejects, or an atom
  (``.atom_size(("…",))``, ``.atom_index(("…",))``) that
  ``core.folding.is_registered_axis_name`` rejects.
"""
from __future__ import annotations

import ast
import os
from typing import List, Optional, Sequence, Tuple

from repro_torch.analysis import Finding
from repro_torch.core.folding import is_logical_axis_name, is_registered_axis_name

WAIVER = "# lint-ok:"
# Modules where value-ordered ops feed routing decisions.
DET_PATH_MODULES = ("router", "dispatcher", "moe_layer", "overlap")
# Module path fragments counted as hot paths (the dtype rule).
HOT_PATHS = (f"{os.sep}core{os.sep}", f"{os.sep}models{os.sep}",
             f"{os.sep}kernels{os.sep}", f"{os.sep}train{os.sep}")
# The step's path (the host-sync rule): the hot paths and serving.
STEP_PATHS = HOT_PATHS + (f"{os.sep}serve{os.sep}",)
_CREATION = ("zeros", "ones", "empty", "full", "arange", "linspace", "eye", "tensor")
_NONDET = ("topk", "argmax", "argmin")
_SORTS = ("sort", "argsort")
# Samplers of ``torch`` (functions) and of a tensor (in-place methods).
_SAMPLERS = ("rand", "randn", "randint", "randperm", "normal", "bernoulli", "multinomial",
             "poisson")
_INPLACE_SAMPLERS = ("normal_", "uniform_", "bernoulli_", "random_", "exponential_",
                     "geometric_", "cauchy_", "log_normal_")
_LIKE_SAMPLERS = ("rand_like", "randn_like", "randint_like")
# Calls whose result is a tensor's value on the host, or a tensor that a
# branch turns into a Python bool.
_VALUE_METHODS = ("item", "tolist")
_VALUE_TORCH = ("any", "all", "equal", "allclose", "isclose", "isfinite", "isnan", "isinf",
                "count_nonzero", "is_nonzero")
_AXIS_METHODS = ("axis", "atoms", "size")
_ATOM_METHODS = ("atom_size", "atom_index")


def _attr_chain(node: ast.AST) -> Tuple[str, ...]:
    """``torch.nn.init.normal_`` → ("torch", "nn", "init", "normal_");
    a call's method on any other value → ("", "method"); else ()."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
    elif parts:
        parts.append("")
    return tuple(reversed(parts))


def _str_const(node: Optional[ast.AST]) -> Optional[str]:
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        return node.value
    return None


def _strings_in(node: ast.AST):
    """(line, value) for a bare string or the strings of a tuple/list literal."""
    s = _str_const(node)
    if s is not None:
        yield node.lineno, s
    elif isinstance(node, (ast.Tuple, ast.List)):
        for elt in node.elts:
            yield from _strings_in(elt)


def _package_path(path: str) -> str:
    """``path`` from the package root on (``/core/router.py`` for any
    ``.../repro_torch/core/router.py``), so that the scope rules read the
    package's own directories only."""
    norm = os.path.normpath(path)
    i = norm.rfind("repro_torch" + os.sep)
    return norm[i + len("repro_torch"):] if i >= 0 else os.sep + norm


def _keyword(node: ast.Call, name: str) -> Optional[ast.keyword]:
    return next((kw for kw in node.keywords if kw.arg == name), None)


class _FileLinter(ast.NodeVisitor):
    def __init__(self, path: str, source: str):
        self.path = path
        self.lines = source.splitlines()
        self.findings: List[Finding] = []
        self.func_stack: List[str] = []
        self.det_guard = 0          # depth of deterministic_router branches
        norm = _package_path(path)
        self.det_module = any(m in os.path.basename(path) for m in DET_PATH_MODULES)
        self.hot = any(h in norm for h in HOT_PATHS)
        self.step = any(h in norm for h in STEP_PATHS)

    # -- helpers --------------------------------------------------------
    def _waived(self, line: int, rule: str) -> bool:
        if 1 <= line <= len(self.lines):
            text = self.lines[line - 1]
            if WAIVER in text and rule in text.split(WAIVER, 1)[1]:
                return True
        return False

    def _emit(self, line: int, rule: str, message: str) -> None:
        if not self._waived(line, rule):
            self.findings.append(Finding(rule=rule, where=f"{self.path}:{line}",
                                         message=message))

    # -- scope tracking -------------------------------------------------
    def visit_FunctionDef(self, node):
        self.func_stack.append(node.name)
        self.generic_visit(node)
        self.func_stack.pop()

    visit_AsyncFunctionDef = visit_FunctionDef

    # -- rule: host-sync-branch ----------------------------------------
    def _check_branch(self, node, test: ast.AST, what: str) -> None:
        if not self.step:
            return
        for n in ast.walk(test):
            if not isinstance(n, ast.Call):
                continue
            chain = _attr_chain(n.func)
            reads = (chain == ("bool",)
                     or (len(chain) >= 2 and chain[-1] in _VALUE_METHODS)
                     or (len(chain) == 2 and chain[0] == "torch" and chain[1] in _VALUE_TORCH))
            if reads:
                self._emit(node.lineno, "host-sync-branch",
                           f"Python {what} on `{'.'.join(c for c in chain if c)}` reads a "
                           "tensor's value on the host: a device sync on the step's path "
                           "(and an error on fake tensors); decide on the device or "
                           "outside the step")
                return

    def visit_If(self, node):
        self._check_branch(node, node.test, "branch")
        guard = "deterministic_router" in ast.dump(node.test)
        if guard:
            self.det_guard += 1
        self.generic_visit(node)
        if guard:
            self.det_guard -= 1

    def visit_While(self, node):
        self._check_branch(node, node.test, "loop")
        self.generic_visit(node)

    def visit_Assert(self, node):
        self._check_branch(node, node.test, "assert")
        self.generic_visit(node)

    # -- unregistered-axis-name on subscripts --------------------------
    def visit_Subscript(self, node):
        if isinstance(node.value, ast.Attribute) and node.value.attr in ("attn", "moe"):
            name = _str_const(node.slice)
            if name is not None and not is_logical_axis_name(node.value.attr, name):
                self._axis_finding(node.lineno, f"{node.value.attr}[{name!r}]")
        self.generic_visit(node)

    def _axis_finding(self, line: int, what: str) -> None:
        self._emit(line, "unregistered-axis-name",
                   f"{what} names no axis the folding defines (core.folding: "
                   "ATTN_AXES / MOE_AXES, atoms pod/pp/fN)")

    # -- rules on calls -------------------------------------------------
    def visit_Call(self, node):
        chain = _attr_chain(node.func)
        dotted = ".".join(c for c in chain if c)
        last = chain[-1] if chain else ""
        torch_fn = len(chain) == 2 and chain[0] == "torch"

        # nondet-in-det-path
        if (self.det_module and self.det_guard == 0
                and "deterministic_top_k" not in self.func_stack and len(chain) >= 2):
            nondet = (last in _NONDET
                      or (last in _SORTS and _keyword(node, "stable") is None
                          and (torch_fn or last == "argsort")))
            if nondet:
                self._emit(node.lineno, "nondet-in-det-path",
                           f"`{dotted}` breaks ties by float compare on a deterministic-"
                           "router path; use router.deterministic_top_k or a stable sort")

        # implicit-dtype
        if self.hot and torch_fn and last in _CREATION and _keyword(node, "dtype") is None:
            self._emit(node.lineno, "implicit-dtype",
                       f"`torch.{last}` without an explicit dtype in a hot path — the "
                       "default silently sets the dtype of downstream arithmetic")

        # global-rng
        draws = ((torch_fn and last in _SAMPLERS and _keyword(node, "generator") is None)
                 or (len(chain) >= 2 and last in _INPLACE_SAMPLERS
                     and _keyword(node, "generator") is None)
                 or (torch_fn and last in _LIKE_SAMPLERS))
        if draws:
            self._emit(node.lineno, "global-rng",
                       f"`{dotted}` draws from the process-global RNG, whose state depends "
                       "on what ran before; pass a seeded torch.Generator")

        # unregistered-axis-name
        if len(chain) >= 2 and last in _AXIS_METHODS and len(node.args) >= 2:
            side, name = _str_const(node.args[0]), _str_const(node.args[1])
            if side is not None and name is not None \
                    and not is_logical_axis_name(side, name):
                self._axis_finding(node.lineno, f".{last}({side!r}, {name!r})")
        if len(chain) >= 2 and last in _ATOM_METHODS and node.args:
            for line, s in _strings_in(node.args[0]):
                if not is_registered_axis_name(s):
                    self._axis_finding(line, f".{last}(... {s!r} ...)")
        self.generic_visit(node)


def lint_source(path: str, source: str) -> List[Finding]:
    """Lint one file's source text. A syntax error is a finding too."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as e:
        return [Finding(rule="syntax-error", where=f"{path}:{e.lineno}", message=str(e.msg))]
    linter = _FileLinter(path, source)
    linter.visit(tree)
    return sorted(linter.findings, key=lambda f: f.where)


def lint_paths(paths: Sequence[str], rules: Optional[Sequence[str]] = None) -> List[Finding]:
    """Lint every ``.py`` file under the given paths."""
    files: List[str] = []
    for p in paths:
        if os.path.isfile(p):
            files.append(p)
        else:
            for root, _dirs, names in os.walk(p):
                files.extend(os.path.join(root, n) for n in sorted(names) if n.endswith(".py"))
    findings: List[Finding] = []
    for f in sorted(set(files)):
        with open(f, encoding="utf-8") as fh:
            found = lint_source(f, fh.read())
        if rules:
            found = [x for x in found if x.rule in rules]
        findings.extend(found)
    return findings
