"""Static analysis of the port: the collective audit over its traced
step's records, an AST lint of its sources and bitwise init-purity checks.

Port of ``repro.analysis``. Three passes, each the counterpart of the
reference's:

* ``audit``  — trace the real step of a structure-preserving probe of each
  ``launch.mappings._TABLE`` row on fake tensors, for every rank of the
  probe's world (``launch.dryrun.trace_pair``), classify every collective
  the ranks issued by the atoms of the fold's rank grid it communicates
  over, its bytes and its fold, and diff the rows against the analytic
  byte budget (``launch.autotune.collective_byte_budget``). An
  *unbudgeted* collective is a named finding; the rows are pinned in
  ``tests/torch_collective_audit_golden.json``.
* ``purity`` — build each rank's stored leaves through the production
  init path under several folds and hold the reassembled whole bitwise
  equal to the one-rank init.
* ``lint``   — AST rules over ``src/repro_torch``: host syncs in branches
  on the step's path, draws from the global RNG, value-ordered ops on the
  deterministic routing path, tensor creation without a dtype in the hot
  paths, and axis-name literals the folding does not define.

CLI::

    PYTHONPATH=src python -m repro_torch.analysis audit [--fast]
    PYTHONPATH=src python -m repro_torch.analysis lint [paths...]
    PYTHONPATH=src python -m repro_torch.analysis purity
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class Finding:
    """One named analysis finding, shared by all three passes.

    ``rule`` is a stable kebab-case identifier (waivable in source with a
    ``# lint-ok: <rule>`` comment for the lint pass; budget entries are the
    waiver of the audit pass). ``where`` locates the finding: ``file:line``
    for lint, the ``arch|shape`` mapping key for audit, the checked path for
    purity.
    """
    rule: str
    where: str
    message: str

    def __str__(self) -> str:
        return f"[{self.rule}] {self.where}: {self.message}"


def format_findings(findings: Sequence[Finding]) -> str:
    if not findings:
        return "no findings"
    return "\n".join(str(f) for f in findings)


__all__ = ["Finding", "format_findings"]
