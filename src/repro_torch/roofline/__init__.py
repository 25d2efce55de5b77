"""Roofline terms of a step on the card: data-sheet constants
(``analysis``), the cost of a step traced on fake tensors (``trace_cost``)
and the renderers of the dry run's JSONL (``perf_log``, ``report``)."""
