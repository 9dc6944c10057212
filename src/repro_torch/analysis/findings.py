"""Finding records and reports of the port's contract checks (port of
``repro.analysis.findings``).

A :class:`Finding` is one violation of a contract at a traced entry point.
Trace findings have no single source line: they use a ``trace:<entry>``
pseudo-path and line 0, as the reference's jaxpr findings use
``jaxpr:<entry>``.  The reference's baseline files grandfather findings of
its AST lint pass; the port has no lint pass (rules RPR001–RPR004 are
JAX idioms scoped to ``src/repro/``) and no baseline: every finding fails.
"""
from __future__ import annotations

import dataclasses
import hashlib
from typing import Dict, Sequence


@dataclasses.dataclass(frozen=True, order=True)
class Finding:
    path: str          # "trace:<entry>" pseudo-path
    line: int          # 0 for trace findings
    rule: str          # "RPRJ01".."RPRJ03"
    message: str
    snippet: str = ""  # the offending op or count (fingerprint component)

    def fingerprint(self) -> str:
        """Stable identity: rule + path + a hash of the offending text."""
        text = self.snippet or self.message
        digest = hashlib.sha256(text.encode("utf-8")).hexdigest()[:16]
        return f"{self.rule}|{self.path}|{digest}"

    def format(self) -> str:
        loc = f"{self.path}:{self.line}" if self.line else self.path
        return f"{loc}: {self.rule} {self.message}"

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["fingerprint"] = self.fingerprint()
        return d


def report_dict(findings: Sequence[Finding],
                entry_reports: Sequence[dict] = ()) -> dict:
    """A JSON-ready report: the findings by rule and every entry's counts."""
    by_rule: Dict[str, int] = {}
    for f in findings:
        by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {
        "version": 1,
        "total": len(findings),
        "by_rule": dict(sorted(by_rule.items())),
        "findings": [f.to_dict() for f in sorted(findings)],
        "trace_entries": list(entry_reports),
    }
